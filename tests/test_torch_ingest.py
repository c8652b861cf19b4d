"""The port's copies of the JAX package's ingestion modules against their
originals, on the JAX tests' own fixtures: the MGH reader and writer in
every dtype, the session ingestion (``.npy`` and ``.mgh`` sessions; the
per-trial files and caption files byte for byte), the behavior readers
(``ValueError`` on missing columns: F0), the repeat average and the
z-scores, the Glasser groups with and without ``n_labels``, the HCP region
names, the NSD key split, the pack (written by either package, opened by
the other, ``data.bin`` byte-identical), the host-resident store and its
block upload, and the NSD stimuli brick. Copies are held exactly."""

import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from masters_thesis_tpu.data import pack as jpack
from masters_thesis_tpu.data import splits as jsplits
from masters_thesis_tpu.data.preprocess import glasser as jglasser
from masters_thesis_tpu.data.preprocess import hcp_regions as jhcp
from masters_thesis_tpu.data.preprocess import mgh as jmgh
from masters_thesis_tpu.data.preprocess import sessions as jsessions
from masters_thesis_tpu.data.preprocess import zscore as jzscore
from masters_thesis_tpu.data.store import ArrayStore as JArrayStore
from masters_thesis_tpu_torch.data import pack, splits
from masters_thesis_tpu_torch.data.preprocess import (
    glasser,
    hcp_regions,
    mgh,
    sessions,
    zscore,
)
from masters_thesis_tpu_torch.data.store import (
    ArrayStore,
    RowConcat,
    upload_rows,
)
from test_sessions_ingest import _write_fixture
from torch_threads import one_thread  # noqa: F401


def _tree(root: Path) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _mgh_sessions(sessions_dir: Path, module) -> None:
    for f in sorted(sessions_dir.glob("*.npy")):
        module.write_mgh(str(f.with_suffix("")) + ".mgh",
                         np.load(f).astype(np.float32))
        f.unlink()


# ---- mgh ----

@pytest.mark.parametrize("dtype", ["float32", "uint8", "int16", "int32"])
@pytest.mark.parametrize("suffix", [".mgh", ".mgz"])
def test_mgh_round_trip_matches_original(tmp_path, dtype, suffix):
    rng = np.random.default_rng(0)
    for shape in ((6, 3), (7,), (3, 4, 5, 2)):
        arr = (rng.standard_normal(shape) * 40).astype(dtype)
        ours, theirs = tmp_path / f"a{suffix}", tmp_path / f"b{suffix}"
        mgh.write_mgh(str(ours), arr)
        jmgh.write_mgh(str(theirs), arr)
        if suffix == ".mgh":
            assert ours.read_bytes() == theirs.read_bytes()
        for path in (ours, theirs):
            got = mgh.read_mgh(str(path))
            want = jmgh.read_mgh(str(path))
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_mgh_rejects_truncated_files_as_original(tmp_path):
    bad = tmp_path / "trunc.mgh"
    bad.write_bytes(b"\x00" * 10)
    for module in (mgh, jmgh):
        with pytest.raises(ValueError, match="truncated"):
            module.read_mgh(str(bad))


# ---- sessions ----

@pytest.mark.parametrize("fmt", ["npy", "mgh"])
def test_ingest_sessions_writes_the_original_files(tmp_path, fmt):
    sessions_dir, behav, caps_json, _, _ = _write_fixture(tmp_path)
    if fmt == "mgh":
        _mgh_sessions(sessions_dir, jmgh)
    reports = []
    for name, module in (("port", sessions), ("jax", jsessions)):
        out = tmp_path / name
        report = module.ingest_sessions(
            str(sessions_dir), str(behav), str(out), n_sessions=3,
            captions_json=str(caps_json))
        reports.append(json.loads(json.dumps(report).replace(str(out), "")))
    assert reports[0] == reports[1]
    port, jax_tree = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert set(port) == set(jax_tree)
    for rel, data in port.items():
        if rel.endswith(".txt"):    # captions name their beta's own path
            data = data.replace(str(tmp_path / "port").encode(), b"")
            want = jax_tree[rel].replace(str(tmp_path / "jax").encode(), b"")
        else:
            want = jax_tree[rel]
        assert data == want, rel
    betas = tmp_path / "port" / "subj_2" / "betas"
    got = list(sessions.averaged_rows(str(betas)))
    want = list(jsessions.averaged_rows(str(betas)))
    assert [k for k, _ in got] == [k for k, _ in want] == [11, 12, 13, 14, 15]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_load_hemi_and_find_session_files_match_original(tmp_path):
    sessions_dir, *_ = _write_fixture(tmp_path)
    for ses in (1, 2, 3):
        assert (sessions.find_session_files(str(sessions_dir), ses)
                == jsessions.find_session_files(str(sessions_dir), ses))
    lh = str(sessions_dir / "lh.betas_session01.npy")
    np.testing.assert_array_equal(sessions.load_hemi(lh),
                                  jsessions.load_hemi(lh))
    _mgh_sessions(sessions_dir, mgh)
    lh = str(sessions_dir / "lh.betas_session01.mgh")
    np.testing.assert_array_equal(sessions.load_hemi(lh),
                                  jsessions.load_hemi(lh))


def test_behavior_readers_match_original(tmp_path):
    tsv = tmp_path / "b.tsv"
    tsv.write_text("SUBJECT\tSESSION\tRUN\tTRIAL\t73KID\n2\t1\t1\t1\t42\n"
                   "2\t2\t1\t1\t43\n")
    csv_ = tmp_path / "b.csv"
    csv_.write_text("73KID,TRIAL,RUN,SESSION,SUBJECT\n7,1,2,1,5\n9.0,2,2,1,5\n")
    empty = tmp_path / "e.csv"
    empty.write_text("")
    for path in (tsv, csv_, empty):
        for ses in (None, 1, 2):
            assert (sessions.read_behavior(str(path), session_index=ses)
                    == jsessions.read_behavior(str(path), session_index=ses))
    bdir = tmp_path / "bdir"
    bdir.mkdir()
    (bdir / "behav_session02.csv").write_text(csv_.read_text())
    for ses in (1, 2):
        assert (sessions.session_behavior(str(bdir), ses)
                == jsessions.session_behavior(str(bdir), ses))


def test_behavior_reader_raises_value_error_on_missing_columns(tmp_path):
    """F0: the JAX reader raises ValueError (its own test expects an
    AssertionError); the copy raises what the original raises."""
    bad = tmp_path / "bad.csv"
    bad.write_text("SUBJECT,SESSION\n2,1\n")
    for module in (sessions, jsessions):
        with pytest.raises(ValueError, match="missing columns"):
            module.read_behavior(str(bad))


def test_ingest_rejects_a_trial_count_mismatch_as_original(tmp_path):
    sessions_dir, behav, *_ = _write_fixture(tmp_path)
    behav.write_text("\n".join(behav.read_text().splitlines()[:-1]) + "\n")
    for name, module in (("port", sessions), ("jax", jsessions)):
        with pytest.raises(ValueError, match="trials in betas"):
            module.ingest_sessions(str(sessions_dir), str(behav),
                                   str(tmp_path / name), n_sessions=2)


# ---- zscore ----

def test_zscore_average_and_stats_match_original():
    rng = np.random.default_rng(3)
    betas = rng.standard_normal((12, 7)).astype(np.float32)
    betas[:, 2] = 1.5                                   # a dead voxel
    for axis in (0, 1):
        np.testing.assert_array_equal(
            zscore.session_zscore(betas, axis=axis),
            jzscore.session_zscore(betas, axis=axis))
    cond = np.array([5, 3, 5, 9, 3, 5, 1, 1, 9, 2, 5, 3])
    for a, b in zip(zscore.average_over_repeats(betas, cond),
                    jzscore.average_over_repeats(betas, cond)):
        np.testing.assert_array_equal(a, b)
    for chunk in (1, 5, 256):
        for a, b in zip(zscore.voxelwise_stats(betas, chunk),
                        jzscore.voxelwise_stats(betas, chunk)):
            np.testing.assert_array_equal(a, b)


# ---- glasser, HCP names ----

def test_glasser_groups_match_original(tmp_path, caplog):
    lh = np.array([1, 2, 2, 3, 0, 5])
    rh = np.array([1, 1, 0, 0, 4, 2])
    for n_labels in (None, 5, 6):
        for exclude_zero in (True, False):
            with caplog.at_level(logging.WARNING):
                got = glasser.groups_from_atlas(lh, rh, exclude_zero,
                                                n_labels=n_labels)
                want = jglasser.groups_from_atlas(lh, rh, exclude_zero,
                                                  n_labels=n_labels)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        glasser.groups_from_atlas(np.array([1, 2, 3]), np.array([1]))
    assert "different label ranges" in caplog.text
    groups = glasser.groups_from_atlas(lh, rh)
    assert ([g.tolist() for g in glasser.select_groups(groups, [1, 3, 99])]
            == [g.tolist() for g in jglasser.select_groups(groups,
                                                           [1, 3, 99])])
    np.testing.assert_array_equal(
        glasser.visual_cortex_mask(lh, rh, [1, 2]),
        jglasser.visual_cortex_mask(lh, rh, [1, 2]))
    np.save(tmp_path / "lh.npy", lh)
    mgh.write_mgh(str(tmp_path / "rh.mgz"), rh.astype(np.int32))
    for name in ("lh.npy", "rh.mgz"):
        np.testing.assert_array_equal(
            glasser.load_atlas_vector(str(tmp_path / name)),
            jglasser.load_atlas_vector(str(tmp_path / name)))


def test_hcp_region_names_match_original(tmp_path):
    assert hcp_regions.HCP_MMP1_REGIONS == jhcp.HCP_MMP1_REGIONS
    names = tmp_path / "names.csv"
    names.write_text("﻿\nregion\n0,V1\n1,MST\n2,V6\n")
    for kw in ({}, {"groups_to_remove": [0, 181, 359]},
               {"names_csv": str(names), "n_per_hemi": 3}):
        assert hcp_regions.region_names(**kw) == jhcp.region_names(**kw)
    assert (hcp_regions.load_names_csv(str(names))
            == jhcp.load_names_csv(str(names)))


# ---- splits ----

def test_get_nsd_keys_and_split_from_keys_match_original(tmp_path):
    cond = tmp_path / "subj01_conditions.csv"
    test = tmp_path / "test_conditions.csv"
    cond.write_text("nsd_key,is_shared\n"
                    + "".join(f"{k},0\n" for k in range(1, 9001))
                    + "".join(f"{k},1\n" for k in range(9001, 10001)))
    test.write_text("nsd_key\n" + "".join(f"{k}\n"
                                          for k in range(9001, 9516)))
    for strict in (True, False):
        got = splits.get_nsd_keys(str(cond), str(test), strict=strict)
        want = jsplits.get_nsd_keys(str(cond), str(test), strict=strict)
        for name in ("train", "val", "test"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
    assert (len(got.train), len(got.val), len(got.test)) == (9000, 485, 515)
    short = tmp_path / "subj02_conditions.csv"
    short.write_text("nsd_key,is_shared\n3,0\n4,1\n9100,1\n")
    for module in (splits, jsplits):
        with pytest.raises(AssertionError, match="unq keys"):
            module.get_nsd_keys(str(short), str(test))
    got = splits.get_nsd_keys(str(short), str(test), strict=False)
    assert got.train.tolist() == [3] and got.val.tolist() == [4]
    assert splits._read_csv(str(short)) == jsplits._read_csv(str(short))
    got = splits.split_from_keys([1, 2], [3], np.array([4]))
    want = jsplits.split_from_keys([1, 2], [3], np.array([4]))
    for name in ("train", "val", "test"):
        a, b = getattr(got, name), getattr(want, name)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.int64


# ---- pack and the host store ----

@pytest.mark.parametrize("row_shape", [(7,), (3, 4)])
def test_pack_round_trip_across_packages(tmp_path, row_shape):
    rng = np.random.default_rng(1)
    keys = [9, 2, 40, 5]
    rows = rng.standard_normal((4, *row_shape)).astype(np.float32)
    metas = [pack.write_pack(str(tmp_path / "port"), keys, rows),
             jpack.write_pack(str(tmp_path / "jax"), keys, rows),
             pack.write_pack(str(tmp_path / "port_it"), None,
                             iter(zip(keys, rows)))]
    assert metas[0] == metas[1] == metas[2]
    for name in ("port_it", "jax"):
        assert _tree(tmp_path / "port") == _tree(tmp_path / name)
    for src in ("port", "jax"):
        ours = pack.open_pack(str(tmp_path / src))
        theirs = jpack.open_pack(str(tmp_path / src))
        assert not ours.device_resident and ours.device is None
        assert isinstance(ours.data, np.memmap)
        np.testing.assert_array_equal(ours.keys, theirs.keys)
        np.testing.assert_array_equal(ours.data, np.asarray(theirs.data))
        assert ours.row_shape == theirs.row_shape == row_shape
        np.testing.assert_array_equal(ours.indices_for([40, 9]),
                                      theirs.indices_for([40, 9]))
        np.testing.assert_array_equal(ours.gather_host(np.array([3, 0])),
                                      theirs.gather_host(np.array([3, 0])))


def test_pack_empty_and_streaming_errors_match_original(tmp_path):
    for module in (pack, jpack):
        with pytest.raises(ValueError, match="empty rows iterable"):
            module.write_pack(str(tmp_path / "p"), None, iter([]))
    pack.write_pack(str(tmp_path / "e"), [], np.zeros((0, 7), np.float32))
    jpack.write_pack(str(tmp_path / "je"), [], np.zeros((0, 7), np.float32))
    assert _tree(tmp_path / "e") == _tree(tmp_path / "je")
    store = pack.open_pack(str(tmp_path / "je"))
    assert len(store) == 0 and len(jpack.open_pack(str(tmp_path / "e"))) == 0
    assert store.upload("cpu").shape == (0, 7)


def test_store_from_npy_dir_and_memmap_match_original(tmp_path):
    rng = np.random.default_rng(2)
    rows = rng.standard_normal((3, 5)).astype(np.float32)
    for k, row in zip((4, 8, 15), rows):
        np.save(tmp_path / f"subj02_KID{k}.npy", row)
    name = lambda k: f"subj02_KID{k}.npy"  # noqa: E731
    ours = ArrayStore.from_npy_dir(tmp_path, [15, 4], name)
    theirs = JArrayStore.from_npy_dir(tmp_path, [15, 4], name)
    assert not ours.device_resident
    np.testing.assert_array_equal(ours.data, theirs.data)
    rows.tofile(tmp_path / "rows.bin")
    ours = ArrayStore.from_memmap(tmp_path / "rows.bin", [1, 2, 3], (3, 5))
    theirs = JArrayStore.from_memmap(tmp_path / "rows.bin", [1, 2, 3],
                                     (3, 5))
    np.testing.assert_array_equal(ours.gather_host([2, 0]),
                                  theirs.gather_host(np.array([2, 0])))
    with pytest.raises(ValueError, match="host-resident"):
        ours.device_array()


@pytest.mark.parametrize("block_bytes", [1, 24, 60, 1 << 20])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_block_upload_equals_a_whole_copy(tmp_path, block_bytes, dtype):
    """The upload in row blocks (one row, rows that straddle the parts of a
    RowConcat, everything at once) gives a whole copy bit for bit."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((5, 2, 3)).astype(np.float32)
    b = rng.standard_normal((4, 2, 3)).astype(np.float32)
    pack.write_pack(str(tmp_path / "a"), range(5), a)
    mm = pack.open_pack(str(tmp_path / "a")).data
    whole = torch.from_numpy(np.concatenate([a, b])).reshape(9, 6)
    tdtype = torch.bfloat16 if dtype else torch.float32
    got = upload_rows(RowConcat([mm, b]), "cpu", tdtype, block_bytes)
    assert got.dtype == tdtype
    assert torch.equal(got, whole.to(tdtype))
    store = ArrayStore(RowConcat([mm, b]), range(9), device_resident=False)
    assert store.n_cols == 6 and store.row_shape == (2, 3)
    assert len(store.data) == 9 and store.data.dtype == np.float32
    assert torch.equal(store.upload("cpu", dtype), whole.to(tdtype))


def test_row_concat_refuses_parts_that_differ():
    with pytest.raises(ValueError, match="row shapes"):
        RowConcat([np.zeros((2, 3), np.float32), np.zeros((2, 4),
                                                          np.float32)])


# ---- NSD stimuli ----

@pytest.fixture()
def brick(tmp_path):
    h5py = pytest.importorskip("h5py")
    imgs = np.random.default_rng(0).integers(0, 255, (10, 6, 6, 3)).astype(
        np.uint8)
    path = tmp_path / "nsd_stimuli.hdf5"
    with h5py.File(path, "w") as f:
        f.create_dataset("imgBrick", data=imgs)
    return str(path)


def test_nsd_stimuli_match_original(brick, tmp_path):
    from masters_thesis_tpu.data import nsd_images as jimages
    from masters_thesis_tpu_torch.data import nsd_images

    for keys in (None, [3, 1, 10, 3], []):
        np.testing.assert_array_equal(
            nsd_images.read_stimuli(brick, keys=keys),
            jimages.read_stimuli(brick, keys=keys))
    for bad in ([0], [11]):
        with pytest.raises(ValueError, match="keys must be in"):
            nsd_images.read_stimuli(brick, keys=bad)
    got = list(nsd_images.iter_stimuli_chunks(brick, [2, 9, 4], chunk=2))
    want = list(jimages.iter_stimuli_chunks(brick, [2, 9, 4], chunk=2))
    assert len(got) == len(want) == 2
    for (k1, c1), (k2, c2) in zip(got, want):
        np.testing.assert_array_equal(k1, k2)
        np.testing.assert_array_equal(c1, c2)
    for fmt in ("npy", "png"):
        if fmt == "png":
            pytest.importorskip("PIL")
        n = nsd_images.export_images(brick, [2, 5], str(tmp_path / "p"),
                                     fmt=fmt)
        jn = jimages.export_images(brick, [2, 5], str(tmp_path / "j"),
                                   fmt=fmt)
        assert n == jn == 2
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j")
