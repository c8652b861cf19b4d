"""The port's ``parallel/`` against the JAX package's, on the CPU.

The sharding decisions equal JAX ``param_pspec`` over every family's
parameter tree at model sizes 1, 2, 3 and 4 (with the replicate fallback's
one warning); the flagship census of ``dryrun --flagship`` (a model built
on the meta device) equals JAX ``params_pspec_tree`` over ``jax.eval_shape``
of the flagship init. On 2 to 4 gloo ranks in their own processes
(``torch_parallel_child.py``): each collective's gradient equals the
single-device gradient (1e-6, float64); ``gather(shard(state))`` is the
state, exactly, for every family; one sharded step at data 1 x model 2 and
data 2 x model 1 equals JAX ``make_sharded_train_step`` on a virtual CPU
mesh of that shape (loss and updated parameters, 2e-5, dropout off); and
multi-rank ``run_training`` equals the port's single-process run with
dropout on and the LocallyDense encoder's BatchNorm (epoch and val losses
1e-5, parameter norm 1e-4: the JAX package's bounds,
tests/test_parallel.py:219-224) at data 2 x model 2 through ``train
--processes``, for uneven hosts, for the families whose sharded leaves
are gathered whole (fc_nic) or whose batch splits by subject (ms2_nic),
and under ``tpu.fused_seq``; a 1 x 1 config through ``train --processes``
becomes data-parallel. A
multi-rank checkpoint restores in one process and on another topology bit
for bit, and a run resumed on another topology equals the uninterrupted
one; ``tpu.use_pallas: false`` at data 1 x model 2 never calls K1's
wrapper and trains the single-process run's epoch. Then the launcher's
typed failures and port-race markers (the JAX
markers, and torch's bind error), ``caption --shard 2`` on two CPU
replicas, and ``dryrun`` on 4 CPU ranks.
"""

import dataclasses
import json
import logging
import shutil
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from masters_thesis_tpu.parallel import multiprocess as jmp
from masters_thesis_tpu.parallel import sharding as jsharding
from masters_thesis_tpu_torch import cli
from masters_thesis_tpu_torch.config import Config
from masters_thesis_tpu_torch.data.synthetic import synthetic_groups
from masters_thesis_tpu_torch.decode.sampling import make_sampling_decoder
from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.parallel import multiprocess as mp
from masters_thesis_tpu_torch.parallel import sharding
from masters_thesis_tpu_torch.parallel.dryrun import flagship_census
from masters_thesis_tpu_torch.serve import Captioner, _replicas, sample_seed
from masters_thesis_tpu_torch.train.checkpoint import CheckpointManager
from masters_thesis_tpu_torch.train.state import (
    LAYOUT_MODELS,
    MODELS,
    model_for,
    new_state,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parallel_child import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOSS_ATOL, NORM_ATOL = 1e-5, 1e-4       # tests/test_parallel.py:219-224
STEP_ATOL = 2e-5
GRAD_ATOL = 1e-6
FAMILY_CONFIGS = {
    "lc_nic": "flagship_synth.yaml", "cnn_rnn": "cnn_rnn.yaml",
    "guse_nic": "guse_nic.yaml", "ms2_nic": "multi_subject.yaml",
    "showtell": "show_and_tell.yaml", "thinkandtell":
        "think_and_tell_pca.yaml",
    # the families no config names, at the flagship's widths
    "ms_nic": "flagship_synth.yaml", "fc_nic": "flagship_synth.yaml",
    "img_nic": "flagship_synth.yaml", "concat_lc_nic": "flagship_synth.yaml",
    "deep_lc_nic": "flagship_synth.yaml",
}
ROW_SHAPES = {"img_nic": (196, 512), "cnn_rnn": (64, 2048),
              "fc_nic": (2048,), "showtell": (4096,),
              "thinkandtell": (5000,)}


def _family_tree(name):
    """{state-dict name: shape} of family ``name`` at its config's widths,
    built on the meta device (2,048 voxels in 12 groups for the families
    that read a layout)."""
    cfg = Config.load(ROOT / "configs" / FAMILY_CONFIGS[name])
    cfg.model = name
    layout = GroupLayout(synthetic_groups(2048, 12), 2048)
    with torch.device("meta"):
        model = model_for(cfg, layout if name in LAYOUT_MODELS else None,
                          row_shape=ROW_SHAPES.get(name))
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


class _Leaf:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("model_size", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(FAMILY_CONFIGS))
def test_param_spec_matches_jax_param_pspec(name, model_size, caplog):
    """The same spec for every parameter, and the same warnings of a
    dimension the model axis does not divide, once a parameter."""
    tree = _family_tree(name)
    jsharding._warned_replicated.clear()
    sharding._warned_replicated.clear()
    with caplog.at_level(logging.WARNING):
        for _ in range(2):
            for path, shape in tree.items():
                names = path.split(".")
                want = tuple(jsharding.param_pspec(names, _Leaf(shape),
                                                   model_size))
                assert sharding.param_spec(names, shape, model_size) == want
    by_logger = {}
    for rec in caplog.records:
        by_logger.setdefault(rec.name, []).append(rec.getMessage())
    assert by_logger.get("masters_thesis_tpu_torch", []) == by_logger.get(
        "masters_thesis_tpu", [])
    if model_size in (2, 4) and name in ("lc_nic", "showtell"):
        # vocab 5,001 is not divided: embedding and head replicated
        assert any("embedding" in m for m in by_logger["masters_thesis_tpu"])


def test_flagship_census_matches_jax_eval_shape():
    """``dryrun --flagship``'s census on 8 ranks (data 4 x model 2, vocab
    5,001 padded to 5,008) against JAX ``params_pspec_tree`` over
    ``jax.eval_shape`` of the flagship init: the same sharded leaves and
    the same shapes on a rank."""
    from masters_thesis_tpu.config import Config as JConfig
    from masters_thesis_tpu.config import TPUConfig as JTPUConfig
    from masters_thesis_tpu.data.synthetic import (
        synthetic_groups as jgroups,
    )
    from masters_thesis_tpu.experiment import build_model as jbuild
    from masters_thesis_tpu.train.state import init_model as jinit

    census = flagship_census(8)
    cfg = JConfig(batch_size=32, max_length=15, top_k=5000, units=512,
                  attn_units=32, group_size=32, embedding_text=512,
                  tpu=JTPUConfig(vocab_pad_multiple=8))
    n_voxels = cfg.input.full
    model, _, _ = jbuild(cfg, jgroups(n_voxels=n_voxels, n_groups=360,
                                      seed=0), n_voxels)
    params = jax.eval_shape(
        lambda b, t: jinit(model, cfg, b, t)[0],
        jax.ShapeDtypeStruct((32, n_voxels), jnp.float32),
        jax.ShapeDtypeStruct((32, 15), jnp.int32))
    specs = jsharding.params_pspec_tree(params, 2)
    want_shapes, want_sharded = {}, []
    for (path, leaf), spec in zip(
            jax.tree_util.tree_leaves_with_path(params),
            jax.tree_util.tree_leaves(specs,
                                      is_leaf=lambda x: isinstance(x, P))):
        name = ".".join(jsharding._name_of(p) for p in path)
        shape = list(leaf.shape)
        for axis, entry in enumerate(spec):
            if entry == "model":
                shape[axis] //= 2
                want_sharded.append(name)
        want_shapes[name] = shape
    assert census["rank_shapes"] == want_shapes
    assert sorted(census["sharded_names"]) == sorted(want_sharded)
    assert census["sharded"] == 9 and census["embedding_sharded"]
    assert census["dims"]["vocab"] == "5001->5008"


def test_rank_columns_partition_the_grouped_layout():
    """The model ranks' columns cover the grouped layout once, each
    bucket's slice of every group side by side; a rank's store is those
    columns of the permuted store, and a bucket the axis does not divide
    is whole on every rank."""
    from masters_thesis_tpu_torch.data.store import permute_rows

    layout = GroupLayout(synthetic_groups(2048, 12), 2048)
    x = torch.randn(3, 2048, generator=torch.Generator().manual_seed(0))
    full = permute_rows(x, layout)
    for m_size in (2, 4):
        cols = [sharding.rank_columns(layout, m, m_size)
                for m in range(m_size)]
        assert sorted(np.concatenate(cols)) == list(
            range(layout.padded_total))
        mesh = type("M", (), {"m": 1, "model": m_size})()
        torch.testing.assert_close(
            sharding.shard_store_array(x, layout, mesh),
            full[:, torch.as_tensor(cols[1])], rtol=0, atol=0)
    cols = sharding.rank_columns(layout, 1, 3)      # 128 % 3 != 0
    assert len(cols) == layout.padded_total


@pytest.fixture(scope="module")
def collective_errors():
    return run_ranks(2, "collectives")


@pytest.mark.parametrize("op", ["encoder_partial_sum", "vocab_embedding",
                                "vocab_head", "gathered_leaf",
                                "batchnorm_global_batch"])
def test_collective_gradient_matches_the_single_device_gradient(
        collective_errors, op):
    assert collective_errors[op] <= GRAD_ATOL, collective_errors


@pytest.mark.parametrize("model_size", [2, 4])
def test_gather_of_shard_is_the_state_for_every_family(model_size):
    report = run_ranks(4, "round_trip", model_size)["families"]
    assert set(report) == set(MODELS)
    for name, r in report.items():
        assert r["exact"], name
        if name in ("lc_nic", "fc_nic", "cnn_rnn"):
            assert r["sharded"] and r["local_params"] < r["params"], name


def _jax_drive_step(tmp_path):
    """The drive's LcNIC, dropout off, one JAX sharded step on a 1 x 2 and
    a 2 x 1 virtual CPU mesh; the weights and batch for the port."""
    from masters_thesis_tpu.config import Config as JConfig
    from masters_thesis_tpu.parallel.mesh import make_mesh
    from masters_thesis_tpu.train.losses import lc_nic_l2_rules
    from masters_thesis_tpu.train.optim import make_optimizer
    from masters_thesis_tpu.train.state import TrainState, init_model

    cfg = JConfig(batch_size=8, max_length=6, top_k=63, units=16,
                  attn_units=8, group_size=4, embedding_text=8,
                  dropout_features=0.0, dropout_text=0.0, dropout_attn=0.0,
                  dropout_lstm=0.0, dropout_out=0.0)
    from masters_thesis_tpu.data.synthetic import (
        synthetic_groups as jgroups,
    )
    from masters_thesis_tpu.experiment import build_model as jbuild

    # the drive's LcNIC through build_model, which takes cfg's dropouts
    model, _, _ = jbuild(cfg, jgroups(n_voxels=256, n_groups=8, seed=0), 256)
    batch = jmp._drive_batches(cfg, 256, 1)[0]
    params, bstats, rng = init_model(model, cfg, jnp.asarray(batch["betas"]),
                                     jnp.asarray(batch["tokens"]))
    flat = {}
    for coll, tree in (("params", params), ("batch_stats", bstats)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            flat["/".join([coll, *(jsharding._name_of(p) for p in path)])] \
                = np.asarray(leaf)
    path = tmp_path / "drive.npz"
    np.savez(path, betas=batch["betas"], tokens=batch["tokens"].astype(
        np.int64), target=batch["target"].astype(np.int64), **flat)
    want = {}
    for d, m in ((1, 2), (2, 1)):
        mesh = make_mesh(data=d, model=m, devices=jax.devices()[:2])
        # the step donates its state: each mesh starts from copies
        fresh = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda x: jnp.array(x, copy=True), t)
        state = TrainState.create(params=fresh(params),
                                  batch_stats=fresh(bstats),
                                  tx=make_optimizer(cfg), rng=fresh(rng))
        state = jsharding.shard_params(state, mesh)
        step = jsharding.make_sharded_train_step(
            model, cfg, lc_nic_l2_rules(cfg), mesh, state)
        g = jsharding.global_batch_from_host_local(
            batch, mesh, with_voxel_axis=True, global_rows=8)
        state, metrics = step(state, g["betas"], g["tokens"], g["target"])
        leaves = {".".join(jsharding._name_of(p) for p in path):
                  np.asarray(leaf) for path, leaf in
                  jax.tree_util.tree_leaves_with_path(state.params)}
        want[f"{d}x{m}"] = (float(metrics["loss"]), leaves)
    return path, want


def test_sharded_step_matches_the_jax_sharded_step(tmp_path):
    """One step at data 1 x model 2 and data 2 x model 1 from the same
    weights and batch: the loss and every updated parameter within 2e-5."""
    path, want = _jax_drive_step(tmp_path)
    got = run_ranks(2, "jax_step", str(path))
    for mesh in ("1x2", "2x1"):
        loss, leaves = want[mesh]
        assert abs(got[mesh]["loss"] - loss) <= STEP_ATOL, mesh
        whole = np.load(f"{path}.{mesh}.npz")
        assert set(leaves) <= set(whole.files)
        for name, value in leaves.items():
            np.testing.assert_allclose(whole[name], value, rtol=0,
                                       atol=STEP_ATOL, err_msg=f"{mesh} "
                                       f"{name}")


def _in_threads(*calls):
    """Run the calls concurrently; their results in order."""
    out, errors = [None] * len(calls), []

    def run(i, fn):
        try:
            out[i] = fn()
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i, fn))
               for i, fn in enumerate(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The drive's runs: single-process, 2 x 2 through ``train
    --processes 2 --devices-per-process 2`` (A), 2 x 1 for one epoch (B),
    and the 1 x 1 config through ``train --processes 2`` for one epoch
    (dp); the launches at once."""
    root = tmp_path_factory.mktemp("drive")
    cfg = mp.train_drive_config(str(root / "a"), mesh_model=2)
    cfg_path = root / "a.yaml"
    cfg.save(cfg_path)
    single = mp.run_training_inprocess(str(root / "single"), mesh_model=0,
                                       device="cpu")

    def cli_run():
        out = _cli_json(["train", "--config", str(cfg_path), "--processes",
                         "2", "--devices-per-process", "2", "--epochs", "2",
                         "--smoke-keys", str(mp.TRAIN_DRIVE_SMOKE_KEYS),
                         "--device", "cpu"])
        return out

    one = mp.train_drive_config(str(root / "one"), mesh_model=0)
    one.save(root / "one.yaml")
    a, b, dp = _in_threads(
        cli_run,
        lambda: mp.run_multiprocess_training(
            str(root / "b"), n_processes=1, devices_per_process=2,
            mesh_model=1, epochs=1, device="cpu", timeout=240),
        lambda: mp.launch_cli_train(
            str(root / "one.yaml"), n_processes=2, devices_per_process=1,
            epochs=1, smoke_keys=mp.TRAIN_DRIVE_SMOKE_KEYS, device="cpu",
            timeout=240))
    return {"root": root, "single": single, "a": a, "b": b, "dp": dp}


def _cli_json(argv):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _close(got, want):
    np.testing.assert_allclose(got["epoch_losses"], want["epoch_losses"],
                               rtol=0, atol=LOSS_ATOL)
    np.testing.assert_allclose(got["epoch_val_losses"],
                               want["epoch_val_losses"], rtol=0,
                               atol=LOSS_ATOL)
    assert abs(got["param_norm"] - want["param_norm"]) <= NORM_ATOL


def test_multirank_training_matches_the_single_process_run(runs):
    """``train --processes 2 --devices-per-process 2`` on the drive's
    config (mesh_model 2): 4 ranks, data 2 x model 2, dropout on."""
    a, single = runs["a"], runs["single"]
    assert a["mesh"] == {"data": 2, "model": 2} and a["ranks"] == 4
    assert a["hosts"] == 2 and a["ranks_per_host"] == [2, 2]
    assert len(a["epoch_losses"]) == 2 and a["latest_epoch"] == 1
    _close(a, single)
    assert a["epoch_losses"][-1] < a["epoch_losses"][0]


def test_multirank_checkpoint_restores_in_one_process_bit_for_bit(runs):
    """The 4-rank run's last checkpoint, restored into a single-process
    state, is the run's whole final state: the same SHA-256."""
    a = runs["a"]
    cfg = Config.load(Path(a["run_path"]) / "config.yaml")
    layout = GroupLayout.load(Path(a["run_path"]) / "layout.npz")
    state = new_state(model_for(cfg, layout), cfg, "cpu")
    CheckpointManager(str(Path(a["run_path"]) / "model")).restore(state)
    assert mp._state_sha256({k: v for k, v in
                             state.model.state_dict().items()}) \
        == a["state_sha256"]


def test_resume_on_another_topology_equals_the_uninterrupted_run(runs):
    """B (data 2 x model 1) trained epoch 0; a copy restored on data 1 x
    model 2 with nothing left to train holds B's state bit for bit, and a
    copy resumed on data 2 x model 2 for epoch 1 equals A, the
    uninterrupted 2-epoch run."""
    root, b = runs["root"], runs["b"]
    for name in ("c", "d"):
        shutil.copytree(root / "b", root / name)
    c, d = _in_threads(
        lambda: mp.run_multiprocess_training(
            str(root / "c"), n_processes=1, devices_per_process=2,
            mesh_model=2, epochs=1, resume=True, device="cpu", timeout=240),
        lambda: mp.run_multiprocess_training(
            str(root / "d"), n_processes=2, devices_per_process=2,
            mesh_model=2, epochs=2, resume=True, device="cpu", timeout=240))
    assert c["mesh"] == {"data": 1, "model": 2}
    assert c["state_sha256"] == b["state_sha256"]
    assert d["latest_epoch"] == 1
    _close(d, runs["a"])
    assert abs(d["final_loss"] - runs["a"]["final_loss"]) <= LOSS_ATOL


def test_uneven_hosts_match_the_single_process_run(tmp_path):
    """Hosts of 2 and 1 ranks (data 3 x model 1): the batch of 8 rounds to
    6 rows, 2 a rank; the single-process run of batch 6."""
    from masters_thesis_tpu_torch.experiment import run_training

    def single():
        cfg = mp.train_drive_config(str(tmp_path / "sp"), mesh_model=0)
        cfg.batch_size = 6
        run_path, logs, bundle = run_training(
            cfg, epochs=1, smoke_keys=mp.TRAIN_DRIVE_SMOKE_KEYS, device="cpu")
        return mp._training_report(run_path, bundle, logs)

    got, want = _in_threads(
        lambda: mp.run_multiprocess_training(
            str(tmp_path / "mp"), n_processes=2, devices_per_process=[2, 1],
            mesh_model=1, epochs=1, device="cpu", timeout=240),
        single)
    assert got["ranks"] == 3 and got["mesh"] == {"data": 3, "model": 1}
    _close(got, want)


@pytest.mark.parametrize("name,tpu", [
    ("fc_nic", {}), ("ms2_nic", {}), ("lc_nic", {"fused_seq": True})])
def test_other_routes_match_the_single_process_run(tmp_path, name, tpu):
    """fc_nic's sharded encoder kernel is gathered whole for its layer;
    ms2_nic's batch splits [A-half ; B-half] across the data axis;
    ``tpu.fused_seq`` trains the decoder through the fused sequence's
    custom backward, whose attention masks are the global batch's too.
    Each at data 2 x model 2, dropout on, against its single-process
    run."""
    knobs = json.dumps(tpu)
    got, want = _in_threads(
        lambda: run_ranks(4, "family_run", name, str(tmp_path / "mp"), 0, 2,
                          1, knobs),
        lambda: run_ranks(1, "family_run", name, str(tmp_path / "sp"), 1, 0,
                          1, knobs))
    assert got["mesh"] == {"data": 2, "model": 2}
    _close(got, want)


def test_plain_route_under_a_mesh_takes_no_kernel(runs, tmp_path):
    """``tpu.use_pallas: false`` at data 1 x model 2 (a voxel-sharded
    store, the scanned steps): K1's wrapper raises
    in every rank and no rank counts a launch, and the epoch is the
    single-process run's first."""
    got = run_ranks(2, "plain_route_run", str(tmp_path / "mp"), 1, 2)
    assert got["mesh"] == {"data": 1, "model": 2}
    assert got["launches_by_rank"]["gather_rows"] == [0, 0]
    single = runs["single"]
    for key in ("epoch_losses", "epoch_val_losses"):
        np.testing.assert_allclose(got[key], single[key][:1], rtol=0,
                                   atol=LOSS_ATOL, err_msg=key)


def test_cli_train_makes_a_1x1_config_data_parallel(runs):
    """``train --processes 2 --devices-per-process 1`` on a config whose
    mesh is 1 x 1: 2 ranks on the data axis, the single-process run's
    first epoch."""
    got = runs["dp"]
    assert got["mesh"] == {"data": 2, "model": 1} and got["ranks"] == 2
    np.testing.assert_allclose(got["epoch_losses"],
                               runs["single"]["epoch_losses"][:1], rtol=0,
                               atol=LOSS_ATOL)


def test_single_rank_mesh_is_the_plain_run(tmp_path):
    """``mesh_data: 0`` in one process: a mesh of one rank over a process
    group of one, the plain run's numbers exactly."""
    plain = mp.run_training_inprocess(str(tmp_path / "p"), mesh_model=0,
                                      epochs=1, device="cpu")
    meshed = mp.run_training_inprocess(str(tmp_path / "m"), mesh_model=1,
                                       epochs=1, device="cpu")
    assert meshed["mesh"] == {"data": 1, "model": 1}
    assert meshed["epoch_losses"] == plain["epoch_losses"]
    assert meshed["state_sha256"] == plain["state_sha256"]


def test_a_mesh_must_take_every_rank(tmp_path):
    """A grid that asks for more ranks than the process group has is
    refused before the run directory is written."""
    from masters_thesis_tpu_torch.experiment import run_training

    cfg = mp.train_drive_config(str(tmp_path), mesh_model=2)
    with pytest.raises(ValueError, match="not divisible by model=2"):
        run_training(cfg, epochs=1, smoke_keys=12, device="cpu")
    cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(
        cfg.tpu, mesh_data=2, mesh_model=1))
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 ranks"):
        run_training(cfg, epochs=1, smoke_keys=12, device="cpu")
    assert not list(tmp_path.rglob("run_meta.json"))


# ---- the launcher's failures ----

TORCH_BIND_ERROR = (
    "torch.distributed.DistNetworkError: The server socket has failed to "
    "listen on any local network address. port: 29500, useIpv6: false, "
    "code: -98, name: EADDRINUSE, message: address already in use")


@pytest.mark.parametrize("text", [
    "RuntimeError: Address already in use",
    "UNAVAILABLE: failed to connect to coordinator_address localhost:1",
    "deadline exceeded while trying to connect",
    "ValueError in coordinator barrier logic: service unavailable",
    "AssertionError: coordinator state mismatch",
    "deadline config invalid",
    "Connection refused (errno 111)",
    TORCH_BIND_ERROR,
])
def test_port_race_markers_equal_the_jax_copy(text):
    assert mp._looks_like_port_race(text) == jmp._looks_like_port_race(text)


def test_port_race_markers_read_torchs_bind_error():
    assert mp._looks_like_port_race(TORCH_BIND_ERROR)
    assert not mp._looks_like_port_race(
        "RuntimeError: mesh 2x1 needs 2 ranks; the process group has 1")


def test_retries_take_races_only():
    """A race is retried on a fresh port up to the attempts; a failure
    that is not one, a child that failed for another reason beside a
    racing one, and a missing report surface at once."""
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise mp.ChildrenFailed("x", child_errors=[TORCH_BIND_ERROR])
        return {"ok": True}

    assert mp._retry_port_races(flaky, 3, "drive") == {"ok": True}
    assert len(calls) == 3
    for exc in (mp.ChildrenFailed("x", child_errors=[
                    TORCH_BIND_ERROR, "ZeroDivisionError: division by zero"]),
                mp.NoReportError("no report: connection refused"),
                RuntimeError("ValueError: bad config")):
        calls.clear()

        def fails(exc=exc):
            calls.append(1)
            raise exc

        with pytest.raises(type(exc)):
            mp._retry_port_races(fails, 3, "drive")
        assert len(calls) == 1
    calls.clear()

    def races():
        calls.append(1)
        raise RuntimeError(TORCH_BIND_ERROR)

    with pytest.raises(RuntimeError, match="after 3 attempts"):
        mp._retry_port_races(races, 3, "drive")
    assert len(calls) == 3


def test_launcher_types_a_failed_child_and_a_missing_report():
    code = ("import os, sys\n"
            "rank = int(os.environ['MTT_DIST_RANK'])\n"
            "print('rank', rank, file=sys.stderr)\n"
            "sys.exit(3 if rank == 1 else 0)\n")
    with pytest.raises(mp.ChildrenFailed) as err:
        mp._launch_children(code, 1, 2, timeout=60)
    assert err.value.child_errors == ["rank 1\n"]
    with pytest.raises(mp.NoReportError):
        mp._launch_children("print('no report')", 2, 1, timeout=60)


# ---- serving and the dry run ----

def test_caption_shard_two_cpu_replicas_gives_one_devices_words(runs,
                                                                tmp_path):
    """``caption --shard 2``: two replicas decode the halves of each batch
    (the service batch rounded up to even); greedy and beam give the words
    of one device, and sampling those of one device at the same service
    batch (8), since each replica draws the whole chunk's uniforms and keeps
    its rows, as JAX's draw over the padded, sharded batch."""
    run = runs["single"]["run_path"]
    rows = np.random.default_rng(0).standard_normal((11, 256)).astype(
        np.float32)
    one = Captioner.from_run_dir(run, device="cpu", batch_size=7)
    one8 = Captioner.from_run_dir(run, device="cpu", batch_size=8)
    two = Captioner.from_run_dir(run, device="cpu", batch_size=7, shard=2)
    assert two.batch_size == 8 and len(two.replicas) == 2
    for decoder in ("greedy", "beam", "sample"):
        want = (one8 if decoder == "sample" else one).caption_ids(rows,
                                                                  decoder)
        np.testing.assert_array_equal(two.caption_ids(rows, decoder), want)
    np.save(tmp_path / "rows.npy", rows)
    for decoder in ("greedy", "sample"):
        outs = {}
        for shard in ("0", "2"):
            out = tmp_path / f"{decoder}{shard}.txt"
            cli.main(["caption", "--run", run, "--betas",
                      str(tmp_path / "rows.npy"), "--shard", shard,
                      "--decoder", decoder, "--device", "cpu", "--out",
                      str(out)])
            outs[shard] = out.read_text()
        assert outs["2"] == outs["0"], decoder


def test_unsharded_sampling_draws_from_the_seed_and_call_alone(runs):
    """One device's sampled words are ``make_sampling_decoder``'s with a
    generator seeded by ``sample_seed(seed, call)`` on each padded chunk,
    call by call: a row window is drawn only under ``shard``."""
    run = runs["single"]["run_path"]
    rows = np.random.default_rng(1).standard_normal((11, 256)).astype(
        np.float32)
    cap = Captioner.from_run_dir(run, device="cpu", batch_size=8, seed=5,
                                 temperature=0.8)
    got = cap.caption_ids(rows, "sample")
    sample = make_sampling_decoder(cap.model, cap.max_length,
                                   temperature=0.8)
    padded = np.concatenate([rows, np.repeat(rows[-1:], 5, 0)])
    want = [sample(torch.from_numpy(padded[i:i + 8]),
                   cap.tokenizer.start_id,
                   torch.Generator().manual_seed(sample_seed(5, call)))
            for call, i in enumerate((0, 8))]
    np.testing.assert_array_equal(got, torch.cat(want).numpy()[:11])
    assert cap._sample_calls == 2


def test_shard_needs_that_many_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--shard 2 needs 2 CUDA devices; "
                                         "1 visible"):
        _replicas(torch.nn.Linear(1, 1), torch.device("cuda"), 2)


def test_dryrun_on_four_cpu_ranks(capsys):
    assert cli.main(["dryrun", "--devices", "4", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("dryrun_multichip(4): mesh={'data': 2, "
                               "'model': 2}") and lines[0].endswith("ok")
    assert "shardings=3 sharded" in lines[0]
    assert lines[1].startswith("dryrun_flagship:") and "9 sharded" in lines[1]
