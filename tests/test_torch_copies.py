"""The port's own copies of the JAX package's framework-free modules against
their originals, on the same inputs: tokenizer (with its Keras-json
persistence), pairs, the batch pipeline, the group layout (with its
``layout.npz``), the synthetic fixtures (the structured and compositional
modes too) and their key split, the caption stores and GloVe tables, caption
post-processing, the serving chunker, the HTTP server, the run-directory
logs and the TensorBoard event writer."""

import io
import json
import struct
import threading
import urllib.request

import numpy as np
import pytest
import torch

from masters_thesis_tpu.data import captions as jcaptions
from masters_thesis_tpu.data import pairs as jpairs
from masters_thesis_tpu.data import pipeline as jpipeline
from masters_thesis_tpu.data import synthetic as jsynthetic
from masters_thesis_tpu.data import tokenizer as jtokenizer
from masters_thesis_tpu.data.store import ArrayStore as JArrayStore
from masters_thesis_tpu.experiment import vocab_overlap as j_vocab_overlap
from masters_thesis_tpu.evalsuite.tokens import ids_to_caption as j_ids_to_caption
from masters_thesis_tpu.evalsuite.tokens import (
    postprocess_text as j_postprocess_text,
)
from masters_thesis_tpu.ops import group_layout as jgroup_layout
from masters_thesis_tpu.serve import padded_chunk_ids as j_padded_chunk_ids
from masters_thesis_tpu.server import make_caption_server as j_make_server
from masters_thesis_tpu.utils import logging as jlogging
from masters_thesis_tpu.utils import tensorboard as jtensorboard
from masters_thesis_tpu_torch.data import captions, pairs, pipeline, synthetic
from masters_thesis_tpu_torch.data import tokenizer
from masters_thesis_tpu_torch.data.store import ArrayStore
from masters_thesis_tpu_torch.experiment import vocab_overlap
from masters_thesis_tpu_torch.evalsuite.tokens import (
    ids_to_caption,
    postprocess_text,
)
from masters_thesis_tpu_torch.ops import group_layout
from masters_thesis_tpu_torch.serve import padded_chunk_ids
from masters_thesis_tpu_torch.server import make_caption_server
from masters_thesis_tpu_torch.utils import logging as plogging
from masters_thesis_tpu_torch.utils import tensorboard as ptensorboard

CAPTIONS = jsynthetic.synthetic_captions(range(1, 13), seed=3)
TEXTS = [jpairs.clean_caption(c) for lines in CAPTIONS.values()
         for c in lines] + ["A Zebra, unseen!  words; here.", ""]


def _fit(module, num_words):
    tok = module.Tokenizer(num_words=num_words)
    tok.fit_on_texts(TEXTS[:40])
    return tok


@pytest.mark.parametrize("num_words", [None, 12])
def test_tokenizer_matches_original(num_words):
    tok, jtok = _fit(tokenizer, num_words), _fit(jtokenizer, num_words)
    assert tok.word_index == jtok.word_index
    assert tok.texts_to_sequences(TEXTS) == jtok.texts_to_sequences(TEXTS)
    tok.install_pad()
    jtok.install_pad()
    assert tok.word_index == jtok.word_index
    assert tok.index_word == jtok.index_word
    assert tok.start_id == jtok.start_id and tok.end_id == jtok.end_id
    np.testing.assert_array_equal(
        tokenizer.pad_sequences(tok.texts_to_sequences(TEXTS), 7),
        jtokenizer.pad_sequences(jtok.texts_to_sequences(TEXTS), 7))


def test_pairs_match_original():
    keys = list(CAPTIONS)
    for single in (False, True):
        assert (pairs.create_pairs(keys, CAPTIONS, single=single)
                == jpairs.create_pairs(keys, CAPTIONS, single=single))
    tok, jtok = _fit(tokenizer, 20), _fit(jtokenizer, 20)
    raw = pairs.create_pairs(keys, CAPTIONS)
    enc, jenc = pairs.encode_pairs(raw, tok, 9), jpairs.encode_pairs(
        raw, jtok, 9)
    for field in ("keys", "tokens", "subjects"):
        np.testing.assert_array_equal(getattr(enc, field),
                                      getattr(jenc, field))
    np.testing.assert_array_equal(pairs.shift_target(enc.tokens),
                                  jpairs.shift_target(jenc.tokens))


def test_synthetic_fixtures_match_original():
    for a, b in zip(synthetic.synthetic_groups(300, 7, seed=2),
                    jsynthetic.synthetic_groups(300, 7, seed=2)):
        np.testing.assert_array_equal(a, b)
    assert (synthetic.synthetic_captions(range(5), seed=4)
            == jsynthetic.synthetic_captions(range(5), seed=4))
    split, prs, tok, betas, keys, groups = synthetic.synthetic_dataset(
        n_keys=20, n_voxels=50, n_groups=4, top_k=25, seed=1)
    jsplit, jprs, jtok, jstore, jgroups = jsynthetic.synthetic_dataset(
        n_keys=20, n_voxels=50, n_groups=4, top_k=25, seed=1)
    for field in ("train", "val", "test"):
        np.testing.assert_array_equal(getattr(split, field),
                                      getattr(jsplit, field))
    assert prs == jprs and tok.word_index == jtok.word_index
    np.testing.assert_array_equal(betas, np.asarray(jstore.data))
    np.testing.assert_array_equal(keys, jstore.keys)
    for a, b in zip(groups, jgroups):
        np.testing.assert_array_equal(a, b)


def _pipes(cls, jcls, batch_size=5, **kw):
    _, prs, tok, betas, keys, _ = synthetic.synthetic_dataset(
        n_keys=24, n_voxels=16, n_groups=2, top_k=30, seed=0)
    enc = pairs.encode_pairs(prs["train"], tok, 6)
    store = ArrayStore(betas, keys, device="cpu")
    jstore = JArrayStore(betas, keys, device_resident=True)
    return (cls(enc, store, batch_size, seed=7, prefetch=0, **kw),
            jcls(enc, jstore, batch_size, seed=7, prefetch=0, **kw))


@pytest.mark.parametrize("shuffle", [True, False])
def test_batch_pipeline_order_matches_original(shuffle):
    pipe, jpipe = _pipes(pipeline.BatchPipeline, jpipeline.BatchPipeline,
                         shuffle=shuffle)
    assert len(pipe) == len(jpipe) > 2
    np.testing.assert_array_equal(pipe.store_idx, jpipe.store_idx)
    for epoch in (0, 3):
        got, want = list(pipe.epoch(epoch)), list(jpipe.epoch(epoch))
        assert len(got) == len(want)
        for batch, jbatch in zip(got, want):
            assert batch.keys() == jbatch.keys()
            for k in batch:
                np.testing.assert_array_equal(batch[k], jbatch[k])
    # the prefetching thread hands out the same batches
    pipe.prefetch = 2
    for batch, jbatch in zip(pipe.epoch(1), jpipe.epoch(1)):
        np.testing.assert_array_equal(batch["sel"], jbatch["sel"])


def test_eval_pipeline_pads_as_original():
    pipe, jpipe = _pipes(pipeline.EvalPipeline, jpipeline.EvalPipeline,
                         batch_size=7)
    got, want = list(pipe.epoch()), list(jpipe.epoch())
    assert len(got) == len(want) and not got[-1]["valid"].all()
    for batch, jbatch in zip(got, want):
        for k in batch:
            np.testing.assert_array_equal(batch[k], jbatch[k])


def test_group_layout_matches_original():
    groups = jsynthetic.synthetic_groups(5000, 9, seed=5)
    layout = group_layout.GroupLayout(groups, 5000)
    jlayout = jgroup_layout.GroupLayout(groups, 5000)
    assert group_layout.BUCKET_LADDER == jgroup_layout.BUCKET_LADDER
    assert len(layout.buckets) == len(jlayout.buckets) >= 2
    for b, jb in zip(layout.buckets, jlayout.buckets):
        assert b.padded == jb.padded
        for field in ("group_ids", "indices", "sizes"):
            np.testing.assert_array_equal(getattr(b, field),
                                          getattr(jb, field))
    assert layout.bucket_offsets == jlayout.bucket_offsets
    assert layout.padded_total == jlayout.padded_total
    np.testing.assert_array_equal(layout.unpermute, jlayout.unpermute)
    np.testing.assert_array_equal(layout.flat_indices(),
                                  jlayout.flat_indices())
    rows = np.random.default_rng(0).standard_normal((3, 5000))
    np.testing.assert_array_equal(layout.permute_rows(rows),
                                  jlayout.permute_rows(rows))


def test_ids_to_caption_matches_original():
    tok = _fit(jtokenizer, None)
    tok.install_pad()
    rows = [[tok.start_id, 5, 0, 6, tok.end_id, 7], [0, 0], [9999, 4],
            [], np.asarray([[3, 4], [tok.end_id, 5]])]
    for ids in rows:
        assert ids_to_caption(ids, tok) == j_ids_to_caption(ids, tok)


@pytest.mark.parametrize("n", [0, 1, 4, 7])
def test_padded_chunk_ids_matches_original(n):
    """The empty request, one row, a full chunk and a ragged last chunk."""
    seen, jseen = [], []

    def run(log):
        def run_chunk(chunk):
            log.append(chunk.copy())
            return chunk[:, :3, 0].astype(np.int32)
        return run_chunk

    rows = np.random.default_rng(n).standard_normal((n, 3, 5)).astype(
        np.float32)
    got = padded_chunk_ids(rows, 4, 3, 5, run(seen))
    want = j_padded_chunk_ids(rows, 4, 3, 5, run(jseen))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (n, 3)
    assert len(seen) == len(jseen)
    for a, b in zip(seen, jseen):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="input width"):
        padded_chunk_ids(rows[..., :4], 4, 3, 5, run([]))


class _Echo:
    """A captioner whose caption of a row is the rounded mean of it."""
    input_width = 6
    input_row_shape = (2, 6)

    def caption(self, rows, decoder="greedy"):
        return [f"{decoder} {float(np.round(r.mean(), 4))}" for r in rows]


def _talk(server, rows):
    host, port = server.server_address[:2]
    base = f"http://{host}:{port}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        out = []
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
            out.append(json.loads(resp.read().decode()))
        buf = io.BytesIO()
        np.save(buf, rows)
        for body, kind in ((buf.getvalue(), "application/octet-stream"),
                           (json.dumps({"betas": rows[0].tolist()}).encode(),
                            "application/json")):
            req = urllib.request.Request(
                f"{base}/caption", data=body, method="POST",
                headers={"Content-Type": kind})
            with urllib.request.urlopen(req, timeout=30) as resp:
                reply = json.loads(resp.read().decode())
            out.append((reply["captions"], reply["decoder"]))
        req = urllib.request.Request(
            f"{base}/caption", data=b"[1, 2]", method="POST",
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        out.append(err.value.code)
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as resp:
            stats = json.loads(resp.read().decode())
        out.append({k: stats[k] for k in ("requests", "rows")})
        return out
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        thread.join(timeout=10)


def test_caption_server_matches_original():
    """Both servers answer the same requests alike: health, a .npy batch,
    a JSON single row, a malformed body (400) and the counters."""
    rows = np.random.default_rng(0).standard_normal((3, 2, 6)).astype(
        np.float32)
    got = _talk(make_caption_server(_Echo(), port=0, max_wait_s=0.0), rows)
    want = _talk(j_make_server(_Echo(), port=0, max_wait_s=0.0), rows)
    assert got == want
    assert got[1][0] == _Echo().caption(rows) and got[3] == 400


def test_caption_server_serves_the_port_captioner_like_original():
    """The port's Captioner (LcNIC, CPU) behind both servers: the same
    captions, equal to ``Captioner.caption``."""
    from masters_thesis_tpu_torch.models.nic import LcNIC
    from masters_thesis_tpu_torch.serve import Captioner

    layout = group_layout.GroupLayout(
        synthetic.synthetic_groups(64, 4, seed=0), 64)
    tok = _fit(tokenizer, None)
    tok.install_pad()
    model = LcNIC(layout, units=8, group_size=4, embedding_text=8,
                  attn_units=4, vocab_size=len(tok.word_index) + 1,
                  max_length=4, generator=torch.Generator().manual_seed(0))
    cap = Captioner(model, tok, 8, 4, batch_size=2, device="cpu")
    rows = np.random.default_rng(1).standard_normal((3, 64)).astype(
        np.float32)
    got = _talk(make_caption_server(cap, port=0, max_wait_s=0.0), rows)
    want = _talk(j_make_server(cap, port=0, max_wait_s=0.0), rows)
    assert got == want
    assert got[1][0] == cap.caption(rows)


def test_tokenizer_persistence_and_texts_match_original(tmp_path):
    """``to_json``/``save``/``load`` and ``sequences_to_texts``: each
    package reads the other's tokenizer.json to the same vocabulary."""
    tok, jtok = _fit(tokenizer, 12), _fit(jtokenizer, 12)
    tok.install_pad()
    jtok.install_pad()
    assert tok.to_json() == jtok.to_json()
    tok.save(tmp_path / "port.json")
    jtok.save(tmp_path / "jax.json")
    for a, b in ((tokenizer.Tokenizer.load(tmp_path / "jax.json"), jtok),
                 (jtokenizer.Tokenizer.load(tmp_path / "port.json"), tok)):
        assert a.word_index == b.word_index
        assert a.index_word == b.index_word
        assert a.word_counts == b.word_counts
    seqs = [[tok.start_id, 3, 11, 12, 40, 0], [], np.asarray([5, 6])]
    assert tok.sequences_to_texts(seqs) == jtok.sequences_to_texts(seqs)


@pytest.mark.parametrize("mode", ["structured", "compositional"])
def test_structured_synthetic_dataset_matches_original(mode):
    """The structured and compositional modes: betas, pairs, tokenizer and
    groups, exactly; and the factor helpers alone."""
    split, prs, tok, betas, keys, groups = synthetic.synthetic_dataset(
        n_keys=30, n_voxels=64, n_groups=4, top_k=40, seed=2,
        structured=mode)
    jsplit, jprs, jtok, jstore, jgroups = jsynthetic.synthetic_dataset(
        n_keys=30, n_voxels=64, n_groups=4, top_k=40, seed=2,
        structured=mode)
    for field in ("train", "val", "test"):
        np.testing.assert_array_equal(getattr(split, field),
                                      getattr(jsplit, field))
    assert prs == jprs and tok.word_index == jtok.word_index
    np.testing.assert_array_equal(betas, np.asarray(jstore.data))
    np.testing.assert_array_equal(keys, jstore.keys)
    for a, b in zip(groups, jgroups):
        np.testing.assert_array_equal(a, b)
    for holdout in (None, "seen", "unseen"):
        f = synthetic.synthetic_factors(keys, seed=4, holdout=holdout)
        np.testing.assert_array_equal(
            f, jsynthetic.synthetic_factors(keys, seed=4, holdout=holdout))
        np.testing.assert_array_equal(synthetic.combo_held_out(f),
                                      jsynthetic.combo_held_out(f))
    assert (synthetic.structured_captions(keys, f, n_caps=3)
            == jsynthetic.structured_captions(keys, f, n_caps=3))
    np.testing.assert_array_equal(
        synthetic.structured_betas(f, 16, seed=1, ambiguity=0.3),
        jsynthetic.structured_betas(f, 16, seed=1, ambiguity=0.3))


def test_group_layout_persistence_matches_original(tmp_path):
    """``layout.npz`` either package wrote loads in the other to the same
    groups, which ``to_groups`` gives back in their original order."""
    groups = jsynthetic.synthetic_groups(3000, 11, seed=6)
    layout = group_layout.GroupLayout(groups, 3000)
    jlayout = jgroup_layout.GroupLayout(groups, 3000)
    layout.save(tmp_path / "port.npz")
    jlayout.save(tmp_path / "jax.npz")
    for a, b in ((group_layout.GroupLayout.load(tmp_path / "jax.npz"),
                  jlayout),
                 (jgroup_layout.GroupLayout.load(tmp_path / "port.npz"),
                  layout)):
        assert a.n_voxels == b.n_voxels
        for ga, gb in zip(a.to_groups(), b.to_groups(), strict=True):
            np.testing.assert_array_equal(ga, gb)
    for ga, gb in zip(layout.to_groups(), groups, strict=True):
        np.testing.assert_array_equal(ga, gb)


def test_postprocess_text_matches_original():
    for text in ("a dog <end> runs", "<start> a <pad> cat", "", "<end>",
                 "no end here"):
        assert postprocess_text(text) == j_postprocess_text(text)


def _masked_jsonl(path):
    rows = [json.loads(line) for line in open(path)]
    for row in rows:
        row["ts"] = None
    return rows


def test_run_logs_match_original(tmp_path):
    """``setup_run_dir`` (its config snapshot aside), ``CSVLogger`` and
    ``MetricLogger`` write the same lines, timestamps masked."""
    for module, name in ((plogging, "port"), (jlogging, "jax")):
        run = module.setup_run_dir(str(tmp_path / name), "r", None,
                                   file_log=False)
        csv = module.CSVLogger(f"{run}/h.csv", ["epoch", "loss", "x"])
        csv.write({"epoch": 0, "loss": "0.500000", "y": 3})
        csv.write({"loss": 1.25})
        csv.close()
        csv = module.CSVLogger(f"{run}/h.csv", ["epoch", "loss", "x"])
        csv.write({"epoch": 2})     # appends, no second header
        csv.close()
        log = module.MetricLogger(f"{run}/m.jsonl")
        log.log("epoch", epoch=1, loss=np.float32(0.25), steps=3,
                note="text", val=torch.tensor(2.5))
        log.log("caption_metrics", epoch=0, val_bleu4=0.5, n_captions=7)
        log.close()
    port, jax_ = tmp_path / "port" / "r", tmp_path / "jax" / "r"
    assert (port / "h.csv").read_text() == (jax_ / "h.csv").read_text()
    assert _masked_jsonl(port / "m.jsonl") == _masked_jsonl(jax_ / "m.jsonl")


def _payloads(path):
    """The event file's record payloads, each record's length and payload
    crc checked."""
    import struct

    data = path.read_bytes()
    out, i = [], 0
    while i < len(data):
        (n,) = struct.unpack("<Q", data[i:i + 8])
        (crc,) = struct.unpack("<I", data[i + 8:i + 12])
        assert crc == jtensorboard._masked_crc(data[i:i + 8])
        payload = data[i + 12:i + 12 + n]
        (crc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        assert crc == jtensorboard._masked_crc(payload)
        out.append(payload)
        i += 16 + n
    return out


def _fields(buf):
    """(field number, raw value) pairs of one protobuf message."""
    out, i = [], 0
    while i < len(buf):
        key, i = _varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            start = i
            _, i = _varint(buf, i)
            out.append((num, buf[start:i]))
            continue
        n, i = ((8, i) if wire == 1 else (4, i) if wire == 5
                else _varint(buf, i))
        out.append((num, buf[i:i + n]))
        i += n
    return out


def _varint(buf, i):
    shift = value = 0
    while True:
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, i


def _unwrapped(payload):
    """An event payload with its wall time (the leading double) cut off and
    its summary's ``value`` wrappers taken away: the layout the JAX writer
    puts its values in, straight into the summary field."""
    assert payload[:1] == b"\x09"             # field 1, 64-bit: wall time
    rest = payload[9:]
    out = b""
    for num, raw in _fields(rest):
        if num != 5:
            out += _field_bytes(num, raw)
            continue
        values = _fields(raw)
        assert [n for n, _ in values] == [1] * len(values)
        inner = b"".join(v for _, v in values)
        out += jtensorboard._bytes_field(5, inner)
    return out


def _field_bytes(num, raw):
    """A field of number ``num`` re-encoded from its raw value: a varint's
    bytes, or a length-delimited payload."""
    if num == 2:                                # Event.step, a varint
        return jtensorboard._field(2, 0) + raw
    return jtensorboard._bytes_field(num, raw)


def _jax_records(path):
    """The JAX writer's records with their wall times cut off."""
    out = []
    for payload in _payloads(path):
        assert payload[:1] == b"\x09"
        out.append(payload[9:])
    return out


def _write_events(module, logdir, img):
    w = module.EventWriter(str(logdir), filename_suffix=".x")
    w.scalar("loss", 0.5, 3)
    w.scalars({"a": 1.0, "b": np.float32(2.5)}, 4, prefix="epoch/")
    w.scalars({}, 5)
    w.text("preview", "a dog", 6)
    w.image("captions/sample_0", module.encode_png(img), 5, 7, 7)
    w.close()
    (path,) = logdir.glob("events.out.tfevents.*.x")
    return path


def test_event_writer_matches_original(tmp_path):
    """``EventWriter`` (scalars, text, an image) and ``encode_png`` against
    the originals. ``encode_png`` is byte for byte the same. The port wraps
    each value in the summary's ``value`` field, where the JAX writer puts
    the value's fields straight into the summary, which TensorBoard's
    parser refuses: TensorBoard's own ``Event`` reads every record of the
    port's file to the tags, steps and values the JAX writer meant."""
    event_pb2 = pytest.importorskip("tensorboard.compat.proto.event_pb2")
    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3),
                                            dtype=np.uint8)
    png = jtensorboard.encode_png(img)
    assert ptensorboard.encode_png(img) == png
    port = _write_events(ptensorboard, tmp_path / "port", img)
    _write_events(jtensorboard, tmp_path / "jax", img)
    events = [event_pb2.Event.FromString(p) for p in _payloads(port)]
    assert len(events) == 5
    assert events[0].file_version == "brain.Event:2"
    got = [(e.step, [(v.tag, v.WhichOneof("value")) for v in e.summary.value])
           for e in events[1:]]
    assert got == [(3, [("loss", "simple_value")]),
                   (4, [("epoch/a", "simple_value"),
                        ("epoch/b", "simple_value")]),
                   (6, [("preview", "tensor")]),
                   (7, [("captions/sample_0", "image")])]
    assert [v.simple_value for e in events[1:3] for v in e.summary.value] \
        == [0.5, 1.0, 2.5]
    (text,) = events[3].summary.value
    assert text.tensor.dtype == 7 and text.tensor.string_val == [b"a dog"]
    assert text.metadata.plugin_data.plugin_name == "text"
    (image,) = events[4].summary.value
    assert (image.image.height, image.image.width, image.image.colorspace,
            image.image.encoded_image_string) == (5, 7, 3, png)
    # render_caption_image is the port's own (a bitmap font, not
    # matplotlib): like the original it returns a PNG and its own size
    for module in (ptensorboard, jtensorboard):
        png, h, w = module.render_caption_image(img, "a caption")
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        assert struct.unpack(">II", png[16:24]) == (w, h)


def test_event_records_unwrap_to_the_original_bytes(tmp_path):
    """Without the ``value`` wrappers, the port's records are the JAX
    writer's, byte for byte with the wall times cut off."""
    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3),
                                            dtype=np.uint8)
    port = _write_events(ptensorboard, tmp_path / "port", img)
    jax_ = _write_events(jtensorboard, tmp_path / "jax", img)
    assert [_unwrapped(p) for p in _payloads(port)] == _jax_records(jax_)


def _caption_dir(tmp_path):
    """The fixtures of tests/test_captions_and_variants.py in one
    directory, with a session-ingest line (``path#i\tcaption``)."""
    d = tmp_path / "caps"
    d.mkdir()
    (d / "subj02_KID7.txt").write_text("a dog.\nthe dog runs.\n")
    (d / "subj02_KID9.txt").write_text("a cat.\n")
    (d / "KID3.txt").write_text("b/KID3.npy#0\ta cat\n\n")
    (d / "KID3.txt~").write_text("STALE BACKUP\n")
    (d / "KID4.png").write_bytes(b"\x89PNG\x00not-text")
    (d / "KID5").mkdir()
    return d


@pytest.mark.parametrize("keys", [None, [9], [3, 7, 11]])
def test_caption_dir_and_annotations_match_original(tmp_path, keys):
    d = _caption_dir(tmp_path)
    caps = captions.load_captions_dir(str(d), keys=keys)
    assert caps == jcaptions.load_captions_dir(str(d), keys=keys)
    captions.save_annotations_json(str(tmp_path / "a.json"), caps)
    jcaptions.save_annotations_json(str(tmp_path / "j.json"), caps)
    assert ((tmp_path / "a.json").read_text()
            == (tmp_path / "j.json").read_text())
    assert (captions.load_annotations_json(str(tmp_path / "j.json"))
            == jcaptions.load_annotations_json(str(tmp_path / "a.json"))
            == caps)


def test_glove_table_matches_original(tmp_path):
    """A GloVe text file with in-vocab, out-of-vocab, wrong-width and
    <start>/<end> lines, against each package's tokenizer; then a file whose
    vectors all have another width, which both refuse alike."""
    texts = ["<start> dog cat bird <end>", "<start> dog fish <end>"]
    tok, jtok = _fit_texts(tokenizer, texts), _fit_texts(jtokenizer, texts)
    g = tmp_path / "glove.txt"
    g.write_text("dog 1.0 2.0 3.0 4.0\ncat 5.0 6.0 7.0 8.0\n"
                 "zebra 9 9 9 9\nbird 1 2 3\n<end> 7 7 7 7\n")
    table = captions.build_glove_table(str(g), tok, dim=4)
    want = jcaptions.build_glove_table(str(g), jtok, dim=4)
    assert table.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(table, want)
    assert table[tok.word_index["dog"]].tolist() == [1, 2, 3, 4]
    assert table[tok.end_id].tolist() == [0, 0, 0, 1]
    errors = []
    for module, t in ((captions, tok), (jcaptions, jtok)):
        with pytest.raises(ValueError) as err:
            module.build_glove_table(str(g), t, dim=5)
        errors.append(str(err.value))
    assert errors[0] == errors[1] and "4-d" in errors[0]


def _fit_texts(module, texts):
    tok = module.Tokenizer(num_words=10)
    tok.fit_on_texts(texts)
    tok.install_pad()
    return tok


# the two tokenizers' texts: the JAX test's (tests/test_captions_and_variants
# .py:89-98), and the cleaned captions of two disjoint synthetic key sets
# (34 and 30 words, 28 shared; at top_k 5 the cut falls among equal counts)
OVERLAP_TEXTS = {
    "jax test": (["a a a b b c"], ["b c c d"]),
    "disjoint synthetic": tuple(
        [jpairs.clean_caption(c) for lines in
         jsynthetic.synthetic_captions(keys, seed=seed).values()
         for c in lines]
        for keys, seed in ((range(0, 2), 5), (range(2, 4), 6))),
}


@pytest.mark.parametrize("top_k", [2, 5, 50, 5000])
@pytest.mark.parametrize("texts", sorted(OVERLAP_TEXTS))
def test_vocab_overlap_matches_original(texts, top_k):
    """The same dict from each package's tokenizers, fitted to the same
    texts, at a cut inside, near and past the vocabularies."""
    got, want = ({}, {})
    for module, fn, out in ((tokenizer, vocab_overlap, got),
                            (jtokenizer, j_vocab_overlap, want)):
        toks = []
        for part in OVERLAP_TEXTS[texts]:
            tok = module.Tokenizer(num_words=10)
            tok.fit_on_texts(part)
            toks.append(tok)
        out.update(fn(*toks, top_k=top_k))
    assert got == want
    assert 0 < want["total"] <= top_k
