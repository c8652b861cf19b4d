"""The port's own copies of the JAX package's framework-free modules against
their originals, on the same inputs: tokenizer, pairs, the batch pipeline,
the group layout, the synthetic fixtures and their key split, caption
post-processing, the serving chunker and the HTTP server."""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from masters_thesis_tpu.data import pairs as jpairs
from masters_thesis_tpu.data import pipeline as jpipeline
from masters_thesis_tpu.data import synthetic as jsynthetic
from masters_thesis_tpu.data import tokenizer as jtokenizer
from masters_thesis_tpu.data.store import ArrayStore as JArrayStore
from masters_thesis_tpu.evalsuite.tokens import ids_to_caption as j_ids_to_caption
from masters_thesis_tpu.ops import group_layout as jgroup_layout
from masters_thesis_tpu.serve import padded_chunk_ids as j_padded_chunk_ids
from masters_thesis_tpu.server import make_caption_server as j_make_server
from masters_thesis_tpu_torch.data import pairs, pipeline, synthetic
from masters_thesis_tpu_torch.data import tokenizer
from masters_thesis_tpu_torch.data.store import ArrayStore
from masters_thesis_tpu_torch.evalsuite.tokens import ids_to_caption
from masters_thesis_tpu_torch.ops import group_layout
from masters_thesis_tpu_torch.serve import padded_chunk_ids
from masters_thesis_tpu_torch.server import make_caption_server

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
