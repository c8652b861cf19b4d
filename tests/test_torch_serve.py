"""The port's Captioner against the JAX package's Captioner on the same
weights and inputs, and the port's HTTP server (its copy of the JAX
package's) driving the port's Captioner on the CPU."""

import io
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from masters_thesis_tpu.data.pairs import clean_caption
from masters_thesis_tpu.data.synthetic import synthetic_captions, synthetic_groups
from masters_thesis_tpu.data.tokenizer import Tokenizer
from masters_thesis_tpu.models.nic import LcNIC as JLcNIC
from masters_thesis_tpu.ops.group_layout import GroupLayout
from masters_thesis_tpu.serve import Captioner as JCaptioner
from masters_thesis_tpu_torch.models.nic import LcNIC
from masters_thesis_tpu_torch.serve import Captioner
from masters_thesis_tpu_torch.server import make_caption_server

N_VOXELS, UNITS, T, BATCH = 128, 16, 6, 4
KW = dict(units=UNITS, group_size=4, embedding_text=8, attn_units=8,
          vocab_size=40, max_length=T)


@pytest.fixture(scope="module")
def setup():
    layout = GroupLayout(synthetic_groups(N_VOXELS, 5), N_VOXELS)
    caps = synthetic_captions(range(8))
    tok = Tokenizer(num_words=40)
    tok.fit_on_texts([clean_caption(c) for lines in caps.values()
                      for c in lines])
    tok.install_pad()
    jmodel = JLcNIC(layout=layout, **KW)
    rng = np.random.default_rng(0)
    betas = rng.standard_normal((7, N_VOXELS)).astype(np.float32)
    a0 = np.zeros((1, UNITS), np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), betas[:1], np.zeros((1, T), np.int32), a0, a0))
    p = variables["params"]
    p["embedding"] = p["embedding"] * 10.0   # words vary along the caption
    p["dense_out"]["kernel"] = rng.normal(0, 0.5, (256, 40)).astype(
        np.float32)
    bn = variables["batch_stats"]["encoder"]["input_bn"]
    bn["mean"] = rng.normal(0, 0.5, 4).astype(np.float32)
    bn["var"] = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    jcap = JCaptioner.from_components(
        jmodel, variables["params"], variables["batch_stats"], tok, UNITS, T,
        batch_size=BATCH)

    def port(**kw):
        kw.setdefault("device", "cpu")
        return Captioner.from_components(
            LcNIC(layout, **KW), variables["params"],
            variables["batch_stats"], tok, UNITS, T, batch_size=BATCH, **kw)

    return jcap, port, betas


@pytest.mark.parametrize("n", [0, 1, 7])
def test_caption_ids_match_jax_captioner(setup, n):
    """n = 7 with a service batch of 4 runs the last-chunk padding path."""
    jcap, port, betas = setup
    want = jcap.caption_ids(betas[:n])
    for cap in (port(), port(use_fused=False)):
        got = cap.caption_ids(betas[:n])
        assert got.shape == (n, T)
        np.testing.assert_array_equal(got, want)
    if n:
        assert port().caption(betas[:n]) == jcap.caption(betas[:n])


def test_wrong_width_and_unported_decoders_raise(setup):
    _, port, betas = setup
    cap = port()
    assert cap.input_width == N_VOXELS
    with pytest.raises(ValueError, match="input width"):
        cap.caption_ids(betas[:, :-1])
    for decoder in ("beam", "sample"):
        with pytest.raises(NotImplementedError, match="M9"):
            cap.caption_ids(betas, decoder=decoder)
    with pytest.raises(ValueError, match="unknown decoder"):
        cap.caption_ids(betas, decoder="magic")


def _post(url, body, content_type):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read().decode())


def test_http_server_serves_the_port_captioner(setup):
    _, port, betas = setup
    cap = port(device=torch.device("cpu"))
    expected = cap.caption(betas)
    server = make_caption_server(cap, port=0, max_wait_s=0.0)
    host, bound = server.server_address[:2]
    base = f"http://{host}:{bound}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
            health = json.loads(resp.read().decode())
        assert health["status"] == "ok" and health["n_voxels"] == N_VOXELS

        buf = io.BytesIO()
        np.save(buf, betas[:3])
        st, out = _post(f"{base}/caption", buf.getvalue(),
                        "application/octet-stream")
        assert st == 200 and out["captions"] == expected[:3]

        body = json.dumps({"betas": betas[3:].tolist()}).encode()
        st, out = _post(f"{base}/caption", body, "application/json")
        assert st == 200 and out["captions"] == expected[3:]
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
