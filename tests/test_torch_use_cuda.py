"""The USE-DAN sentence encoder on the card (``models/use_encoder.py``).

At the class's full width (embed 512, hidden 512 x 3, out 512) over a
50,000-token vocabulary and 256 OOV buckets, the card's vectors are held
within 1e-5 of the CPU forward on the same weights (TF32 off: the MLP's
GEMMs in fp32 on both sides), and the chunked ``embed`` (64 rows a device
call) within 1e-5 of one call over all 512 sentences. Each needs an
NVIDIA GPU and skips without one.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_use_cuda.py
"""

import numpy as np
import pytest
import torch

from masters_thesis_tpu_torch.models.use_encoder import (
    USEEncoder,
    init_use_params,
)

pytestmark = pytest.mark.cuda

TOL = 1e-5
VOCAB_SIZE, OOV = 50_000, 256
HIDDEN = (512, 512, 512)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the encoder runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def bundle():
    vocab = [f"w{i}" for i in range(VOCAB_SIZE)]
    params = init_use_params(VOCAB_SIZE, oov_buckets=OOV, embed_dim=512,
                             hidden=HIDDEN, out_dim=512, seed=0)
    rng = np.random.default_rng(0)
    sentences = []
    for _ in range(512):
        n = int(rng.integers(0, 80))
        sentences.append(" ".join(
            f"w{int(i)}" if rng.random() < 0.9 else f"oov{int(i)}"
            for i in rng.integers(0, VOCAB_SIZE, n)))
    return vocab, params, sentences


def _encoder(bundle, device):
    vocab, params, _ = bundle
    return USEEncoder(vocab, params, OOV, HIDDEN, 512, 512, device=device)


def test_card_vectors_match_the_cpu_forward(cuda, bundle):
    sentences = bundle[2]
    got = _encoder(bundle, cuda).embed(sentences)
    want = _encoder(bundle, "cpu").embed(sentences)
    err = float(np.abs(got - want).max())
    print(f"USE-DAN card vs CPU on {len(sentences)} sentences: {err:.2e}")
    assert err <= TOL, err


def test_chunked_embed_matches_one_call_on_the_card(cuda, bundle):
    sentences = bundle[2]
    enc = _encoder(bundle, cuda)
    whole = enc.embed(sentences, chunk=len(sentences))
    chunked = enc.embed(sentences, chunk=64)
    err = float(np.abs(chunked - whole).max())
    print(f"USE-DAN chunks of 64 vs one call on the card: {err:.2e}")
    assert err <= TOL, err
