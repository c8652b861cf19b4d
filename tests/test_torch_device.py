"""The port's entry points run on the card unless the caller asks for the
CPU: ``serve.Captioner``, ``train.state.init_model`` and
``data.store.ArrayStore`` take ``device=None`` as ``cuda``. Without a card
they raise, naming ``device='cpu'``; with it they run on the CPU. Whether a
card is present is decided inside each test, never at import."""

import numpy as np
import pytest
import torch

from masters_thesis_tpu_torch.config import Config
from masters_thesis_tpu_torch.data.store import ArrayStore
from masters_thesis_tpu_torch.data.synthetic import synthetic_groups
from masters_thesis_tpu_torch.data.tokenizer import Tokenizer
from masters_thesis_tpu_torch.device import resolve_device
from masters_thesis_tpu_torch.models.nic import CnnRnnNIC
from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.serve import Captioner
from masters_thesis_tpu_torch.train.state import init_model

from torch_threads import one_thread  # noqa: F401

CFG = dict(batch_size=4, max_length=4, top_k=19, units=8, attn_units=4,
           group_size=4, embedding_text=8)


@pytest.fixture
def no_card(monkeypatch):
    """A machine without a usable card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _captioner(**kw):
    tok = Tokenizer(num_words=20)
    tok.fit_on_texts(["<start> a b <end>"])
    tok.install_pad()
    model = CnnRnnNIC(embed_dim=8, units=8, vocab_size=20, max_length=4,
                      n_patches=3, in_channels=5,
                      generator=torch.Generator().manual_seed(0))
    return Captioner(model, tok, 8, 4, batch_size=2, **kw)


def _layout():
    return GroupLayout(synthetic_groups(64, 4, seed=0), 64)


@pytest.mark.parametrize("make", ["captioner", "init_model", "store"])
def test_entry_points_default_to_cuda_and_raise_without_a_card(no_card,
                                                               make):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if make == "captioner":
            _captioner()
        elif make == "init_model":
            init_model(Config(**CFG), _layout())
        else:
            ArrayStore(np.zeros((2, 3), np.float32), [1, 2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")


def test_entry_points_run_on_the_cpu_when_asked(no_card):
    cap = _captioner(device="cpu")
    assert cap.device == torch.device("cpu")
    assert next(cap.model.parameters()).device.type == "cpu"
    ids = cap.caption_ids(np.zeros((3, 3, 5), np.float32))
    assert ids.shape == (3, 4)
    state = init_model(Config(**CFG), _layout(), device="cpu")
    assert next(state.model.parameters()).device.type == "cpu"
    store = ArrayStore(np.zeros((2, 3), np.float32), [1, 2], device="cpu")
    assert store.device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")
