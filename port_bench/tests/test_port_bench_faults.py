"""Each fault a cell can have, planted under the timed path of a whole run
at a tiny size on the CPU, makes ``correct`` come out false: a step that
returns its state unchanged, half of the batch left out (the mean taken
over the rest), a word altered where it is produced. No cell has an
exchange between chips to leave out."""

from unittest import mock

import pytest
import torch

from port_bench.tests import tiny

TRAIN = [tiny.QUEUED["workload"]["name"]]
DECODE = ["lcnic_eval_greedy", "cnnrnn_eval_greedy"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("tiny"))


def unchanged(program):
    """The train step returns its state as it got it."""
    def broken(state, *args):
        params = [p.detach().clone() for p in state.model.parameters()]
        moments = [m.clone() for m in state.tx.mu + state.tx.nu]
        count, step = state.tx.count, state.step
        state, metrics = program(state, *args)
        with torch.no_grad():
            for p, saved in zip(state.model.parameters(), params):
                p.copy_(saved)
            for m, saved in zip(state.tx.mu + state.tx.nu, moments):
                m.copy_(saved)
        state.tx.count, state.step = count, step
        return state, metrics
    return broken


def half_train_batch(program):
    def broken(state, store, idx, tokens, target, pair_idx):
        return program(state, store, idx, tokens, target,
                       pair_idx[:, :pair_idx.shape[1] // 2])
    return broken


def word_altered(decode):
    """At the decode's second step the runner-up word comes out of the head
    in the best one's place and is fed back, as a kernel whose argmax or
    head went wrong would produce it (the plain decode loop's head
    wrapped)."""
    from masters_thesis_tpu_torch.ops import fused_decode

    product = fused_decode._product

    def demoted(w, wide):
        head = product(w, wide)
        calls["product"] += 1
        if calls["product"] % 2:             # h Wi: the hidden layer
            return head

        def logits(x):                       # hi Wo: the vocabulary
            out = head(x)
            calls["step"] += 1
            if calls["step"] == 2:
                top = torch.topk(out, 2, dim=-1)
                out = out.scatter(-1, top.indices[..., :1],
                                  top.values[..., 1:] - 1.0)
            return out
        return logits

    calls = {}

    def broken(betas, start_id):
        calls.update(product=0, step=0)
        with mock.patch.object(fused_decode, "_product", demoted):
            return decode(betas, start_id)
    return broken


def half_decode_batch(decode):
    def broken(betas, start_id):
        words, alphas = decode(betas[:betas.shape[0] // 2], start_id)
        pad = betas.shape[0] - words.shape[0]
        return (torch.cat([words, torch.zeros_like(words[:pad])]),
                torch.cat([alphas, torch.zeros_like(alphas[:pad])]))
    return broken


def decode_unchanged(decode):
    """Every step's state is the first step's: its word and alphas."""
    def broken(betas, start_id):
        words, alphas = decode(betas, start_id)
        return (words[:, :1].expand_as(words).contiguous(),
                alphas[:, :1].expand_as(alphas).contiguous())
    return broken


@pytest.mark.parametrize("cell,fault", [(c, f) for c in TRAIN for f in (
    unchanged, half_train_batch)] + [(c, f) for c in DECODE for f in (
        word_altered, half_decode_batch, decode_unchanged)],
    ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_fault_is_not_correct(root, cell, fault):
    assert tiny.run(root, cell)["correct"] is True
    result = tiny.run(root, cell, hook=fault)
    assert result["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in result["checks"].values())
