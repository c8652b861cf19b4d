"""Train and eval steps of the LcNIC family, in PyTorch.

Counterpart of ``masters_thesis_tpu/train/steps.py``. A train step runs the
training forward (dropout, BatchNorm batch statistics), the loss, the
backward and the optimizer, in place on ``state``; SAM (``cfg.sam_rho`` > 0,
lc_NIC.py:713-838) is its two-pass variant. Every step returns the metrics
``loss``, ``L2``, ``attention``, ``accuracy``, ``total`` and ``grad_norm``
(the global norm of the raw gradients) as 0-dim tensors on the device.
With ``cfg.tpu.fused_seq`` on, a model that ``ops.fused_seq`` supports
trains its decoder through the fused sequence's custom backward
(``make_train_forward_loss``); any other model takes autograd of its
forward.

"Scanned" steps run K steps inside one call as a Python loop: each step
indexes the device-resident tables with its row of the (K, B) pair ids,
gathers the betas from the store through K1 (``ops.gather.gather_rows``),
and the metrics come back stacked (K,) and still on the device, so the host
never waits on a step. A CUDA graph of the step is later work (ROADMAP
M17).

The JAX package's ``model`` argument has no counterpart: the model lives in
the state.
"""

from __future__ import annotations

import torch

from masters_thesis_tpu_torch.ops.fused_seq import (
    fused_train_supported,
    make_train_forward_loss,
)
from masters_thesis_tpu_torch.ops.gather import gather_rows
from masters_thesis_tpu_torch.train.losses import (
    accuracy,
    attention_loss,
    caption_loss,
    l2_loss,
)


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: the norm of all ``tensors`` as one vector."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


def _forward_loss(model, cfg, l2_rules, betas, tokens, target, mask,
                  generator):
    """Training forward and loss -> (total, metrics). The compute is fp32: a
    bf16 store's rows are widened here, as JAX promotes them against fp32
    parameters."""
    betas = betas.float()
    a0 = torch.zeros(betas.shape[0], cfg.units, device=betas.device)
    logits, alphas = model(betas, tokens.long(), a0, a0, training=True,
                           generator=generator)
    cce = caption_loss(logits, target, mask)
    l2 = l2_loss(model, l2_rules)
    attn = attention_loss(alphas)
    total = cce + l2
    if cfg.attn_loss:
        total = total + attn
    metrics = {"loss": cce.detach(), "L2": l2.detach(),
               "attention": attn.detach(),
               "accuracy": accuracy(logits.detach(), target, mask)}
    return total, metrics


def _step_body(cfg, l2_rules, masked: bool):
    """``one(state, betas, tokens, target) -> (state, metrics)``: one
    optimisation step, SAM's two passes when ``cfg.sam_rho`` > 0."""
    routes = {}     # model -> its forward and loss, built on first use

    def forward_loss(model):
        if model not in routes:
            if cfg.tpu.fused_seq and fused_train_supported(model, cfg):
                routes[model] = make_train_forward_loss(model, cfg, l2_rules)
            else:
                routes[model] = lambda *batch, key: _forward_loss(
                    model, cfg, l2_rules, *batch)
        return routes[model]

    def loss_and_grads(state, params, betas, tokens, target, mask):
        total, metrics = forward_loss(state.model)(
            betas, tokens, target, mask, state.dropout_generator(),
            key=state.dropout_key())
        return total, metrics, torch.autograd.grad(total, params)

    def one(state, betas, tokens, target):
        model = state.model
        params = list(model.parameters())
        mask = (target != 0) if masked else None
        batch = (betas, tokens, target, mask)
        if cfg.sam_rho > 0:
            # perturb by rho * g / ||g||, take the gradient there with the
            # same dropout masks and from the same BatchNorm statistics,
            # then apply it to the unperturbed parameters
            stats = [b for b in model.buffers() if b.is_floating_point()]
            saved_stats = [b.clone() for b in stats]
            _, _, g1 = loss_and_grads(state, params, *batch)
            scale = cfg.sam_rho / (global_norm(g1) + 1e-12)
            saved = [p.detach().clone() for p in params]
            with torch.no_grad():
                for p, g in zip(params, g1):
                    p.add_(g * scale)
                for b, s in zip(stats, saved_stats):
                    b.copy_(s)
            total, metrics, grads = loss_and_grads(state, params, *batch)
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
        else:
            total, metrics, grads = loss_and_grads(state, params, *batch)
        metrics["total"] = total.detach()
        metrics["grad_norm"] = global_norm(grads)
        state.tx.step(grads)
        state.step += 1
        return state, metrics

    return one


def make_train_step(cfg, l2_rules, masked: bool = False):
    """``step(state, betas, tokens, target) -> (state, metrics)``."""
    return _step_body(cfg, l2_rules, masked)


def make_gathered_train_step(cfg, l2_rules, masked: bool = False):
    """``step(state, store, idx, tokens, target) -> (state, metrics)``, the
    beta rows gathered from the device store by K1 inside the step."""
    one = _step_body(cfg, l2_rules, masked)

    def step(state, store, idx, tokens, target):
        return one(state, gather_rows(store, idx), tokens, target)

    return step


def _eval_body(cfg, l2_rules, masked: bool):
    """Inference-mode forward and the reference's val metrics
    (lc_NIC.test_step :410-459), shared by the per-batch and the scanned
    eval."""

    @torch.no_grad()
    def body(state, betas, tokens, target):
        mask = (target != 0) if masked else None
        betas = betas.float()
        a0 = torch.zeros(betas.shape[0], cfg.units, device=betas.device)
        logits, alphas = state.model(betas, tokens.long(), a0, a0)
        return {
            "loss": caption_loss(logits, target, mask),
            "L2": l2_loss(state.model, l2_rules),
            "attention": attention_loss(alphas),
            "accuracy": accuracy(logits, target, mask),
        }

    return body


def make_eval_step(cfg, l2_rules, masked: bool = False):
    """``step(state, betas, tokens, target) -> metrics``, no update."""
    return _eval_body(cfg, l2_rules, masked)


def _stack(metrics: list[dict]) -> dict:
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def make_scanned_train_steps_from_tables(cfg, l2_rules, masked: bool = False):
    """``steps(state, store, store_idx (N,), tokens (N, T), target (N, T),
    pair_idx (K, B)) -> (state, metrics stacked (K,))``: K steps in one
    call, the tables and the store on the device and indexed by pair id."""
    one = _step_body(cfg, l2_rules, masked)

    def steps(state, store, store_idx, tokens, target, pair_idx):
        metrics = []
        for pidx in pair_idx:
            betas = gather_rows(store, store_idx.index_select(0, pidx))
            state, m = one(state, betas, tokens.index_select(0, pidx),
                           target.index_select(0, pidx))
            metrics.append(m)
        return state, _stack(metrics)

    return steps


def make_scanned_eval_steps_from_tables(cfg, l2_rules, masked: bool = False):
    """The whole validation pass in one call, over the (K, B) pair ids, as
    ``make_scanned_train_steps_from_tables``: metrics stacked (K,)."""
    body = _eval_body(cfg, l2_rules, masked)

    def steps(state, store, store_idx, tokens, target, pair_idx):
        return _stack([body(state,
                            gather_rows(store, store_idx.index_select(0, p)),
                            tokens.index_select(0, p),
                            target.index_select(0, p))
                       for p in pair_idx])

    return steps
