"""Train and eval steps of every model family, in PyTorch.

Counterpart of ``masters_thesis_tpu/train/steps.py``. A train step runs the
training forward (dropout, BatchNorm batch statistics), the loss, the
backward and the optimizer, in place on ``state``; SAM (``cfg.sam_rho`` > 0,
lc_NIC.py:713-838) is its two-pass variant. Every step returns the metrics
``loss``, ``L2``, ``attention``, ``accuracy``, ``total`` and ``grad_norm``
(the global norm of the raw gradients) as 0-dim tensors on the device.
With ``cfg.tpu.fused_seq`` on, a model that ``ops.fused_seq`` supports
trains its decoder through the fused sequence's custom backward
(``make_train_forward_loss``); any other model takes autograd of its
forward. ``masked`` (the CnnRnn and ShowTell families) zeroes the CCE of
padded targets.

"Scanned" steps run K steps inside one call as a Python loop: each step
indexes the device-resident tables with its row of the (K, B) pair ids,
gathers the betas from the store through K1 (``ops.gather.gather_rows``;
under ``tpu.use_pallas: false`` the library take, ``ops.gather.take_rows``,
as the JAX package takes them with ``jnp.take``), and the metrics come
back stacked (K,) and still on the device, so the host never waits on a
step. A CUDA graph of the step is later work (ROADMAP M17).

Mixed precision (``tpu.compute_dtype: bfloat16``) follows the JAX
``_compute_dtype``: bf16 on the accelerator (here a CUDA device), fp32
elsewhere, so a CPU run trains in fp32. At bf16 the training forward runs
on bf16 copies of the fp32 parameters, each cast once a step by a
differentiable cast (``models.common.parameters_as``), so the gradients
land on the fp32 masters; the betas are cast to bf16, BatchNorm's running
statistics stay fp32, the CCE reads fp32 logits, the attention loss fp32
alphas, L2 the masters and ``accuracy`` the logits as they come. The eval
steps stay fp32. ``tpu.param_dtype`` is read by nothing, as in JAX.

The JAX package's ``model`` argument has no counterpart: the model lives in
the state. ``mesh`` (``parallel.sharding.MeshOps``) makes a body a rank's
part of a sharded step: the forward reads the sharded leaves that no layer
computes with in their gathered whole, the gradients are averaged over the
data group, the norms are those of the whole tensors and the metrics are
those of the global batch (``parallel.sharding`` builds these steps).
"""

from __future__ import annotations

import contextlib

import torch

from masters_thesis_tpu_torch.models.common import parameters_as
from masters_thesis_tpu_torch.ops.fused_seq import (
    fused_train_supported,
    make_train_forward_loss,
)
from masters_thesis_tpu_torch.ops.gather import row_gather
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


def _compute_dtype(cfg, device) -> torch.dtype:
    """The training forward's dtype: bf16 for ``tpu.compute_dtype:
    bfloat16`` on a CUDA device, else fp32, as the JAX ``_compute_dtype``
    gives bf16 only on its accelerator (``train/steps.py:28-34``)."""
    name = getattr(getattr(cfg, "tpu", None), "compute_dtype", "float32")
    if name == "bfloat16" and torch.device(device).type == "cuda":
        return torch.bfloat16
    return torch.float32


def _forward_loss(model, cfg, l2_rules, betas, tokens, target, mask,
                  generator, cdt=torch.float32):
    """Training forward and loss -> (total, metrics), the forward in
    ``cdt`` (the module docstring). At fp32 a bf16 store's rows are widened
    here, as JAX promotes them against fp32 parameters."""
    betas = betas.to(cdt)
    a0 = torch.zeros(betas.shape[0], cfg.units, dtype=betas.dtype,
                     device=betas.device)
    with parameters_as(model, cdt):
        logits, alphas = model(betas, tokens.long(), a0, a0, training=True,
                               generator=generator)
    cce = caption_loss(logits.float(), target, mask)
    l2 = l2_loss(model, l2_rules)
    attn = attention_loss(alphas.float())
    total = cce + l2
    if cfg.attn_loss:
        total = total + attn
    metrics = {"loss": cce.detach(), "L2": l2.detach(),
               "attention": attn.detach(),
               "accuracy": accuracy(logits.detach(), target, mask)}
    return total, metrics


def _step_body(cfg, l2_rules, masked: bool, mesh=None):
    """``one(state, betas, tokens, target) -> (state, metrics)``: one
    optimisation step, SAM's two passes when ``cfg.sam_rho`` > 0; a rank's
    part of the sharded step with ``mesh``."""
    routes = {}     # (model, dtype) -> its forward and loss, on first use
    norm = global_norm if mesh is None else mesh.global_norm

    def forward_loss(model, cdt):
        if (model, cdt) not in routes:
            if cfg.tpu.fused_seq and fused_train_supported(model, cfg):
                routes[model, cdt] = make_train_forward_loss(
                    model, cfg, l2_rules, cdt)
            else:
                routes[model, cdt] = lambda *batch, key: _forward_loss(
                    model, cfg, l2_rules, *batch, cdt)
        return routes[model, cdt]

    def loss_and_grads(state, params, betas, tokens, target, mask):
        cdt = _compute_dtype(cfg, betas.device)
        with (contextlib.nullcontext() if mesh is None
              else mesh.gathered(state.model)):
            total, metrics = forward_loss(state.model, cdt)(
                betas, tokens, target, mask, state.dropout_generator(),
                key=state.dropout_key())
            grads = torch.autograd.grad(total, params)
        if mesh is not None:
            grads = mesh.average(grads)
        return total, metrics, grads

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
            scale = cfg.sam_rho / (norm(g1) + 1e-12)
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
        metrics["grad_norm"] = norm(grads)
        state.tx.step(grads)
        state.step += 1
        if mesh is not None:
            metrics = mesh.metrics(metrics)
        return state, metrics

    return one


def make_train_step(cfg, l2_rules, masked: bool = False, mesh=None):
    """``step(state, betas, tokens, target) -> (state, metrics)``."""
    return _step_body(cfg, l2_rules, masked, mesh)


def make_gathered_train_step(cfg, l2_rules, masked: bool = False):
    """``step(state, store, idx, tokens, target) -> (state, metrics)``, the
    beta rows gathered from the device store inside the step by
    ``ops.gather.row_gather``."""
    one = _step_body(cfg, l2_rules, masked)
    gather = row_gather(cfg.tpu.use_pallas)

    def step(state, store, idx, tokens, target):
        return one(state, gather(store, idx), tokens, target)

    return step


def _eval_body(cfg, l2_rules, masked: bool, mesh=None):
    """Inference-mode forward and the reference's val metrics
    (lc_NIC.test_step :410-459), shared by the per-batch and the scanned
    eval; a rank's part of the sharded eval with ``mesh``."""

    @torch.no_grad()
    def body(state, betas, tokens, target):
        mask = (target != 0) if masked else None
        betas = betas.float()
        a0 = torch.zeros(betas.shape[0], cfg.units, device=betas.device)
        with (contextlib.nullcontext() if mesh is None
              else mesh.gathered(state.model)):
            logits, alphas = state.model(betas, tokens.long(), a0, a0)
            metrics = {
                "loss": caption_loss(logits, target, mask),
                "L2": l2_loss(state.model, l2_rules),
                "attention": attention_loss(alphas),
                "accuracy": accuracy(logits, target, mask),
            }
        return metrics if mesh is None else mesh.metrics(metrics)

    return body


def make_eval_step(cfg, l2_rules, masked: bool = False, mesh=None):
    """``step(state, betas, tokens, target) -> metrics``, no update."""
    return _eval_body(cfg, l2_rules, masked, mesh)


def _stack(metrics: list[dict]) -> dict:
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def make_scanned_train_steps_from_tables(cfg, l2_rules, masked: bool = False,
                                         mesh=None):
    """``steps(state, store, store_idx (N,), tokens (N, T), target (N, T),
    pair_idx (K, B)) -> (state, metrics stacked (K,))``: K steps in one
    call, the tables and the store on the device and indexed by pair id,
    the rows gathered by ``ops.gather.row_gather``."""
    one = _step_body(cfg, l2_rules, masked, mesh)
    gather = row_gather(cfg.tpu.use_pallas)

    def steps(state, store, store_idx, tokens, target, pair_idx):
        metrics = []
        for pidx in pair_idx:
            betas = gather(store, store_idx.index_select(0, pidx))
            state, m = one(state, betas, tokens.index_select(0, pidx),
                           target.index_select(0, pidx))
            metrics.append(m)
        return state, _stack(metrics)

    return steps


def make_scanned_eval_steps_from_tables(cfg, l2_rules, masked: bool = False,
                                        mesh=None):
    """The whole validation pass in one call, over the (K, B) pair ids, as
    ``make_scanned_train_steps_from_tables``: metrics stacked (K,)."""
    body = _eval_body(cfg, l2_rules, masked, mesh)
    gather = row_gather(cfg.tpu.use_pallas)

    def steps(state, store, store_idx, tokens, target, pair_idx):
        return _stack([body(state,
                            gather(store, store_idx.index_select(0, p)),
                            tokens.index_select(0, p),
                            target.index_select(0, p))
                       for p in pair_idx])

    return steps


def make_grad_stats_fn(cfg, l2_rules, masked: bool = False):
    """Per-parameter gradient statistics on one batch (the reference's
    ``df_grads.csv``, AttemptFour/main.py:359-361): ``fn(state, betas,
    tokens, target) -> {param_path: (norm, mean_abs, max_abs)}`` with
    '/'-joined flax paths, from the training forward at the state's step
    (its dropout masks) and autograd. The state is left as it was: the
    BatchNorm statistics the forward moves are put back."""

    def fn(state, betas, tokens, target):
        model = state.model
        names, params = zip(*model.named_parameters())
        stats = [b for b in model.buffers() if b.is_floating_point()]
        saved = [b.clone() for b in stats]
        mask = (target != 0) if masked else None
        try:
            total, _ = _forward_loss(model, cfg, l2_rules, betas, tokens,
                                     target, mask, state.dropout_generator(),
                                     _compute_dtype(cfg, betas.device))
            grads = torch.autograd.grad(total, params)
        finally:
            with torch.no_grad():
                for b, s in zip(stats, saved):
                    b.copy_(s)
        table = torch.stack([torch.stack([torch.linalg.vector_norm(g),
                                          g.abs().mean(), g.abs().max()])
                             for g in grads]).cpu().tolist()
        return {name.replace(".", "/"): tuple(row)
                for name, row in zip(names, table)}

    return fn
