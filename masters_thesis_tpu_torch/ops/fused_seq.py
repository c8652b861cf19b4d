"""The teacher-forced attention+LSTM sequence as one unit with a custom
backward, and its whole-sequence forward kernel written by hand in CUDA (K4).

Counterpart of ``masters_thesis_tpu/ops/fused_seq.py``, the train half of the
reference's fused step. Two forwards share one backward:

- ``"scan"`` (the JAX package's ``backend='xla'``): a step loop in plain
  PyTorch that can drop attention scores, with masks regenerated per step;
- ``"kernel"`` (its ``backend='pallas'``): K4, ``csrc/fused_seq.cu`` (its
  header says what bounds it on Hopper and how the design answers that:
  three kernels a step, h W2 and the cell on the pipelined tile kernel of
  ``csrc/tile_kernels.cuh`` on the plans of ``seq_plans``), eval
  mode only, as the TPU kernel has no dropout path.

Each stores the residuals the backward reads: h, c, alpha, the gates'
pre-activations z and the attention query's pre-activation hw_pre. The
backward (``_backward``) walks t = T-1..0 carrying only (dh, dc) and the
data-sized dfeatures/dpre/dv/dbv sums, emits the per-step dz, dhw_pre and
demb, and after the loop takes every weight gradient as one (B·T)-row
product. It is plain PyTorch: the JAX backward is an XLA scan, not a Pallas
kernel.

``pre = act(features W1 + b1)``, the embedding gather, the head and the loss
stay outside the custom backward, under autograd, as in JAX.

Attention-dropout masks are regenerated, never stored: the forward and the
backward each draw step t's mask from a generator seeded on the host from an
integer key and t (``fold_in``), as JAX folds t into its key. The two
frameworks draw different masks all the same.

``fused_seq_forward`` takes the plain version for CPU tensors only; for CUDA
tensors it launches K4 or raises. There is no fallback. Everything is fp32
(the TPU's bf16 weights and ``compute_dtype`` wait for ROADMAP M16).
"""

from __future__ import annotations

import torch

from masters_thesis_tpu_torch.models.common import (
    ACTIVATION_SLOPES,
    activation,
    dropout,
    leaky_relu,
)
from masters_thesis_tpu_torch.models.nic import NIC
from masters_thesis_tpu_torch.ops.fused_decode import (
    plain_or_kernel,
    require_hopper,
)
from masters_thesis_tpu_torch.ops import tiles
from masters_thesis_tpu_torch.train.losses import (
    accuracy,
    attention_loss,
    caption_loss,
    l2_loss,
)

REGION_MULTIPLE = 8    # the TPU kernel's sublane padding of the regions
PAD_NEG = -1e30        # score of a padded region
_MASK64 = 2**64 - 1

# the kernel's positional arguments, in order
SEQ_ARGS = "pre features emb w2 b2 v bv wx wh b".split()


def _dlrelu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """LeakyReLU's derivative, in x's dtype."""
    return torch.where(x >= 0, torch.ones_like(x), slope)


def _time_major_out(steps: list[torch.Tensor]) -> torch.Tensor:
    """(B, ·) per step -> a (B, T, ·) view of a contiguous (T, B, ·)."""
    return torch.stack(steps).transpose(0, 1)


# ---- attention-dropout masks ----

def fold_in(key: int, t: int) -> int:
    """A 64-bit generator seed for step ``t`` of ``key`` (splitmix64 of
    key + (t + 1) * golden ratio), mixed into every bit, so that the CPU
    generator, which reads the low 32, sees a different seed a step."""
    x = (key + (t + 1) * 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _attn_mask(generator: torch.Generator, key: int, t: int, like, rate):
    """Step t's inverted-dropout scale mask for the attention scores
    (dropout after the tanh, attention.py), drawn from ``generator``
    reseeded from (key, t): keep / (1 - rate) or 0."""
    generator.manual_seed(fold_in(key, t))
    keep = 1.0 - rate
    m = torch.rand(like.shape, generator=generator, device=like.device)
    return (m < keep).to(like.dtype) / keep


# ---- forwards: each returns (hseq, cseq, alphas, zs, hwps), batch-major
# views of time-major storage ----

def _lstm(z: torch.Tensor, c: torch.Tensor):
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def fused_seq_forward_reference(pre, features, emb, w2, b2, v, bv, wx, wh, b,
                                attn_slope: float):
    """Plain PyTorch version of K4: the step loop of the TPU kernel
    ``_seq_kernel``, with its padding of the regions to a multiple of 8 and
    their scores masked to -1e30. Shapes as ``fused_seq_forward``."""
    B, R, _ = pre.shape
    T, U = emb.shape[1], wh.shape[0]
    Rp = -(-R // REGION_MULTIPLE) * REGION_MULTIPLE
    pre = torch.nn.functional.pad(pre, (0, 0, 0, Rp - R))
    features = torch.nn.functional.pad(features, (0, 0, 0, Rp - R))
    real = torch.arange(Rp, device=pre.device) < R
    h = c = torch.zeros(B, U, dtype=pre.dtype, device=pre.device)
    out = [[] for _ in range(5)]
    for t in range(T):
        hw_pre = h @ w2 + b2
        s = torch.tanh(pre + leaky_relu(hw_pre, attn_slope)[:, None, :])
        e = torch.where(real, torch.sum(s * v, dim=-1) + bv, PAD_NEG)
        alpha = torch.softmax(e, dim=1)
        ctx = torch.sum(alpha[:, :, None] * features, dim=1)
        z = torch.cat([ctx, emb[:, t]], dim=-1) @ wx + h @ wh + b
        h, c = _lstm(z, c)
        for acc, x in zip(out, (h, c, alpha[:, :R], z, hw_pre)):
            acc.append(x)
    return tuple(map(_time_major_out, out))


def _forward_scan(pre, features, emb, w2, b2, v, bv, wx, wh, b,
                  attn_slope: float, attn_dropout: float = 0.0,
                  key: int | None = None):
    """The step loop of the JAX ``_forward_xla``, storing the residuals;
    with ``attn_dropout`` > 0 step t's scores are dropped by the mask of
    (``key``, t)."""
    B, T, U = pre.shape[0], emb.shape[1], wh.shape[0]
    h = c = torch.zeros(B, U, dtype=pre.dtype, device=pre.device)
    generator = (torch.Generator(device=pre.device) if attn_dropout > 0
                 else None)
    out = [[] for _ in range(5)]
    for t in range(T):
        hw_pre = h @ w2 + b2
        s = torch.tanh(pre + leaky_relu(hw_pre, attn_slope)[:, None, :])
        if generator is not None:
            s = s * _attn_mask(generator, key, t, s, attn_dropout)
        alpha = torch.softmax(s @ v + bv, dim=1)
        ctx = torch.einsum("br,brd->bd", alpha, features)
        z = torch.cat([ctx, emb[:, t]], dim=-1) @ wx + h @ wh + b
        h, c = _lstm(z, c)
        for acc, x in zip(out, (h, c, alpha, z, hw_pre)):
            acc.append(x)
    return tuple(map(_time_major_out, out))


def fused_seq_forward(pre, features, emb, w2, b2, v, bv, wx, wh, b,
                      attn_slope: float):
    """K4: the whole teacher-forced forward with its residuals.

    pre (B, R, A) = act(features W1 + b1); features (B, R, D); emb (B, T, E)
    the embedded tokens; w2 (U, A); b2, v (A,); bv (1,); wx (D+E, 4U); wh
    (U, 4U); b (4U,). Returns (hseq, cseq (B, T, U), alphas (B, T, R), zs
    (B, T, 4U), hwps (B, T, A)), batch-major views of time-major storage, as
    the TPU kernel returns them.

    ``fused_seq_forward.launches`` counts the kernel's launches."""
    args = (pre, features, emb, w2, b2, v, bv, wx, wh, b)
    if plain_or_kernel("fused_seq_forward", args):
        return fused_seq_forward_reference(*args, attn_slope)
    out = _launch(args, attn_slope)
    fused_seq_forward.launches += 1
    return out


fused_seq_forward.launches = 0


def seq_plans(args, force: tuple[int, int] | None = None):
    """The plans (``ops.tiles.plan``) of K4's two tile-kernel products on
    ``args`` (``fused_seq_forward``'s tensors): the cell's, over
    [ctx | emb | h], and h W2's. ``force`` (cell, h W2) names the tiles,
    as a test forces them."""
    a = dict(zip(SEQ_ARGS, args))
    B, _, A = a["pre"].shape
    D = a["features"].shape[2]
    E = a["emb"].shape[2]
    U = a["w2"].shape[0]
    # the other tensors the products read are K4's own scratch and outputs
    aligned = tiles.aligned16(*(a[k] for k in ("emb", "w2", "wx", "wh")))
    cell, hw = force if force is not None else (None, None)
    return (tiles.plan(B, U, (D, E, U), 4, aligned, cell),
            tiles.plan(B, A, (U,), 1, aligned, hw))


def _launch(args, attn_slope: float, plans=None):
    """Launch K4 on ``plans`` (cell, h W2), by default ``seq_plans``'s."""
    from masters_thesis_tpu_torch.ops import _build

    a = dict(zip(SEQ_ARGS, args))
    device = a["pre"].device
    require_hopper(device, "K4")
    B, R, A = a["pre"].shape
    D = a["features"].shape[2]
    T, E = a["emb"].shape[1:]
    U = a["w2"].shape[0]
    shapes = {"pre": (B, R, A), "features": (B, R, D), "emb": (B, T, E),
              "w2": (U, A), "b2": (A,), "v": (A,), "bv": (1,),
              "wx": (D + E, 4 * U), "wh": (U, 4 * U), "b": (4 * U,)}
    for name, t in a.items():
        if tuple(t.shape) != shapes[name] or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 {shapes[name]}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    # Copies and scratch freed on return stay safe: the caching allocator
    # hands their memory only to work queued after the kernel on the same
    # stream.
    inputs = [t.contiguous() for t in args]
    inputs[2] = a["emb"].transpose(0, 1).contiguous()         # (T, B, E)
    cell, hw = plans if plans is not None else seq_plans(inputs)
    empty = lambda *shape: torch.empty(shape, device=device)  # noqa: E731
    zeros = torch.zeros(B, U, device=device)                  # h0 and c0
    out = (empty(T, B, U), empty(T, B, U), empty(T, B, R),
           empty(T, B, 4 * U), empty(T, B, A))
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    code = _build.load_library().mtt_fused_seq_forward(
        *(t.data_ptr() for t in (*inputs, zeros, zeros, empty(B, D), *out)),
        B, R, A, D, E, U, T, attn_slope, *cell.args, *hw.args, index,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check_error(code, "fused_seq_forward")
    return tuple(t.transpose(0, 1) for t in out)


# ---- the shared backward ----

def _backward(w: dict, pre, features, emb, residuals, dhseq, dalphas,
              attn_slope: float, attn_dropout: float = 0.0,
              key: int | None = None):
    """The custom backward of ``fused_seq.py:284-380``: the loop over
    t = T-1..0 carries only (dh, dc) and the dfeat/dpre/dv/dbv sums; every
    weight gradient is one (B·T)-row product after it. ``residuals`` as the
    forwards return them; a gradient of ``None`` counts as zeros. Returns
    (dw, dpre, dfeat, demb), dw keyed as ``w``."""
    hseq, cseq, alphas, zs, hwps = (r.transpose(0, 1) for r in residuals)
    T, B, U = hseq.shape
    D = features.shape[2]
    zero = hseq.new_zeros(B, U)
    h_prev = torch.cat([zero[None], hseq[:-1]])                  # (T, B, U)
    generator = (torch.Generator(device=pre.device) if attn_dropout > 0
                 else None)

    dh_c, dc_c = zero, zero
    dfeat, dpre = torch.zeros_like(features), torch.zeros_like(pre)
    dv, dbv = torch.zeros_like(w["v"]), hseq.new_zeros(())
    dz_all = hseq.new_empty(T, B, 4 * U)
    dhwp_all = torch.empty_like(hwps)
    demb = hseq.new_empty(T, B, emb.shape[2])
    for t in reversed(range(T)):
        dh = dh_c if dhseq is None else dh_c + dhseq[:, t]
        # LSTM cell backward, activations recomputed from the stored z
        i, f, g, o = torch.chunk(zs[t], 4, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        tc = torch.tanh(cseq[t])
        do = dh * tc
        dc = dc_c + dh * o * (1.0 - tc * tc)
        di, df, dg = dc * g, dc * (cseq[t - 1] if t else zero), dc * i
        dc_prev = dc * f
        dz = torch.cat([di * i * (1 - i), df * f * (1 - f),
                        dg * (1 - g * g), do * o * (1 - o)], dim=-1)
        dz_all[t] = dz
        dx = dz @ w["wx"].T
        dh_prev_rec = dz @ w["wh"].T
        dctx = dx[:, :D]
        demb[t] = dx[:, D:]

        # attention backward: s recomputed from pre + hw, the dropout mask
        # regenerated from (key, t)
        alpha = alphas[t]
        dalpha = torch.einsum("bd,brd->br", dctx, features)
        if dalphas is not None:
            dalpha = dalpha + dalphas[:, t]
        dfeat += alpha[:, :, None] * dctx[:, None, :]
        de = alpha * (dalpha - torch.sum(alpha * dalpha, dim=1, keepdim=True))
        hwp = hwps[t]
        s = torch.tanh(pre + leaky_relu(hwp, attn_slope)[:, None, :])
        mask = (None if generator is None else
                _attn_mask(generator, key, t, s, attn_dropout))
        s_used = s if mask is None else s * mask
        ds_used = de[:, :, None] * w["v"]
        dv += torch.einsum("bra,br->a", s_used, de)
        dbv += torch.sum(de)
        ds = ds_used if mask is None else ds_used * mask
        ds_pre = ds * (1.0 - s * s)
        dpre += ds_pre
        dhw_pre = torch.sum(ds_pre, dim=1) * _dlrelu(hwp, attn_slope)
        dhwp_all[t] = dhw_pre
        dh_c = dh_prev_rec + dhw_pre @ w["w2"].T
        dc_c = dc_prev

    # the weight gradients: one tall product each, no sums in the loop
    rows = lambda x: x.reshape(T * B, -1)                      # noqa: E731
    ctx_all = torch.einsum("tbr,brd->tbd", alphas, features)
    x_all = torch.cat([ctx_all, emb.transpose(0, 1)], dim=-1)
    dw = {"w2": rows(h_prev).T @ rows(dhwp_all),
          "b2": dhwp_all.sum(dim=(0, 1)), "v": dv,
          "bv": dbv.reshape(w["bv"].shape),
          "wx": rows(x_all).T @ rows(dz_all),
          "wh": rows(h_prev).T @ rows(dz_all),
          "b": dz_all.sum(dim=(0, 1))}
    return dw, dpre, dfeat, demb.transpose(0, 1)


# ---- the custom backward and its consumers ----

W_KEYS = ("w2", "b2", "v", "bv", "wx", "wh", "b")


class FusedSequence(torch.autograd.Function):
    """(hseq (B, T, U), alphas (B, T, R)) of the sequence, with the shared
    custom backward. ``forward_fn(pre, features, emb, *w)`` is one of the
    two forwards; the gradients returned are those of the seven weights
    (``W_KEYS``), pre, features and emb."""

    @staticmethod
    def forward(ctx, forward_fn, attn_slope, attn_dropout, key, w2, b2, v,
                bv, wx, wh, b, pre, features, emb):
        w = (w2, b2, v, bv, wx, wh, b)
        residuals = forward_fn(pre, features, emb, *w)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*w, pre, features, emb, *residuals)
        ctx.opts = (attn_slope, attn_dropout, key)
        return residuals[0], residuals[2]

    @staticmethod
    def backward(ctx, dhseq, dalphas):
        saved = ctx.saved_tensors
        w = dict(zip(W_KEYS, saved[:7]))
        pre, features, emb = saved[7:10]
        attn_slope, attn_dropout, key = ctx.opts
        dw, dpre, dfeat, demb = _backward(
            w, pre, features, emb, saved[10:], dhseq, dalphas, attn_slope,
            attn_dropout, key)
        return (None, None, None, None, *(dw[k] for k in W_KEYS), dpre,
                dfeat, demb)


def make_fused_sequence(attn_slope: float = 0.2, backend: str = "scan",
                        attn_dropout: float = 0.0):
    """``seq(w, pre, features, emb, key=None) -> (hseq, alphas)`` with the
    custom backward; ``w`` as ``extract_seq_params`` gives it.

    ``backend`` ``"scan"`` is the JAX package's ``'xla'`` (the plain step
    loop, with attention dropout at ``attn_dropout`` > 0, masks from
    ``key``); ``"kernel"`` is its ``'pallas'`` (``fused_seq_forward``: K4 on
    CUDA tensors, its plain version on CPU ones), which has no dropout
    path."""
    if backend not in ("scan", "kernel"):
        raise ValueError(f"backend {backend!r}: expected 'scan' or 'kernel'")
    if backend == "kernel" and attn_dropout > 0.0:
        raise ValueError("the kernel forward has no dropout path; training "
                         "with attention dropout takes backend='scan'")

    def seq(w: dict, pre, features, emb, key: int | None = None):
        if attn_dropout > 0.0 and key is None:
            raise ValueError("attention dropout needs an integer key")
        if backend == "kernel":
            def forward_fn(*args):
                return fused_seq_forward(*args, attn_slope)
        else:
            def forward_fn(*args):
                return _forward_scan(*args, attn_slope, attn_dropout, key)
        return FusedSequence.apply(
            forward_fn, attn_slope, attn_dropout, key,
            *(w[k] for k in W_KEYS), pre, features, emb)

    return seq


def extract_seq_params(model: NIC) -> dict:
    """The attention and LSTM weights of a port ``NIC``, named as in the JAX
    package's ``extract_seq_params``; ``bv`` keeps its shape (1,)."""
    attn = model.attention
    return {"w2": attn.W2.kernel, "b2": attn.W2.bias,
            "v": attn.V.kernel[:, 0], "bv": attn.V.bias,
            "wx": model.lstm.kernel, "wh": model.lstm.recurrent_kernel,
            "b": model.lstm.bias}


def fused_train_supported(model, cfg) -> bool:
    """Can the train step route through the fused sequence? The custom
    backward implements the LSTM, zero-initial-carry, trainable-embedding
    teacher-forced loop; the port's ``NIC`` has no other carry or embedding
    yet (ROADMAP M11). ``remat`` exists to avoid storing per-step
    activations, which the custom backward stores, so it falls back."""
    return (isinstance(model, NIC) and model.cell_type == "lstm"
            and not getattr(cfg.tpu, "remat", False))


def _pre_and_emb(model: NIC, features, tokens):
    attn = model.attention
    pre = activation(attn.W1(features), model.attn_inner_activation)
    return pre, model.embed(tokens.long())


def make_train_forward_loss(model: NIC, cfg, l2_rules):
    """The training forward and loss with the fused sequence inside, for a
    model that ``fused_train_supported`` accepts: every dropout site (input
    and features in ``encode``, text on the embeddings, attention scores in
    the custom backward, the LSTM outputs, the head), BatchNorm's batch
    statistics, the L2 rules and ``attn_loss``.

    ``forward(betas, tokens, target, mask, generator, key) -> (total,
    metrics)``, as ``train.steps._forward_loss``: the masks of the other
    sites come from ``generator``, the attention's from the integer
    ``key``."""
    if not fused_train_supported(model, cfg):
        raise ValueError("the fused sequence takes an LSTM NIC without remat")
    attn_slope = ACTIVATION_SLOPES[model.attn_inner_activation]
    seq = make_fused_sequence(attn_slope, "scan", model.attention.dropout)

    def forward(betas, tokens, target, mask, generator, key):
        features = model.encode(betas.float(), True, generator)
        pre, emb = _pre_and_emb(model, features, tokens)
        emb = dropout(emb, model.dropout_text, generator, True)
        hseq, alphas = seq(extract_seq_params(model), pre, features, emb,
                           key)
        hseq = dropout(hseq, model.dropout_lstm, generator, True)
        logits = model.head(hseq, True, generator)
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

    return forward


def make_fused_forward_loss(model: NIC, cfg, backend: str = "scan"):
    """Eval-mode teacher-forced forward and CCE loss with the fused sequence
    inside, differentiable end to end: ``fn(betas, tokens, target) ->
    loss``. The encoder, ``pre``, the embedding gather, the head and the
    loss stay under autograd; their gradients close over the custom
    backward's dpre, dfeatures, demb and dhseq. ``backend="kernel"`` is the
    route into K4. ``cfg`` is the JAX signature's; the eval loss reads
    nothing of it."""
    if model.cell_type != "lstm":
        raise ValueError("the fused sequence takes an LSTM NIC")
    seq = make_fused_sequence(ACTIVATION_SLOPES[model.attn_inner_activation],
                              backend)

    def fn(betas, tokens, target):
        features = model.encode(betas)
        pre, emb = _pre_and_emb(model, features, tokens)
        hseq, _ = seq(extract_seq_params(model), pre, features, emb)
        return caption_loss(model.head(hseq), target)

    return fn
