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
tensors it launches K4 or raises. There is no fallback.

Mixed precision (``compute_dtype`` bf16, the JAX ``cdt``): the step loop
and the backward take their products through ``_mm``/``_ein``, which round
both operands to bf16 and multiply them in fp32, returning fp32 as the JAX
``preferred_element_type=float32`` does (not a bf16 product, which torch
would round to bf16); carries, residuals and gradients stay fp32. The
``"kernel"`` forward at bf16 hands K4 bf16 ``w2``, ``wx`` and ``wh`` (the
TPU kernel's bf16 weights, ``fused_seq.py:228``): it rounds ``h`` and the
cell input ``[ctx ; emb]`` to bf16, accumulates in fp32, and keeps ``ctx``
in fp32, where the step loop's ``_ein`` rounds alpha and the features; each
forward keeps its own rule. That K4 runs its products on the bf16 tensor
cores (the wide cell on ``wgmma`` fed by TMA, ``wgmma_cell``, the rest on
``mma.sync``; ``csrc/fused_seq.cu``'s header says what bounds it: the wide
cell's 13.4 GFLOP a step read through L2, and at flagship the attention
and L2 latency, as for the fp32 K4), each input rounded once a step where
it is staged: ``emb`` by ``_launch`` into its time-major copy, ``h`` by the
cell that makes it, ``ctx`` as the cell stages it.
``make_train_forward_loss`` follows the JAX train route at bf16
(``fused_seq.py:525-560``): bf16 parameters and betas into the encoder,
fp32 features, ``pre``, embeddings and logits, the head's products through
the same rounding.
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
from masters_thesis_tpu_torch.parallel.collectives import batch_rand
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


def _mm(a: torch.Tensor, b: torch.Tensor, cdt) -> torch.Tensor:
    """The JAX ``_mm``: at bf16 both operands rounded to bf16, multiplied
    and summed in fp32, the product fp32; else ``a @ b`` as they are. K4
    takes its products at its weights' dtype (the TPU kernel's
    ``jnp.dot(x.astype(w.dtype), w, preferred_element_type=float32)``)."""
    if cdt != torch.bfloat16:
        return a @ b
    return a.to(cdt).float() @ b.to(cdt).float()


def _ein(spec: str, a: torch.Tensor, b: torch.Tensor, cdt) -> torch.Tensor:
    """The JAX ``_ein``: ``_mm``'s rule for an einsum."""
    if cdt != torch.bfloat16:
        return torch.einsum(spec, a, b)
    return torch.einsum(spec, a.to(cdt).float(), b.to(cdt).float())


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
    reseeded from (key, t): keep / (1 - rate) or 0; inside a sharded step,
    this rank's rows of the global batch's mask."""
    generator.manual_seed(fold_in(key, t))
    keep = 1.0 - rate
    m = batch_rand(like.shape, generator, like.device)
    return (m < keep).to(like.dtype) / keep


# ---- forwards: each returns (hseq, cseq, alphas, zs, hwps), batch-major
# views of time-major storage ----

def _lstm(z: torch.Tensor, c: torch.Tensor):
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def fused_seq_forward_reference(pre, features, emb, w2, b2, v, bv, wx, wh, b,
                                attn_slope: float, carries=None):
    """Plain PyTorch version of K4: the step loop of the TPU kernel
    ``_seq_kernel``, with its padding of the regions to a multiple of 8 and
    their scores masked to -1e30, and its casts: bf16 ``w2``, ``wx`` and
    ``wh`` take h and the cell input rounded to bf16 (``_mm``), ``ctx``
    stays fp32. Shapes as ``fused_seq_forward``.

    ``carries`` (hseq, cseq), (B, T, U) each, start step t from their step
    t - 1 (zeros at t = 0) instead of this loop's own: each step's
    arithmetic on another forward's carries. A check needs it at bf16,
    where the rounding of h to bf16 in the recurrence turns a last-bit
    difference of two forwards into one of a bf16 step within a few
    steps."""
    B, R, _ = pre.shape
    T, U = emb.shape[1], wh.shape[0]
    Rp = -(-R // REGION_MULTIPLE) * REGION_MULTIPLE
    pre = torch.nn.functional.pad(pre, (0, 0, 0, Rp - R))
    features = torch.nn.functional.pad(features, (0, 0, 0, Rp - R))
    real = torch.arange(Rp, device=pre.device) < R
    h = c = torch.zeros(B, U, dtype=pre.dtype, device=pre.device)
    out = [[] for _ in range(5)]
    for t in range(T):
        hw_pre = _mm(h, w2, w2.dtype) + b2
        s = torch.tanh(pre + leaky_relu(hw_pre, attn_slope)[:, None, :])
        e = torch.where(real, torch.sum(s * v, dim=-1) + bv, PAD_NEG)
        alpha = torch.softmax(e, dim=1)
        ctx = torch.sum(alpha[:, :, None] * features, dim=1)
        z = (_mm(torch.cat([ctx, emb[:, t]], dim=-1), wx, wx.dtype)
             + _mm(h, wh, wh.dtype) + b)
        h, c = _lstm(z, c)
        for acc, x in zip(out, (h, c, alpha[:, :R], z, hw_pre)):
            acc.append(x)
        if carries is not None:
            h, c = carries[0][:, t], carries[1][:, t]
    return tuple(map(_time_major_out, out))


def _forward_scan(pre, features, emb, w2, b2, v, bv, wx, wh, b,
                  attn_slope: float, attn_dropout: float = 0.0,
                  key: int | None = None, cdt=torch.float32):
    """The step loop of the JAX ``_forward_xla``, storing the residuals;
    with ``attn_dropout`` > 0 step t's scores are dropped by the mask of
    (``key``, t); products by ``_mm``/``_ein`` in ``cdt``."""
    B, T, U = pre.shape[0], emb.shape[1], wh.shape[0]
    h = c = torch.zeros(B, U, dtype=pre.dtype, device=pre.device)
    generator = (torch.Generator(device=pre.device) if attn_dropout > 0
                 else None)
    out = [[] for _ in range(5)]
    for t in range(T):
        hw_pre = _mm(h, w2, cdt) + b2
        s = torch.tanh(pre + leaky_relu(hw_pre, attn_slope)[:, None, :])
        if generator is not None:
            s = s * _attn_mask(generator, key, t, s, attn_dropout)
        # an fp32 s against a bf16 v promotes, as jnp.einsum does
        alpha = torch.softmax(s @ v.to(s.dtype) + bv, dim=1)
        ctx = _ein("br,brd->bd", alpha, features, cdt)
        z = (_mm(torch.cat([ctx, emb[:, t]], dim=-1), wx, cdt)
             + _mm(h, wh, cdt) + b)
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
    the TPU kernel returns them. Every tensor is fp32, or ``w2``, ``wx`` and
    ``wh`` are all bf16: the bf16-weight K4 (the TPU kernel at ``cdt``
    bf16), which rounds h and the cell input to bf16 and sums in fp32.

    ``fused_seq_forward.launches`` counts the fp32 kernel's launches,
    ``fused_seq_forward.launches_bf16`` the bf16 one's."""
    args = (pre, features, emb, w2, b2, v, bv, wx, wh, b)
    if plain_or_kernel("fused_seq_forward", args):
        return fused_seq_forward_reference(*args, attn_slope)
    out = _launch(args, attn_slope)
    if w2.dtype == torch.bfloat16:
        fused_seq_forward.launches_bf16 += 1
    else:
        fused_seq_forward.launches += 1
    return out


fused_seq_forward.launches = 0
fused_seq_forward.launches_bf16 = 0

# the tensors that the bf16-weight K4 takes in bf16
BF16_ARGS = ("w2", "wx", "wh")


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


def wgmma_cell(B: int, D: int, E: int, U: int) -> bool:
    """Whether the bf16-weight K4 runs its cell on wgmma, fed by TMA from a
    K-major copy of [wx ; wh] that ``_launch`` makes once a call: batches
    above 128 rows (the wide shape) whose segment widths D, E and U are
    multiples of the kernel's 64-k chunk, with ctx (D) in the ring's first
    five stages. Other shapes take the mma.sync tiles."""
    return (B > 128 and D % 64 == 0 and E % 64 == 0 and U % 64 == 0
            and D <= 320)


def _launch(args, attn_slope: float, plans=None):
    """Launch K4 on ``plans`` (cell, h W2), by default ``seq_plans``'s; the
    bf16-weight K4 when ``w2``, ``wx`` and ``wh`` are bf16. That one has no
    plans: its tensor-core tiles of ``csrc/fused_seq.cu`` are picked there
    by B, and its wide cell runs on wgmma where ``wgmma_cell`` holds, from
    the K-major weights made here. It takes ``emb`` rounded to bf16 here,
    once a call,
    into the time-major copy, and a (2, B, U) bf16 scratch in h0's place,
    zeros at first, into which each step's cell writes its h rounded for the
    next step's products."""
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
    bf16 = a["w2"].dtype == torch.bfloat16
    for name, t in a.items():
        dtype = (torch.bfloat16 if bf16 and name in BF16_ARGS
                 else torch.float32)
        if tuple(t.shape) != shapes[name] or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shapes[name]}, got "
                             f"{t.dtype} {tuple(t.shape)} (K4 takes every "
                             f"tensor in float32, or w2, wx and wh all in "
                             f"bfloat16)")
    if bf16 and plans is not None:
        raise ValueError("the bf16-weight K4 takes no tile plans")
    # Copies and scratch freed on return stay safe: the caching allocator
    # hands their memory only to work queued after the kernel on the same
    # stream.
    inputs = [t.contiguous() for t in args]
    emb = a["emb"].transpose(0, 1)                              # (T, B, E)
    # at bf16 rounded as torch rounds (to nearest even), in the one copy
    inputs[2] = (emb.to(torch.bfloat16, memory_format=torch.contiguous_format)
                 if bf16 else emb.contiguous())
    empty = lambda *shape: torch.empty(shape, device=device)  # noqa: E731
    zeros = torch.zeros(B, U, device=device)                  # h0 and c0
    h0 = (torch.zeros(2, B, U, dtype=torch.bfloat16, device=device) if bf16
          else zeros)
    out = (empty(T, B, U), empty(T, B, U), empty(T, B, R),
           empty(T, B, 4 * U), empty(T, B, A))
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    pointers = (t.data_ptr() for t in (*inputs, h0, zeros, empty(B, D),
                                       *out))
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = _build.load_library()
    if bf16:
        wt = None                  # the wgmma cell's K-major weights
        if wgmma_cell(B, D, E, U):
            wt = torch.empty(4 * U, D + E + U, dtype=torch.bfloat16,
                             device=device)
            wt[:, :D + E] = inputs[7].t()
            wt[:, D + E:] = inputs[8].t()
        code = lib.mtt_fused_seq_forward_bf16(
            *pointers, None if wt is None else wt.data_ptr(), B, R, A, D, E,
            U, T, attn_slope, index, stream)
    else:
        cell, hw = plans if plans is not None else seq_plans(inputs)
        code = lib.mtt_fused_seq_forward(
            *pointers, B, R, A, D, E, U, T, attn_slope, *cell.args,
            *hw.args, index, stream)
    _build.check_error(code, "fused_seq_forward")
    return tuple(t.transpose(0, 1) for t in out)


# ---- the shared backward ----

def _backward(w: dict, pre, features, emb, residuals, dhseq, dalphas,
              attn_slope: float, attn_dropout: float = 0.0,
              key: int | None = None, cdt=torch.float32):
    """The custom backward of ``fused_seq.py:284-380``: the loop over
    t = T-1..0 carries only (dh, dc) and the dfeat/dpre/dv/dbv sums; every
    weight gradient is one (B·T)-row product after it, each product by
    ``_mm``/``_ein`` in ``cdt``. ``residuals`` as the forwards return them;
    a gradient of ``None`` counts as zeros. Returns (dw, dpre, dfeat, demb),
    dw keyed as ``w``, all fp32."""
    hseq, cseq, alphas, zs, hwps = (r.transpose(0, 1) for r in residuals)
    T, B, U = hseq.shape
    D = features.shape[2]
    zero = hseq.new_zeros(B, U)
    h_prev = torch.cat([zero[None], hseq[:-1]])                  # (T, B, U)
    generator = (torch.Generator(device=pre.device) if attn_dropout > 0
                 else None)

    dh_c, dc_c = zero, zero
    dfeat, dpre = torch.zeros_like(features), torch.zeros_like(pre)
    dv, dbv = hseq.new_zeros(w["v"].shape), hseq.new_zeros(())
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
        dx = _mm(dz, w["wx"].T, cdt)
        dh_prev_rec = _mm(dz, w["wh"].T, cdt)
        dctx = dx[:, :D]
        demb[t] = dx[:, D:]

        # attention backward: s recomputed from pre + hw, the dropout mask
        # regenerated from (key, t)
        alpha = alphas[t]
        dalpha = _ein("bd,brd->br", dctx, features, cdt)
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
        dh_c = dh_prev_rec + _mm(dhw_pre, w["w2"].T, cdt)
        dc_c = dc_prev

    # the weight gradients: one tall product each, no sums in the loop
    rows = lambda x: x.reshape(T * B, -1)                      # noqa: E731
    ctx_all = _ein("tbr,brd->tbd", alphas, features, cdt)
    x_all = torch.cat([ctx_all, emb.transpose(0, 1)], dim=-1)
    dw = {"w2": _mm(rows(h_prev).T, rows(dhwp_all), cdt),
          "b2": dhwp_all.sum(dim=(0, 1)), "v": dv,
          "bv": dbv.reshape(w["bv"].shape),
          "wx": _mm(rows(x_all).T, rows(dz_all), cdt),
          "wh": _mm(rows(h_prev).T, rows(dz_all), cdt),
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
    def forward(ctx, forward_fn, attn_slope, attn_dropout, key, cdt, w2, b2,
                v, bv, wx, wh, b, pre, features, emb):
        # at bf16 the forward and the backward read the weights rounded to
        # bf16, and the gradients go back to the weights as given unrounded
        # (fp32 masters get fp32 gradients, as through the JAX custom_vjp)
        w = tuple(x.to(cdt) if cdt != torch.float32 else x
                  for x in (w2, b2, v, bv, wx, wh, b))
        residuals = forward_fn(pre, features, emb, *w)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*w, pre, features, emb, *residuals)
        ctx.opts = (attn_slope, attn_dropout, key, cdt)
        return residuals[0], residuals[2]

    @staticmethod
    def backward(ctx, dhseq, dalphas):
        saved = ctx.saved_tensors
        w = dict(zip(W_KEYS, saved[:7]))
        pre, features, emb = saved[7:10]
        attn_slope, attn_dropout, key, cdt = ctx.opts
        dw, dpre, dfeat, demb = _backward(
            w, pre, features, emb, saved[10:], dhseq, dalphas, attn_slope,
            attn_dropout, key, cdt)
        return (None, None, None, None, None, *(dw[k] for k in W_KEYS),
                dpre, dfeat, demb)


def make_fused_sequence(attn_slope: float = 0.2, backend: str = "scan",
                        attn_dropout: float = 0.0,
                        compute_dtype: torch.dtype = torch.float32):
    """``seq(w, pre, features, emb, key=None) -> (hseq, alphas)`` with the
    custom backward; ``w`` as ``extract_seq_params`` gives it.

    ``backend`` ``"scan"`` is the JAX package's ``'xla'`` (the plain step
    loop, with attention dropout at ``attn_dropout`` > 0, masks from
    ``key``); ``"kernel"`` is its ``'pallas'`` (``fused_seq_forward``: K4 on
    CUDA tensors, its plain version on CPU ones), which has no dropout
    path. ``compute_dtype`` is the JAX ``compute_dtype`` of the train
    route, whose sequence takes all seven weights in bf16: at bf16 the
    weights are rounded to bf16 inside (their gradients come back fp32 and
    unrounded, as through the JAX ``custom_vjp``; torch would round the
    gradient of a bf16 input), the scan and the backward round their
    products' operands (``_mm``/``_ein``), and the kernel forward is the
    bf16-weight K4 (``w2``, ``wx``, ``wh`` in bf16, the others widened
    back to fp32); on a CUDA tensor that is the bf16 kernel or an error."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype}: expected "
                         f"torch.float32 or torch.bfloat16")
    if backend not in ("scan", "kernel"):
        raise ValueError(f"backend {backend!r}: expected 'scan' or 'kernel'")
    if backend == "kernel" and attn_dropout > 0.0:
        raise ValueError("the kernel forward has no dropout path; training "
                         "with attention dropout takes backend='scan'")

    def seq(w: dict, pre, features, emb, key: int | None = None):
        if attn_dropout > 0.0 and key is None:
            raise ValueError("attention dropout needs an integer key")
        if backend == "kernel":
            def forward_fn(pre, features, emb, *ws):
                if compute_dtype != torch.float32:
                    ws = [x.to(compute_dtype if k in BF16_ARGS
                               else torch.float32)
                          for k, x in zip(W_KEYS, ws)]
                return fused_seq_forward(pre, features, emb, *ws, attn_slope)
        else:
            def forward_fn(*args):
                return _forward_scan(*args, attn_slope, attn_dropout, key,
                                     compute_dtype)
        return FusedSequence.apply(
            forward_fn, attn_slope, attn_dropout, key, compute_dtype,
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
    teacher-forced loop, as the JAX package's does: a learned initial carry
    or a frozen pretrained table takes autograd of the model's forward.
    ``remat`` exists to avoid storing per-step activations, which the
    custom backward stores, so it falls back."""
    return (isinstance(model, NIC) and model.cell_type == "lstm"
            and not model.learned_init_state
            and isinstance(model.embedding, torch.nn.Parameter)
            and not getattr(cfg.tpu, "remat", False))


def _pre_and_emb(model: NIC, features, tokens, rounded=None):
    """``pre = act(features W1 + b1)`` (with ``rounded``, features rounded
    to that dtype and the product fp32: the JAX ``_mm``) and the embedded
    tokens."""
    attn = model.attention
    x = features if rounded is None else features.to(rounded).float()
    pre = activation(attn.W1(x), model.attn_inner_activation)
    return pre, model.embed(tokens.long())


def make_train_forward_loss(model: NIC, cfg, l2_rules,
                            compute_dtype: torch.dtype = torch.float32):
    """The training forward and loss with the fused sequence inside, for a
    model that ``fused_train_supported`` accepts: every dropout site (input
    and features in ``encode``, text on the embeddings, attention scores in
    the custom backward, the LSTM outputs, the head), BatchNorm's batch
    statistics, the L2 rules and ``attn_loss``.

    ``forward(betas, tokens, target, mask, generator, key) -> (total,
    metrics)``, as ``train.steps._forward_loss``: the masks of the other
    sites come from ``generator``, the attention's from the integer
    ``key``. At ``compute_dtype`` bf16 it is the JAX route at bf16
    (``fused_seq.py:525-560``): the parameters' bf16 copies
    (``models.common.parameters_as``) and bf16 betas into the encoder, fp32
    features, embeddings and logits, and ``pre`` and the head's products
    on operands rounded to bf16 with fp32 sums."""
    from masters_thesis_tpu_torch.models.common import parameters_as

    if not fused_train_supported(model, cfg):
        raise ValueError("the fused sequence takes an LSTM NIC without remat")
    attn_slope = ACTIVATION_SLOPES[model.attn_inner_activation]
    seq = make_fused_sequence(attn_slope, "scan", model.attention.dropout,
                              compute_dtype)
    rounded = None if compute_dtype == torch.float32 else compute_dtype

    def forward(betas, tokens, target, mask, generator, key):
        # the sequence's weights as they are (fp32 masters): the sequence
        # rounds them itself and gives them unrounded gradients
        w = extract_seq_params(model)
        with parameters_as(model, compute_dtype):
            features = model.encode(betas.to(compute_dtype), True,
                                    generator).float()
            pre, emb = _pre_and_emb(model, features, tokens, rounded)
            emb = dropout(emb.float(), model.dropout_text, generator, True)
            hseq, alphas = seq(w, pre, features, emb, key)
            hseq = dropout(hseq, model.dropout_lstm, generator, True)
            logits = model.head(hseq, True, generator, rounded)
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
