"""The whole greedy decode loop as one hand-written CUDA kernel chain, for
both cells of the NIC family: K2 (LSTM) and K3 (GRU).

Counterpart of ``masters_thesis_tpu/ops/fused_decode.py``. The fp32
kernels are in ``csrc/fused_decode.cu`` (its header says what bounds them
on Hopper and how the design answers that); the products that run on the
tile kernel of ``csrc/tile_kernels.cuh`` (K2's h W2, cell and head, K3's h
W2 and head) are planned here (``lstm_decode_plans``, ``gru_decode_plans``,
by ``ops.tiles.plan``) and the C side refuses a plan it cannot run. The
bf16-weight K2 and K3 are one persistent cooperative kernel,
``csrc/decode_bf16.cu``, on the launch record of ``ops.decode_plan``
(``bf16_decode_plan``), which the C side checks in the same way. ``fused_greedy_decode_reference`` and
``fused_greedy_decode_gru_reference`` are the same computations in plain
PyTorch:

    per step:  alpha  = softmax(vᵀ tanh(pre + act_a(h W2 + b2)) + bv)
               ctx    = Σ alpha · features
               h(, c) = cell([ctx ; emb], h(, c))
               logits = act_h(h W_i + b_i) W_o + b_o
               word   = argmax(logits)          (first index on ties)
               emb    = E[word]

``act_a`` and ``act_h`` are LeakyReLU with a negative slope taken from the
model, as the JAX kernel takes them: 0.2 (leaky_relu), 0 (relu) or 1
(linear, the identity). The LSTM cell is Keras' [i|f|g|o]; the GRU cell is
Keras' reset_after [z|r|h̄] with separate input and recurrent biases, and
under ``zero_state`` (the CnnRnn quirk) it restarts from zeros every step,
so hz = b_rec and the carried h feeds only the next step's attention.

The wrappers take the plain version for CPU tensors only; for CUDA tensors
they launch the kernel or raise. There is no fallback.

The dtypes of the arguments pick the mode, as the TPU kernels' casts do on
their accelerator (``_fused_decode_call``, ``masters_thesis_tpu/ops/
fused_decode.py:159-166``): ``wx``, ``wh``, ``wi``, ``wo`` and ``emb_table``
all fp32 (the fp32 kernels) or all bf16 (the bf16-weight kernels); ``pre``
and ``features`` both fp32 or both bf16 (``feat_bf16``, which comes with
bf16 weights, as on the TPU); every other tensor fp32. A mixed set is
refused before any work. With bf16 weights every product with them is an
fp32 sum of exact products of operands rounded to bf16 (the TPU kernels'
``jnp.dot(x.astype(bf16), w, preferred_element_type=float32)``): [ctx ; emb]
Wx and h Wh (kept apart for the GRU's h̄ gate), h Wi and hi Wo. h W2 stays
fp32, as W2 does; the carries stay fp32 and h is rounded only as an
operand; the re-embedding gives the bf16 table's row, widened; ``emb0``
stays fp32. Under ``feat_bf16`` the attention reads ``pre`` and
``features`` widened, with fp32 sums.

Unlike the TPU kernels, regions are not padded (that served TPU sublanes)
and the re-embedding is a row gather, not a one-hot matmul.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from masters_thesis_tpu_torch.models.common import (
    ACTIVATION_SLOPES,
    BatchNorm,
    leaky_relu,
)
from masters_thesis_tpu_torch.ops import tiles
from masters_thesis_tpu_torch.ops.decode_plan import CELLS, decode_plan
from masters_thesis_tpu_torch.utils.profiling import span

PAD_NEG = -1e30      # padded-vocab bias: never wins the argmax
VOCAB_MULTIPLE = 128


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _product(w, wide):
    """x -> x w as the decode kernels form it: as it stands for an fp32 (or
    float64) ``w``; for a bf16 ``w`` the TPU kernels' bf16 product, x
    rounded to bf16, every product exact and the sum in ``wide``, the
    carries' dtype."""
    if w.dtype != torch.bfloat16:
        return lambda x: x @ w
    w = w.to(wide)
    return lambda x: x.to(torch.bfloat16).to(wide) @ w


def _greedy_loop(cell, pre, features, w2, b2, v, bv, wi, bi, wo, bo,
                 emb_table, emb0, h0, *, max_length: int, slope: float,
                 attn_slope: float, return_margins: bool):
    """The plain versions' shared loop; ``cell(x, h) -> h'`` is the cell
    on x = [ctx ; emb]."""
    B = pre.shape[0]
    wide = h0.dtype
    pre, features = pre.to(wide), features.to(wide)   # feat_bf16: widened
    head_i, head_o = _product(wi, wide), _product(wo, wide)
    h = h0
    emb = emb0.expand(B, -1)
    words, alphas, margins = [], [], []
    for _ in range(max_length):
        hw = leaky_relu(h @ w2 + b2, attn_slope)
        e = torch.tanh(pre + hw[:, None, :]) @ v + bv           # (B, R)
        alpha = torch.softmax(e, dim=1)
        ctx = torch.sum(alpha[:, :, None] * features, dim=1)     # (B, D)
        h = cell(torch.cat([ctx, emb], dim=-1), h)
        logits = head_o(leaky_relu(head_i(h) + bi, slope)) + bo
        nxt = torch.argmax(logits, dim=-1)
        emb = emb_table[nxt].to(wide)
        words.append(nxt)
        alphas.append(alpha)
        if return_margins:
            top2 = torch.topk(logits, 2, dim=-1).values
            margins.append(top2[:, 0] - top2[:, 1])
    out = (torch.stack(words, 1).to(torch.int32), torch.stack(alphas, 1))
    return out + (torch.stack(margins, 1),) if return_margins else out


def fused_greedy_decode_reference(pre, features, w2, b2, v, bv, wx, wh, b,
                                  wi, bi, wo, bo, emb_table, emb0, h0, c0, *,
                                  max_length: int, slope: float = 0.2,
                                  attn_slope: float = 0.2,
                                  return_margins: bool = False):
    """Plain PyTorch version of K2, in either mode (the module docstring).
    Returns (words (B, T) int32, alphas (B, T, R) in the carries' dtype);
    with ``return_margins`` also the top-2 logit margin of every step
    (B, T), which tells a near-tie from a fault when the kernel's summation
    order picks another word. Carries in float64 (with the fp32 tensors
    widened, and bf16 ones as they are) give the same decode summed in
    float64."""
    args = (pre, features, w2, b2, v, bv, wx, wh, b, wi, bi, wo, bo,
            emb_table, emb0, h0, c0)
    decode_precision("lstm", args, plain=True)
    c = c0
    x_wx, h_wh = _product(wx, h0.dtype), _product(wh, h0.dtype)

    def lstm(x, h):
        nonlocal c
        z = x_wx(x) + h_wh(h) + b
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c)

    return _greedy_loop(lstm, pre, features, w2, b2, v, bv, wi, bi, wo, bo,
                        emb_table, emb0, h0, max_length=max_length,
                        slope=slope, attn_slope=attn_slope,
                        return_margins=return_margins)


def fused_greedy_decode_gru_reference(pre, features, w2, b2, v, bv, wx, wh,
                                      b_in, b_rec, wi, bi, wo, bo, emb_table,
                                      emb0, h0, *, max_length: int,
                                      slope: float = 1.0,
                                      attn_slope: float = 1.0,
                                      zero_state: bool = False,
                                      return_margins: bool = False):
    """Plain PyTorch version of K3; takes and returns as
    ``fused_greedy_decode_reference`` does."""
    args = (pre, features, w2, b2, v, bv, wx, wh, b_in, b_rec, wi, bi, wo,
            bo, emb_table, emb0, h0)
    decode_precision("gru", args, plain=True)
    x_wx, h_wh = _product(wx, h0.dtype), _product(wh, h0.dtype)

    def gru(x, h):
        xz_z, xz_r, xz_h = torch.chunk(x_wx(x) + b_in, 3, dim=-1)
        if zero_state:           # h @ wh is 0: the recurrent part is b_rec
            h = torch.zeros_like(h)
            hz = b_rec.expand(h.shape[0], -1)
        else:
            hz = h_wh(h) + b_rec
        hz_z, hz_r, hz_h = torch.chunk(hz, 3, dim=-1)
        z = torch.sigmoid(xz_z + hz_z)
        r = torch.sigmoid(xz_r + hz_r)
        hh = torch.tanh(xz_h + r * hz_h)
        return z * h + (1.0 - z) * hh

    return _greedy_loop(gru, pre, features, w2, b2, v, bv, wi, bi, wo, bo,
                        emb_table, emb0, h0, max_length=max_length,
                        slope=slope, attn_slope=attn_slope,
                        return_margins=return_margins)


def plain_or_kernel(name: str, args) -> bool:
    """True for all-CPU tensors (the plain version); False for one CUDA
    device (the kernel); raises on anything else."""
    devices = {a.device for a in args}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"{name} needs every tensor on one CUDA device or all on the "
            f"CPU; got {sorted(map(str, devices))}")
    return False


def require_hopper(device: torch.device, what: str) -> None:
    """Raise unless ``device`` is a Hopper card (sm_90), the only target the
    kernels are built for."""
    if torch.cuda.get_device_capability(device) != (9, 0):
        raise RuntimeError(
            f"{what} is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} is "
            f"sm_{''.join(map(str, torch.cuda.get_device_capability(device)))}")


def fused_greedy_decode(pre, features, w2, b2, v, bv, wx, wh, b, wi, bi, wo,
                        bo, emb_table, emb0, h0, c0, *, max_length: int,
                        slope: float = 0.2, attn_slope: float = 0.2):
    """K2: every greedy step of an LSTM NIC for (B, R, ·) inputs.

    pre (B, R, A) = act_a(features W1 + b1); features (B, R, D); w2 (U, A);
    b2, v (A,); bv (1,); wx (D+E, 4U); wh (U, 4U); b (4U,); wi (U, H);
    bi (H,); wo (H, Vp); bo (Vp,) with -1e30 on padded ids; emb_table
    (V, E); emb0 (E,); h0, c0 (B, U). ``slope`` and ``attn_slope`` are the
    negative slopes of the head's and the attention's activations.
    Returns (words (B, T) int32, alphas (B, T, R) fp32). Every tensor fp32,
    or ``BF16_WEIGHTS`` in bf16 (and ``BF16_FEATURES`` too, for
    ``feat_bf16``): the bf16-weight K2 (the module docstring).

    ``fused_greedy_decode.launches`` counts the fp32 kernel chain's
    launches, ``fused_greedy_decode.launches_bf16`` the bf16 one's;
    ``fused_greedy_decode.plans`` holds the tile plans (``ops.tiles.Plan``)
    of the last fp32 launch. The call is the span ``decode.kernel``
    (``utils.profiling.span``)."""
    args = (pre, features, w2, b2, v, bv, wx, wh, b, wi, bi, wo, bo,
            emb_table, emb0, h0, c0)
    with span("decode.kernel", pre):
        if plain_or_kernel("fused_greedy_decode", args):
            return fused_greedy_decode_reference(
                *args, max_length=max_length, slope=slope,
                attn_slope=attn_slope)
        out = _launch("lstm", args, max_length=max_length, slope=slope,
                      attn_slope=attn_slope)
    if wx.dtype == torch.bfloat16:
        fused_greedy_decode.launches_bf16 += 1
    else:
        fused_greedy_decode.launches += 1
    return out


fused_greedy_decode.launches = 0
fused_greedy_decode.launches_bf16 = 0
fused_greedy_decode.plans = ()


def fused_greedy_decode_gru(pre, features, w2, b2, v, bv, wx, wh, b_in,
                            b_rec, wi, bi, wo, bo, emb_table, emb0, h0, *,
                            max_length: int, slope: float = 1.0,
                            attn_slope: float = 1.0,
                            zero_state: bool = False):
    """K3: every greedy step of a GRU NIC, the arguments of
    ``fused_greedy_decode`` with wx (D+E, 3U), wh (U, 3U), the input and
    recurrent biases b_in, b_rec (3U,) in place of b, and no c0.
    ``zero_state`` restarts the recurrence from zeros every step. The
    dtypes pick the mode as for K2.

    ``fused_greedy_decode_gru.launches`` counts the fp32 kernel chain's
    launches, ``fused_greedy_decode_gru.launches_bf16`` the bf16 one's;
    ``fused_greedy_decode_gru.plans`` holds the tile plans (h W2, Wi, Wo)
    of the last fp32 launch. The call is the span
    ``decode.kernel``."""
    args = (pre, features, w2, b2, v, bv, wx, wh, b_in, b_rec, wi, bi, wo,
            bo, emb_table, emb0, h0)
    with span("decode.kernel", pre):
        if plain_or_kernel("fused_greedy_decode_gru", args):
            return fused_greedy_decode_gru_reference(
                *args, max_length=max_length, slope=slope,
                attn_slope=attn_slope, zero_state=zero_state)
        out = _launch("gru", args, max_length=max_length, slope=slope,
                      attn_slope=attn_slope, zero_state=zero_state)
    if wx.dtype == torch.bfloat16:
        fused_greedy_decode_gru.launches_bf16 += 1
    else:
        fused_greedy_decode_gru.launches += 1
    return out


fused_greedy_decode_gru.launches = 0
fused_greedy_decode_gru.launches_bf16 = 0
fused_greedy_decode_gru.plans = ()


# the positional arguments of each cell's kernel, in order
DECODE_ARGS = {
    "lstm": ("pre features w2 b2 v bv wx wh b wi bi wo bo emb_table emb0 h0 "
             "c0").split(),
    "gru": ("pre features w2 b2 v bv wx wh b_in b_rec wi bi wo bo emb_table "
            "emb0 h0").split(),
}
# what the TPU kernels cast to bf16 on their accelerator: the weights with
# the embedding table, and under feat_bf16 the attention's inputs
BF16_WEIGHTS = ("wx", "wh", "wi", "wo", "emb_table")
BF16_FEATURES = ("pre", "features")


def decode_precision(cell: str, args, plain: bool = False) -> tuple:
    """(weights_bf16, feat_bf16) of a decode's arguments (``cell`` "lstm"
    or "gru"): ``BF16_WEIGHTS`` all bf16 or all fp32, ``BF16_FEATURES``
    both bf16 (only beside bf16 weights) or both fp32, every other tensor
    fp32. ``plain`` (the plain versions) also takes every fp32 tensor in
    float64 instead, for a decode summed in float64. Raises ValueError on
    any other set."""
    a = dict(zip(DECODE_ARGS[cell], args))
    wide = a["h0"].dtype
    wides = (torch.float32, torch.float64) if plain else (torch.float32,)

    def bf16(names):
        dtypes = {a[n].dtype for n in names}
        return None if len(dtypes) > 1 else dtypes.pop() == torch.bfloat16

    weights, feat = bf16(BF16_WEIGHTS), bf16(BF16_FEATURES)
    rest = {t.dtype for n, t in a.items()
            if not (weights and n in BF16_WEIGHTS)
            and not (feat and n in BF16_FEATURES)}
    if (weights is None or feat is None or rest != {wide}
            or wide not in wides or (feat and not weights)):
        got = ", ".join(f"{n} {str(t.dtype).removeprefix('torch.')}"
                        for n, t in a.items())
        raise ValueError(
            f"the decode takes every tensor in float32, or wx, wh, wi, wo "
            f"and emb_table all in bfloat16 (and with them pre and features "
            f"both in bfloat16, for feat_bf16) and the rest in float32; got "
            f"{got}")
    return bool(weights), bool(feat)


def cast_decode_inputs(cell: str, args, *, weights_bf16: bool = False,
                       feat_bf16: bool = False) -> tuple:
    """``args`` (fp32, as ``decode_inputs`` gives them) with
    ``BF16_WEIGHTS`` cast to bf16 if ``weights_bf16`` and
    ``BF16_FEATURES`` if ``feat_bf16``, as the TPU kernels cast them on
    their accelerator. ``feat_bf16`` needs ``weights_bf16``."""
    if feat_bf16 and not weights_bf16:
        raise ValueError("feat_bf16 comes with weights_bf16, as on the TPU")
    names = ((BF16_WEIGHTS if weights_bf16 else ())
             + (BF16_FEATURES if feat_bf16 else ()))
    return tuple(t.to(torch.bfloat16) if n in names else t
                 for n, t in zip(DECODE_ARGS[cell], args))


def lstm_decode_plans(args, force=None) -> tuple[tiles.Plan, ...]:
    """The plans (``ops.tiles.plan``) of K2's four tile-kernel products on
    ``args`` (``fused_greedy_decode``'s tensors): h W2, B rows of h times W2
    (U, A); the cell, [ctx | emb | h] times [Wx ; Wh]; the first head layer,
    h times Wi (U, H); the logits, hi times Wo (H, Vp). ``force`` (h W2,
    cell, Wi, Wo) names tiles, each or None, as a test forces them. Each
    plan sums K in the order K2 summed that product in before it ran on the
    tile kernel: h W2 in block_vecmat's, the cell and the head in
    rows_kernel's. h, ctx, emb and hi are K2's own scratch."""
    a = dict(zip(DECODE_ARGS["lstm"], args))
    B, _, A = a["pre"].shape
    D = a["features"].shape[2]
    U = a["w2"].shape[0]
    E = a["emb_table"].shape[1]
    H, Vp = a["wo"].shape
    hw, cell, wi, wo = force if force is not None else (None,) * 4
    aligned = tiles.aligned16
    return (tiles.plan(B, A, (U,), 1, aligned(a["w2"]), hw, "vecmat"),
            tiles.plan(B, U, (D, E, U), 4, aligned(a["wx"], a["wh"]), cell,
                       "rows"),
            tiles.plan(B, H, (U,), 1, aligned(a["wi"]), wi, "rows"),
            tiles.plan(B, Vp, (H,), 1, aligned(a["wo"]), wo, "rows"))


def gru_decode_plans(args, force=None) -> tuple[tiles.Plan, ...]:
    """The plans (``ops.tiles.plan``) of K3's three tile-kernel products on
    ``args`` (``fused_greedy_decode_gru``'s tensors): h W2, B rows of h
    times W2 (U, A); the first head layer, h times Wi (U, H); the logits,
    hi times Wo (H, Vp). ``force`` (h W2, Wi, Wo) names tiles, each or
    None, as a test forces them. h W2 sums in the tile's default order, the
    head in rows_kernel's, which summed it before it ran on the tile
    kernel. h and hi are K3's own scratch."""
    a = dict(zip(DECODE_ARGS["gru"], args))
    B, _, A = a["pre"].shape
    U = a["w2"].shape[0]
    H, Vp = a["wo"].shape
    hw, wi, wo = force if force is not None else (None,) * 3
    aligned = tiles.aligned16
    return (tiles.plan(B, A, (U,), 1, aligned(a["w2"]), hw),
            tiles.plan(B, H, (U,), 1, aligned(a["wi"]), wi, "rows"),
            tiles.plan(B, Vp, (H,), 1, aligned(a["wo"]), wo, "rows"))


def _launch(cell: str, args, *, max_length: int, slope: float,
            attn_slope: float, zero_state: bool = False, plans=None,
            plan=None, stamps=None):
    """Launch K2 (``cell`` "lstm") or K3 ("gru") in the mode that the
    arguments' dtypes select (``decode_precision``, which refuses a mixed
    set before any work). The fp32 K2 runs on ``plans`` (h W2, cell, Wi,
    Wo), by default ``lstm_decode_plans``'s, the fp32 K3 on ``plans`` (h
    W2, Wi, Wo), by default ``gru_decode_plans``'s; the last ones run are
    ``fused_greedy_decode.plans`` and ``fused_greedy_decode_gru.plans``.
    The bf16-weight decode is one cooperative launch of
    ``csrc/decode_bf16.cu`` on ``plan`` (an ``ops.decode_plan.DecodePlan``,
    by default ``decode_plan``'s for the card), and takes no tile plans;
    ``stamps`` (int64, 5 + 9 T, on the device) receives its phases'
    ``%globaltimer`` stamps."""
    from masters_thesis_tpu_torch.ops import _build

    a = dict(zip(DECODE_ARGS[cell], args))
    weights_bf16, feat_bf16 = decode_precision(cell, args)
    device = a["pre"].device
    require_hopper(device, "the decode kernels")
    B, R, A = a["pre"].shape
    D = a["features"].shape[2]
    U = a["w2"].shape[0]
    V, E = a["emb_table"].shape
    H, Vp = a["wo"].shape
    G = 3 if cell == "gru" else 4          # gates a unit
    shapes = {
        "pre": (B, R, A), "features": (B, R, D), "w2": (U, A), "b2": (A,),
        "v": (A,), "bv": (1,), "wx": (D + E, G * U), "wh": (U, G * U),
        "b": (G * U,), "b_in": (G * U,), "b_rec": (G * U,), "wi": (U, H),
        "bi": (H,), "wo": (H, Vp), "bo": (Vp,), "emb_table": (V, E),
        "emb0": (E,), "h0": (B, U), "c0": (B, U)}
    for name, t in a.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: expected {t.dtype} {shapes[name]}, "
                             f"got {tuple(t.shape)}")
    if weights_bf16:
        if plans is not None:
            raise ValueError("the bf16-weight decode takes no tile plans")
        if plan is None:
            plan = bf16_decode_plan(cell, args, max_length, zero_state)
        return _launch_bf16(cell, a, plan, max_length, zero_state, slope,
                            attn_slope, stamps)

    lib = _build.load_library()
    # Copies and scratch freed on return stay safe: the caching allocator
    # hands their memory only to work queued after these kernels on the
    # same stream.
    inputs = {name: t.contiguous() for name, t in a.items()
              if name not in ("emb0", "h0", "c0")}
    empty = lambda *shape: torch.empty(shape, device=device)  # noqa: E731
    h_a = a["h0"].contiguous().clone()
    # c is double buffered as h is: the cell tile reads c and writes c'
    cell_state = ([a["c0"].contiguous().clone(), empty(B, U)]
                  if cell == "lstm" else [])
    words = torch.empty(B, max_length, dtype=torch.int32, device=device)
    alphas = empty(B, max_length, R)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    sizes = [B, R, A, D, E, U, H, Vp, max_length]
    stream = torch.cuda.current_stream(device).cuda_stream
    planned = [inputs.get(n, a[n]) for n in a]
    emb = a["emb0"].expand(B, E).contiguous()
    scratch = [emb, h_a, empty(B, U), *cell_state, empty(B, D), empty(B, H),
               empty(B, Vp), empty(B, A)]       # ..., hi, logits, h W2 + b2
    pointers = [t.data_ptr()
                for t in [*inputs.values(), *scratch, words, alphas]]
    if plans is None:
        plans = (gru_decode_plans if cell == "gru"
                 else lstm_decode_plans)(planned)
    plan_args = [x for p in plans for x in p.args]
    if cell == "gru":
        wrapper = fused_greedy_decode_gru
        code = lib.mtt_fused_greedy_decode_gru(
            *pointers, *sizes, int(zero_state), *plan_args, slope,
            attn_slope, index, stream)
    else:
        wrapper = fused_greedy_decode
        code = lib.mtt_fused_greedy_decode(
            *pointers, *sizes, *plan_args, slope, attn_slope, index, stream)
    _build.check_error(code, f"fused greedy decode ({cell})")
    wrapper.plans = tuple(plans)
    return words, alphas


def bf16_decode_plan(cell: str, args, max_length: int,
                     zero_state: bool = False):
    """The plan (``ops.decode_plan``) that the bf16-weight decode of
    ``args`` (``cell``'s tensors) runs on unless it is given another: one
    block an SM of the tensors' card (of an H100 SXM's 132 for CPU
    tensors, which only a report of the plan reads)."""
    a = dict(zip(DECODE_ARGS[cell], args))
    B, R, A = a["pre"].shape
    H, Vp = a["wo"].shape
    device = a["pre"].device
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else 132)
    return decode_plan(
        cell, B, R, A, a["features"].shape[2], a["emb_table"].shape[1],
        a["w2"].shape[0], H, Vp, max_length,
        feat_bf16=a["pre"].dtype == torch.bfloat16, zero_state=zero_state,
        sms=sms)


# (record, device) -> the record as C reads it on the host and on the device
_RECORDS: dict = {}


def _launch_bf16(cell: str, a: dict, plan, max_length: int, zero_state: bool,
                 slope: float, attn_slope: float, stamps=None):
    """The bf16-weight decode's one cooperative launch on the arguments
    ``a`` (checked by ``_launch``) under ``plan``. The kernel fills its own
    scratch from emb0, h0 and c0; the record is made once a plan and
    device."""
    from masters_thesis_tpu_torch.ops import _build

    h = plan.header
    device = a["pre"].device
    B, R, A = a["pre"].shape
    H, V = a["wo"].shape
    want = dict(cell=CELLS[cell], B=B, R=R, A=A, D=a["features"].shape[2],
                E=a["emb_table"].shape[1], U=a["w2"].shape[0], H=H, V=V,
                T=max_length, feat_bf16=int(a["pre"].dtype == torch.bfloat16),
                zero_state=int(zero_state))
    if any(h[k] != v for k, v in want.items()):
        raise ValueError(f"the plan is for {[h[k] for k in want]}, the "
                         f"arguments are {list(want.values())}")
    T, U = max_length, h["U"]
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    key = (plan, index)
    if key not in _RECORDS:
        if len(_RECORDS) >= 256:
            _RECORDS.clear()
        record = plan.record
        _RECORDS[key] = ((ctypes.c_int * len(record))(*record),
                         torch.tensor(record, dtype=torch.int32,
                                      device=device))
    host, dev = _RECORDS[key]
    f32 = dict(dtype=torch.float32, device=device)
    words = torch.empty(B, T, dtype=torch.int32, device=device)
    alphas = torch.empty(B, T, h["R"], **f32)
    lstm = cell == "lstm"
    scratch = [
        torch.empty(2, B, h["kx"], dtype=torch.bfloat16, device=device),  # x
        torch.empty(B, U, **f32),                                         # h
        torch.empty(B, U, **f32) if lstm else None,                       # c
        torch.empty(B, h["hp"], dtype=torch.bfloat16, device=device),     # hi
        torch.empty(B, h["A"], **f32),                                    # hw
        torch.empty(B, h["blocks"], **f32),                               # pval
        torch.empty(B, h["blocks"], dtype=torch.int32, device=device),
        torch.empty(1, dtype=torch.int32, device=device)]                 # bar
    inputs = [a[n] for n in ("pre", "features", "w2", "b2", "v", "bv", "wx",
                             "wh")]
    inputs += ([a["b"], None] if lstm else [a["b_in"], a["b_rec"]])
    inputs += [a[n] for n in ("wi", "bi", "wo", "bo", "emb_table", "emb0",
                              "h0")]
    inputs.append(a["c0"] if lstm else None)
    # the tensors stay referenced here until the launch is queued
    tensors = [*inputs, *scratch, words, alphas, stamps]
    held = [None if t is None else t.contiguous() for t in tensors]
    pointers = (ctypes.c_void_p * len(held))(
        *(None if t is None else t.data_ptr() for t in held))
    code = _build.load_library().mtt_greedy_decode_bf16(
        pointers, host, dev.data_ptr(), slope, attn_slope, index,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check_error(code, f"bf16-weight greedy decode ({cell})")
    return words, alphas


def decode_options(model) -> dict:
    """The keyword options of the model's decode kernel: the activations'
    negative slopes (leaky_relu 0.2, relu 0, linear 1), as the JAX package
    maps them, and for a GRU the zero-state quirk."""
    opts = {"slope": ACTIVATION_SLOPES[model.head_activation],
            "attn_slope": ACTIVATION_SLOPES[model.attn_inner_activation]}
    if model.cell_type == "gru":
        opts["zero_state"] = model.gru_zero_state
    return opts


def decode_kernel(model):
    """(kernel wrapper, its plain version) for the model's cell: K2 for an
    LSTM, K3 for a GRU."""
    if model.cell_type == "gru":
        return fused_greedy_decode_gru, fused_greedy_decode_gru_reference
    return fused_greedy_decode, fused_greedy_decode_reference


def extract_decode_params(model) -> dict:
    """Attention, cell, head and embedding weights of a port ``NIC``, named
    as in the JAX package's ``extract_decode_params``. The embedding is the
    model's table whether it trains or is a frozen pretrained buffer, which
    the model padded to ``vocab_size`` rows."""
    attn = model.attention
    out = {
        "w1": attn.W1.kernel, "b1": attn.W1.bias,
        "w2": attn.W2.kernel, "b2": attn.W2.bias,
        "v": attn.V.kernel[:, 0], "bv": attn.V.bias,
        "wx": model.cell.kernel, "wh": model.cell.recurrent_kernel,
        "wi": model.dense_inter.kernel, "bi": model.dense_inter.bias,
        "wo": model.dense_out.kernel, "bo": model.dense_out.bias,
        "embedding": model.embedding,
    }
    if model.cell_type == "gru":
        out.update(b_in=model.gru.bias[0], b_rec=model.gru.bias[1])
    else:
        out.update(b=model.lstm.bias)
    return out


def decode_inputs(model, betas: torch.Tensor, start_id: int, *,
                  weights_bf16: bool = False,
                  feat_bf16: bool = False) -> tuple:
    """The positional arguments of the model's decode kernel
    (``decode_kernel``) for ``betas`` (B, ...).

    Encodes (through the backbone, span ``encode.backbone``, for a model
    on pixels), precomputes ``pre = act_a(features W1 + b1)``, pads the vocab
    axis to a multiple of 128 with bias -1e30 from ``model.true_vocab`` on,
    and takes the start embedding and the model's own initial carry (zeros,
    or the learned one from the features); then casts as
    ``cast_decode_inputs`` does for ``weights_bf16`` and ``feat_bf16``.
    The call is the span ``decode.inputs`` (``utils.profiling.span``)."""
    with span("decode.inputs", betas):
        args = _decode_inputs(model, betas, start_id)
        if weights_bf16 or feat_bf16:
            args = cast_decode_inputs(model.cell_type, args,
                                      weights_bf16=weights_bf16,
                                      feat_bf16=feat_bf16)
        return args


def _decode_inputs(model, betas: torch.Tensor, start_id: int) -> tuple:
    sp = extract_decode_params(model)
    features = model.encode(betas)
    pre = leaky_relu(features @ sp["w1"] + sp["b1"],
                     ACTIVATION_SLOPES[model.attn_inner_activation])
    vocab = sp["embedding"].shape[0]
    vp = _round_up(vocab, VOCAB_MULTIPLE)
    tv = model.true_vocab or vocab
    wo = F.pad(sp["wo"], (0, vp - vocab))
    bo = F.pad(sp["bo"][:tv], (0, vp - tv), value=PAD_NEG)
    h0, c0 = model.init_carry(features)
    if model.cell_type == "gru":
        cell, carry = (sp["wx"], sp["wh"], sp["b_in"], sp["b_rec"]), (h0,)
    else:
        cell, carry = (sp["wx"], sp["wh"], sp["b"]), (h0, c0)
    return (pre, features, sp["w2"], sp["b2"], sp["v"], sp["bv"], *cell,
            sp["wi"], sp["bi"], wo, bo, sp["embedding"],
            sp["embedding"][start_id], *carry)


def make_whole_fused_greedy_decoder(model, max_length: int, *,
                                    weights_bf16: bool = False,
                                    feat_bf16: bool = False):
    """Drop-in for ``decode.greedy.make_greedy_decoder`` minus the logits:
    decode(betas (B, ...), start_id) -> (words (B, T) int32, alphas
    (B, T, R)).

    Runs the model's decode kernel (K2 for an LSTM, K3 for a GRU) on
    ``decode_inputs``: the CUDA kernel on a CUDA model, the plain version on
    a CPU one. ``weights_bf16`` runs it with the weights and the embedding
    table in bf16, and ``feat_bf16`` (with it) with ``pre`` and
    ``features`` in bf16, as the JAX kernels run on the TPU; the casts are
    made in every call, as the JAX decoder makes them inside its jit."""
    kernel, _ = decode_kernel(model)
    opts = decode_options(model)
    if feat_bf16 and not weights_bf16:
        raise ValueError("feat_bf16 comes with weights_bf16, as on the TPU")

    @torch.inference_mode()
    def decode(betas: torch.Tensor, start_id: int):
        args = decode_inputs(model, betas, start_id,
                             weights_bf16=weights_bf16, feat_bf16=feat_bf16)
        return kernel(*args, max_length=max_length, **opts)

    return decode


def compare_with_reference(words, alphas, ref_words, ref_alphas, ref_margins,
                           *, alpha_atol: float = 1e-6,
                           tie_margin: float = 1e-3) -> dict:
    """Hold a kernel decode against its plain version (run with
    ``return_margins``) on the same inputs.

    Both sum in different orders, so a row may take another word where the
    plain version's top-2 logit margin is a near-tie (< ``tie_margin``);
    from that step on the two decodes follow different words. A row is bad
    if its words differ at a step that was no near-tie, if its alphas differ
    by more than ``alpha_atol`` up to and including its first differing
    step, or if any of its alphas is not finite.

    Returns {"bad_rows": [...], "near_tie_rows": n, "max_abs_err": x}."""
    T = words.shape[1]
    diff = words != ref_words
    differs = diff.any(dim=1)
    first = torch.where(differs, diff.int().argmax(dim=1),
                        torch.full_like(differs, T, dtype=torch.long))
    steps = torch.arange(T, device=words.device)
    compared = steps[None, :] <= first[:, None]
    step_err = (alphas - ref_alphas).abs().amax(dim=-1)          # (B, T)
    row_err = torch.where(compared, step_err, 0.0).amax(dim=1)
    margin = ref_margins.gather(1, first.clamp(max=T - 1)[:, None])[:, 0]
    near_tie = differs & (margin < tie_margin)
    bad = ((differs & ~near_tie) | ~(row_err <= alpha_atol)
           | ~torch.isfinite(alphas).all(dim=2).all(dim=1))
    return {"bad_rows": bad.nonzero().flatten().tolist(),
            "near_tie_rows": int(near_tie.sum()),
            "max_abs_err": float(row_err.max())}


@torch.no_grad()
def spread_for_check(model, generator: torch.Generator) -> None:
    """Give a freshly initialised model, in place, weights under which a
    check of the decode sees every parameter.

    The initialisers leave every bias at 0 (1 for the forget gate) and
    BatchNorm at scale 1, shift 0, mean 0, variance 1, so a kernel that
    dropped one of them would still agree with its plain version; and
    their small embedding and head make greedy settle on a few ids. Here
    the encoder's biases, its BatchNorms' parameters and running statistics,
    the attention's and the cell's biases (and the learned initial carry's)
    get seeded random values (variance positive), and the embedding, attention,
    context input of the cell and head are widened so that the words vary
    from row to row and step to step. Scales are relative to fan-in, so any
    width works; the fp32 rounding of a decode stays at a few 1e-7 in the
    alphas."""
    def normal(t, std):
        return (torch.randn(t.shape, generator=generator) * std).to(t)

    enc, attn, cell = model.encoder, model.attention, model.cell
    batch_norms = [m for m in enc.modules() if isinstance(m, BatchNorm)]
    in_bn = {id(p) for bn in batch_norms for p in bn.parameters()}
    for name, p in enc.named_parameters():
        # LocallyDense's bias_{b}, PatchDense's bias or proj.bias, the other
        # encoders' Dense and per-region biases; not a BatchNorm's shift
        if name.split(".")[-1].startswith("bias") and id(p) not in in_bn:
            p.copy_(normal(p, 0.1))
    for bn in batch_norms:
        bn.scale.add_(normal(bn.scale, 0.1))
        bn.bias.copy_(normal(bn.bias, 0.1))
        bn.mean.copy_(normal(bn.mean, 0.5))
        bn.var.copy_(0.5 + 1.5 * torch.rand(bn.var.shape, generator=generator)
                     .to(bn.var))
    attn.W1.bias.copy_(normal(attn.W1.bias, 0.5))
    attn.W2.bias.copy_(normal(attn.W2.bias, 0.5))
    attn.V.bias.copy_(normal(attn.V.bias, 1.0))
    attn.W2.kernel.mul_(2.0)
    # A linear inner activation keeps the negative halves of W1 f and W2 h
    # at full size, so the scores' tanh saturates: at CnnRnn width a x5 V
    # makes the attention near one-hot and the fp32 rounding of the scores
    # grows over the steps to ~5e-5 in the alphas; x2 keeps the attention
    # soft (largest alpha ~0.3) and that rounding under 2e-7 (the plain
    # version against float64, held by tests/test_torch_fused_decode_gru.py).
    attn.V.kernel.mul_(5.0 if model.attn_inner_activation == "leaky_relu"
                       else 2.0)
    ctx_rows = cell.kernel.shape[0] - model.embedding.shape[1]
    cell.kernel[:ctx_rows].mul_(5.0)
    cell.bias.add_(normal(cell.bias, 0.5))
    model.embedding.mul_(20.0)
    for dense, bias_std in ((model.dense_inter, 0.5), (model.dense_out, 0.2)):
        fan_in = dense.kernel.shape[0]
        dense.kernel.copy_(normal(dense.kernel, 4.0 / fan_in ** 0.5))
        dense.bias.copy_(normal(dense.bias, bias_std))
    if model.learned_init_state:
        # a small live carry: a GRU keeps a large h0 (z h + (1 - z) h~),
        # and at CnnRnn width one that dominated the head left 8 distinct
        # words on an H100 where the zero carry gives 16 or more
        for dense in (model.hidden_init, model.carry_init):
            dense.kernel.mul_(0.2)
            dense.bias.copy_(normal(dense.bias, 0.1))
