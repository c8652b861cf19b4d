"""The whole greedy decode loop as one hand-written CUDA kernel chain (K2).

Counterpart of ``masters_thesis_tpu/ops/fused_decode.py``. The kernel is
``csrc/fused_decode.cu`` (its header says what bounds it on Hopper and how
the design answers that); ``fused_greedy_decode_reference`` is the same
computation in plain PyTorch:

    per step:  alpha  = softmax(vᵀ tanh(pre + lrelu(h W2 + b2)) + bv)
               ctx    = Σ alpha · features
               h, c   = LSTM([ctx ; emb], h, c)
               logits = lrelu(h W_i + b_i) W_o + b_o
               word   = argmax(logits)          (first index on ties)
               emb    = E[word]

``fused_greedy_decode`` takes the plain version for CPU tensors only; for
CUDA tensors it launches the kernel or raises. There is no fallback.

Unlike the TPU kernel, regions are not padded (that served TPU sublanes)
and the re-embedding is a row gather, not a one-hot matmul.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from masters_thesis_tpu_torch.models.common import leaky_relu

PAD_NEG = -1e30      # padded-vocab bias: never wins the argmax
VOCAB_MULTIPLE = 128


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def fused_greedy_decode_reference(pre, features, w2, b2, v, bv, wx, wh, b,
                                  wi, bi, wo, bo, emb_table, emb0, h0, c0, *,
                                  max_length: int,
                                  return_margins: bool = False):
    """Plain PyTorch version of the kernel. Returns (words (B, T) int32,
    alphas (B, T, R) fp32); with ``return_margins`` also the top-2 logit
    margin of every step (B, T), which tells a near-tie from a fault when
    the kernel's summation order picks another word."""
    B = pre.shape[0]
    h, c = h0, c0
    emb = emb0.expand(B, -1)
    words, alphas, margins = [], [], []
    for _ in range(max_length):
        hw = leaky_relu(h @ w2 + b2)
        e = torch.tanh(pre + hw[:, None, :]) @ v + bv           # (B, R)
        alpha = torch.softmax(e, dim=1)
        ctx = torch.sum(alpha[:, :, None] * features, dim=1)     # (B, D)
        z = torch.cat([ctx, emb], dim=-1) @ wx + h @ wh + b
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        logits = leaky_relu(h @ wi + bi) @ wo + bo
        nxt = torch.argmax(logits, dim=-1)
        emb = emb_table[nxt]
        words.append(nxt)
        alphas.append(alpha)
        if return_margins:
            top2 = torch.topk(logits, 2, dim=-1).values
            margins.append(top2[:, 0] - top2[:, 1])
    out = (torch.stack(words, 1).to(torch.int32), torch.stack(alphas, 1))
    return out + (torch.stack(margins, 1),) if return_margins else out


def fused_greedy_decode(pre, features, w2, b2, v, bv, wx, wh, b, wi, bi, wo,
                        bo, emb_table, emb0, h0, c0, *, max_length: int):
    """Run every greedy step for (B, R, ·) inputs.

    pre (B, R, A) = lrelu(features W1 + b1); features (B, R, D); w2 (U, A);
    b2, v (A,); bv (1,); wx (D+E, 4U); wh (U, 4U); b (4U,); wi (U, H);
    bi (H,); wo (H, Vp); bo (Vp,) with -1e30 on padded ids; emb_table
    (V, E); emb0 (E,); h0, c0 (B, U).
    Returns (words (B, T) int32, alphas (B, T, R) fp32).

    ``fused_greedy_decode.launches`` counts the kernel chain's launches."""
    args = (pre, features, w2, b2, v, bv, wx, wh, b, wi, bi, wo, bo,
            emb_table, emb0, h0, c0)
    devices = {a.device for a in args}
    if devices == {torch.device("cpu")}:
        return fused_greedy_decode_reference(*args, max_length=max_length)
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"fused_greedy_decode needs every tensor on one CUDA device or "
            f"all on the CPU; got {sorted(map(str, devices))}")
    return _launch(*args, max_length=max_length)


fused_greedy_decode.launches = 0


def _launch(pre, features, w2, b2, v, bv, wx, wh, b, wi, bi, wo, bo,
            emb_table, emb0, h0, c0, *, max_length: int):
    from masters_thesis_tpu_torch.ops import _build

    device = pre.device
    if torch.cuda.get_device_capability(device) != (9, 0):
        raise RuntimeError(
            f"the decode kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} is "
            f"sm_{''.join(map(str, torch.cuda.get_device_capability(device)))}")
    B, R, A = pre.shape
    D = features.shape[2]
    U = h0.shape[1]
    E = emb_table.shape[1]
    H, Vp = wo.shape
    expected = {
        "pre": (pre, (B, R, A)), "features": (features, (B, R, D)),
        "w2": (w2, (U, A)), "b2": (b2, (A,)), "v": (v, (A,)), "bv": (bv, (1,)),
        "wx": (wx, (D + E, 4 * U)), "wh": (wh, (U, 4 * U)), "b": (b, (4 * U,)),
        "wi": (wi, (U, H)), "bi": (bi, (H,)), "wo": (wo, (H, Vp)),
        "bo": (bo, (Vp,)), "emb_table": (emb_table, (emb_table.shape[0], E)),
        "emb0": (emb0, (E,)), "h0": (h0, (B, U)), "c0": (c0, (B, U)),
    }
    for name, (t, shape) in expected.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")

    lib = _build.load_library()
    # Copies and scratch freed on return stay safe: the caching allocator
    # hands their memory only to work queued after these kernels on the
    # same stream.
    c = lambda t: t.contiguous()  # noqa: E731
    inputs = [c(t) for t in (pre, features, w2, b2, v, bv, wx, wh, b, wi, bi,
                             wo, bo, emb_table)]
    empty = lambda *shape: torch.empty(shape, device=device)  # noqa: E731
    emb = emb0.expand(B, E).contiguous()
    h_a, cell = h0.contiguous().clone(), c0.contiguous().clone()
    scratch = [emb, h_a, empty(B, U), cell, empty(B, D), empty(B, H),
               empty(B, Vp)]
    words = torch.empty(B, max_length, dtype=torch.int32, device=device)
    alphas = empty(B, max_length, R)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    code = lib.mtt_fused_greedy_decode(
        *(t.data_ptr() for t in inputs + scratch + [words, alphas]),
        B, R, A, D, E, U, H, Vp, max_length, index,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check_error(code, "fused_greedy_decode")
    fused_greedy_decode.launches += 1
    return words, alphas


def extract_decode_params(model) -> dict:
    """Attention, LSTM, head and embedding weights of a port ``NIC``, named
    as in the JAX package's ``extract_decode_params``."""
    attn = model.attention
    return {
        "w1": attn.W1.kernel, "b1": attn.W1.bias,
        "w2": attn.W2.kernel, "b2": attn.W2.bias,
        "v": attn.V.kernel[:, 0], "bv": attn.V.bias,
        "wx": model.lstm.kernel, "wh": model.lstm.recurrent_kernel,
        "b": model.lstm.bias,
        "wi": model.dense_inter.kernel, "bi": model.dense_inter.bias,
        "wo": model.dense_out.kernel, "bo": model.dense_out.bias,
        "embedding": model.embedding,
    }


def decode_inputs(model, betas: torch.Tensor, start_id: int) -> tuple:
    """The arguments of ``fused_greedy_decode`` for ``betas`` (B, N).

    Encodes, precomputes ``pre = lrelu(features W1 + b1)``, pads the vocab
    axis to a multiple of 128 with bias -1e30 from ``model.true_vocab`` on,
    and takes the start embedding and the model's initial carry."""
    sp = extract_decode_params(model)
    features = model.encode(betas)
    pre = leaky_relu(features @ sp["w1"] + sp["b1"])
    vocab = sp["embedding"].shape[0]
    vp = _round_up(vocab, VOCAB_MULTIPLE)
    tv = model.true_vocab or vocab
    wo = F.pad(sp["wo"], (0, vp - vocab))
    bo = F.pad(sp["bo"][:tv], (0, vp - tv), value=PAD_NEG)
    h0, c0 = model.init_carry(features)
    return (pre, features, sp["w2"], sp["b2"], sp["v"], sp["bv"], sp["wx"],
            sp["wh"], sp["b"], sp["wi"], sp["bi"], wo, bo, sp["embedding"],
            sp["embedding"][start_id], h0, c0)


def make_whole_fused_greedy_decoder(model, max_length: int):
    """Drop-in for ``decode.greedy.make_greedy_decoder`` minus the logits:
    decode(betas (B, N), start_id) -> (words (B, T) int32, alphas (B, T, R)).

    Runs ``fused_greedy_decode`` on ``decode_inputs``: the CUDA kernel on a
    CUDA model, the plain version on a CPU one."""

    @torch.inference_mode()
    def decode(betas: torch.Tensor, start_id: int):
        return fused_greedy_decode(*decode_inputs(model, betas, start_id),
                                   max_length=max_length)

    return decode


def compare_with_reference(words, alphas, ref_words, ref_alphas, ref_margins,
                           *, alpha_atol: float = 1e-6,
                           tie_margin: float = 1e-3) -> dict:
    """Hold a kernel decode against ``fused_greedy_decode_reference`` (run
    with ``return_margins``) on the same inputs.

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
    the biases and BatchNorm's parameters and running statistics get seeded
    random values (variance positive), and the embedding, attention, context
    input and head are widened so that the words vary from row to row and
    step to step. Scales are relative to fan-in, so any width works; the
    fp32 rounding of a decode stays at a few 1e-7 in the alphas."""
    def normal(t, std):
        return (torch.randn(t.shape, generator=generator) * std).to(t)

    enc, attn = model.encoder, model.attention
    for name, p in enc.named_parameters():
        if name.startswith("bias_"):
            p.copy_(normal(p, 0.1))
    bn = enc.input_bn
    bn.scale.add_(normal(bn.scale, 0.1))
    bn.bias.copy_(normal(bn.bias, 0.1))
    bn.mean.copy_(normal(bn.mean, 0.5))
    bn.var.copy_(0.5 + 1.5 * torch.rand(bn.var.shape, generator=generator)
                 .to(bn.var))
    attn.W1.bias.copy_(normal(attn.W1.bias, 0.5))
    attn.W2.bias.copy_(normal(attn.W2.bias, 0.5))
    attn.V.bias.copy_(normal(attn.V.bias, 1.0))
    attn.W2.kernel.mul_(2.0)
    attn.V.kernel.mul_(5.0)
    ctx_rows = model.lstm.kernel.shape[0] - model.embedding.shape[1]
    model.lstm.kernel[:ctx_rows].mul_(5.0)
    model.lstm.bias.add_(normal(model.lstm.bias, 0.5))
    model.embedding.mul_(20.0)
    for dense, bias_std in ((model.dense_inter, 0.5), (model.dense_out, 0.2)):
        fan_in = dense.kernel.shape[0]
        dense.kernel.copy_(normal(dense.kernel, 4.0 / fan_in ** 0.5))
        dense.bias.copy_(normal(dense.bias, bias_std))
