"""The H100's published peaks and the least time work can take on it.

A frozen copy of the fp32 case of ``chip_smoke.py``'s ``bound`` and
``decode_bound``, taking shapes instead of the kernel's tensors, so that a
kernel that does the same work is read against the same yardstick
whatever its inputs look like.
Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W power
limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12           # fp32 outside the tensor cores
BF16_FLOPS = 989e12          # bf16, dense, on the tensor cores
PEAKS = {"float32": FP32_FLOPS, "bfloat16": BF16_FLOPS}


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS) -> dict:
    """The least time the card could take for work that must move
    ``nbytes`` and do ``flops`` operations at ``peak``: the larger of the
    two times, and which of them it is."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / peak * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def gather_bound(rows: int, row_bytes: int) -> dict:
    """A row gather: each row read once and written once."""
    return bound(2.0 * rows * row_bytes, 0.0)


def decode_bound(cell: str, *, batch: int, regions: int, feat_dim: int,
                 attn_units: int, units: int, emb_dim: int, head_dim: int,
                 vocab: int, steps: int, zero_state: bool = False) -> dict:
    """``bound`` of one whole fp32 greedy decode of ``batch`` rows: each
    input read once (the head's and the embedding's true vocab only; no
    recurrent kernel under ``zero_state``, whose cell never reads it),
    words and alphas written once, and per row and step the multiply-adds
    of the attention (h W2, the scores, the context), the cell and the
    head."""
    B, R, D, A, U, E, H, V = (batch, regions, feat_dim, attn_units, units,
                              emb_dim, head_dim, vocab)
    gates = 4 if cell == "lstm" else 3
    wx, wh = (D + E) * gates * U, U * gates * U
    bias = gates * U * (1 if cell == "lstm" else 2)
    read = 4 * (B * R * A + B * R * D                # pre, features
                + U * A + A + A + 1                  # w2, b2, v, bv
                + wx + (0 if zero_state else wh) + bias
                + U * H + H                          # wi, bi
                + H * V + V                          # wo, bo
                + V * E + E                          # the table, emb0
                + B * U * (2 if cell == "lstm" else 1))   # h0 (and c0)
    written = 4 * B * steps * (1 + R)
    cell_fma = wx + (0 if zero_state else wh)
    attn = B * steps * (U * A + R * A + R * D)
    weights = B * steps * (cell_fma + U * H + H * V)
    return bound(read + written, 2 * (attn + weights))
