"""The rule by which model FLOPs are counted from shapes, and the count of
one greedy decode step that every decoding family shares; each family's
reference module (``caption_flops``, ``train_flops_per_sample``) counts
its own model by it.

A rewrite without JAX of ``bench.py::flagship_flops_per_step``: useful
matrix-product FLOPs only (2 m n k a product; no bucket padding, no
elementwise work, BatchNorm or softmax, which are O(activations)), and the
backward counted as twice the forward. The count follows the algorithm, not
an implementation, so two kernels that do the same work are read against
the same number.
"""

from __future__ import annotations


def decode_step_flops(cell: str, *, regions: int, feat_dim: int,
                      attn_units: int, units: int, emb_dim: int,
                      head_dim: int, vocab: int,
                      zero_state: bool = False) -> float:
    """One greedy decode step of one row after the features' projection
    ``pre``: h W2, the scores, the context, the cell (no recurrent product
    under ``zero_state``) and the head."""
    gates = 4 if cell == "lstm" else 3
    R, D, A, U, E, H, V = (regions, feat_dim, attn_units, units, emb_dim,
                           head_dim, vocab)
    attn = U * A + R * A + R * D
    cell_fma = (D + E) * gates * U + (0 if zero_state else U * gates * U)
    return 2.0 * (attn + cell_fma + U * H + H * V)
