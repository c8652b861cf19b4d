"""The fp32 K2's share of its roofline: the least time one greedy decode of
a request can take (``reference/roofline.py::decode_bound``, bound by its
fp32 operations) over K2's device time a decode, in %. K2's kernels by
name: the tile kernel, either feed (``tile_kernel<>`` and
``tile_kernel_tma<>``; h W2, the cell, the head), the attention and the
argmax."""

from port_bench.reference.roofline import decode_bound

PATTERNS = ("::tile_kernel", "::attention_kernel<", "::argmax_embed_kernel(")


def read(trace, bench):
    us, n = trace.kernel_us(PATTERNS)
    if not n:
        return None
    c = bench.config
    least = decode_bound(
        "lstm", batch=trace.counters["batch"], regions=c["n_groups"],
        feat_dim=c["group_size"], attn_units=c["attn_units"],
        units=c["units"], emb_dim=c["embedding_text"],
        head_dim=c["head_dim"], vocab=c["vocab_size"],
        steps=c["max_length"])["bound_ms"]
    return 100.0 * 1e3 * least / (us / trace.counters["decodes"])
