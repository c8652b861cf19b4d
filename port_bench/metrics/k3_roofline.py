"""The fp32 K3's share of its roofline: the least time one greedy decode of
a request can take (``reference/roofline.py::decode_bound``, the
zero-state GRU, bound by its fp32 operations) over K3's device time a
decode, in %. K3's kernels by name: the tile kernel, either feed
(``tile_kernel<>`` and ``tile_kernel_tma<>``; h W2), the attention, the
row kernel (the cell and the head) and the argmax."""

from port_bench.reference.roofline import decode_bound

PATTERNS = ("::tile_kernel", "::attention_kernel<", "::rows_kernel<",
            "::argmax_embed_kernel(")


def read(trace, bench):
    us, n = trace.kernel_us(PATTERNS)
    if not n:
        return None
    c = bench.config
    least = decode_bound(
        "gru", batch=trace.counters["batch"], regions=c["n_patches"],
        feat_dim=c["embed_dim"], attn_units=c["units"], units=c["units"],
        emb_dim=c["embed_dim"], head_dim=c["units"], vocab=c["vocab_size"],
        steps=c["max_length"], zero_state=True)["bound_ms"]
    return 100.0 * 1e3 * least / (us / trace.counters["decodes"])
