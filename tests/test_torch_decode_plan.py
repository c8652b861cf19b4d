"""The plan of the bf16-weight decode's persistent kernel
(``ops/decode_plan.py``), on the CPU.

At the flagship LcNIC's and CnnRnn's widths, at the service batches
``Captioner`` gives the kernel (1, 5, 64, 65, 130, 256 rows) and at every
shape of the CUDA tests' bf16 cases, on an H100 SXM's 132 SMs and an H100
PCIe's 114: every unit (with all its gates), Wi column, vocab id, h W2
output and attention row has exactly one owner; every block's regions are
16-byte aligned, in order, apart and within its shared memory; the
attention is resident where the design says (LcNIC at 64 rows) and
streamed where it cannot be (CnnRnn's 640 KB rows); no such shape is
refused. Then a plain-torch walk of a plan (each block's products in its
own chunk order, the partial argmaxes reduced in block order, as the
kernel does) against the bf16 plain version of K2 and K3: at T = 1 within
the fp32 limits, at T = 15 within the bf16 ones (the CUDA tests' limits).
"""

import numpy as np
import pytest
import torch
from test_torch_kernels_cuda import (
    DECODE_SHAPES,
    GRU_SHAPES,
    SHAPES,
    _decode_case,
)

from masters_thesis_tpu_torch.data.synthetic import synthetic_groups
from masters_thesis_tpu_torch.models.nic import CnnRnnNIC, LcNIC
from masters_thesis_tpu_torch.ops import fused_decode
from masters_thesis_tpu_torch.ops.decode_plan import (
    BK,
    CELL_UNITS,
    PW,
    SMEM_LIMIT,
    attn_row_bytes,
    attn_share,
    attn_width,
    cell_bytes,
    decode_plan,
    dense_bytes,
    w2_pitch,
)
from masters_thesis_tpu_torch.ops.group_layout import GroupLayout

from torch_threads import one_thread  # noqa: F401

BLOCK_SMEM = 232_448          # an H100 block's shared memory
FLAGSHIP = dict(R=360, A=32, D=32, E=512, U=512, H=256, V=5120)
CNN_RNN = dict(R=64, A=512, D=2048, E=256, U=512, H=512, V=5120)
SERVICE_ROWS = (1, 5, 64, 65, 130, 256)


def _model_shape(model, rows):
    """(R, A, D, E, U, H, V) of a small model's decode, from its inputs."""
    with torch.inference_mode():
        a = dict(zip(fused_decode.DECODE_ARGS[model.cell_type],
                     fused_decode.decode_inputs(model, rows, 1)))
    B, R, A = a["pre"].shape
    return dict(R=R, A=A, D=a["features"].shape[2],
                E=a["emb_table"].shape[1], U=a["w2"].shape[0],
                H=a["wo"].shape[0], V=a["wo"].shape[1]), B


def _small_lstm():
    cfg = dict(SHAPES["small"])
    n_voxels, n_groups, batch = (cfg.pop(k) for k in
                                 ("n_voxels", "n_groups", "batch"))
    layout = GroupLayout(synthetic_groups(n_voxels, n_groups, seed=0),
                         n_voxels)
    model = LcNIC(layout, generator=torch.Generator().manual_seed(0), **cfg)
    return _model_shape(model, torch.zeros(batch, n_voxels))


def _small_gru(shape):
    patches, channels, units, vocab, true_vocab, batch = GRU_SHAPES[shape]
    model = CnnRnnNIC(embed_dim=64, units=units, vocab_size=vocab,
                      true_vocab=true_vocab, max_length=6, n_patches=patches,
                      in_channels=channels,
                      generator=torch.Generator().manual_seed(0))
    return _model_shape(model, torch.zeros(batch, patches, channels))


def _cases():
    """name -> (cell, B, sizes, feat_bf16, zero_state, T)."""
    out = {}
    for B in SERVICE_ROWS:
        for feat in (False, True):
            out[f"lcnic-b{B}{'-feat' if feat else ''}"] = (
                "lstm", B, FLAGSHIP, feat, False, 15)
        for zero in (True, False):
            out[f"cnn_rnn-b{B}-{'zero' if zero else 'carried'}"] = (
                "gru", B, CNN_RNN, False, zero, 15)
    shape, B = _small_lstm()
    for feat in (False, True):
        for rows in (1, 5, B):
            out[f"small-b{rows}{'-feat' if feat else ''}"] = (
                "lstm", rows, shape, feat, False, 6)
    for name, (B, R, A, D, E, U, H, V) in DECODE_SHAPES.items():
        out[name] = ("lstm", B, dict(R=R, A=A, D=D, E=E, U=U, H=H,
                                     V=-(-V // 128) * 128), False, False, 5)
    for name in GRU_SHAPES:
        if name == "cnn_rnn":
            continue
        shape, B = _small_gru(name)
        for zero in (True, False):
            for rows in sorted({1, 5, B}):
                out[f"{name}-b{rows}-{'zero' if zero else 'carried'}"] = (
                    "gru", rows, shape, False, zero, 6)
    return out


CASES = _cases()


def _plan(case, sms):
    cell, B, s, feat, zero, T = CASES[case]
    return decode_plan(cell, B, s["R"], s["A"], s["D"], s["E"], s["U"],
                       s["H"], s["V"], T, feat_bf16=feat, zero_state=zero,
                       sms=sms)


def _owners(n, ranges):
    count = np.zeros(n, int)
    for r0, r1 in ranges:
        count[r0:r1] += 1
    return count


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("case", list(CASES))
def test_every_unit_column_and_row_has_one_owner(case, sms):
    cell, B, s, feat, zero, T = CASES[case]
    plan = _plan(case, sms)
    h, blocks = plan.header, plan.blocks
    assert len(blocks) == h["blocks"] <= sms
    for key, n in (("u", s["U"]), ("i", s["H"]), ("o", s["V"])):
        ranges = [(b[f"{key}0"], b[f"{key}1"]) for b in blocks]
        assert (_owners(n, ranges) == 1).all(), key
        # cut in block order, as the C side checks
        assert [r0 for r0, _ in ranges[1:]] == [r1 for _, r1 in ranges[:-1]]
    # each non-empty range starts on a unit pair or an n8 tile
    for key, step in (("u", 2), ("i", 8), ("o", 8)):
        assert all(b[f"{key}0"] % step == 0 for b in blocks
                   if b[f"{key}1"] > b[f"{key}0"]), key
    hw = np.zeros((B, s["A"]), int)
    for b in blocks:
        hw[b["r0"]:b["r1"], b["a0"]:b["a1"]] += 1
    assert (hw == 1).all()
    # every ctx column of every row once; the group's first block leads
    ctx = np.zeros((B, s["D"]), int)
    lead = np.zeros(B, int)
    groups = h["blocks"] // h["asplit"]
    for j, b in enumerate(blocks):
        d0, d1 = attn_share(s["D"], h["asplit"], j)
        for k in range(b["rows"]):
            ctx[j // h["asplit"] + k * groups, d0:d1] += 1
            lead[j // h["asplit"] + k * groups] += j % h["asplit"] == 0
    assert (ctx == 1).all() and (lead == 1).all()


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("case", list(CASES))
def test_every_block_fits_its_shared_memory(case, sms):
    cell, B, s, feat, zero, T = CASES[case]
    plan = _plan(case, sms)
    h = plan.header
    G = 4 if cell == "lstm" else 3
    kc = h["kx"] if not zero else h["o_h"]
    assert h["smem"] <= SMEM_LIMIT < BLOCK_SMEM
    for j, b in enumerate(plan.blocks):
        sizes = [
            cell_bytes(G, b["u0"], b["u1"], kc) if h["res_cell"] else 0,
            dense_bytes(b["i0"], b["i1"], -(-s["U"] // 16) * 16)
            if h["res_wi"] else 0,
            dense_bytes(b["o0"], b["o1"], h["hp"]) if h["res_wo"] else 0,
            4 * w2_pitch(s["U"]) * (b["a1"] - b["a0"]) if h["res_w2"] else 0,
            b["rows"] * attn_row_bytes(
                s["R"], attn_width(s["D"], h["asplit"], j), h["ps"], feat)
            if h["res_attn"] else 0,
            h["scratch"]]
        offs = [b[f"off_{k}"] for k in ("cell", "wi", "wo", "w2", "attn",
                                        "scratch")]
        assert all(o % 16 == 0 for o in offs)
        assert all(o + n <= nxt for o, n, nxt in
                   zip(offs, sizes, offs[1:] + [h["smem"]]))
    assert h["smem"] == max(b["off_scratch"] for b in plan.blocks) + (
        h["scratch"])
    assert 3 <= h["stages"] <= 16


def test_the_design_s_resident_and_streamed_choices():
    """LcNIC's attention rows stay resident at 64 rows (92 KB fp32, 46 KB
    bf16 a row, beside the weights); CnnRnn's (640 KB a row) stream; every
    weight of both is resident at 64 rows on 132 SMs, one block an SM."""
    for case in ("lcnic-b64", "lcnic-b64-feat"):
        plan = _plan(case, 132)
        assert plan.describe() == dict(
            blocks=132, smem_bytes=plan.header["smem"], attn="resident",
            cell="resident", wi="resident", wo="resident", w2="resident")
    for case in ("cnn_rnn-b64-zero", "cnn_rnn-b64-carried"):
        d = _plan(case, 132).describe()
        assert d["attn"] == "streamed" and d["blocks"] == 132
        assert {d[k] for k in ("cell", "wi", "wo", "w2")} == {"resident"}
    # two LcNIC rows a block do not fit beside the weights: the attention
    # streams first, and the weights stay
    d = _plan("lcnic-b256", 132).describe()
    assert d["attn"] == "streamed"
    assert {d[k] for k in ("cell", "wi", "wo", "w2")} == {"resident"}


def test_a_shape_that_fits_nowhere_is_refused():
    """Even with every operand streamed, the attention's scratch of tens
    of thousands of regions exceeds a block: refused, not truncated."""
    with pytest.raises(ValueError, match="shared memory"):
        decode_plan("lstm", 4, 60_000, 8, 4, 8, 16, 16, 128, 2)


def test_the_record_is_the_header_then_a_row_a_block():
    plan = _plan("lcnic-b64", 132)
    record = plan.record
    from masters_thesis_tpu_torch.ops.decode_plan import BLOCK, HEADER

    assert len(record) == len(HEADER) + len(BLOCK) * plan.header["blocks"]
    assert record[:len(HEADER)] == [plan.header[k] for k in HEADER]
    assert record[len(HEADER) + len(BLOCK):len(HEADER) + 2 * len(BLOCK)] == [
        plan.blocks[1][k] for k in BLOCK]


# ---- the plan walked in plain torch ----

def _bf(t):
    """t rounded to bf16, widened back (exact)."""
    return t.to(torch.bfloat16).float()


def _chunked(x, w, rot):
    """x w summed as the kernel's product sums it: K in chunks of BK, in the
    block's rotation, each chunk's sum added into an fp32 sum."""
    chunks = -(-x.shape[1] // BK)
    out = torch.zeros(x.shape[0], w.shape[1])
    for c in range(chunks):
        k = (c + rot) % chunks * BK
        out = out + x[:, k:k + BK] @ w[k:k + BK]
    return out


def walk(plan, cell, args, T, slope, attn_slope, zero_state=False):
    """The persistent kernel's decode in plain torch, block by block as the
    plan cuts it: returns (words (B, T) int32, alphas (B, T, R))."""
    h, blocks = plan.header, plan.blocks
    a = dict(zip(fused_decode.DECODE_ARGS[cell], args))
    pre, feat = a["pre"].float(), a["features"].float()
    B, R, A = pre.shape
    D, U, E = feat.shape[2], h["U"], h["E"]
    G, lstm = (4, True) if cell == "lstm" else (3, False)
    o_emb, o_h, kx, hp = h["o_emb"], h["o_h"], h["kx"], h["hp"]
    wcell = torch.zeros(kx, G * U)
    wcell[:D] = a["wx"][:D].float()
    wcell[o_emb:o_emb + E] = a["wx"][D:].float()
    wcell[o_h:o_h + U] = a["wh"].float()
    wi = torch.zeros(kx - o_h, h["H"])
    wi[:U] = a["wi"].float()
    wo = torch.zeros(hp, h["V"])
    wo[:h["H"]] = a["wo"].float()
    hcar = a["h0"].clone()
    c = a["c0"].clone() if lstm else None
    x = torch.zeros(B, kx)
    x[:, o_emb:o_emb + E] = _bf(a["emb0"])
    x[:, o_h:o_h + U] = _bf(a["h0"])
    hw = torch.zeros(B, A)

    def hw_tiles(hv):
        for b in blocks:
            hw[b["r0"]:b["r1"], b["a0"]:b["a1"]] = (
                hv[b["r0"]:b["r1"]] @ a["w2"][:, b["a0"]:b["a1"]]
                + a["b2"][b["a0"]:b["a1"]])

    hw_tiles(hcar)
    words, alphas, word = [], [], None
    for t in range(T):
        if word is not None:
            x[:, o_emb:o_emb + E] = a["emb_table"][word].float()
        e = (torch.tanh(pre + fused_decode.leaky_relu(hw, attn_slope)[:, None])
             @ a["v"] + a["bv"])
        alpha = torch.softmax(e, dim=1)
        x[:, :D] = _bf((alpha[:, :, None] * feat).sum(1))
        hnew = torch.empty(B, U)
        for j, b in enumerate(blocks):
            units = torch.arange(b["u0"], b["u1"])
            if not len(units):
                continue
            cols = torch.cat([g * U + units for g in range(G)])

            def gates(z):
                return z.reshape(B, G, len(units)).unbind(1)
            if lstm:
                i, f, g, o = gates(_chunked(x, wcell[:, cols], j)
                                   + a["b"][cols])
                c[:, units] = (torch.sigmoid(f) * c[:, units]
                               + torch.sigmoid(i) * torch.tanh(g))
                hnew[:, units] = torch.sigmoid(o) * torch.tanh(c[:, units])
            else:
                xz = gates(_chunked(x[:, :o_h], wcell[:o_h, cols], j)
                           + a["b_in"][cols])
                hz = (_chunked(x[:, o_h:], wcell[o_h:, cols], j)
                      if not zero_state else 0) + a["b_rec"][cols]
                hz = gates(hz.expand(B, -1))
                z = torch.sigmoid(xz[0] + hz[0])
                r = torch.sigmoid(xz[1] + hz[1])
                hh = torch.tanh(xz[2] + r * hz[2])
                prev = 0 if zero_state else hcar[:, units]
                hnew[:, units] = z * prev + (1 - z) * hh
        hcar = hnew
        hb = torch.zeros(B, kx - o_h)
        hb[:, :U] = _bf(hnew)
        hi = torch.zeros(B, hp)
        for j, b in enumerate(blocks):
            cols = slice(b["i0"], b["i1"])
            if b["i1"] > b["i0"]:
                hi[:, cols] = _bf(fused_decode.leaky_relu(
                    _chunked(hb, wi[:, cols], j) + a["bi"][cols], slope))
        hw_tiles(hcar)
        best = torch.full((B, len(blocks)), -torch.inf)
        idx = torch.full((B, len(blocks)), -1)
        for j, b in enumerate(blocks):
            if b["o1"] > b["o0"]:
                cols = slice(b["o0"], b["o1"])
                logits = _chunked(hi, wo[:, cols], j) + a["bo"][cols]
                best[:, j] = logits.max(dim=1).values
                idx[:, j] = b["o0"] + logits.argmax(dim=1)
        word = idx.gather(1, best.argmax(dim=1, keepdim=True))[:, 0]
        x = torch.cat([x[:, :o_h], hb], dim=1)
        words.append(word)
        alphas.append(alpha)
    return torch.stack(words, 1).to(torch.int32), torch.stack(alphas, 1)


def _gru_case(B, R, A, D, E, U, H, V, seed=0):
    """K3's arguments beside _decode_case's K2 ones: Wx and Wh cut to three
    gates, separate input and recurrent biases, no c0."""
    args = list(_decode_case("cpu", B, R, A, D, E, U, H, V, seed))
    gen = torch.Generator().manual_seed(seed + 1)
    args[6] = args[6][:, :3 * U].contiguous()
    args[7] = args[7][:, :3 * U].contiguous()
    args[8:9] = [torch.randn(3 * U, generator=gen) * 0.5,
                 torch.randn(3 * U, generator=gen) * 0.5]
    return args[:-1]


WALKS = {
    # (cell, zero_state, shape, sms): one block an SM, and few SMs, where
    # blocks take several rows, units panels and vocab panels
    "lstm-b70-u40": ("lstm", False, "b70-u40", 132),
    "lstm-b70-u40-8sms": ("lstm", False, "b70-u40", 8),
    "lstm-unaligned-3sms": ("lstm", False, "unaligned", 3),
    "lstm-b70-u40-3sms": ("lstm", False, "b70-u40", 3),
    "lstm-b130-u300-3sms": ("lstm", False, "b130-u300", 3),
    "gru-carried-b130-u300-4sms": ("gru", False, "b130-u300", 4),
    "gru-zero-b70-u40": ("gru", True, "b70-u40", 132),
}


@pytest.mark.parametrize("feat", [False, True])
@pytest.mark.parametrize("walk_case", list(WALKS))
def test_the_plan_walked_in_torch_gives_the_plain_version_s_decode(
        walk_case, feat):
    cell, zero, shape, sms = WALKS[walk_case]
    B, R, A, D, E, U, H, V = DECODE_SHAPES[shape]
    args = (_gru_case if cell == "gru" else
            lambda *s: _decode_case("cpu", *s))(B, R, A, D, E, U, H, V)
    args = fused_decode.cast_decode_inputs(cell, args, weights_bf16=True,
                                           feat_bf16=feat)
    reference = (fused_decode.fused_greedy_decode_gru_reference
                 if cell == "gru"
                 else fused_decode.fused_greedy_decode_reference)
    opts = dict(slope=0.2, attn_slope=0.2)
    if cell == "gru":
        opts["zero_state"] = zero
    Vp = args[fused_decode.DECODE_ARGS[cell].index("wo")].shape[1]
    for T, atol, tie in ((1, 1e-6, 1e-3), (15, 1e-3, 1e-2)):
        plan = decode_plan(cell, B, R, A, D, E, U, H, Vp, T, feat_bf16=feat,
                           zero_state=zero, sms=sms)
        words, alphas = walk(plan, cell, args, T, 0.2, 0.2, zero)
        ref = reference(*args, max_length=T, return_margins=True, **opts)
        report = fused_decode.compare_with_reference(
            words, alphas, *ref, alpha_atol=atol, tie_margin=tie)
        assert report["bad_rows"] == [], (T, report)
    assert len(torch.unique(ref[0])) >= 4


def test_a_block_may_own_several_panels():
    """At 3 SMs a block owns more than CELL_UNITS units and more than PW
    vocab columns, so its cell and its logits run in several panels (the
    CUDA tests run such plans on the card)."""
    B, R, A, D, E, U, H, V = DECODE_SHAPES["b130-u300"]
    plan = decode_plan("lstm", B, R, A, D, E, U, H, 384, 5, sms=3)
    assert max(b["u1"] - b["u0"] for b in plan.blocks) > CELL_UNITS
    assert max(b["o1"] - b["o0"] for b in plan.blocks) > PW
