"""Show, Attend and Tell from pixels: InceptionV3 (Szegedy et al. 2016,
arXiv:1512.00567, at the widths of ``keras.applications.InceptionV3`` with
``include_top=False``) whose mixed10 map is the attention features of the
thesis' CNN_RNN captioner (arXiv:1502.03044; CNN_RNN/train.py extracts
them, CNN_RNN/model.py decodes them). In plain PyTorch: the benchmark's
reference of the ``cnn_rnn_inception`` family, in inference, with the
family's raw rows and weights drawn from the seed and its model FLOPs.

The backbone follows Keras' ``inception_v3.py`` branch by branch, in NCHW:
every convolution is ``conv2d_bn`` (``F.conv2d`` with no bias, Keras
"same" padding written out, a BatchNormalization without scale at epsilon
1e-3 on its running statistics, ReLU); the branches' 3x3 average pools
leave the padding out of the count (``AveragePooling2D(padding='same')``),
the reductions' 3x3 max pools are stride 2 "valid", and each block
concatenates its branches' channels in Keras' order. ``LAYERS`` is the
table of its 94 convolutions in the order Keras creates them. The decoder
is ``cnn_rnn.py``'s, on the (P, 2,048) patches of the mixed10 map read row
by row (P = 64 at 299 x 299).

Departures from Keras: none in the arithmetic. The input is (B, H·W·3)
rows of pixel values 0-255 in RGB, scaled once by ``preprocess`` (Keras'
``inception_v3.preprocess_input``, ``x / 127.5 - 1``), and the weights are
drawn by the rule of ``weights``, not read from ImageNet training.

Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench.reference import cnn_rnn
from port_bench.reference.roofline import bound
from port_bench.reference.weights import draw

CHANNELS = 2048          # mixed10's
EPSILON = 1e-3           # Keras BatchNormalization's default


def _table() -> tuple:
    """(name, in, out, kh, kw, stride, padding, side) of every convolution
    in Keras' order; ``side`` names the feature map it reads
    (``sides``)."""
    t = [("stem1", 3, 32, 3, 3, 2, "valid", "image"),
         ("stem2", 32, 32, 3, 3, 1, "valid", "s1"),
         ("stem3", 32, 64, 3, 3, 1, "same", "s2"),
         ("stem4", 64, 80, 1, 1, 1, "valid", "s3"),
         ("stem5", 80, 192, 3, 3, 1, "valid", "s3")]
    c = 192
    for i, pool in enumerate((32, 64, 64)):          # mixed0-2, 35 x 35
        m = f"mixed{i}"
        t += [(f"{m}.branch1x1", c, 64, 1, 1, 1, "same", "s5"),
              (f"{m}.branch5x5_1", c, 48, 1, 1, 1, "same", "s5"),
              (f"{m}.branch5x5_2", 48, 64, 5, 5, 1, "same", "s5"),
              (f"{m}.branch3x3dbl_1", c, 64, 1, 1, 1, "same", "s5"),
              (f"{m}.branch3x3dbl_2", 64, 96, 3, 3, 1, "same", "s5"),
              (f"{m}.branch3x3dbl_3", 96, 96, 3, 3, 1, "same", "s5"),
              (f"{m}.branch_pool", c, pool, 1, 1, 1, "same", "s5")]
        c = 64 + 64 + 96 + pool
    t += [("mixed3.branch3x3", c, 384, 3, 3, 2, "valid", "s5"),
          ("mixed3.branch3x3dbl_1", c, 64, 1, 1, 1, "same", "s5"),
          ("mixed3.branch3x3dbl_2", 64, 96, 3, 3, 1, "same", "s5"),
          ("mixed3.branch3x3dbl_3", 96, 96, 3, 3, 2, "valid", "s5")]
    c = 384 + 96 + c
    for i, c7 in zip(range(4, 8), (128, 160, 160, 192)):   # 17 x 17
        m = f"mixed{i}"
        t += [(f"{m}.branch1x1", c, 192, 1, 1, 1, "same", "s6"),
              (f"{m}.branch7x7_1", c, c7, 1, 1, 1, "same", "s6"),
              (f"{m}.branch7x7_2", c7, c7, 1, 7, 1, "same", "s6"),
              (f"{m}.branch7x7_3", c7, 192, 7, 1, 1, "same", "s6"),
              (f"{m}.branch7x7dbl_1", c, c7, 1, 1, 1, "same", "s6"),
              (f"{m}.branch7x7dbl_2", c7, c7, 7, 1, 1, "same", "s6"),
              (f"{m}.branch7x7dbl_3", c7, c7, 1, 7, 1, "same", "s6"),
              (f"{m}.branch7x7dbl_4", c7, c7, 7, 1, 1, "same", "s6"),
              (f"{m}.branch7x7dbl_5", c7, 192, 1, 7, 1, "same", "s6"),
              (f"{m}.branch_pool", c, 192, 1, 1, 1, "same", "s6")]
        c = 4 * 192
    t += [("mixed8.branch3x3_1", c, 192, 1, 1, 1, "same", "s6"),
          ("mixed8.branch3x3_2", 192, 320, 3, 3, 2, "valid", "s6"),
          ("mixed8.branch7x7x3_1", c, 192, 1, 1, 1, "same", "s6"),
          ("mixed8.branch7x7x3_2", 192, 192, 1, 7, 1, "same", "s6"),
          ("mixed8.branch7x7x3_3", 192, 192, 7, 1, 1, "same", "s6"),
          ("mixed8.branch7x7x3_4", 192, 192, 3, 3, 2, "valid", "s6")]
    c = 320 + 192 + c
    for i in (9, 10):                                   # 8 x 8
        m = f"mixed{i}"
        t += [(f"{m}.branch1x1", c, 320, 1, 1, 1, "same", "s7"),
              (f"{m}.branch3x3", c, 384, 1, 1, 1, "same", "s7"),
              (f"{m}.branch3x3_1", 384, 384, 1, 3, 1, "same", "s7"),
              (f"{m}.branch3x3_2", 384, 384, 3, 1, 1, "same", "s7"),
              (f"{m}.branch3x3dbl_1", c, 448, 1, 1, 1, "same", "s7"),
              (f"{m}.branch3x3dbl_2", 448, 384, 3, 3, 1, "same", "s7"),
              (f"{m}.branch3x3dbl_3", 384, 384, 1, 3, 1, "same", "s7"),
              (f"{m}.branch3x3dbl_4", 384, 384, 3, 1, 1, "same", "s7"),
              (f"{m}.branch_pool", c, 192, 1, 1, 1, "same", "s7")]
        c = 320 + 2 * 384 + 2 * 384 + 192
    assert c == CHANNELS
    return tuple(t)


LAYERS = _table()
CONV = {row[0]: row for row in LAYERS}


def sides(size: int) -> dict:
    """The side of each feature map the convolutions read, for an image
    side of ``size``: ``s1`` after stem1, ``s2`` after stem2 (and stem3),
    ``s3`` after the first max pool, ``s4`` after stem5, ``s5`` the 35 x 35
    blocks' (after the second max pool), ``s6`` the 17 x 17 blocks' (after
    mixed3), ``s7`` the 8 x 8 blocks' (after mixed8)."""
    def valid(n, k, s):
        return (n - k) // s + 1

    s = {"image": size}
    s["s1"] = valid(size, 3, 2)
    s["s2"] = valid(s["s1"], 3, 1)
    s["s3"] = valid(s["s2"], 3, 2)
    s["s4"] = valid(s["s3"], 3, 1)
    s["s5"] = valid(s["s4"], 3, 2)
    s["s6"] = valid(s["s5"], 3, 2)
    s["s7"] = valid(s["s6"], 3, 2)
    return s


def image_size(cfg: dict) -> tuple[int, int]:
    return tuple(cfg["image_size"])


def patches(cfg: dict) -> int:
    """Patches of the mixed10 map: the decoder's regions."""
    h, w = image_size(cfg)
    n = sides(h)["s7"] * sides(w)["s7"]
    if n != cfg["n_patches"] or cfg["in_channels"] != CHANNELS:
        raise ValueError(f"an image of {h} x {w} gives {n} patches of "
                         f"{CHANNELS} channels, the configuration states "
                         f"{cfg['n_patches']} of {cfg['in_channels']}")
    return n


def row_width(cfg: dict) -> int:
    """Values in one raw store row: an image's pixels, H·W·3 in RGB."""
    h, w = image_size(cfg)
    return h * w * 3


def draw_rows(cfg: dict, n: int, generator, device) -> torch.Tensor:
    """``n`` raw store rows: whole pixel values 0-255, uniform."""
    return torch.randint(0, 256, (n, row_width(cfg)), generator=generator,
                         device=device, dtype=torch.float32)


def preprocess(rows: torch.Tensor) -> torch.Tensor:
    """Keras' InceptionV3 ``preprocess_input``: pixels to [-1, 1]."""
    return rows / 127.5 - 1.0


def regions(cfg: dict) -> int:
    """What the attention weighs: the patches."""
    return patches(cfg)


# the rule of the backbone's weights: He-normal kernels, shifts N(0,
# BETA²), and as running statistics those of each convolution's output
# over CALIBRATION images drawn from the seed, as a trained network's are
# those of its data. The statistics take each layer's output back to
# N(beta, 1) before its ReLU, through all 94 layers; drawn statistics
# would not remove the part of a channel that no image moves, which then
# grows layer by layer until every image gives the same patches
BETA = 0.1
CALIBRATION = 8


def weights(cfg: dict, seed: int, device) -> dict:
    """The decoder's leaves (``cnn_rnn.weights`` of the same seed) and the
    backbone's: per convolution ``<name>.w`` (out, in, kh, kw) and its
    BatchNorm's ``<name>.beta``, ``<name>.mean`` and ``<name>.var``, drawn
    from a second generator of the seed (``BETA``, ``CALIBRATION``)."""
    out = cnn_rnn.weights(cfg, seed, device)
    shapes = {}
    for name, cin, cout, kh, kw, *_ in LAYERS:
        shapes[f"{name}.w"] = (cout, cin, kh, kw)
        shapes[f"{name}.beta"] = (cout,)
    gen = torch.Generator(device=device).manual_seed(
        (seed ^ 0x5EED_1CE7_BACB_0E5E) % 2**63)
    r = draw(shapes, gen, device, set())
    for name, cin, cout, kh, kw, *_ in LAYERS:
        out[f"{name}.w"] = r[f"{name}.w"] * math.sqrt(2.0 / (cin * kh * kw))
        out[f"{name}.beta"] = BETA * r[f"{name}.beta"]
    h, w = image_size(cfg)
    images = preprocess(draw_rows(cfg, CALIBRATION, gen, device))
    with torch.no_grad():
        backbone(out, images.view(-1, h, w, 3).permute(0, 3, 1, 2)
                 .contiguous())
    return out


def conv_bn(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """Keras' ``conv2d_bn`` of the table's convolution ``name``. While
    ``weights`` draws them, a convolution whose statistics ``w`` lacks
    takes those of its output over the batch."""
    _, _, _, kh, kw, stride, padding, _ = CONV[name]
    if padding == "same":
        # Keras "same" at stride 1 with an odd kernel: (k - 1) / 2 a side
        assert stride == 1 and kh % 2 == kw % 2 == 1, name
        pad = ((kh - 1) // 2, (kw - 1) // 2)
    else:
        pad = (0, 0)
    y = F.conv2d(x, w[f"{name}.w"], stride=stride, padding=pad)
    if f"{name}.mean" not in w:
        w[f"{name}.mean"] = y.mean(dim=(0, 2, 3))
        w[f"{name}.var"] = y.var(dim=(0, 2, 3), unbiased=False)
    mean, var, beta = (w[f"{name}.{p}"][:, None, None]
                       for p in ("mean", "var", "beta"))
    return torch.relu((y - mean) * torch.rsqrt(var + EPSILON) + beta)


def avg_pool(x):
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=False)


def max_pool(x):
    return F.max_pool2d(x, 3, 2)


def chain(w: dict, x, *names):
    for name in names:
        x = conv_bn(w, name, x)
    return x


def backbone(w: dict, images: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) images in [-1, 1] -> the mixed10 map (B, 2048, h, w)."""
    x = chain(w, images, "stem1", "stem2", "stem3")
    x = max_pool(x)
    x = chain(w, x, "stem4", "stem5")
    x = max_pool(x)
    for i in range(3):                                  # mixed0-2
        m = f"mixed{i}."
        x = torch.cat([
            conv_bn(w, m + "branch1x1", x),
            chain(w, x, m + "branch5x5_1", m + "branch5x5_2"),
            chain(w, x, m + "branch3x3dbl_1", m + "branch3x3dbl_2",
                  m + "branch3x3dbl_3"),
            conv_bn(w, m + "branch_pool", avg_pool(x))], dim=1)
    m = "mixed3."
    x = torch.cat([
        conv_bn(w, m + "branch3x3", x),
        chain(w, x, m + "branch3x3dbl_1", m + "branch3x3dbl_2",
              m + "branch3x3dbl_3"),
        max_pool(x)], dim=1)
    for i in range(4, 8):                               # mixed4-7
        m = f"mixed{i}."
        x = torch.cat([
            conv_bn(w, m + "branch1x1", x),
            chain(w, x, *(m + f"branch7x7_{j}" for j in (1, 2, 3))),
            chain(w, x, *(m + f"branch7x7dbl_{j}" for j in range(1, 6))),
            conv_bn(w, m + "branch_pool", avg_pool(x))], dim=1)
    m = "mixed8."
    x = torch.cat([
        chain(w, x, m + "branch3x3_1", m + "branch3x3_2"),
        chain(w, x, *(m + f"branch7x7x3_{j}" for j in range(1, 5))),
        max_pool(x)], dim=1)
    for i in (9, 10):                                   # mixed9-10
        m = f"mixed{i}."
        b3 = conv_bn(w, m + "branch3x3", x)
        bd = chain(w, x, m + "branch3x3dbl_1", m + "branch3x3dbl_2")
        x = torch.cat([
            conv_bn(w, m + "branch1x1", x),
            conv_bn(w, m + "branch3x3_1", b3),
            conv_bn(w, m + "branch3x3_2", b3),
            conv_bn(w, m + "branch3x3dbl_3", bd),
            conv_bn(w, m + "branch3x3dbl_4", bd),
            conv_bn(w, m + "branch_pool", avg_pool(x))], dim=1)
    return x


def encode_patches(w: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """Raw rows (B, H·W·3) -> the mixed10 patches (B, P, 2048), read row by
    row as Keras' reshape of the (h, w, 2048) map reads them."""
    h, wd = image_size(cfg)
    images = preprocess(x).view(x.shape[0], h, wd, 3).permute(0, 3, 1, 2)
    m = backbone(w, images.contiguous())
    return m.permute(0, 2, 3, 1).reshape(x.shape[0], patches(cfg), CHANNELS)


def teacher_forced(w: dict, cfg: dict, x, tokens):
    """Logits (B, T, V) and alphas (B, T, P) of the raw rows ``x`` on the
    input ``tokens`` (B, T): the backbone, then ``cnn_rnn``'s decoder."""
    feats = encode_patches(w, cfg, x)
    return cnn_rnn.teacher_forced(w, cfg, feats.reshape(x.shape[0], -1),
                                  tokens)


def backbone_flops(cfg: dict) -> float:
    """One image through the backbone (``reference/flops.py``'s rule):
    2 x the multiply-adds of every convolution of ``LAYERS`` at the
    configuration's image size; 11.42 GFLOP at 299 x 299."""
    h, w = image_size(cfg)
    sh, sw = sides(h), sides(w)
    macs = 0
    for _, cin, cout, kh, kw, stride, padding, side in LAYERS:
        oh, ow = sh[side], sw[side]
        if padding == "valid":
            oh, ow = (oh - kh) // stride + 1, (ow - kw) // stride + 1
        macs += oh * ow * cout * cin * kh * kw
    return 2.0 * macs


def backbone_bound(cfg: dict, batch: int) -> dict:
    """``bound`` of the backbone on ``batch`` images in fp32: the images
    read once, every kernel, shift and statistic read once, the patches
    written once, and ``backbone_flops`` an image."""
    weights_n = sum(cout * (cin * kh * kw + 3)
                    for _, cin, cout, kh, kw, *_ in LAYERS)
    nbytes = 4 * (batch * row_width(cfg) + weights_n
                  + batch * patches(cfg) * CHANNELS)
    return bound(nbytes, batch * backbone_flops(cfg))


def caption_flops(cfg: dict) -> float:
    """One greedy caption: the backbone on its image, then ``cnn_rnn``'s
    count (the patch projection, ``pre`` and every decode step)."""
    return backbone_flops(cfg) + cnn_rnn.caption_flops(cfg)
