"""Show, Attend and Tell from pixels on EfficientNet-B3 (Tan & Le 2019,
arXiv:1905.11946, at the widths of ``keras.applications.EfficientNetB3``
with ``include_top=False``), whose top map (after ``top_conv``, its
BatchNorm and swish) is the attention features of the thesis' CNN_RNN
captioner (arXiv:1502.03044). In plain PyTorch: the benchmark's reference
of the ``cnn_rnn_efficientnet`` family, in inference, with the family's
raw rows and weights drawn from the seed and its model FLOPs.

The backbone follows Keras' ``efficientnet.py`` block by block, in NCHW:
the stem (a 3x3 stride-2 convolution, BatchNorm, swish); 26 MBConv blocks
in 7 stages (``BLOCKS``), each a 1x1 expansion by 6 with BatchNorm and
swish (not in the first stage, whose ratio is 1), a depthwise 3x3 or 5x5
convolution (``groups`` = channels) with BatchNorm and swish,
squeeze-and-excitation (the spatial mean, a 1x1 reduction to a quarter of
the block's input channels with bias and swish, a 1x1 expansion with bias
and a sigmoid, the product with every channel), a 1x1 projection with
BatchNorm and no activation, and the residual where the stride is 1 and
the widths match; then ``top_conv`` (1x1 to 1,536), BatchNorm and swish.
Every BatchNorm is Keras' default (scale and shift, epsilon 1e-3) on its
running statistics: ``(x - mean) * rsqrt(var + 1e-3) * gamma + beta``;
swish is ``x * sigmoid(x)``. A stride-2 layer pads with Keras'
``correct_pad`` (one row and column fewer before than after at an even
side) and convolves "valid"; a stride-1 layer pads ``k // 2`` a side.
``LAYERS`` is the table of its 130 convolutions in the order Keras creates
them. The decoder is ``cnn_rnn.py``'s, on the (P, 1,536) patches of the top
map read row by row (P = 100 at 300 x 300).

Departures from Keras:

- Keras rescales and normalises the pixels inside the model (``Rescaling``
  and ``Normalization`` with ImageNet's mean and deviation); here
  ``preprocess`` does the same arithmetic, ``(x / 255 - mean) / std``,
  once, where the family's rows are stored (``programs/`` ``to_store``).
- Drop-connect (the blocks' ``Dropout`` before the residual) and the top's
  dropout are left out: they do nothing in inference.
- The weights are drawn by the rule of ``weights``, not read from ImageNet
  training.
- The captioner attends over the unpooled top map; the thesis pooled it to
  one 1,536-wide vector.

Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench.reference import cnn_rnn
from port_bench.reference.roofline import bound
from port_bench.reference.weights import draw

CHANNELS = 1536          # top_conv's: round_filters(1280) at width 1.2
EPSILON = 1e-3           # Keras BatchNormalization's default
SE_RATIO = 0.25
WIDTH, DEPTH = 1.2, 1.4  # EfficientNet-B3's coefficients
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)

# Keras' DEFAULT_BLOCKS_ARGS (B0): kernel, repeats, in, out, expand, stride
_STAGES = ((3, 1, 32, 16, 1, 1), (3, 2, 16, 24, 6, 2), (5, 2, 24, 40, 6, 2),
           (3, 3, 40, 80, 6, 2), (5, 3, 80, 112, 6, 1),
           (5, 4, 112, 192, 6, 2), (3, 1, 192, 320, 6, 1))


def round_filters(filters: int, divisor: int = 8) -> int:
    """Keras' ``round_filters`` at B3's width."""
    filters *= WIDTH
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def _blocks() -> tuple:
    """(name, in, out, kernel, stride, expand) of each MBConv block in
    Keras' order and names (``block1a``, ``block1b``, ``block2a``...)."""
    out = []
    for i, (k, repeats, cin, cout, expand, stride) in enumerate(_STAGES):
        cin, cout = round_filters(cin), round_filters(cout)
        for j in range(int(math.ceil(DEPTH * repeats))):
            out.append((f"block{i + 1}{chr(97 + j)}", cin if j == 0 else cout,
                        cout, k, stride if j == 0 else 1, expand))
    return tuple(out)


BLOCKS = _blocks()


def _table() -> tuple:
    """(name, in, out, kernel, stride, groups, kind) of every convolution
    in Keras' order; ``kind`` is ``conv`` (followed by BatchNorm), ``se``
    (a squeeze-and-excitation convolution with bias, on the 1 x 1 mean)."""
    stem = round_filters(32)
    t = [("stem_conv", 3, stem, 3, 2, 1, "conv")]
    for name, cin, cout, k, stride, expand in BLOCKS:
        mid, se = cin * expand, max(1, int(cin * SE_RATIO))
        if expand != 1:
            t.append((f"{name}_expand_conv", cin, mid, 1, 1, 1, "conv"))
        t += [(f"{name}_dwconv", mid, mid, k, stride, mid, "conv"),
              (f"{name}_se_reduce", mid, se, 1, 1, 1, "se"),
              (f"{name}_se_expand", se, mid, 1, 1, 1, "se"),
              (f"{name}_project_conv", mid, cout, 1, 1, 1, "conv")]
    t.append(("top_conv", BLOCKS[-1][2], CHANNELS, 1, 1, 1, "conv"))
    return tuple(t)


LAYERS = _table()
CONV = {row[0]: row for row in LAYERS}


def image_size(cfg: dict) -> tuple[int, int]:
    return tuple(cfg["image_size"])


def out_side(side: int, stride: int) -> int:
    """A "same" layer's output side: ``ceil(side / stride)``."""
    return -(-side // stride)


def top_side(size: int) -> int:
    """The side of the top map for an image side of ``size``: the stem and
    every stride-2 block halve it, rounding up."""
    for stride in (2,) + tuple(b[4] for b in BLOCKS):
        size = out_side(size, stride)
    return size


def patches(cfg: dict) -> int:
    """Patches of the top map: the decoder's regions."""
    h, w = image_size(cfg)
    n = top_side(h) * top_side(w)
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
    """Keras' in-model ``Rescaling(1 / 255)`` and ImageNet ``Normalization``
    of (N, H·W·3) RGB rows: ``(x / 255 - mean) / std`` per channel."""
    mean = torch.tensor(MEAN, dtype=rows.dtype, device=rows.device)
    std = torch.tensor(STD, dtype=rows.dtype, device=rows.device)
    x = rows.view(rows.shape[0], -1, 3) / 255.0
    return ((x - mean) / std).view(rows.shape)


def regions(cfg: dict) -> int:
    """What the attention weighs: the patches."""
    return patches(cfg)


# the rule of the backbone's weights: He-normal kernels (fan-in the
# kernel's window times its input channels a group), BatchNorm scales
# 1 + N(0, GAMMA²) and shifts N(0, BETA²), squeeze-and-excitation biases
# N(0, BETA²), and as running statistics those of each convolution's
# output over images drawn from the seed (``calibration_images``), as a
# trained network's are those of its data: each BatchNorm then takes its
# layer to N(beta, gamma²) before its swish, so the activations stay O(1)
# through the 26 blocks and their residuals, and the top's patches differ
# image to image. The statistics are taken over at least
# CALIBRATION_PATCHES positions of the top map: CALIBRATION images at
# 300 x 300, more on a smaller image. Over 8 images of 64 x 64 (32
# positions at the top) the late stages' variances come from too few
# samples, a new image's outputs leave them by a random factor, and the
# residual stream grows by ~2x a block to a top mean of ~86
BETA = 0.1
GAMMA = 0.1
CALIBRATION = 8
CALIBRATION_PATCHES = 800


def calibration_images(cfg: dict) -> int:
    """Images whose statistics the BatchNorms take: ``CALIBRATION``, or as
    many as give ``CALIBRATION_PATCHES`` top-map positions."""
    return max(CALIBRATION, -(-CALIBRATION_PATCHES // patches(cfg)))


def weights(cfg: dict, seed: int, device) -> dict:
    """The decoder's leaves (``cnn_rnn.weights`` of the same seed) and the
    backbone's: per convolution ``<name>.w`` (out, in / groups, k, k); per
    BatchNorm (named by its convolution) ``<name>.gamma``, ``.beta``,
    ``.mean`` and ``.var``; per squeeze-and-excitation convolution its bias
    ``<name>.b``; drawn from a second generator of the seed (``BETA``,
    ``GAMMA``, ``calibration_images``)."""
    out = cnn_rnn.weights(cfg, seed, device)
    shapes = {}
    for name, cin, cout, k, _, groups, kind in LAYERS:
        shapes[f"{name}.w"] = (cout, cin // groups, k, k)
        if kind == "se":
            shapes[f"{name}.b"] = (cout,)
        else:
            shapes[f"{name}.gamma"] = (cout,)
            shapes[f"{name}.beta"] = (cout,)
    gen = torch.Generator(device=device).manual_seed(
        (seed ^ 0xEFF1_C1E4_7B3D_0A5E) % 2**63)
    r = draw(shapes, gen, device, set())
    for name, cin, cout, k, _, groups, kind in LAYERS:
        out[f"{name}.w"] = r[f"{name}.w"] * math.sqrt(
            2.0 / (cin // groups * k * k))
        if kind == "se":
            out[f"{name}.b"] = BETA * r[f"{name}.b"]
        else:
            out[f"{name}.gamma"] = 1.0 + GAMMA * r[f"{name}.gamma"]
            out[f"{name}.beta"] = BETA * r[f"{name}.beta"]
    h, w = image_size(cfg)
    images = preprocess(draw_rows(cfg, calibration_images(cfg), gen,
                                  device))
    with torch.no_grad():
        backbone(out, images.view(-1, h, w, 3).permute(0, 3, 1, 2)
                 .contiguous())
    return out


def correct_pad(side: int, k: int) -> tuple[int, int]:
    """Keras' ``imagenet_utils.correct_pad`` of one axis: (before, after)
    for a stride-2 "valid" layer of kernel ``k``."""
    adjust = 1 - side % 2
    return k // 2 - adjust, k // 2


def conv(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """The table's convolution ``name``: explicit pads, then ``F.conv2d``
    (a squeeze-and-excitation one with its bias)."""
    _, _, _, k, stride, groups, kind = CONV[name]
    if stride == 2:
        top, bottom = correct_pad(x.shape[2], k)
        left, right = correct_pad(x.shape[3], k)
        x = F.pad(x, (left, right, top, bottom))
        pad = 0
    else:
        pad = k // 2
    return F.conv2d(x, w[f"{name}.w"], w.get(f"{name}.b"), stride=stride,
                    padding=pad, groups=groups)


def batch_norm(w: dict, name: str, y: torch.Tensor) -> torch.Tensor:
    """The BatchNorm after convolution ``name``. While ``weights`` draws
    them, one whose statistics ``w`` lacks takes those of ``y`` over the
    batch."""
    if f"{name}.mean" not in w:
        w[f"{name}.mean"] = y.mean(dim=(0, 2, 3))
        w[f"{name}.var"] = y.var(dim=(0, 2, 3), unbiased=False)
    mean, var, gamma, beta = (w[f"{name}.{p}"][:, None, None]
                              for p in ("mean", "var", "gamma", "beta"))
    return (y - mean) * torch.rsqrt(var + EPSILON) * gamma + beta


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def conv_bn(w: dict, name: str, x: torch.Tensor, act: bool = True):
    y = batch_norm(w, name, conv(w, name, x))
    return swish(y) if act else y


def depthwise_se(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """Block ``name``'s depthwise convolution with its BatchNorm and swish,
    and its squeeze-and-excitation: the gated output."""
    x = conv_bn(w, f"{name}_dwconv", x)
    se = x.mean(dim=(2, 3), keepdim=True)
    se = swish(conv(w, f"{name}_se_reduce", se))
    se = torch.sigmoid(conv(w, f"{name}_se_expand", se))
    return x * se


def block(w: dict, spec: tuple, x: torch.Tensor) -> torch.Tensor:
    """One MBConv block of ``BLOCKS``."""
    name, cin, cout, _, stride, expand = spec
    y = conv_bn(w, f"{name}_expand_conv", x) if expand != 1 else x
    y = depthwise_se(w, name, y)
    y = conv_bn(w, f"{name}_project_conv", y, act=False)
    if stride == 1 and cin == cout:
        y = y + x
    return y


def backbone(w: dict, images: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) preprocessed images -> the top map (B, 1536, h, w)."""
    x = conv_bn(w, "stem_conv", images)
    for spec in BLOCKS:
        x = block(w, spec, x)
    return conv_bn(w, "top_conv", x)


def encode_patches(w: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """Raw rows (B, H·W·3) -> the top map's patches (B, P, 1536), read row
    by row as Keras' reshape of the (h, w, 1536) map reads them."""
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


def layer_sides(size: int) -> dict:
    """(input side, output side) of every convolution of ``LAYERS`` for an
    image side of ``size``; a squeeze-and-excitation one reads the 1 x 1
    mean."""
    out, side = {}, size
    for name, _, _, _, stride, _, kind in LAYERS:
        if kind == "se":
            out[name] = (1, 1)
            continue
        out[name] = (side, out_side(side, stride))
        side = out[name][1]
    return out


def layer_macs(cfg: dict) -> dict:
    """Multiply-adds of each convolution of ``LAYERS`` on one image."""
    h, w = image_size(cfg)
    sh, sw = layer_sides(h), layer_sides(w)
    return {name: sh[name][1] * sw[name][1] * cout * (cin // groups) * k * k
            for name, cin, cout, k, _, groups, _ in LAYERS}


def backbone_flops(cfg: dict) -> float:
    """One image through the backbone (``reference/flops.py``'s rule):
    2 x the multiply-adds of every convolution of ``LAYERS`` at the
    configuration's image size; 3.65 GFLOP at 300 x 300."""
    return 2.0 * sum(layer_macs(cfg).values())


def _weights_n(names) -> int:
    """Values of the weights of the named convolutions: kernels, and a
    BatchNorm's four vectors or a squeeze-and-excitation bias."""
    n = 0
    for name in names:
        _, cin, cout, k, _, groups, kind = CONV[name]
        n += cout * (cin // groups * k * k + (1 if kind == "se" else 4))
    return n


def backbone_bound(cfg: dict, batch: int) -> dict:
    """``bound`` of the backbone on ``batch`` images in fp32: the images
    read once, every kernel, BatchNorm vector and bias read once, the
    patches written once, and ``backbone_flops`` an image."""
    nbytes = 4 * (batch * row_width(cfg) + _weights_n(CONV)
                  + batch * patches(cfg) * CHANNELS)
    return bound(nbytes, batch * backbone_flops(cfg))


def depthwise_se_bound(cfg: dict, batch: int) -> dict:
    """``bound`` of the 26 blocks' depthwise and squeeze-and-excitation
    part (the program's span ``encode.depthwise_se``) on ``batch`` images
    in fp32: each block's depthwise input read once and its gated output
    written once, the depthwise kernel, its BatchNorm and the
    squeeze-and-excitation weights read once, and the multiply-adds of the
    depthwise and the two squeeze-and-excitation convolutions. The count
    follows the algorithm, not an implementation."""
    h, w = image_size(cfg)
    sh, sw = layer_sides(h), layer_sides(w)
    macs = layer_macs(cfg)
    nbytes = flops = 0
    for name, *_ in BLOCKS:
        dw = f"{name}_dwconv"
        mid = CONV[dw][2]
        (ih, oh), (iw, ow) = sh[dw], sw[dw]
        nbytes += 4 * batch * mid * (ih * iw + oh * ow)
        parts = (dw, f"{name}_se_reduce", f"{name}_se_expand")
        nbytes += 4 * _weights_n(parts)
        flops += 2 * batch * sum(macs[p] for p in parts)
    return bound(nbytes, flops)


def caption_flops(cfg: dict) -> float:
    """One greedy caption: the backbone on its image, then ``cnn_rnn``'s
    count (the patch projection, ``pre`` and every decode step)."""
    return backbone_flops(cfg) + cnn_rnn.caption_flops(cfg)
