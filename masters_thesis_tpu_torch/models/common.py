"""Keras-parity building blocks in PyTorch: initialisers, activations,
BatchNorm constants, dropout, and the two small layers every model shares.

Counterpart of ``masters_thesis_tpu/models/common.py``. Initialisers take an
explicit ``torch.Generator`` and return a new CPU tensor; they follow the
distributions of the JAX package (``jax.nn.initializers``), not its numbers,
because the two frameworks draw different bits from the same seed. Tests
that compare the two packages transplant the flax weights instead.

Layers keep flax's parameter layout: a Dense kernel is (in, out), not
torch's (out, in), so state-dict keys and shapes match the flax tree one to
one (see ``masters_thesis_tpu_torch/transplant.py``).

Mixed dtypes follow flax and ``jnp``, since a bf16 training forward
(``tpu.compute_dtype``) runs on bf16 copies of fp32 parameters beside fp32
carries and statistics: a product of a bf16 and an fp32 tensor promotes
both to fp32 (``promote``, ``matmul``; torch refuses such a product), a
product that JAX takes with ``preferred_element_type=float32`` rounds
nothing and sums in fp32 (``matmul_f32``), BatchNorm takes its batch
statistics in fp32, and dropout keeps its input's dtype.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
from torch import nn

from masters_thesis_tpu_torch.parallel.collectives import (
    batch_moments,
    batch_rand,
)

BN_MOMENTUM = 0.99
BN_EPSILON = 1e-3
NEGATIVE_SLOPE = 0.2  # LeakyReLU(0.2) throughout lc_NIC
VOCAB_PAD_NEG = -1e9
# the head's and the attention's activations by name, as the negative slope
# that the decode kernels and their plain versions take (1: identity)
ACTIVATION_SLOPES = {"leaky_relu": NEGATIVE_SLOPE, "relu": 0.0, "linear": 1.0}

# jax.nn.initializers' truncated-normal std correction (truncation at ±2)
_TRUNC_STD = 0.87962566103423978


def _fans(shape) -> tuple[int, int]:
    """(fan_in, fan_out) of an (in, out) kernel, as jax computes them."""
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def truncated_normal(shape, std: float, generator=None) -> torch.Tensor:
    """N(0, std) truncated at ±2 std, with jax's std correction."""
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w * (std / _TRUNC_STD)


def glorot_uniform(shape, generator=None) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


def glorot_normal(shape, generator=None) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    return truncated_normal(shape, math.sqrt(2.0 / (fan_in + fan_out)),
                            generator)


def he_normal(shape, generator=None) -> torch.Tensor:
    return truncated_normal(shape, math.sqrt(2.0 / _fans(shape)[0]),
                            generator)


def lecun_normal(shape, generator=None) -> torch.Tensor:
    """flax ``nn.Dense``'s default kernel initialiser."""
    return truncated_normal(shape, math.sqrt(1.0 / _fans(shape)[0]),
                            generator)


def orthogonal(shape, generator=None) -> torch.Tensor:
    w = torch.empty(shape)
    nn.init.orthogonal_(w, generator=generator)
    return w


def embedding_init(shape, generator=None) -> torch.Tensor:
    """RandomUniform(-0.08, 0.08) (lc_NIC.py:108)."""
    return torch.empty(shape).uniform_(-0.08, 0.08, generator=generator)


def unit_forget_bias(shape, generator=None) -> torch.Tensor:
    """Keras LSTM bias: zeros with the forget-gate slice set to 1."""
    units = shape[0] // 4
    b = torch.zeros(shape)
    b[units:2 * units] = 1.0
    return b


def pad_zero_rows(init, true_rows: int):
    """Wrap an initialiser: rows >= true_rows come out exactly zero."""
    def f(shape, generator=None):
        w = init(shape, generator)
        if true_rows and true_rows < shape[0]:
            w[true_rows:] = 0
        return w
    return f


def pad_zero_cols(init, true_cols: int):
    """Wrap an initialiser: last-axis cols >= true_cols come out zero."""
    def f(shape, generator=None):
        w = init(shape, generator)
        if true_cols and true_cols < shape[-1]:
            w[..., true_cols:] = 0
        return w
    return f


def leaky_relu(x: torch.Tensor,
               negative_slope: float = NEGATIVE_SLOPE) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


def activation(x: torch.Tensor, name: str) -> torch.Tensor:
    """``leaky_relu`` (slope 0.2), ``relu`` or ``linear`` (identity)."""
    if name == "leaky_relu":
        return leaky_relu(x)
    if name == "relu":
        return torch.relu(x)
    if name == "linear":
        return x
    raise ValueError(f"activation {name!r}: expected one of "
                     f"{sorted(ACTIVATION_SLOPES)}")


def promote(*tensors: torch.Tensor) -> list[torch.Tensor]:
    """flax ``promote_dtype``: every tensor in the dtype they all promote
    to (bf16 with fp32 -> fp32)."""
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    return [t.to(dtype) for t in tensors]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.matmul``: both operands promoted to one dtype first (bf16 with
    bf16 stays bf16, as the JAX dot rounds its fp32 sum to bf16)."""
    a, b = promote(a, b)
    return a @ b


def matmul_f32(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(spec, a, b, preferred_element_type=float32)``: the
    operands as they are (a bf16 value is exact in fp32), the products
    summed and returned in fp32, nothing rounded to bf16."""
    return torch.einsum(spec, a.float(), b.float())


@contextlib.contextmanager
def parameters_from(slots, tensors):
    """Inside, each (module, name) of ``slots`` holds the matching tensor of
    ``tensors`` as its parameter; the parameters come back after."""
    kept = [m._parameters[name] for m, name in slots]
    try:
        for (m, name), t in zip(slots, tensors):
            m._parameters[name] = t
        yield
    finally:
        for (m, name), t in zip(slots, kept):
            m._parameters[name] = t


def parameters_as(module: nn.Module, dtype: torch.dtype):
    """Inside, every fp32 parameter of ``module`` is a ``dtype`` copy made
    by one differentiable cast, so a backward through the forward run
    inside lands its gradients on the fp32 parameters themselves (flax's
    ``tree_map(astype)`` of the masters); buffers keep their dtype. The
    identity at fp32."""
    slots = [] if dtype == torch.float32 else [
        (m, name) for m in module.modules()
        for name, p in m._parameters.items()
        if p is not None and p.dtype == torch.float32]
    return parameters_from(slots, [m._parameters[name].to(dtype)
                                   for m, name in slots])


def widen_carry(x: torch.Tensor) -> torch.Tensor:
    """A recurrent carry in at least fp32: bf16 widened, as the JAX scans
    re-cast theirs after every cell under a bf16 compute dtype; a float64
    model's (the checks') kept float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def dropout(x: torch.Tensor, rate: float, generator=None,
            training: bool = False, columns: bool = False) -> torch.Tensor:
    """flax ``nn.Dropout``: in training, keep each element with probability
    1 - rate and scale kept ones by 1 / (1 - rate); the identity otherwise
    and at rate 0. The mask is drawn from ``generator`` (on ``x``'s
    device), so one seed gives one mask on either framework's side only.
    Inside a sharded step it is this rank's rows of the global batch's
    mask, and with ``columns`` (the model's input) this rank's columns of a
    voxel-sharded row (``parallel.collectives.batch_rand``)."""
    if not training or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = batch_rand(x.shape, generator, x.device, columns) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def mask_padded_vocab(logits: torch.Tensor, true_vocab: int) -> torch.Tensor:
    """-1e9 on padded vocab slots (no-op when true_vocab covers the axis).

    Must be the head's last op: masking before an activation would let the
    activation change the mask."""
    V = logits.shape[-1]
    if not true_vocab or true_vocab >= V:
        return logits
    pad = torch.arange(V, device=logits.device) >= true_vocab
    return logits.masked_fill(pad, VOCAB_PAD_NEG)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` with kernel (in, out)."""

    def __init__(self, in_features: int, out_features: int,
                 kernel_init=lecun_normal, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(
            kernel_init((in_features, out_features), generator))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, kernel, bias = promote(x, self.kernel, self.bias)
        return x @ kernel + bias


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis with Keras' constants:
    running statistics ``mean``/``var`` are buffers (flax's
    ``batch_stats``), ``scale``/``bias`` are parameters.

    In training, the statistics are those of the batch over every axis but
    the last (of the global batch inside a sharded step, whose data axis
    is wider than one: ``parallel.collectives.batch_moments``), the
    variance is the biased one, and the running statistics move in place
    as ``ra = 0.99 ra + 0.01 batch``, as flax's do. The batch statistics
    are taken in at least fp32 and the running ones stay fp32; the output
    is in the dtype that x, scale and bias promote to (flax
    ``_compute_stats`` and ``_normalize``).
    ``torch.nn.BatchNorm*`` would use the unbiased variance for the running
    update and a momentum of 0.01 in the other sense."""

    def __init__(self, features: int, epsilon: float = BN_EPSILON):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        if training:
            axes = tuple(range(x.ndim - 1))
            var, mean = batch_moments(
                x.to(torch.promote_types(x.dtype, torch.float32)), axes)
            with torch.no_grad():
                m = BN_MOMENTUM
                self.mean.mul_(m).add_((1 - m) * mean)
                self.var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = self.scale * torch.rsqrt(var + self.epsilon)
        out = (x - mean) * mul + self.bias
        return out.to(promote(x, self.scale, self.bias)[0].dtype)
