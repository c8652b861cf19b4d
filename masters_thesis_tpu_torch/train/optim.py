"""The optimizer chain of the train step, with optax's meaning, in PyTorch.

Counterpart of ``masters_thesis_tpu/train/optim.py`` (reference
AttemptFour/main.py:96-104, Model/agc.py). In order, on the raw gradients:

1. adaptive gradient clipping (``agc_clip`` > 0), unitwise norms;
2. Keras ``clipnorm``: each gradient TENSOR clipped by its own norm, with no
   global norm (``torch.nn.utils.clip_grad_norm_`` is the global one);
3. Adam (beta_2 0.98, eps outside the square root) or SGD with momentum 0.9,
   no Nesterov.

The learning rate is a schedule evaluated at optax's step count: the count
BEFORE the update's increment, so linear warmup gives 0 at the first step.
Schedules compute in fp32, one operation at a time, as optax writes them.
Updates happen in place on the parameters, under ``torch.no_grad``.
"""

from __future__ import annotations

import math

import torch

# ---- gradient transforms (lists of tensors in, new list out) ----


def clip_by_per_tensor_norm(grads, max_norm: float) -> list[torch.Tensor]:
    """``tf.clip_by_norm`` tensor by tensor: a norm above ``max_norm``
    scales that tensor by max_norm / (norm + 1e-12)."""
    out = []
    for g in grads:
        norm = torch.linalg.vector_norm(g)
        out.append(g * torch.where(norm > max_norm, max_norm / (norm + 1e-12),
                                   1.0))
    return out


def _unitwise_norm(x: torch.Tensor) -> torch.Tensor:
    """NFNet unitwise norm (Model/agc.py:6-18): the whole tensor for <= 1-D,
    per output unit (axis 0) for 2-D and 3-D kernels, per filter (axes 0, 1,
    2) for 4-D conv kernels."""
    if x.ndim <= 1:
        return torch.sqrt(torch.sum(torch.square(x)))
    dims = (0,) if x.ndim in (2, 3) else (0, 1, 2)
    return torch.sqrt(torch.sum(torch.square(x), dim=dims, keepdim=True))


def adaptive_grad_clip(grads, params, clip_factor: float,
                       eps: float = 1e-3) -> list[torch.Tensor]:
    """NFNet AGC: a unit whose gradient norm reaches clip_factor times its
    weight norm (at least ``eps``) is scaled back to that bound."""
    out = []
    for g, w in zip(grads, params):
        max_norm = torch.clamp(_unitwise_norm(w), min=eps) * clip_factor
        g_norm = _unitwise_norm(g)
        clipped = g * (max_norm / torch.clamp(g_norm, min=1e-6))
        out.append(torch.where(g_norm < max_norm, g, clipped))
    return out


# ---- schedules: count (python int) -> learning rate (python float) ----


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def constant_schedule(value: float):
    return lambda count: value


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int):
    """optax.linear_schedule."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count: int) -> float:
        count = torch.tensor(min(max(count, 0), transition_steps),
                             dtype=torch.int32)
        frac = 1 - count / transition_steps
        return float((init_value - end_value) * frac ** 1 + end_value)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0):
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs decay_steps > 0, got "
                         f"{decay_steps}")

    def schedule(count: int) -> float:
        count = _f32(min(float(count), float(decay_steps)))
        decay = 0.5 * (1 + torch.cos(math.pi * count / float(decay_steps)))
        return float(init_value * ((1 - alpha) * decay ** 1.0 + alpha))

    return schedule


def join_schedules(schedules, boundaries):
    """optax.join_schedules: past boundary i, schedule i + 1 runs on the
    count since that boundary."""
    def schedule(count: int) -> float:
        value = schedules[0](count)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if count >= boundary:
                value = fn(count - boundary)
        return value

    return schedule


def warmup_schedule(base_lr: float, warmup_steps: int):
    """Linear warmup from 0, then constant (WarmupScheduler.py)."""
    if warmup_steps <= 0:
        return constant_schedule(base_lr)
    return join_schedules([linear_schedule(0.0, base_lr, warmup_steps),
                           constant_schedule(base_lr)], [warmup_steps])


# ---- the chain ----


class Optimizer:
    """AGC -> per-tensor clipnorm -> Adam or SGD over ``params``, updated
    in place by ``step(grads)``. ``count`` is optax's step count."""

    def __init__(self, params, lr, name: str = "adam", beta_1: float = 0.9,
                 beta_2: float = 0.98, epsilon: float = 1e-8,
                 clipnorm: float = 0.0, agc_clip: float = 0.0):
        self.params = list(params)
        self.lr = lr if callable(lr) else constant_schedule(lr)
        self.name = name.lower()
        if self.name not in ("adam", "sgd"):
            raise ValueError(f"unknown optimizer {name!r}")
        self.beta_1, self.beta_2, self.epsilon = beta_1, beta_2, epsilon
        self.clipnorm, self.agc_clip = clipnorm, agc_clip
        self.count = 0
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        if self.name == "adam":
            self.mu, self.nu = zeros(), zeros()
        else:
            self.trace = zeros()

    @torch.no_grad()
    def step(self, grads) -> None:
        grads = list(grads)
        if self.agc_clip:
            grads = adaptive_grad_clip(grads, self.params, self.agc_clip)
        if self.clipnorm:
            grads = clip_by_per_tensor_norm(grads, self.clipnorm)
        step_size = -self.lr(self.count)
        self.count += 1
        if self.name == "sgd":
            for p, g, t in zip(self.params, grads, self.trace):
                t.mul_(0.9).add_(g)                  # optax.trace, decay 0.9
                p.add_(t * step_size)
            return
        b1, b2 = self.beta_1, self.beta_2
        bc1 = float(1 - _f32(b1) ** self.count)
        bc2 = float(1 - _f32(b2) ** self.count)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * torch.square(g))
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.epsilon)
            p.add_(update * step_size)


def make_optimizer(cfg, params, schedule=None) -> Optimizer:
    """The configured chain (``make_optimizer`` of the JAX package) over
    ``params``. The learning rate: ``schedule`` if given; else a cosine
    decay over ``cosine_decay_steps`` (after a linear warmup when
    ``warmup_steps`` is set); else a warmup alone; else ``alpha``."""
    if schedule is not None:
        lr = schedule
    elif cfg.cosine_decay_steps:
        decay = cosine_decay_schedule(cfg.alpha, cfg.cosine_decay_steps)
        lr = (join_schedules([linear_schedule(0.0, cfg.alpha,
                                              cfg.warmup_steps), decay],
                             [cfg.warmup_steps])
              if cfg.warmup_steps else decay)
    elif cfg.warmup_steps:
        lr = warmup_schedule(cfg.alpha, cfg.warmup_steps)
    else:
        lr = cfg.alpha
    return Optimizer(params, lr, cfg.optimizer, cfg.beta_1, cfg.beta_2,
                     cfg.epsilon, cfg.clipnorm, cfg.agc_clip)
