"""The collectives of a sharded step and the placement its layers read.

The JAX package leaves every collective to XLA: GSPMD partitions one global
program over the ('data', 'model') mesh (``parallel/mesh.py`` there). Here
each rank runs the single-device program on its own rows and its own
parameter shards, and the layers insert the collectives themselves, in the
conjugate pairs of tensor parallelism:

- ``reduce_from_model``: the model group's sum forward, the identity
  backward: the encoder's partial products over its voxel shards, the
  vocab-sharded embedding's lookups, a sharded leaf's L2 term;
- ``copy_to_model``: the identity forward, the model group's sum backward:
  the replicated input of the vocab-sharded head;
- ``gather_from_model``: the model group's shards side by side forward, this
  rank's slice of the gradient backward: the head's logits, a sharded leaf
  that a layer reads whole;
- ``sum_over_data``: the data group's sum forward and backward: BatchNorm's
  batch statistics over the global batch.

Every collective is an ``all_reduce``: gloo takes only ``all_reduce`` and
``broadcast`` of CUDA tensors, and ranks that share one card run gloo (NCCL
refuses two ranks on one device), so a gather is the sum of zero-padded
buffers, in which each element has one non-zero addend and comes out exact.

``Placement`` is what the running step tells its layers: the mesh, this
rank's rows of the global batch, the names of the parameters whose shard a
layer computes with (``tp``) and, for a voxel-sharded input, the columns of
the single-device input that this rank holds. ``placement(...)`` makes it
active for a block; a layer outside any block runs as it does on one
device. Dropout masks are drawn at the global batch's shape and sliced to
this rank's rows (``batch_rand``), so a sharded step drops what the
single-device step on the whole batch drops.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Placement:
    """``rows``: this rank's rows' ids in the global batch of ``n_rows``
    (a LongTensor on the rank's device). ``tp``: the state-dict names of the
    parameters held as shards that their layer computes with.
    ``input_cols``/``input_width``: the columns of a single-device input row
    of ``input_width`` that this rank's input rows hold, when its input is
    voxel-sharded."""

    mesh: object
    rows: torch.Tensor
    n_rows: int
    tp: frozenset = frozenset()
    input_cols: torch.Tensor | None = None
    input_width: int | None = None


_ACTIVE: list[Placement] = []


def active() -> Placement | None:
    """The placement of the running sharded step, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def placement(p: Placement):
    _ACTIVE.append(p)
    try:
        yield p
    finally:
        _ACTIVE.pop()


@contextlib.contextmanager
def sub_rows(first: int, count: int, n_rows: int):
    """Within a placement, a block that runs on ``count`` of this rank's
    rows from ``first``, which are rows of a global batch of ``n_rows``
    whose ids start at the first of them rounded down to ``n_rows``: the
    ms2_nic encoders' halves. Outside a placement it does nothing."""
    p = active()
    if p is None:
        yield None
        return
    rows = p.rows[first:first + count]
    with placement(dataclasses.replace(p, rows=rows % n_rows, n_rows=n_rows,
                                       input_cols=None)) as q:
        yield q


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in place; nothing for a group of one
    (``group`` None)."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def all_gather(x: torch.Tensor, dim: int, index: int, size: int,
               group) -> torch.Tensor:
    """The ``size`` shards of ``group`` side by side along ``dim``, this
    rank's ``x`` at ``index``: an all-reduce of zero-padded buffers."""
    if group is None:
        return x
    shape = list(x.shape)
    n = shape[dim]
    shape[dim] = n * size
    buf = x.new_zeros(shape)
    buf.narrow(dim, index * n, n).copy_(x)
    return all_reduce(buf, group)


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.group), None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, index, size, group):
        ctx.slot = (dim, index, x.shape[dim])
        return all_gather(x, dim, index, size, group)

    @staticmethod
    def backward(ctx, grad):
        dim, index, n = ctx.slot
        return (grad.narrow(dim, index * n, n).contiguous(), None, None,
                None, None)


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.group), None


def _mesh():
    p = active()
    if p is None:
        raise RuntimeError("a sharded layer runs only inside a sharded step "
                           "(parallel.collectives.placement)")
    return p.mesh


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    mesh = _mesh()
    return _ReduceFromGroup.apply(x, mesh.model_group)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    mesh = _mesh()
    return _CopyToGroup.apply(x, mesh.model_group)


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    mesh = _mesh()
    return _GatherFromGroup.apply(x, dim % x.dim(), mesh.m, mesh.model,
                                  mesh.model_group)


def sum_over_data(x: torch.Tensor) -> torch.Tensor:
    mesh = _mesh()
    return _SumOverGroup.apply(x, mesh.data_group)


# ---- what the layers call ----

def batch_rand(shape, generator, device, columns: bool = False):
    """``torch.rand(shape)`` with this rank's rows of the draw at the global
    batch's shape inside a placement (and, with ``columns``, this rank's
    columns of a voxel-sharded input row), so that a sharded step's masks
    are the single-device step's."""
    p = active()
    if p is None:
        return torch.rand(shape, generator=generator, device=device)
    if shape[0] != len(p.rows):
        raise ValueError(f"a mask of {shape[0]} rows inside a step of "
                         f"{len(p.rows)} rows on this rank")
    sharded = columns and p.input_cols is not None
    full = (p.n_rows, p.input_width) if sharded else (p.n_rows, *shape[1:])
    mask = torch.rand(full, generator=generator, device=device)
    mask = mask.index_select(0, p.rows)
    return mask.index_select(1, p.input_cols) if sharded else mask


def batch_moments(x: torch.Tensor, axes: tuple) -> tuple:
    """(biased variance, mean) over ``axes``: over the global batch inside a
    placement whose data axis is wider than one, from sums over the data
    group (the mean first, then the squared deviations from it)."""
    p = active()
    if p is None or p.mesh.data_group is None:
        return torch.var_mean(x, dim=axes, correction=0)
    count = x.new_tensor([x.numel() // x.shape[-1]])
    sums = sum_over_data(torch.cat([x.sum(dim=axes), count]))
    mean = sums[:-1] / sums[-1]
    var = sum_over_data(torch.square(x - mean).sum(dim=axes)) / sums[-1]
    return var, mean


def global_sums(*values: torch.Tensor) -> list[torch.Tensor]:
    """Scalars summed over the data group inside a placement (no
    gradient); as they are outside one."""
    p = active()
    if p is None or p.mesh.data_group is None:
        return list(values)
    total = all_reduce(torch.stack([v.detach().float() for v in values]),
                       p.mesh.data_group)
    return list(total)


def is_sharded(name: str) -> bool:
    """Is the parameter ``name`` a shard its layer computes with?"""
    p = active()
    return p is not None and name in p.tp


def vocab_parallel_embedding(tokens: torch.Tensor,
                             rows: torch.Tensor) -> torch.Tensor:
    """The embedding of ``tokens`` from this rank's ``rows`` of a
    vocab-sharded table: its own ids looked up, the others zero, summed over
    the model group."""
    mesh = _mesh()
    n = rows.shape[0]
    local = tokens - mesh.m * n
    inside = (local >= 0) & (local < n)
    emb = F.embedding(local.clamp(0, n - 1), rows)
    return reduce_from_model(emb * inside[..., None].to(emb.dtype))


def vocab_parallel_dense(x: torch.Tensor, kernel: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """``x @ kernel + bias`` with this rank's columns of a vocab-sharded
    kernel: the replicated input's products on each rank, side by side;
    a bf16 operand against an fp32 one is promoted, as in ``Dense``."""
    dtype = torch.promote_types(x.dtype, kernel.dtype)
    return gather_from_model(copy_to_model(x.to(dtype)) @ kernel.to(dtype),
                             -1) + bias
