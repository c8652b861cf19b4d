"""Sharding rules, sharded state, input placement and the sharded steps.

Counterpart of ``masters_thesis_tpu/parallel/sharding.py``, with its layout:

- batch rows:                                      over 'data'
- LocallyDense bucket kernels (G, P, D):           P over 'model'
- other rank-2 encoder kernels (N, D) / (C, D):    input axis over 'model'
- embedding (V, E) and dense_out kernel (., V):    vocab axis over 'model'
- everything else:                                 replicated

``param_spec`` is the JAX ``param_pspec``'s decisions, framework-free,
over a parameter's flax path (the port's state-dict names split at the
dots) and shape: a dimension the model axis does not divide is replicated,
with one warning a parameter and model size.

Where XLA partitions one global program, each rank here runs its own rows
through its own shards, and the layers insert the collectives
(``parallel.collectives``): the flagship's bucket kernels, embedding and
head compute with their shards (tensor parallel: the encoder's partial
products summed over the model group, the embedding a vocab-sharded
lookup, the head's logits gathered), and a sharded leaf of any other layer
is gathered whole for the forward and hands back its slice of the
gradient. Gradients are averaged over the data group, BatchNorm takes the
global batch's statistics, and every dropout mask is this rank's slice of
the global batch's, so a sharded run takes the single-device run's steps.

``shard_params`` keeps each rank's slice of every sharded parameter and
Adam moment; ``gather_state_dict``/``gather_slots`` are the inverse, for
checkpoints and reports. ``MeshInputPlacer`` gives rank (d, m) its rows of
each global batch (contiguous, as the JAX mesh shards a batch) and, for a
voxel-sharded encoder, the columns ``rank_columns`` of the grouped layout
(each bucket's slice of every group side by side, so that a row stays
contiguous and K1 copies it whole); ``shard_store_array`` lays a store out
so once, at upload.
"""

from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch

from masters_thesis_tpu_torch.parallel.collectives import (
    Placement,
    all_gather,
    all_reduce,
    gather_from_model,
    placement,
)

logger = logging.getLogger("masters_thesis_tpu_torch")

_warned_replicated: set = set()


def param_spec(path_names, shape, model_size: int = 1) -> tuple:
    """The sharding of one parameter, by its flax path and shape, as the
    entries of the JAX ``PartitionSpec`` ("model" on the sharded axis,
    None elsewhere; () when replicated). A dimension the model axis does
    not divide falls back to replication, with a warning."""
    names = [str(n) for n in path_names]
    joined = "/".join(names)
    shape = tuple(shape)

    def ok(dim):
        if not (model_size > 0 and len(shape) > dim):
            return False
        if shape[dim] % model_size == 0:
            return True
        key = (joined, model_size)
        if key not in _warned_replicated:
            _warned_replicated.add(key)
            logger.warning(
                "param %s dim %d (=%d) not divisible by model axis %d; "
                "replicating instead of sharding",
                joined, dim, shape[dim], model_size)
        return False

    if "encoder" in joined and names[-1].startswith("kernel"):
        if len(shape) == 3 and ok(1):
            return (None, "model", None)    # (G, P_pad, D): the voxel axis
        if len(shape) == 2 and ok(0):
            return ("model", None)          # the contraction (input) axis
        return ()
    if names[-1] == "embedding" and ok(0):
        return ("model", None)
    if "dense_out" in joined and names[-1] == "kernel" and ok(1):
        return (None, "model")
    return ()


def sharded_axis(spec: tuple) -> int | None:
    return spec.index("model") if "model" in spec else None


def param_specs(model: torch.nn.Module, model_size: int) -> dict:
    """{state-dict name: spec} of every parameter of ``model``."""
    return {name: param_spec(name.split("."), p.shape, model_size)
            for name, p in model.named_parameters()}


def tensor_parallel_names(model, shards: dict) -> set:
    """The sharded parameters whose layer computes with its shard: a NIC's
    embedding and head kernel and, when the encoder is a plain
    ``LocallyDense``, its bucket kernels."""
    from masters_thesis_tpu_torch.models.locally_dense import LocallyDense
    from masters_thesis_tpu_torch.models.nic import NIC

    if not isinstance(model, NIC):
        return set()
    names = {n for n in ("embedding", "dense_out.kernel") if n in shards}
    if type(model.encoder) is LocallyDense:
        names |= {n for n in shards if n.startswith("encoder.kernel_")}
    return names


def encoder_voxel_sharded(model, shards: dict) -> bool:
    """Does the model read this rank's columns of its input rows?"""
    return any(n.startswith("encoder.kernel_")
               for n in tensor_parallel_names(model, shards))


def shard_tensor(full: torch.Tensor, axis: int, mesh) -> torch.Tensor:
    """This rank's slice of ``full`` along ``axis``: the m-th of
    ``mesh.model`` equal pieces."""
    n = full.shape[axis] // mesh.model
    return full.narrow(axis, mesh.m * n, n).clone()


def shard_params(state, mesh):
    """Keep this rank's slice of every parameter (and optimizer moment)
    that ``param_spec`` shards over a model axis wider than one, in place;
    the state then records ``mesh`` and ``shards`` ({name: axis}). A
    voxel-sharded LocallyDense then reads the rank's columns of its input
    (``rank_columns``)."""
    from masters_thesis_tpu_torch.train.checkpoint import _slots

    model, tx = state.model, state.tx
    shards = {}
    if mesh.model > 1:
        shards = {n: sharded_axis(s)
                  for n, s in param_specs(model, mesh.model).items()
                  if sharded_axis(s) is not None}
    names = [n for n, _ in model.named_parameters()]
    with torch.no_grad():
        for i, (name, p) in enumerate(model.named_parameters()):
            axis = shards.get(name)
            if axis is None:
                continue
            p.data = shard_tensor(p.data, axis, mesh)
            for slot in _slots(tx):
                moments = getattr(tx, slot)
                moments[i] = shard_tensor(moments[i], axis, mesh)
    if encoder_voxel_sharded(model, shards):
        model.encoder.pregathered = True
    if shards:
        tx.shard_axes = [shards.get(n) for n in names]
        tx.model_sum = lambda s: all_reduce(s.clone(), mesh.model_group)
    state.mesh, state.shards = mesh, shards
    return state


def gather_state_dict(state) -> dict:
    """The model's whole state dict (a collective over the model group when
    the state holds shards); the tensors are detached."""
    sd = {k: v.detach() for k, v in state.model.state_dict().items()}
    mesh = state.mesh
    for name, axis in state.shards.items():
        sd[name] = all_gather(sd[name], axis, mesh.m, mesh.model,
                              mesh.model_group)
    return sd


def gather_slots(state) -> dict:
    """{slot: [whole moment of each parameter]} of the optimizer (a
    collective when the state holds shards)."""
    from masters_thesis_tpu_torch.train.checkpoint import _slots

    mesh = state.mesh
    names = [n for n, _ in state.model.named_parameters()]
    out = {}
    for slot in _slots(state.tx):
        out[slot] = [
            all_gather(t, state.shards[n], mesh.m, mesh.model,
                       mesh.model_group) if n in state.shards else t
            for n, t in zip(names, getattr(state.tx, slot))]
    return out


def local_slice(name: str, full: torch.Tensor, state) -> torch.Tensor:
    """This rank's part of a whole tensor of parameter ``name``."""
    axis = state.shards.get(name)
    return full if axis is None else shard_tensor(full, axis, state.mesh)


def param_norm(state) -> float:
    """The norm of every parameter, whole (a collective when sharded), in
    float64."""
    names = {n for n, _ in state.model.named_parameters()}
    sd = gather_state_dict(state)
    return float(torch.sqrt(sum(torch.sum(torch.square(sd[n].double()))
                                for n in names)))


# ---- inputs ----

def rank_rows(mesh, batch_size: int) -> np.ndarray:
    """This rank's rows of a global batch: the d-th of ``mesh.data``
    contiguous blocks."""
    if batch_size % mesh.data:
        raise ValueError(f"global batch {batch_size} not divisible by data "
                         f"axis {mesh.data}")
    b = batch_size // mesh.data
    return np.arange(mesh.d * b, (mesh.d + 1) * b)


def rank_columns(layout, m: int, model_size: int) -> np.ndarray:
    """The columns of the grouped padded layout (``layout.padded_total``)
    that rank m of the model axis holds: bucket by bucket, each group's
    m-th slice of its padded width (the whole width for a bucket the axis
    does not divide, as ``param_spec`` replicates its kernel)."""
    cols, offset = [], 0
    for bucket in layout.buckets:
        g, p = len(bucket.group_ids), bucket.padded
        w, lo = (p // model_size, m * (p // model_size)) \
            if p % model_size == 0 else (p, 0)
        block = offset + np.arange(g)[:, None] * p + lo + np.arange(w)
        cols.append(block.reshape(-1))
        offset += g * p
    return np.concatenate(cols)


def shard_store_array(data: torch.Tensor, layout, mesh) -> torch.Tensor:
    """(N, n_voxels) rows -> this rank's (N, W_m) columns of the grouped
    layout (``rank_columns``), on ``data``'s device, a chunk at a time."""
    from masters_thesis_tpu_torch.data.store import permute_rows

    cols = rank_columns(layout, mesh.m, mesh.model)
    return permute_rows(data, layout, columns=layout.flat_indices()[cols])


class MeshInputPlacer:
    """Gives the Trainer's steps this rank's rows of every global batch.

    Every rank builds the same seed-determined global batches; ``batch``
    cuts a batch's ids, tokens and targets to this rank's rows and ``sel``
    a (K, B) block of pair ids. ``placement`` is what the rank's step tells
    its layers (``parallel.collectives.Placement``): its rows, the global
    batch, the tensor-parallel leaves and, under a voxel-sharded encoder,
    which columns of the single-device input its rows hold (for the input
    dropout's mask)."""

    def __init__(self, mesh, batch_size: int, state=None, layout=None,
                 pregathered_reference: bool = False):
        self.mesh = mesh
        self.batch_size = batch_size
        self.rows = rank_rows(mesh, batch_size)
        tp = frozenset()
        cols = width = None
        if state is not None:
            tp = frozenset(tensor_parallel_names(state.model, state.shards))
            if layout is not None and encoder_voxel_sharded(state.model,
                                                            state.shards):
                cols = rank_columns(layout, mesh.m, mesh.model)
                width = layout.padded_total
                if not pregathered_reference:
                    # the raw row's voxel of each column (a padding slot
                    # holds zero: any column's mask does)
                    cols = np.minimum(layout.flat_indices()[cols],
                                      layout.n_voxels - 1)
                    width = layout.n_voxels
        device = mesh.device
        self.placement = Placement(
            mesh=mesh, rows=torch.as_tensor(self.rows, device=device),
            n_rows=batch_size, tp=tp,
            input_cols=(None if cols is None
                        else torch.as_tensor(cols, device=device)),
            input_width=width)

    def batch(self, batch: dict) -> dict:
        out = dict(batch)
        for key in ("idx", "tokens", "target"):
            if key in batch:
                out[key] = np.asarray(batch[key])[self.rows]
        return out

    def sel(self, sel: torch.Tensor) -> torch.Tensor:
        """(K, B) pair ids -> this rank's (K, B / data)."""
        rows = self.placement.rows.to(sel.device)
        return sel.index_select(1, rows)


# ---- the sharded steps ----

class MeshOps:
    """What a rank's part of a sharded step adds to the step bodies of
    ``train.steps`` (their ``mesh`` argument)."""

    def __init__(self, state, placer: MeshInputPlacer):
        self.mesh = state.mesh
        self.placer = placer
        names = [n for n, _ in state.model.named_parameters()]
        self.axes = [state.shards.get(n) for n in names]
        tp = placer.placement.tp
        self.fallback = {n: a for n, a in state.shards.items() if n not in tp}

    def scope(self):
        return placement(self.placer.placement)

    @contextlib.contextmanager
    def gathered(self, model):
        """The sharded leaves that no layer computes with, gathered whole
        for the forward (their backward is this rank's slice)."""
        swapped = []
        try:
            for name, axis in self.fallback.items():
                path, leaf = name.rpartition(".")[::2]
                owner = model.get_submodule(path) if path else model
                param = owner._parameters[leaf]
                owner._parameters[leaf] = gather_from_model(param, axis)
                swapped.append((owner, leaf, param))
            yield
        finally:
            for owner, leaf, param in swapped:
                owner._parameters[leaf] = param

    def average(self, grads) -> list:
        """Gradients averaged over the data group, in one all-reduce."""
        grads = list(grads)
        group = self.mesh.data_group
        if group is None:
            return grads
        flat = torch.cat([g.reshape(-1) for g in grads])
        all_reduce(flat, group).div_(self.mesh.data)
        out, i = [], 0
        for g in grads:
            out.append(flat[i:i + g.numel()].view_as(g))
            i += g.numel()
        return out

    def global_norm(self, grads) -> torch.Tensor:
        """The norm of the whole gradients (shards' squares summed over the
        model group)."""
        from masters_thesis_tpu_torch.train.steps import global_norm

        if not any(a is not None for a in self.axes):
            return global_norm(grads)
        sq = [torch.square(torch.linalg.vector_norm(g)) for g in grads]
        rep = sum(s for s, a in zip(sq, self.axes) if a is None)
        shard = sum(s for s, a in zip(sq, self.axes) if a is not None)
        return torch.sqrt(rep + all_reduce(shard.clone(),
                                           self.mesh.model_group))

    def metrics(self, metrics: dict) -> dict:
        """The global batch's metrics: the means over the data group of the
        ranks' equal-sized batches' (the masked accuracy already sums over
        it)."""
        group = self.mesh.data_group
        if group is None:
            return metrics
        keys = list(metrics)
        values = torch.stack([metrics[k].float() for k in keys])
        all_reduce(values, group).div_(self.mesh.data)
        return dict(zip(keys, values))


def _scoped(fn, ops: MeshOps):
    def step(*args):
        with ops.scope():
            return fn(*args)

    return step


def make_sharded_train_step(cfg, l2_rules, state, placer, masked=False):
    """``step(state, betas, tokens, target)`` on this rank's rows: its part
    of the train step over the mesh."""
    from masters_thesis_tpu_torch.train.steps import make_train_step

    ops = MeshOps(state, placer)
    return _scoped(make_train_step(cfg, l2_rules, masked, mesh=ops), ops)


def make_sharded_eval_step(cfg, l2_rules, state, placer, masked=False):
    """The validation step over the mesh; its metrics are the global
    batch's on every rank."""
    from masters_thesis_tpu_torch.train.steps import make_eval_step

    ops = MeshOps(state, placer)
    return _scoped(make_eval_step(cfg, l2_rules, masked, mesh=ops), ops)


def make_sharded_scanned_train_steps_from_tables(cfg, l2_rules, state, placer,
                                                 masked=False):
    """K steps a call over the mesh: the tables replicated, the pair ids
    this rank's columns of the (K, B) block (``MeshInputPlacer.sel``), the
    rows gathered by K1 from this rank's store."""
    from masters_thesis_tpu_torch.train.steps import (
        make_scanned_train_steps_from_tables,
    )

    ops = MeshOps(state, placer)
    return _scoped(make_scanned_train_steps_from_tables(
        cfg, l2_rules, masked, mesh=ops), ops)


def make_sharded_scanned_eval_steps_from_tables(cfg, l2_rules, state, placer,
                                                masked=False):
    """The validation pass in one call over the mesh."""
    from masters_thesis_tpu_torch.train.steps import (
        make_scanned_eval_steps_from_tables,
    )

    ops = MeshOps(state, placer)
    return _scoped(make_scanned_eval_steps_from_tables(
        cfg, l2_rules, masked, mesh=ops), ops)
