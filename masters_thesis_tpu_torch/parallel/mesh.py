"""The ('data', 'model') grid over ranks, and the process group under it.

Counterpart of ``masters_thesis_tpu/parallel/mesh.py``. The JAX package's
mesh is a grid of devices inside one SPMD program; here it is a grid of
ranks, one process and one device each:

  axes = ('data', 'model')
    data  — the batch's rows, split over ranks; gradients averaged
    model — the encoder's voxel axis and the vocab axis, split over ranks

Rank r sits at (r // model, r % model): a data row of the grid is ``model``
consecutive ranks, as the JAX mesh reshapes its device list. Each rank
holds its two process groups, one along each axis (None for an axis of
one), which ``parallel.collectives`` reduces over.

A rank holds one device: ``cuda:(local_rank % device_count)``, or the CPU
when the caller asks for it. The backend is NCCL where every rank of the
machine has a card of its own, and gloo on the CPU or where ranks share a
card, since NCCL refuses two ranks on one device.

``maybe_distributed_init`` starts ``torch.distributed`` from the port's own
environment (``MTT_DIST_*``, set by ``parallel.multiprocess``) and does
nothing in a process without it; ``ensure_process_group`` also starts a
group of one rank there, so that a mesh always has a process group.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket

import torch
import torch.distributed as dist

from masters_thesis_tpu_torch.device import resolve_device

# the launcher's environment: init method (tcp://host:port), world size,
# this rank, its index among the ranks of its machine and their number
ENV_INIT = "MTT_DIST_INIT_METHOD"
ENV_WORLD = "MTT_DIST_WORLD_SIZE"
ENV_RANK = "MTT_DIST_RANK"
ENV_LOCAL_RANK = "MTT_DIST_LOCAL_RANK"
ENV_LOCAL_WORLD = "MTT_DIST_LOCAL_WORLD_SIZE"
TIMEOUT = datetime.timedelta(minutes=10)


def free_port() -> int:
    """A port that was free a moment ago on localhost (the launch that
    hands it on may lose it to another process: ``multiprocess`` retries
    such races)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(device=None, local_rank: int = 0) -> torch.device:
    """The device of a rank: ``cuda:(local_rank % device_count)`` for
    ``device`` cuda (the default; raises without a card), the CPU for
    ``device`` cpu."""
    device = resolve_device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def backend_for(device: torch.device, local_world: int) -> str:
    """NCCL when every rank of the machine has a card of its own, else
    gloo."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _init(device, rank: int, world: int, local_rank: int, local_world: int,
          init_method: str) -> torch.device:
    device = rank_device(device, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(device, local_world),
                            init_method=init_method, world_size=world,
                            rank=rank, timeout=TIMEOUT)
    return device


def maybe_distributed_init(device=None) -> torch.device | None:
    """Start the process group from ``MTT_DIST_*`` and return this rank's
    device; None (and nothing started) without that environment, or the
    rank's device when the group already runs."""
    if dist.is_initialized():
        return rank_device(device, int(os.environ.get(ENV_LOCAL_RANK, 0)))
    if not os.environ.get(ENV_INIT):
        return None
    world = int(os.environ[ENV_WORLD])
    local_rank = int(os.environ.get(ENV_LOCAL_RANK, os.environ[ENV_RANK]))
    return _init(device, int(os.environ[ENV_RANK]), world, local_rank,
                 int(os.environ.get(ENV_LOCAL_WORLD, world)),
                 os.environ[ENV_INIT])


def ensure_process_group(device=None) -> torch.device:
    """``maybe_distributed_init``, or a group of this one rank on a free
    localhost port; returns the rank's device."""
    started = maybe_distributed_init(device)
    if started is not None:
        return started
    return _init(device, 0, 1, 0, 1, f"tcp://localhost:{free_port()}")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the ('data', 'model') grid: the axes' sizes,
    its coordinates (d, m), its rank among ``world``, its device, and the
    process groups along each axis (None for an axis of one rank)."""

    data: int
    model: int
    rank: int
    device: torch.device
    data_group: object = None
    model_group: object = None

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def d(self) -> int:
        return self.rank // self.model

    @property
    def m(self) -> int:
        return self.rank % self.model

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}


def make_mesh(data: int = 0, model: int = 1, device=None) -> Mesh:
    """The ('data', 'model') grid over the ranks of the running process
    group (started here if none runs, ``ensure_process_group``);
    ``data=0`` means "all remaining ranks". The grid must take every
    rank."""
    device = ensure_process_group(device)
    world = dist.get_world_size()
    if model < 1:
        raise ValueError(f"model axis {model}: expected at least 1")
    if data <= 0:
        if world % model:
            raise ValueError(f"{world} ranks not divisible by model={model}")
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks; "
                         f"the process group has {world}")
    rank = dist.get_rank()
    groups = {}
    # every rank creates every group, in one order
    for d in range(data):
        ranks = [d * model + m for m in range(model)]
        g = dist.new_group(ranks) if model > 1 else None
        if rank in ranks:
            groups["model"] = g
    for m in range(model):
        ranks = [d * model + m for d in range(data)]
        g = dist.new_group(ranks) if data > 1 else None
        if rank in ranks:
            groups["data"] = g
    return Mesh(data, model, rank, device, groups["data"], groups["model"])
