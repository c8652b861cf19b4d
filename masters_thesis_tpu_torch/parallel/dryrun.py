"""Dry run of the sharded train step over N ranks, and the flagship's
sharding census.

Counterpart of ``masters_thesis_tpu/parallel/dryrun.py``. The JAX dry run
shards one train step over N virtual CPU devices; here N ranks
(``parallel.multiprocess``'s launcher, one process a rank) each run their
part of one sharded train step and two scanned steps at tiny shapes: on
the card by default, all sharing it under gloo where there are fewer cards
than ranks, or on the CPU under ``device="cpu"``. Rank 0 prints the mesh,
the losses and how many parameters are sharded.

``flagship_census`` is the counterpart of the JAX compile-only
``flagship_dryrun``: the reference-dimension LcNIC (327,684 voxels in 360
groups, vocab 5,001 padded by ``tpu.vocab_pad_multiple`` to a multiple of
max(8, model axis), units 512) built on the ``meta`` device, with no array
allocated, and each parameter's shard shape and bytes on a rank from
``param_spec``. XLA's memory analysis of the compiled step has no
counterpart here; the census gives the parameters' and Adam's bytes on a
rank instead.
"""

from __future__ import annotations

import math

import numpy as np

from masters_thesis_tpu_torch.parallel.multiprocess import (
    _child_finish,
    _child_setup,
    _launch_children,
    _retry_port_races,
)

DRYRUN_TAG = "DRYRUN"
FLAGSHIP_GROUPS = 360


def _axes(n: int) -> tuple[int, int]:
    """(data, model) of an n-rank dry run: a model axis of 2 when n is
    even."""
    model = 2 if n % 2 == 0 else 1
    return n // model, model


def flagship_census(n_ranks: int = 8) -> dict:
    """The sharding of the flagship model over an ``n_ranks`` mesh (the
    model axis 2 when n is even), from ``param_spec`` on the model built on
    the ``meta`` device: which parameters are sharded, each one's shape on
    a rank, and a rank's bytes of parameters and of the Adam state."""
    import torch

    from masters_thesis_tpu_torch.config import Config, TPUConfig
    from masters_thesis_tpu_torch.data.synthetic import synthetic_groups
    from masters_thesis_tpu_torch.experiment import build_model
    from masters_thesis_tpu_torch.parallel.sharding import (
        param_spec,
        sharded_axis,
    )

    data, model_size = _axes(n_ranks)
    cfg = Config(
        batch_size=8 * data, max_length=15, top_k=5000, units=512,
        attn_units=32, group_size=32, embedding_text=512,
        # 5,001 divides nothing: pad to the model axis (8 covers every
        # power-of-two axis up to 8)
        tpu=TPUConfig(vocab_pad_multiple=max(8, model_size)))
    n_voxels = cfg.input.full
    groups = synthetic_groups(n_voxels=n_voxels, n_groups=FLAGSHIP_GROUPS,
                              seed=0)
    with torch.device("meta"):
        model, _, _ = build_model(cfg, groups, n_voxels)
    shapes, sharded, replicated, nbytes = {}, [], 0, 0
    for name, p in model.named_parameters():
        shape = list(p.shape)
        axis = sharded_axis(param_spec(name.split("."), shape, model_size))
        if axis is not None and model_size > 1:
            shape[axis] //= model_size
            sharded.append(name)
        else:
            replicated += 1
        shapes[name] = shape
        nbytes += math.prod(shape) * p.element_size()
    return {
        "mesh": {"data": data, "model": model_size},
        "dims": {"voxels": n_voxels, "groups": FLAGSHIP_GROUPS,
                 "vocab": f"{cfg.vocab_size}->{cfg.padded_vocab_size}",
                 "units": cfg.units},
        "sharded": len(sharded),
        "replicated": replicated,
        "encoder_kernels_sharded": sum(n.startswith("encoder")
                                       for n in sharded),
        "embedding_sharded": "embedding" in sharded,
        "dense_out_sharded": "dense_out.kernel" in sharded,
        "sharded_names": sharded,
        "rank_shapes": shapes,
        "params_mb_per_rank": round(nbytes / 1e6, 1),
        # parameters and Adam's two moments
        "state_mb_per_rank": round(3 * nbytes / 1e6, 1),
    }


def census_line(census: dict) -> str:
    d = census["dims"]
    return (f"dryrun_flagship: dims=({d['voxels']} voxels/{d['groups']} "
            f"groups/vocab {d['vocab']}/units {d['units']}) "
            f"mesh={census['mesh']} census={census['sharded']} sharded "
            f"({census['encoder_kernels_sharded']} encoder kernels + "
            f"embedding + dense_out) / {census['replicated']} replicated; "
            f"params/rank={census['params_mb_per_rank']} MB, params+Adam/"
            f"rank={census['state_mb_per_rank']} MB; built on the meta "
            f"device, no array allocated")


def _dryrun_rank(n_ranks: int, device) -> dict:
    """One rank's part of the dry run; rank 0's report holds its lines."""
    import torch

    from masters_thesis_tpu_torch.config import Config, TPUConfig
    from masters_thesis_tpu_torch.data.synthetic import synthetic_groups
    from masters_thesis_tpu_torch.experiment import build_model
    from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
    from masters_thesis_tpu_torch.parallel import sharding
    from masters_thesis_tpu_torch.parallel.mesh import make_mesh
    from masters_thesis_tpu_torch.train.state import new_state

    data, model_size = _axes(n_ranks)
    mesh = make_mesh(data, model_size, device)
    # top_k 63: vocab 64, which the model axis divides, so the embedding
    # and head shard too
    cfg = Config(batch_size=2 * data, max_length=6, top_k=63, units=16,
                 attn_units=8, group_size=4, embedding_text=8,
                 tpu=TPUConfig(mesh_data=data, mesh_model=model_size))
    n_voxels, n_groups = 512, 8
    groups = synthetic_groups(n_voxels=n_voxels, n_groups=n_groups, seed=0)
    layout = GroupLayout(groups, n_voxels)
    model, rules, masked = build_model(cfg, groups, n_voxels)
    state = sharding.shard_params(new_state(model, cfg, mesh.device), mesh)
    placer = sharding.MeshInputPlacer(mesh, cfg.batch_size, state, layout)
    voxel_sharded = sharding.encoder_voxel_sharded(state.model, state.shards)

    def rank_store(rows: np.ndarray) -> torch.Tensor:
        rows = torch.as_tensor(rows, device=mesh.device)
        return (sharding.shard_store_array(rows, layout, mesh)
                if voxel_sharded else rows)

    rng = np.random.default_rng(0)
    B, T, K = cfg.batch_size, cfg.max_length, 2
    betas = rng.standard_normal((B, n_voxels)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int64)
    target = np.concatenate([tokens[:, 1:], np.zeros((B, 1), np.int64)], 1)
    rows = placer.rows
    step = sharding.make_sharded_train_step(cfg, rules, state, placer, masked)
    on = lambda a: torch.as_tensor(a, device=mesh.device)  # noqa: E731
    state, metrics = step(state, rank_store(betas)[on(rows)],
                          on(tokens[rows]), on(target[rows]))
    loss = float(metrics["loss"])

    # K scanned steps from the tables, rows gathered by K1 from the rank's
    # store
    store = rank_store(rng.standard_normal((4 * B, n_voxels))
                       .astype(np.float32))
    store_idx = rng.integers(0, 4 * B, K * B)
    sel = placer.sel(on(np.arange(K * B).reshape(K, B)))
    scanned = sharding.make_sharded_scanned_train_steps_from_tables(
        cfg, rules, state, placer, masked)
    state, smetrics = scanned(state, store, on(store_idx),
                              on(np.tile(tokens, (K, 1))),
                              on(np.tile(target, (K, 1))), sel)
    sloss = float(smetrics["loss"][-1])
    if not (np.isfinite(loss) and np.isfinite(sloss)):
        raise RuntimeError(f"non-finite dry-run loss {loss}, {sloss}")
    lines = [f"dryrun_multichip({n_ranks}): mesh={mesh.shape} "
             f"device={mesh.device} loss={loss:.4f} "
             f"scanned_k{K}_loss={sloss:.4f} shardings={len(state.shards)} "
             f"sharded / {len(list(model.parameters())) - len(state.shards)} "
             f"replicated params ok"]
    census = None
    if mesh.rank == 0:
        census = flagship_census(n_ranks)
        lines.append(census_line(census))
    return {"lines": lines, "loss": loss, "scanned_loss": sloss,
            "mesh": mesh.shape, "flagship": census}


def _dryrun_child_main(argv) -> None:
    n_ranks, device = int(argv[0]), argv[1]
    _child_setup(device)
    _child_finish(_dryrun_rank(n_ranks, device), DRYRUN_TAG)


_DRYRUN_CHILD = ("import sys\n"
                 "from masters_thesis_tpu_torch.parallel.dryrun import "
                 "_dryrun_child_main\n"
                 "_dryrun_child_main(sys.argv[1:])\n")


def dryrun_multichip(n_ranks: int, flagship_only: bool = False,
                     device: str = "cuda", timeout: float = 600,
                     attempts: int = 3) -> dict:
    """``dryrun --devices N [--flagship]``: N ranks run one sharded train
    step and two scanned steps, then the flagship census (with
    ``flagship_only``, the census alone, in this process); prints the
    report's lines and returns it."""
    if flagship_only:
        census = flagship_census(n_ranks)
        print(census_line(census), flush=True)
        return {"flagship": census}
    report = _retry_port_races(
        lambda: _launch_children(_DRYRUN_CHILD, 1, n_ranks, timeout,
                                 child_args=(n_ranks, device),
                                 report_tag=DRYRUN_TAG),
        attempts, f"dryrun --devices {n_ranks}")
    for line in report["lines"]:
        print(line, flush=True)
    return report
