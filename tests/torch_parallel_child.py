"""Rank-side bodies of the port's multi-rank tests (``test_torch_parallel.py``).

Each runs inside one rank of a process group that
``masters_thesis_tpu_torch.parallel.multiprocess._launch_children`` starts
on the CPU (gloo), imports nothing of JAX, and returns a JSON-able report
that rank 0 prints. ``run_ranks`` launches them.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

TAG = "RANKTEST"
_HERE = os.path.dirname(os.path.abspath(__file__))
_CHILD = ("import sys\n"
          f"sys.path.insert(0, {_HERE!r})\n"
          "import torch_parallel_child\n"
          "torch_parallel_child.main(sys.argv[1:])\n")


def run_ranks(n: int, body: str, *args, timeout: float = 240) -> dict:
    """Rank 0's report of ``body(*args)`` run on ``n`` CPU ranks."""
    from masters_thesis_tpu_torch.parallel.multiprocess import (
        _launch_children,
        _retry_port_races,
    )

    return _retry_port_races(
        lambda: _launch_children(_CHILD, 1, n, timeout,
                                 child_args=(body, *args), report_tag=TAG),
        3, body)


def main(argv) -> None:
    from masters_thesis_tpu_torch.parallel.mesh import ensure_process_group
    from masters_thesis_tpu_torch.parallel.multiprocess import (
        _child_finish,
        _child_setup,
    )

    _child_setup("cpu")
    ensure_process_group("cpu")
    _child_finish(globals()[argv[0]](*argv[1:]), TAG)


# ---- bodies ----

def _tiny_cfg(**kw):
    from masters_thesis_tpu_torch.config import Config

    base = dict(batch_size=8, max_length=6, top_k=63, units=16,
                attn_units=8, group_size=4, embedding_text=8,
                embedding_features=16)
    base.update(kw)
    return Config(**base)


def _family_state(name: str, seed: int = 0):
    """A tiny model of family ``name`` with its optimizer, every moment set
    to seeded noise, on the CPU."""
    from masters_thesis_tpu_torch.data.synthetic import synthetic_groups
    from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
    from masters_thesis_tpu_torch.train.state import (
        LAYOUT_MODELS,
        model_for,
        new_state,
    )

    cfg = _tiny_cfg(model=name)
    layout = GroupLayout(synthetic_groups(n_voxels=256, n_groups=8, seed=0),
                         256)
    row_shape = {"img_nic": (4, 32), "cnn_rnn": (4, 32)}.get(name, (256,))
    model = model_for(cfg, layout if name in LAYOUT_MODELS else None,
                      row_shape=row_shape)
    state = new_state(model, cfg, "cpu")
    gen = torch.Generator().manual_seed(seed)
    slots = ("mu", "nu") if state.tx.name == "adam" else ("trace",)
    for slot in slots:
        for t in getattr(state.tx, slot):
            t.copy_(torch.randn(t.shape, generator=gen))
    return state


def round_trip(model_size: str) -> dict:
    """``gather(shard(state))`` against the state, for every family, on a
    (world / model_size) x model_size mesh: exact?"""
    from masters_thesis_tpu_torch.parallel.mesh import make_mesh
    from masters_thesis_tpu_torch.parallel.sharding import (
        gather_slots,
        gather_state_dict,
        shard_params,
    )
    from masters_thesis_tpu_torch.train.state import MODELS

    mesh = make_mesh(0, int(model_size), "cpu")
    out = {}
    for name in MODELS:
        state = _family_state(name)
        whole = {k: v.clone() for k, v in state.model.state_dict().items()}
        slots = {s: [t.clone() for t in getattr(state.tx, s)]
                 for s in ("mu", "nu")}
        shard_params(state, mesh)
        local = sum(p.numel() for p in state.model.parameters())
        sd, moments = gather_state_dict(state), gather_slots(state)
        exact = (sd.keys() == whole.keys()
                 and all(torch.equal(sd[k], whole[k]) for k in whole)
                 and all(torch.equal(a, b) for s in slots
                         for a, b in zip(moments[s], slots[s])))
        out[name] = {"exact": bool(exact), "sharded": sorted(state.shards),
                     "local_params": local,
                     "params": sum(v.numel() for k, v in whole.items()
                                   if k in dict(state.model.named_parameters()))}
    return {"families": out}


def collectives() -> dict:
    """Each collective op's gradient against the single-device gradient of
    the same function, on a 1 x world and a world x 1 mesh: max |error|."""
    from masters_thesis_tpu_torch.models.common import BatchNorm
    from masters_thesis_tpu_torch.models.locally_dense import LocallyDense
    from masters_thesis_tpu_torch.data.synthetic import synthetic_groups
    from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
    from masters_thesis_tpu_torch.parallel import collectives as c
    from masters_thesis_tpu_torch.parallel.mesh import make_mesh
    from masters_thesis_tpu_torch.parallel.sharding import (
        MeshOps,
        MeshInputPlacer,
        rank_columns,
        shard_tensor,
    )
    from masters_thesis_tpu_torch.train.state import TrainState

    world = torch.distributed.get_world_size()
    errors = {}
    gen = torch.Generator().manual_seed(0)
    rand = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                                  dtype=torch.float64)
    model_mesh = make_mesh(1, world, "cpu")

    def err(a, b):
        return float((a - b).abs().max())

    def scope(mesh, rows, n):
        return c.placement(c.Placement(mesh=mesh, rows=torch.as_tensor(rows),
                                       n_rows=n))

    # the encoder's partial products: a LocallyDense on its voxel slices
    layout = GroupLayout(synthetic_groups(n_voxels=256, n_groups=8, seed=0),
                         256)
    enc = LocallyDense(layout, out_dim=4, dropout=0.0, use_bn=False,
                       generator=torch.Generator().manual_seed(1)).double()
    x = rand(6, 256)
    w = rand(6, 8, 4)
    full = {k: v.detach().clone().requires_grad_() for k, v in
            enc.named_parameters()}
    xin = x.clone().requires_grad_()
    (torch.func.functional_call(enc, full, (xin,)) * w).sum().backward()
    flat = torch.as_tensor(layout.flat_indices())
    cols = torch.as_tensor(rank_columns(layout, model_mesh.m, world))
    local = {k: (shard_tensor(v.detach(), 1, model_mesh) if "kernel" in k
                 else v.detach()).clone().requires_grad_()
             for k, v in enc.named_parameters()}
    enc.pregathered = True
    xr = torch.nn.functional.pad(x, (0, 1))[:, flat[cols]].requires_grad_()
    with scope(model_mesh, range(6), 6):
        (torch.func.functional_call(enc, local, (xr,)) * w).sum().backward()
    errors["encoder_partial_sum"] = max(
        err(local[k].grad, shard_tensor(full[k].grad, 1, model_mesh)
            if "kernel" in k else full[k].grad) for k in full)

    # the vocab-sharded embedding lookup
    table = rand(16, 3).requires_grad_()
    ids = torch.randint(0, 16, (5, 4), generator=gen)
    wemb = rand(5, 4, 3)
    (torch.nn.functional.embedding(ids, table) * wemb).sum().backward()
    rows = shard_tensor(table.detach(), 0, model_mesh).requires_grad_()
    with scope(model_mesh, range(5), 5):
        (c.vocab_parallel_embedding(ids, rows) * wemb).sum().backward()
    errors["vocab_embedding"] = err(rows.grad,
                                    shard_tensor(table.grad, 0, model_mesh))

    # the vocab-sharded head: the replicated input's gradient summed, the
    # logits' gradient sliced
    h = rand(5, 6).requires_grad_()
    kernel, bias = rand(6, 16).requires_grad_(), rand(16).requires_grad_()
    wl = rand(5, 16)
    (torch.log_softmax(h @ kernel + bias, -1) * wl).sum().backward()
    hl = h.detach().clone().requires_grad_()
    kl = shard_tensor(kernel.detach(), 1, model_mesh).requires_grad_()
    bl = bias.detach().clone().requires_grad_()
    with scope(model_mesh, range(5), 5):
        (torch.log_softmax(c.vocab_parallel_dense(hl, kl, bl), -1)
         * wl).sum().backward()
    errors["vocab_head"] = max(err(hl.grad, h.grad), err(bl.grad, bias.grad),
                               err(kl.grad, shard_tensor(kernel.grad, 1,
                                                         model_mesh)))

    # a leaf gathered whole for its layer: its slice of the gradient
    wk = rand(8, 3).requires_grad_()
    xk = rand(4, 8)
    (torch.tanh(xk @ wk)).sum().backward()
    wkl = shard_tensor(wk.detach(), 0, model_mesh).requires_grad_()
    with scope(model_mesh, range(4), 4):
        torch.tanh(xk @ c.gather_from_model(wkl, 0)).sum().backward()
    errors["gathered_leaf"] = err(wkl.grad, shard_tensor(wk.grad, 0,
                                                         model_mesh))

    # BatchNorm over the global batch on a world x 1 mesh: the ranks'
    # averaged gradients against the whole batch's
    data_mesh = make_mesh(world, 1, "cpu")
    bn = BatchNorm(3).double()
    xb, wb = rand(4 * world, 2, 3), rand(4 * world, 2, 3)
    full = {k: v.detach().clone().requires_grad_()
            for k, v in bn.named_parameters()}
    xfull = xb.clone().requires_grad_()
    (torch.func.functional_call(bn, full, (xfull, True)) * wb).mean(
    ).backward()
    running = bn.mean.clone(), bn.var.clone()
    bn.mean.zero_()
    bn.var.fill_(1.0)
    mine = slice(4 * data_mesh.d, 4 * data_mesh.d + 4)
    loc = {k: v.detach().clone().requires_grad_()
           for k, v in bn.named_parameters()}
    xloc = xb[mine].clone().requires_grad_()
    state = TrainState(model=bn, tx=None, generator=None, seed=0,
                       mesh=data_mesh)
    placer = MeshInputPlacer(data_mesh, 4 * world)
    ops = MeshOps(state, placer)
    with ops.scope():
        (torch.func.functional_call(bn, loc, (xloc, True)) * wb[mine]).mean(
        ).backward()
    grads = ops.average([loc["scale"].grad, loc["bias"].grad])
    xgrad = xloc.grad / world       # the local loss is 1/world of the mean
    errors["batchnorm_global_batch"] = max(
        err(grads[0], full["scale"].grad), err(grads[1], full["bias"].grad),
        err(xgrad, xfull.grad[mine]), err(bn.mean, running[0]),
        err(bn.var, running[1]))
    return errors


def jax_step(path: str) -> dict:
    """One sharded train step of the drive's LcNIC from the weights and
    batch in ``path`` (npz), on each of a 1 x world and a world x 1 mesh:
    the loss and the whole updated parameters, written next to ``path``."""
    from masters_thesis_tpu_torch.config import Config
    from masters_thesis_tpu_torch.data.synthetic import synthetic_groups
    from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
    from masters_thesis_tpu_torch.parallel import sharding
    from masters_thesis_tpu_torch.parallel.mesh import make_mesh
    from masters_thesis_tpu_torch.train.losses import lc_nic_l2_rules
    from masters_thesis_tpu_torch.train.state import model_for, new_state
    from masters_thesis_tpu_torch.transplant import from_flax

    data = np.load(path)
    world = torch.distributed.get_world_size()
    out = {}
    for d, m in ((1, world), (world, 1)):
        cfg = Config(batch_size=8, max_length=6, top_k=63, units=16,
                     attn_units=8, group_size=4, embedding_text=8,
                     dropout_features=0.0, dropout_text=0.0,
                     dropout_attn=0.0, dropout_lstm=0.0, dropout_out=0.0)
        layout = GroupLayout(synthetic_groups(n_voxels=256, n_groups=8,
                                              seed=0), 256)
        model = model_for(cfg, layout)
        params = {}
        for key in data.files:
            if key.startswith("params/") or key.startswith("batch_stats/"):
                node = params
                parts = key.split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = data[key]
        model.load_state_dict(from_flax(params))
        mesh = make_mesh(d, m, "cpu")
        state = sharding.shard_params(new_state(model, cfg, "cpu"), mesh)
        placer = sharding.MeshInputPlacer(mesh, cfg.batch_size, state,
                                          layout)
        betas = torch.as_tensor(data["betas"])
        if sharding.encoder_voxel_sharded(state.model, state.shards):
            betas = sharding.shard_store_array(betas, layout, mesh)
        rows = torch.as_tensor(placer.rows)
        step = sharding.make_sharded_train_step(cfg, lc_nic_l2_rules(cfg),
                                                state, placer)
        state, metrics = step(state, betas[rows],
                              torch.as_tensor(data["tokens"])[rows],
                              torch.as_tensor(data["target"])[rows])
        whole = sharding.gather_state_dict(state)
        if mesh.rank == 0:
            np.savez(f"{path}.{d}x{m}.npz",
                     **{k: v.numpy() for k, v in whole.items()})
        out[f"{d}x{m}"] = {"loss": float(metrics["loss"]),
                           "grad_norm": float(metrics["grad_norm"])}
    return out


def family_run(name: str, root: str, mesh_data: str, mesh_model: str,
               epochs: str, tpu: str = "{}") -> dict:
    """``run_training`` of the drive's config as family ``name``, with the
    ``tpu:`` knobs of the JSON ``tpu``, on this rank's part of a
    mesh_data x mesh_model mesh (1 1 on one rank; mesh_model 0: no mesh);
    its report."""
    import json

    from masters_thesis_tpu_torch.experiment import run_training
    from masters_thesis_tpu_torch.parallel.multiprocess import (
        TRAIN_DRIVE_SMOKE_KEYS,
        _training_report,
        train_drive_config,
    )

    cfg = train_drive_config(root, int(mesh_model), 2, int(mesh_data))
    cfg.model = name
    for knob, value in json.loads(tpu).items():
        setattr(cfg.tpu, knob, value)
    run_path, logs, bundle = run_training(
        cfg, epochs=int(epochs), smoke_keys=TRAIN_DRIVE_SMOKE_KEYS,
        device="cpu")
    return _training_report(run_path, bundle, logs)


def plain_route_run(root: str, mesh_data: str, mesh_model: str) -> dict:
    """``family_run`` of lc_nic for one epoch under ``tpu.use_pallas:
    false``, K1's wrapper replaced by one that raises: every gather of the
    rank must take the library take. The stand-in carries K1's count for
    the report, which nothing moves while it stands."""
    from masters_thesis_tpu_torch.ops import gather

    def refused(*args, **kwargs):
        raise AssertionError("K1's wrapper called under use_pallas: false")

    refused.launches = gather.gather_rows.launches
    gather.gather_rows = refused
    return family_run("lc_nic", root, mesh_data, mesh_model, "1",
                      '{"use_pallas": false}')


def padded_vocab_run(root: str, mesh_data: str, mesh_model: str) -> dict:
    """The drive's config at vocab 61 padded to 64 on this rank's part of
    a mesh_data x mesh_model mesh; its report."""
    from masters_thesis_tpu_torch.experiment import run_training
    from masters_thesis_tpu_torch.parallel.multiprocess import (
        TRAIN_DRIVE_SMOKE_KEYS,
        _training_report,
        train_drive_config,
    )

    cfg = train_drive_config(root, int(mesh_model), 2, int(mesh_data))
    cfg.top_k = 60
    cfg.tpu.vocab_pad_multiple = 8
    run_path, logs, bundle = run_training(
        cfg, epochs=1, smoke_keys=TRAIN_DRIVE_SMOKE_KEYS, device="cpu")
    return _training_report(run_path, bundle, logs)


if __name__ == "__main__":
    main(sys.argv[1:])


def remat_step(compute_dtype: str) -> dict:
    """One sharded train step of a tiny LcNIC with every dropout on, on a
    1 x world mesh (vocab- and voxel-sharded, masks from ``batch_rand``),
    with and without ``tpu.remat``, from the same initial state: each
    loss, the largest difference of the whole updated parameters, and the
    dropout-off loss. ``compute_dtype`` "bfloat16" forces the forward into
    bf16 as on the card."""
    from masters_thesis_tpu_torch.data.synthetic import synthetic_groups
    from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
    from masters_thesis_tpu_torch.parallel import sharding
    from masters_thesis_tpu_torch.parallel.mesh import make_mesh
    from masters_thesis_tpu_torch.train import steps
    from masters_thesis_tpu_torch.train.losses import lc_nic_l2_rules
    from masters_thesis_tpu_torch.train.state import model_for, new_state

    cdt = getattr(torch, compute_dtype)
    steps._compute_dtype = lambda cfg, device: cdt
    world = torch.distributed.get_world_size()
    layout = GroupLayout(synthetic_groups(n_voxels=256, n_groups=8, seed=0),
                         256)
    rng = np.random.default_rng(0)
    betas = torch.as_tensor(rng.standard_normal((8, 256)).astype(np.float32))
    tokens = torch.as_tensor(rng.integers(1, 64, (8, 6)).astype(np.int32))
    target = torch.roll(tokens, -1, 1)
    runs = {}
    for name, remat, rate in (("plain", False, 0.3), ("remat", True, 0.3),
                              ("off", False, 0.0)):
        cfg = _tiny_cfg(dropout_features=rate, dropout_text=rate,
                        dropout_attn=rate, dropout_lstm=rate,
                        dropout_out=rate, dropout_input=rate)
        cfg.tpu.remat = remat
        mesh = make_mesh(1, world, "cpu")
        state = sharding.shard_params(
            new_state(model_for(cfg, layout), cfg, "cpu"), mesh)
        placer = sharding.MeshInputPlacer(mesh, cfg.batch_size, state,
                                          layout)
        rows = torch.as_tensor(placer.rows)
        x = betas
        if sharding.encoder_voxel_sharded(state.model, state.shards):
            x = sharding.shard_store_array(betas, layout, mesh)
        step = sharding.make_sharded_train_step(cfg, lc_nic_l2_rules(cfg),
                                                state, placer)
        state, metrics = step(state, x[rows], tokens[rows], target[rows])
        runs[name] = (float(metrics["loss"]),
                      sharding.gather_state_dict(state))
    plain, remat = runs["plain"][1], runs["remat"][1]
    return {name: loss for name, (loss, _) in runs.items()} | {
        "max_param_diff": max(float((plain[k] - remat[k]).abs().max())
                              for k in plain),
        "dtypes": sorted({str(v.dtype) for v in remat.values()})}
