"""Training across ranks in separate OS processes.

Counterpart of ``masters_thesis_tpu/parallel/multiprocess.py`` (its
product-path drive and the ``train --processes`` launcher). The launcher
starts one child interpreter a rank, all on this machine, hands each the
process group's address, the world size and its rank through ``MTT_DIST_*``
(``parallel.mesh``), and reads the tagged JSON report that rank 0 prints.
``--processes P --devices-per-process D`` starts P x D ranks, grouped as P
hosts of D ranks, contiguous on the data axis: the JAX launch's global
device count and mesh, one rank a device. A list of D's gives uneven
hosts. A rank's device is ``cuda:(rank % device_count)``, or the CPU with
``device="cpu"``: ranks that share a card run gloo, as do CPU ranks.

``run_training_inprocess`` is the drive's ``run_training`` call, shared by
the children and the single-process reference, so the trained program is
the same; ``_training_report`` is the per-epoch trajectory, the whole
parameters' norm and a SHA-256 of the whole state, and each rank's K1
launches (collective: every rank calls it, rank 0 reports).

Free-port discovery is a race (the port may be taken while the children
start): an attempt whose every failed child's error reads as a bind or
connect failure (``_looks_like_port_race``, the JAX package's markers;
torch's TCPStore reports "address already in use") is retried on a fresh
port; any other failure, or children that exit 0 without a report
(``NoReportError``), raises at once.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

from masters_thesis_tpu_torch.parallel.mesh import (
    ENV_INIT,
    ENV_LOCAL_RANK,
    ENV_LOCAL_WORLD,
    ENV_RANK,
    ENV_WORLD,
    free_port,
)

REPORT_TAG = "MPTRAIN"
TRAIN_DRIVE_SMOKE_KEYS = 24


class NoReportError(RuntimeError):
    """Children exited 0 but no report line was found: a harness
    regression, never a port race (excluded from retry, whatever words the
    embedded child output holds)."""


class ChildrenFailed(RuntimeError):
    """One or more children exited non-zero; carries each failed child's
    stderr apart, so the race heuristic classifies child by child: when
    rank 0 dies, its peers' errors read as failed connects."""

    def __init__(self, message: str, child_errors=()):
        super().__init__(message)
        self.child_errors = list(child_errors)


# only phrases of the bind/connect phase
_PORT_RACE_MARKERS = (
    "address already in use", "failed to bind", "bind failed",
    "connection refused", "failed to connect",
)
# wrapped errors ("UNAVAILABLE: ...", "deadline exceeded") count only when
# the same text also names the connect/bind phase
_PORT_RACE_WEAK = ("unavailable", "deadline exceeded")
_PORT_RACE_CONTEXT = ("bind", "connect", "coordinator_address")


def _looks_like_port_race(err_text: str) -> bool:
    t = err_text.lower()
    if any(m in t for m in _PORT_RACE_MARKERS):
        return True
    return any(m in t for m in _PORT_RACE_WEAK) and any(
        c in t for c in _PORT_RACE_CONTEXT)


def _retry_port_races(fn, attempts: int, what: str):
    last_err: Exception | None = None
    for _ in range(attempts):
        try:
            return fn()
        except NoReportError:
            raise
        except ChildrenFailed as e:
            if not (e.child_errors
                    and all(_looks_like_port_race(c)
                            for c in e.child_errors)):
                raise
            last_err = e
        except RuntimeError as e:
            if not _looks_like_port_race(str(e)):
                raise
            last_err = e
    raise RuntimeError(f"{what} failed after {attempts} attempts") \
        from last_err


def _hosts(n_processes: int, devices_per_process) -> list[int]:
    if isinstance(devices_per_process, int):
        devices_per_process = [devices_per_process] * n_processes
    devices_per_process = [int(d) for d in devices_per_process]
    if len(devices_per_process) != n_processes or min(devices_per_process) < 1:
        raise ValueError(f"devices_per_process {devices_per_process}: "
                         f"expected {n_processes} counts of at least 1")
    return devices_per_process


def _launch_children(child_code: str, n_processes: int, devices_per_process,
                     timeout: float, child_args=(),
                     report_tag: str = REPORT_TAG) -> dict:
    """Start one child a rank (P hosts of D ranks) on a fresh port; return
    the tagged JSON report a child printed, with the topology added. Each
    child's output goes to a file, so no child waits on a full pipe while
    its peers wait on it in a collective; one shared deadline bounds the
    whole launch, and on it every child is killed."""
    hosts = _hosts(n_processes, devices_per_process)
    world = sum(hosts)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base = dict(os.environ)
    base["PYTHONPATH"] = repo_root + os.pathsep + base.get("PYTHONPATH", "")
    base[ENV_INIT] = f"tcp://localhost:{free_port()}"
    base[ENV_WORLD] = str(world)
    # every host of the launch is this machine
    base[ENV_LOCAL_WORLD] = str(world)
    procs = []
    with tempfile.TemporaryDirectory(prefix="mtt_ranks_") as tmp:
        try:
            for rank in range(world):
                env = dict(base, **{ENV_RANK: str(rank),
                                    ENV_LOCAL_RANK: str(rank)})
                out = open(os.path.join(tmp, f"{rank}.out"), "w+")
                err = open(os.path.join(tmp, f"{rank}.err"), "w+")
                procs.append((subprocess.Popen(
                    [sys.executable, "-c", child_code, *map(str, child_args)],
                    env=env, cwd=repo_root, stdout=out, stderr=err,
                    text=True), out, err))
            deadline = time.monotonic() + timeout
            for proc, _, _ in procs:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for proc, _, _ in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        outs, failed = [], []
        for rank, (proc, out, err) in enumerate(procs):
            out.seek(0)
            err.seek(0)
            outs.append(out.read())
            if proc.returncode != 0:
                failed.append((rank, proc.returncode, err.read()[-2000:]))
            out.close()
            err.close()
    if failed:
        raise ChildrenFailed(
            f"multi-rank run failed: {failed}",
            child_errors=[e for _, _, e in failed])
    for out in outs:
        for line in out.splitlines():
            if line.startswith(report_tag + " "):
                report = json.loads(line[len(report_tag) + 1:])
                report.update(hosts=n_processes, ranks_per_host=hosts,
                              ranks=world)
                return report
    raise NoReportError(f"no {report_tag} report in child output: {outs}")


# ------------------------------------------------------------ the drive

def train_drive_config(run_root: str, mesh_model: int = 2,
                       scan_steps: int = 2, mesh_data: int = 0):
    """The JAX drive's tiny flagship-family config: every axis divides a
    (data, model=2) mesh, and the structured synthetic data makes the loss
    fall. ``mesh_model=0``: the single-device run of the same config."""
    from masters_thesis_tpu_torch.config import (
        Config,
        DatasetConfig,
        InputConfig,
        TPUConfig,
    )

    tpu = (TPUConfig(mesh_data=mesh_data, mesh_model=mesh_model,
                     scan_steps=scan_steps, prefetch_depth=0)
           if mesh_model else
           TPUConfig(scan_steps=scan_steps, prefetch_depth=0))
    return Config(
        run="mpdrive", log=run_root, epochs=2, batch_size=8, max_length=6,
        top_k=63, units=16, attn_units=8, group_size=4, embedding_text=8,
        seed=3, input=InputConfig(full=256),
        dataset=DatasetConfig(synthetic="structured"), tpu=tpu)


def _state_sha256(sd: dict) -> str:
    """SHA-256 of a whole state dict's tensors, by sorted name."""
    h = hashlib.sha256()
    for name in sorted(sd):
        h.update(name.encode())
        h.update(sd[name].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _training_report(run_path: str, bundle, logs) -> dict:
    """The run's trajectory, the whole parameters' norm and state hash, and
    each rank's K1 launches. Collective under a mesh: every rank calls it;
    the epoch records are read from the primary's ``metrics.jsonl``."""
    import torch
    import torch.distributed as dist

    from masters_thesis_tpu_torch.ops.gather import gather_rows
    from masters_thesis_tpu_torch.parallel.collectives import all_gather
    from masters_thesis_tpu_torch.parallel.sharding import (
        gather_state_dict,
        param_norm,
    )

    state = bundle["state"]
    launches = torch.tensor([gather_rows.launches], dtype=torch.float64)
    mesh = state.mesh
    if mesh is not None and mesh.world > 1:
        launches = all_gather(launches.to(mesh.device), 0, mesh.rank,
                              mesh.world, dist.group.WORLD).cpu()
    report = {
        "run_path": run_path,
        "final_loss": float(logs.get("loss", float("nan"))),
        "final_val_loss": float(logs.get("val_loss", float("nan"))),
        "param_norm": param_norm(state),
        "state_sha256": _state_sha256(gather_state_dict(state)),
        "latest_epoch": bundle["manager"].latest_epoch(),
        "mesh": mesh.shape if mesh is not None else None,
        "launches_by_rank": {"gather_rows": [int(x) for x in launches]},
    }
    metrics_path = os.path.join(run_path, "metrics.jsonl")
    if os.path.exists(metrics_path):
        rows = [json.loads(line) for line in open(metrics_path)
                if line.strip()]
        epochs = [r for r in rows if r.get("kind") == "epoch"]
        report["epoch_losses"] = [r["loss"] for r in epochs]
        report["epoch_val_losses"] = [r["val_loss"] for r in epochs
                                      if "val_loss" in r]
        report["steps_per_sec"] = [r["steps_per_sec"] for r in epochs]
    return report


def run_training_inprocess(run_root: str, mesh_model: int = 2,
                           epochs: int = 2, scan_steps: int = 2,
                           resume: bool = False, mesh_data: int = 0,
                           device=None) -> dict:
    """The drive's ``run_training`` call, shared by the single-process
    reference and the children."""
    from masters_thesis_tpu_torch.experiment import run_training

    cfg = train_drive_config(run_root, mesh_model, scan_steps, mesh_data)
    run_path, logs, bundle = run_training(
        cfg, epochs=epochs, smoke_keys=TRAIN_DRIVE_SMOKE_KEYS, resume=resume,
        device=device)
    return _training_report(run_path, bundle, logs)


def _child_setup(device: str) -> None:
    """A CPU rank takes its share of the cores."""
    import torch

    if device == "cpu":
        local = int(os.environ.get(ENV_LOCAL_WORLD, 1))
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local))


def _child_finish(report: dict, tag: str = REPORT_TAG) -> None:
    """Rank 0 prints the tagged report; every rank leaves the group."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"{tag} " + json.dumps(report), flush=True)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def _train_child_main(argv) -> None:
    run_root, mesh_model, epochs, scan_steps, resume, mesh_data, device = (
        argv[0], int(argv[1]), int(argv[2]), int(argv[3]), argv[4] == "1",
        int(argv[5]), argv[6])
    _child_setup(device)
    _child_finish(run_training_inprocess(
        run_root, mesh_model=mesh_model, epochs=epochs,
        scan_steps=scan_steps, resume=resume, mesh_data=mesh_data,
        device=device))


_TRAIN_CHILD = ("import sys\n"
                "from masters_thesis_tpu_torch.parallel.multiprocess import "
                "_train_child_main\n"
                "_train_child_main(sys.argv[1:])\n")


def run_multiprocess_training(run_root: str, n_processes: int = 2,
                              devices_per_process=2, mesh_model: int = 2,
                              epochs: int = 2, scan_steps: int = 2,
                              resume: bool = False, mesh_data: int = 0,
                              device: str = "cuda", timeout: float = 900,
                              attempts: int = 3) -> dict:
    """The drive across ranks in separate processes; rank 0's report.
    ``devices_per_process`` may be a list for uneven hosts."""
    return _retry_port_races(
        lambda: _launch_children(
            _TRAIN_CHILD, n_processes, devices_per_process, timeout,
            child_args=(run_root, mesh_model, epochs, scan_steps,
                        "1" if resume else "0", mesh_data, device)),
        attempts, "multi-rank training drive")


def _cli_train_child_main(argv) -> None:
    """A ``train --processes P`` rank: the user's config through
    ``run_training``."""
    from masters_thesis_tpu_torch.config import load_config
    from masters_thesis_tpu_torch.experiment import run_training

    config_path, epochs_s, smoke_keys_s, resume_s, device = argv[:5]
    _child_setup(device)
    cfg = load_config(config_path)
    if cfg.tpu.mesh_data == 1 and cfg.tpu.mesh_model == 1:
        # a 1 x 1 mesh would train P unsharded copies: data-parallel over
        # every rank instead
        cfg.tpu.mesh_data = 0
    run_path, logs, bundle = run_training(
        cfg, epochs=None if epochs_s == "none" else int(epochs_s),
        smoke_keys=int(smoke_keys_s), resume=resume_s == "1", device=device)
    _child_finish(_training_report(run_path, bundle, logs))


_CLI_TRAIN_CHILD = ("import sys\n"
                    "from masters_thesis_tpu_torch.parallel.multiprocess "
                    "import _cli_train_child_main\n"
                    "_cli_train_child_main(sys.argv[1:])\n")


def launch_cli_train(config_path: str, n_processes: int = 2,
                     devices_per_process=4, epochs: int | None = None,
                     smoke_keys: int = 48, resume: bool = False,
                     device: str = "cuda", timeout: float = 3600,
                     attempts: int = 3) -> dict:
    """``train --processes P``: P x D ranks run ``run_training`` on the
    user's config; rank 0's report."""
    return _retry_port_races(
        lambda: _launch_children(
            _CLI_TRAIN_CHILD, n_processes, devices_per_process, timeout,
            child_args=(os.path.abspath(config_path),
                        "none" if epochs is None else epochs, smoke_keys,
                        "1" if resume else "0", device)),
        attempts, "train --processes")

