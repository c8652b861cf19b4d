"""Multi-host trial dispatch over a shared filesystem — the remote-cluster
analogue of the reference's ``ray.init(address="auto")`` + Ray Tune workers
(AttemptFour/tune.py:215-228).

TPU pods don't run Ray/NCCL control planes; the idiomatic coordination
substrate is the shared filesystem every host already mounts (NFS / GCS
fuse). The protocol is a directory queue:

    queue/
      pending/trial_0007.json     trial specs (config + id)
      running/trial_0007.json     claimed via atomic os.rename
      done/trial_0007.json        result records
      rungs.json + rungs.lock     cross-host ASHA rung state
      STOP                        sentinel: workers drain and exit

A coordinator enqueues the search space and (optionally) works the queue
itself; any number of extra hosts join with ``mtt tune --worker --queue DIR``.
``os.rename`` within one directory is atomic on POSIX (and on NFS for the
same-directory case), so each trial runs exactly once; the ASHA rung file is
guarded by an O_EXCL lockfile so the top-1/rf cutoff is computed against all
hosts' results (ASHAScheduler.on_result_shared semantics, asha.py:44-50).

Worker-crash recovery (Ray restarts lost trials when a worker node dies;
tune.py's cluster mode relies on that): a live worker HEARTBEATS its claimed
``running/`` spec by touching its mtime every few seconds, and every idle
worker / polling coordinator re-queues running specs whose heartbeat is
older than ``stale_claim_s`` (atomic rename back to pending/, so exactly one
contender performs the re-queue; clocks compared on the FILESERVER's clock,
like the lock). A re-run trial re-reports its early rungs — duplicate
observations, same as Ray's retry semantics.

The port's own copy of ``masters_thesis_tpu/tune/dispatch.py``, with the
same names and meaning (``tests/test_torch_tune.py`` runs the original's
cases against both), but for three faults of the original's ``FileLock``
heartbeat, fixed here only: a transient ``OSError`` no longer ends the
heartbeat; the heartbeat touches the lock only while the lock file holds
its own acquisition's token, through the descriptor it read the token
from, so a beat that outlives its lock cannot refresh the next holder's;
and each beat thread keeps its own stop event and token, so an
``__exit__`` whose join times out leaves the thread nothing to lose.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid

PENDING, RUNNING, DONE = "pending", "running", "done"
# the lock's heartbeat touches the file it read its token from, by
# descriptor, where the platform allows it
_UTIME_FD = os.utime in os.supports_fd


def _server_now(near_path: str) -> float:
    """The FILESERVER's clock, via a freshly-written probe file's mtime.
    Comparing another file's mtime against local time.time() would let a
    host with clock skew > the stale threshold break LIVE state. The probe
    name carries host + pid + a random suffix: pid alone collides across
    hosts sharing the queue (default pid space is 32768), and a colliding
    contender's unlink would FileNotFoundError our getmtime."""
    probe = (f"{near_path}.probe.{os.uname().nodename}."
             f"{os.getpid()}.{uuid.uuid4().hex[:8]}")
    try:
        with open(probe, "w"):
            pass
        now = os.path.getmtime(probe)
    finally:
        try:
            os.unlink(probe)
        except OSError:
            pass
    return now


class FileLock:
    """O_EXCL spin lock. Reentrant-free, crash-tolerant via stale timeout.

    A LIVE holder refreshes the lock file's mtime from a daemon thread
    (every ``stale_s/3``) so a holder merely stalled past ``stale_s`` (NFS
    server pause, host swap) is not mistaken for a dead one — only a
    process that actually died stops heartbeating and gets its lock
    broken. The lock body carries a per-acquire random token; the
    heartbeat touches the file only while it holds that token, and
    ``__exit__`` unlinks only if the file still holds OUR token, so a
    holder that WAS (correctly or not) broken can neither keep the next
    holder's lock fresh nor delete it on its way out."""

    # seconds __exit__ waits for the beat thread; a beat stuck in a slow
    # filesystem call may outlive it, and then ends on its own
    join_s = 2.0

    def __init__(self, path: str, stale_s: float = 30.0, poll_s: float = 0.02):
        self.path = path
        self.stale_s = stale_s
        self.poll_s = poll_s
        self._token: bytes | None = None
        self._beat_stop: threading.Event | None = None
        self._beat_thread: threading.Thread | None = None

    def _server_now(self) -> float:
        return _server_now(self.path)

    def __enter__(self):
        token = (f"{os.uname().nodename}:{os.getpid()}:"
                 f"{uuid.uuid4().hex}").encode()
        while True:
            try:
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, token)
                os.close(fd)
                self._token = token
                # the thread gets its own event and token: __exit__ may drop
                # its references while a stalled beat is still running
                self._beat_stop = threading.Event()
                self._beat_thread = threading.Thread(
                    target=self._beat, args=(self._beat_stop, token),
                    daemon=True)
                self._beat_thread.start()
                return self
            except FileExistsError:
                try:
                    # break dead holders' locks via atomic rename so only ONE
                    # contender removes it (a bare unlink could race another
                    # breaker and delete a freshly re-acquired lock); re-stat
                    # immediately before renaming to shrink the stale window
                    if (self._server_now() - os.path.getmtime(self.path)
                            > self.stale_s):
                        broken = f"{self.path}.broken.{os.getpid()}"
                        if (self._server_now() - os.path.getmtime(self.path)
                                > self.stale_s):
                            os.rename(self.path, broken)
                            os.unlink(broken)
                        continue
                except OSError:
                    pass
                time.sleep(self.poll_s)

    def _beat(self, stop: threading.Event, token: bytes):
        while not stop.wait(self.stale_s / 3.0):
            try:
                with open(self.path, "rb") as f:
                    if f.read() != token:
                        return  # broken and taken by another holder
                    # through the descriptor: the file touched is the one
                    # whose token was just read, even if the lock is broken
                    # and re-created in between
                    os.utime(f.fileno() if _UTIME_FD else self.path, None)
            except FileNotFoundError:
                return  # broken out from under us — stop beating
            except OSError:
                continue  # transient (NFS hiccup): beat again next period

    def __exit__(self, *exc):
        if self._beat_stop is not None:
            self._beat_stop.set()
            self._beat_thread.join(timeout=self.join_s)
            self._beat_stop = self._beat_thread = None
        try:
            with open(self.path, "rb") as f:
                still_ours = f.read() == self._token
        except OSError:
            still_ours = False
        self._token = None
        if still_ours:
            try:
                os.unlink(self.path)
            except OSError:
                pass


class FileRungs:
    """dict-like ASHA rung store backed by rungs.json; every access reads
    fresh state so the get->append->set inside the scheduler's lock window
    sees all hosts' reports."""

    def __init__(self, path: str):
        self.path = path

    def _load(self) -> dict:
        try:
            with open(self.path) as f:
                return {int(k): v for k, v in json.load(f).items()}
        except (FileNotFoundError, json.JSONDecodeError):
            return {}

    def get(self, t: int, default=None):
        return self._load().get(int(t), default)

    def __setitem__(self, t: int, vals) -> None:
        data = self._load()
        data[int(t)] = list(vals)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({str(k): v for k, v in data.items()}, f)
        os.replace(tmp, self.path)


def init_queue(queue_dir: str) -> None:
    for sub in (PENDING, RUNNING, DONE):
        os.makedirs(os.path.join(queue_dir, sub), exist_ok=True)


def enqueue_trials(queue_dir: str, configs) -> int:
    """Write one spec per trial into pending/. Returns the trial count."""
    init_queue(queue_dir)
    n = 0
    for i, cfg in enumerate(configs):
        spec = {"trial_id": i, "config": cfg}
        path = os.path.join(queue_dir, PENDING, f"trial_{i:04d}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(spec, f)
        os.replace(tmp, path)
        n += 1
    return n


def claim_next(queue_dir: str, worker_id: str) -> dict | None:
    """Atomically move one pending spec to running/; None when empty."""
    pending = os.path.join(queue_dir, PENDING)
    for name in sorted(os.listdir(pending)):
        if not name.endswith(".json"):
            continue
        src = os.path.join(pending, name)
        dst = os.path.join(queue_dir, RUNNING, name)
        try:
            os.rename(src, dst)  # atomic claim; loser raises
        except OSError:
            continue
        try:
            # fresh heartbeat NOW: rename preserves the enqueue-time mtime,
            # so a spec that sat in pending/ longer than stale_claim_s would
            # otherwise look stale to every requeue_stale poll until the
            # heartbeat thread's first touch (heartbeat_s later) — a live
            # claim would be re-queued and run twice
            os.utime(dst, None)
        except OSError:
            pass
        try:
            with open(dst) as f:
                spec = json.load(f)
        except (OSError, json.JSONDecodeError):
            # stolen back by a concurrent requeue_stale (the utime above
            # lost to another host's stale scan of the preserved enqueue
            # mtime) — the trial is pending again; move on rather than
            # crash the worker loop
            continue
        spec["_claimed"] = dst
        spec["_worker"] = worker_id
        return spec
    return None


def write_result(queue_dir: str, spec: dict, record: dict) -> None:
    name = f"trial_{spec['trial_id']:04d}.json"
    path = os.path.join(queue_dir, DONE, name)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f)
    os.replace(tmp, path)
    try:
        os.unlink(spec["_claimed"])
    except OSError:
        pass


def requeue_stale(queue_dir: str, stale_claim_s: float = 60.0) -> int:
    """Move running/ specs whose heartbeat mtime is older than
    ``stale_claim_s`` (fileserver clock) back to pending/. The winning rename
    targets a contender-private name first, so the requeue-count rewrite
    can't race another claimer; returns how many trials were re-queued."""
    running = os.path.join(queue_dir, RUNNING)
    n_requeued = _sweep_requeue_orphans(queue_dir, stale_claim_s)
    try:
        names = [n for n in os.listdir(running) if n.endswith(".json")]
    except FileNotFoundError:
        return n_requeued
    if not names:
        return n_requeued
    now = _server_now(os.path.join(running, "clock"))
    for name in sorted(names):
        src = os.path.join(running, name)
        try:
            if now - os.path.getmtime(src) <= stale_claim_s:
                continue
            mine = os.path.join(queue_dir, PENDING,
                                f"{name}.requeue.{os.getpid()}")
            os.rename(src, mine)  # atomic: one contender wins the requeue
        except OSError:
            continue
        try:
            # refresh NOW: the rename preserved the dead worker's heartbeat
            # mtime, which is >= stale_claim_s old by construction — without
            # this touch the orphan sweep's grace window never protects a
            # LIVE requeuer and a concurrent sweeper races our rewrite
            # (claim_next does the same for the same reason)
            os.utime(mine, None)
        except OSError:
            pass
        try:
            with open(mine) as f:
                spec = json.load(f)
            spec["requeues"] = int(spec.get("requeues", 0)) + 1
            spec.pop("_claimed", None)
            spec.pop("_worker", None)
            with open(mine, "w") as f:
                json.dump(spec, f)
        except (OSError, json.JSONDecodeError):
            pass  # requeue with the original spec content
        try:
            os.rename(mine, os.path.join(queue_dir, PENDING, name))
        except OSError:
            continue  # transient fs error: the orphan sweep recovers `mine`
        n_requeued += 1
    return n_requeued


def _sweep_requeue_orphans(queue_dir: str, stale_claim_s: float) -> int:
    """Recover trials stranded as ``pending/<name>.requeue.<pid>`` by a
    requeuer that died between its two renames — every listing filters on
    ``.endswith('.json')``, so without this sweep such a trial would never
    run again. Only orphans older than ``stale_claim_s`` are swept (a live
    requeuer finishes its rewrite in milliseconds), and the rename back to
    the canonical name is atomic, so at most one contender restores it."""
    pending = os.path.join(queue_dir, PENDING)
    try:
        orphans = [n for n in os.listdir(pending) if ".json.requeue." in n]
    except FileNotFoundError:
        return 0
    if not orphans:
        return 0
    now = _server_now(os.path.join(pending, "clock"))
    n = 0
    for name in sorted(orphans):
        src = os.path.join(pending, name)
        try:
            if now - os.path.getmtime(src) <= stale_claim_s:
                continue
            canonical = name.split(".requeue.")[0]
            os.rename(src, os.path.join(pending, canonical))
        except OSError:
            continue
        n += 1
    return n


_STALE_SCAN_AT: dict = {}  # queue_dir -> monotonic time of last scan


def _requeue_stale_throttled(queue_dir: str, stale_claim_s: float) -> int:
    """Per-process rate limit on the stale scan: every poll tick (0.5 s)
    doing a listdir + probe-file create/stat/unlink per caller is real
    metadata churn on NFS/GCS-fuse. Scanning every stale_claim_s/2 still
    detects a dead worker within 1.5x the staleness threshold."""
    now = time.monotonic()
    last = _STALE_SCAN_AT.get(queue_dir)
    if last is not None and now - last < stale_claim_s / 2.0:
        return 0
    _STALE_SCAN_AT[queue_dir] = now
    return requeue_stale(queue_dir, stale_claim_s)


class _Heartbeat:
    """Daemon thread touching a claimed running/ spec's mtime so other hosts
    can tell a live long trial from a dead worker's orphan."""

    def __init__(self, path: str, every_s: float = 5.0):
        self.path = path
        self.every_s = every_s
        try:
            # first beat synchronously: the thread's first touch is every_s
            # away, and claim_next's utime could itself race a slow fs
            os.utime(path, None)
        except OSError:
            pass
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(self.every_s):
            try:
                os.utime(self.path, None)
            except OSError:
                return  # spec moved (finished or re-queued) — nothing to beat

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)


def stop_queue(queue_dir: str) -> None:
    with open(os.path.join(queue_dir, "STOP"), "w") as f:
        f.write("1")


def _stopped(queue_dir: str) -> bool:
    return os.path.exists(os.path.join(queue_dir, "STOP"))


def run_worker(queue_dir: str, trial_fn, scheduler=None,
               worker_id: str | None = None, poll_s: float = 0.5,
               max_idle_s: float | None = None,
               stale_claim_s: float = 60.0,
               heartbeat_s: float = 5.0) -> int:
    """Work the queue until STOP (or ``max_idle_s`` with nothing pending).
    Returns the number of trials this worker completed. Idle workers
    re-queue dead workers' stale running/ claims (``stale_claim_s``)."""
    init_queue(queue_dir)
    worker_id = worker_id or f"{os.uname().nodename}:{os.getpid()}"
    rungs = FileRungs(os.path.join(queue_dir, "rungs.json"))
    lock = FileLock(os.path.join(queue_dir, "rungs.lock"))
    n_done = 0
    idle_since = time.time()
    while True:
        spec = claim_next(queue_dir, worker_id)
        if spec is None:
            if _requeue_stale_throttled(queue_dir, stale_claim_s):
                continue  # a dead worker's trial is pending again — claim it
            if _stopped(queue_dir):
                return n_done
            if max_idle_s is not None and time.time() - idle_since > max_idle_s:
                return n_done
            time.sleep(poll_s)
            continue
        idle_since = time.time()
        heartbeat = _Heartbeat(spec["_claimed"], every_s=heartbeat_s)
        history: list = []
        stopped_early = False

        def report(t, metrics):
            nonlocal stopped_early
            history.append({"t": t, **{k: float(v) for k, v in metrics.items()}})
            if scheduler is not None:
                decision = scheduler.on_result_shared(t, metrics, rungs, lock)
                if decision == "stop":
                    stopped_early = True
                return "stop" if decision == "complete" else decision
            return "continue"

        t0 = time.time()
        try:
            final = float(trial_fn(spec["config"], report))
            record = {
                "trial_id": spec["trial_id"], "config": spec["config"],
                "history": history, "final_metric": final,
                "stopped_early": stopped_early,
                "wall_s": time.time() - t0, "worker": worker_id,
            }
        except Exception as e:  # record the failure; keep the queue moving
            record = {
                "trial_id": spec["trial_id"], "config": spec["config"],
                "history": history, "final_metric": None,
                "error": f"{type(e).__name__}: {e}",
                "wall_s": time.time() - t0, "worker": worker_id,
            }
        finally:
            heartbeat.stop()
        if spec.get("requeues"):
            record["requeues"] = spec["requeues"]
        write_result(queue_dir, spec, record)
        n_done += 1


def collect_results(queue_dir: str, n_expected: int, poll_s: float = 0.5,
                    timeout_s: float | None = None,
                    stale_claim_s: float = 60.0) -> list[dict]:
    """Block until n_expected results exist in done/; returns them sorted.
    The poll loop re-queues dead workers' stale running/ claims so a live
    worker (any host) can pick them up."""
    done = os.path.join(queue_dir, DONE)
    t0 = time.time()
    while True:
        names = [n for n in os.listdir(done) if n.endswith(".json")]
        if len(names) >= n_expected:
            break
        _requeue_stale_throttled(queue_dir, stale_claim_s)
        if timeout_s is not None and time.time() - t0 > timeout_s:
            raise TimeoutError(
                f"{len(names)}/{n_expected} trials done after {timeout_s}s")
        time.sleep(poll_s)
    out = []
    for name in sorted(names):
        with open(os.path.join(done, name)) as f:
            out.append(json.load(f))
    return sorted(out, key=lambda r: r["trial_id"])


def _count_done(queue_dir: str) -> int:
    done = os.path.join(queue_dir, DONE)
    return len([n for n in os.listdir(done) if n.endswith(".json")])


def resume_queue(queue_dir: str, configs) -> int:
    """Reconcile an interrupted experiment's queue with THIS run's search
    space: done/ results and in-flight claims are kept (a dead coordinator's
    orphaned running/ specs fall to the stale-claim requeue), only trials
    missing from every state are enqueued, and any spec whose recorded
    config differs from this run's same-id config is refused — resume
    requires the search space to be reproduced exactly (same seed /
    deterministic search), or trial ids would silently mean different
    configs across the two runs. Returns the expected total trial count."""
    init_queue(queue_dir)
    for name in ("STOP", "rungs.lock"):  # keep rungs.json: ASHA state
        p = os.path.join(queue_dir, name)
        if os.path.exists(p):
            os.unlink(p)
    present: dict[int, dict] = {}
    for sub in (PENDING, RUNNING, DONE):
        d = os.path.join(queue_dir, sub)
        for n in os.listdir(d):
            if not n.endswith(".json"):
                continue
            try:
                with open(os.path.join(d, n)) as f:
                    spec = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue  # claimed/renamed mid-scan — its state is in flight
            present[int(spec["trial_id"])] = spec
    configs = list(configs)
    if present and max(present) >= len(configs):
        raise RuntimeError(
            f"resume mismatch: queue holds trial id {max(present)} but this "
            f"run's search space has only {len(configs)} trials — leftover "
            "trials from a larger run would leak into collect_results; "
            "resume needs the identical (seeded) search space"
        )
    for i, cfg in enumerate(configs):
        prev = present.get(i)
        if prev is not None and prev.get("config") != cfg:
            raise RuntimeError(
                f"resume mismatch: queued trial {i} has config "
                f"{prev.get('config')!r} but this run's search produced "
                f"{cfg!r} — resume needs the identical (seeded) search space"
            )
    missing = [(i, cfg) for i, cfg in enumerate(configs) if i not in present]
    for i, cfg in missing:
        path = os.path.join(queue_dir, PENDING, f"trial_{i:04d}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"trial_id": i, "config": cfg}, f)
        os.replace(tmp, path)
    return len(configs)


def run_distributed_experiment(trial_fn, search, scheduler=None,
                               metric: str = "val_loss", mode: str = "min",
                               queue_dir: str = None, work_inline: bool = True,
                               timeout_s: float | None = None,
                               stale_claim_s: float = 60.0,
                               resume: bool = False):
    """Coordinator: enqueue the search space, optionally work the queue on
    this host, gather all results. Extra hosts attach any time with
    ``run_worker(queue_dir, ...)`` / ``mtt tune --worker --queue DIR``.
    An inline coordinator keeps re-entering the worker loop until every
    trial is done, so trials re-queued after a remote worker's death
    (``stale_claim_s`` heartbeat timeout) get re-run even with no other
    worker left alive. ``resume=True`` continues an interrupted run's
    queue (done results kept, missing trials enqueued) instead of
    refusing the leftover state."""
    from masters_thesis_tpu_torch.tune.runner import TuneResult

    assert queue_dir, "queue_dir required"
    configs = list(search)
    if resume:
        n = resume_queue(queue_dir, configs)
    else:
        _require_fresh_queue(queue_dir)
        n = enqueue_trials(queue_dir, configs)
    t0 = time.time()
    try:
        if work_inline:
            while _count_done(queue_dir) < n:
                run_worker(queue_dir, trial_fn, scheduler, max_idle_s=2.0,
                           stale_claim_s=stale_claim_s)
                if _count_done(queue_dir) >= n:
                    break
                if timeout_s is not None and time.time() - t0 >= timeout_s:
                    break  # collect_results raises with the final count
                time.sleep(0.5)
        remaining = (None if timeout_s is None
                     else max(0.0, timeout_s - (time.time() - t0)))
        records = collect_results(queue_dir, n, timeout_s=remaining,
                                  stale_claim_s=stale_claim_s)
    finally:
        # ALWAYS drop the sentinel — a collect timeout or coordinator crash
        # must not leave remote `mtt tune --worker` hosts polling forever
        stop_queue(queue_dir)
    result = TuneResult(metric=metric, mode=mode)
    # keep errored records (final_metric None): best() skips them, the
    # saved results show what failed
    result.trials = records
    return result


def _require_fresh_queue(queue_dir: str) -> None:
    """Refuse stale coordinator state: a leftover STOP is cleared (it only
    means a previous run ended), but leftover done/ or pending/ trial files
    would be mistaken for THIS run's trials (names collide across runs)."""
    init_queue(queue_dir)
    stale = {
        sub: [n for n in os.listdir(os.path.join(queue_dir, sub))
              if n.endswith(".json")]
        for sub in (PENDING, RUNNING, DONE)
    }
    bad = {k: len(v) for k, v in stale.items() if v}
    if bad:
        # refuse BEFORE touching rungs.json/rungs.lock: this error path
        # tells the user to retry with --resume-queue, and resume
        # deliberately preserves rungs.json (ASHA state) — deleting it
        # first would destroy exactly what the suggested retry needs,
        # and unlinking the lock of a possibly-still-active queue could
        # free a lock a live worker holds
        raise RuntimeError(
            f"queue dir {queue_dir!r} has leftover trial files {bad} from a "
            "previous run — results would collide; use a fresh directory, "
            "clear pending/, running/ and done/, or pass --resume-queue "
            "(resume=True) to continue that run"
        )
    for name in ("STOP", "rungs.json", "rungs.lock"):
        p = os.path.join(queue_dir, name)
        if os.path.exists(p):
            os.unlink(p)
