"""HTTP captioning service with dynamic micro-batching.

The port's own copy of ``masters_thesis_tpu/server.py``
(``make_caption_server`` and what it builds on, with the same names and
meaning; ``tests/test_torch_copies.py`` serves one port ``Captioner``
through both). An accelerator serves well only with full batches, so the
server coalesces concurrent requests into one device call:

- HTTP handler threads enqueue (rows, decoder, future) and block on the
  future — they never touch the device;
- ONE batcher thread drains the queue: it waits up to ``max_wait_s`` after
  the first request for more work, packs consecutive same-decoder requests
  up to ``max_batch`` rows, runs a single ``Captioner.caption`` call, and
  fans the captions back out per request.

The single consumer thread also serializes every device call — no device
contention, no locks around the model.

API:
  POST /caption   body = .npy bytes (np.save format) of one row or (N, ...)
                  rows of the captioner's ``input_row_shape``, or JSON
                  {"betas": [[...], ...]}; optional ?decoder=greedy|beam|sample
                  -> {"captions": [...], "batched_with": <rows in the
                      device batch>, "decoder": ...}
  GET  /healthz   -> {"status": "ok", "n_voxels": V, ...}
  GET  /stats     -> request/batch counters (mean fill shows whether
                     batching is engaging)
"""

from __future__ import annotations

import io
import json
import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

_DECODERS = ("greedy", "beam", "sample")


@dataclass
class _Request:
    rows: np.ndarray  # (n, V) float32
    decoder: str
    future: Future = field(default_factory=Future)


class DynamicBatcher:
    """Single-consumer request coalescer around a ``Captioner``."""

    def __init__(self, captioner, max_batch: int = 64,
                 max_wait_s: float = 0.005):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.captioner = captioner
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self._q: queue.Queue = queue.Queue()
        self._stats_lock = threading.Lock()
        self.n_requests = 0
        self.n_batches = 0
        self.n_rows = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mtt-batcher")
        self._thread.start()

    def submit(self, rows: np.ndarray, decoder: str) -> Future:
        req = _Request(rows=rows, decoder=decoder)
        with self._stats_lock:
            self.n_requests += 1
        self._q.put(req)
        return req.future

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=5)

    # ---- batcher thread ----

    def _run(self) -> None:
        import time

        pushback: list[_Request] = []  # at most one carryover request
        while True:
            first = pushback.pop(0) if pushback else self._q.get()
            if first is None:
                return
            batch = [first]
            rows = len(first.rows)
            # wait briefly for co-batchable work, then drain what's there
            deadline = time.monotonic() + self.max_wait_s
            while rows < self.max_batch:
                timeout = deadline - time.monotonic()
                try:
                    nxt = self._q.get(timeout=max(timeout, 0))
                except queue.Empty:
                    break
                if nxt is None:
                    # a parked request can't be pending here: pushback is
                    # only appended-to immediately before breaking out of
                    # this loop, and the next outer iteration pops it as
                    # `first` before the sentinel is read — so flushing
                    # `batch` strands nobody
                    self._flush(batch)
                    return
                if (nxt.decoder != first.decoder
                        or rows + len(nxt.rows) > self.max_batch):
                    # incompatible with this batch: park it (it leads the
                    # next batch — FIFO preserved) and stop growing
                    pushback.append(nxt)
                    break
                batch.append(nxt)
                rows += len(nxt.rows)
                if timeout <= 0:
                    break
            self._flush(batch)

    def _flush(self, batch: list[_Request]) -> None:
        # EVERYTHING that can raise stays inside the try: an exception
        # escaping _flush kills the batcher thread, after which every
        # current and future request would hang on an unresolved future
        # while /healthz stays green (e.g. concatenate on mismatched widths
        # when the captioner has no input_width to validate against)
        try:
            rows = np.concatenate([r.rows for r in batch], axis=0)
            texts = self.captioner.caption(rows, decoder=batch[0].decoder)
        except Exception as e:  # surface the error on every waiter
            for r in batch:
                r.future.set_exception(e)
            return
        with self._stats_lock:
            self.n_batches += 1
            self.n_rows += len(rows)
        off = 0
        for r in batch:
            n = len(r.rows)
            r.future.set_result((texts[off:off + n], len(rows)))
            off += n


def _parse_body(body: bytes, content_type: str,
                row_shape: tuple | None) -> np.ndarray:
    """Decode a request body into (N, *row_shape) float32 rows.

    ``row_shape`` is the captioner's per-request input shape — (V,) for
    flat betas, (patches, channels) for image-feature models. A body of
    exactly ``row_shape`` counts as a batch of one."""
    if content_type.startswith("application/json"):
        payload = json.loads(body.decode("utf-8"))
        rows = np.asarray(payload["betas"], np.float32)
    else:
        rows = np.load(io.BytesIO(body), allow_pickle=False)
        rows = np.asarray(rows, np.float32)
    if row_shape is None:
        if rows.ndim == 1:
            rows = rows[None]
        if rows.ndim < 2:
            raise ValueError(f"betas must be batched; got {tuple(rows.shape)}")
    else:
        row_shape = tuple(int(d) for d in row_shape)
        if tuple(rows.shape) == row_shape:
            rows = rows[None]
        if rows.shape[1:] != row_shape or rows.ndim != len(row_shape) + 1:
            raise ValueError(
                f"betas must be {row_shape} or (N, "
                f"{', '.join(str(d) for d in row_shape)}); "
                f"got shape {tuple(rows.shape)}")
    if len(rows) == 0:
        raise ValueError("empty betas batch")
    return rows


def make_caption_server(captioner, host: str = "127.0.0.1", port: int = 0,
                        default_decoder: str = "greedy",
                        max_batch: int = 64, max_wait_s: float = 0.005):
    """Build (but don't start) the HTTP server. Returns it with ``.batcher``
    attached; ``server_address[1]`` carries the bound port (port=0 picks a
    free one — handy for tests)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    if default_decoder not in _DECODERS:
        raise ValueError(f"decoder must be one of {_DECODERS}")
    batcher = DynamicBatcher(captioner, max_batch=max_batch,
                             max_wait_s=max_wait_s)
    n_voxels = (None if captioner.input_width is None
                else int(captioner.input_width))
    # the full per-request shape: (V,) flat betas, (patches, channels) for
    # image-feature runs — input_width alone validates only the last dim
    row_shape = getattr(captioner, "input_row_shape", None)
    if row_shape is None and n_voxels is not None:
        row_shape = (n_voxels,)

    class Handler(BaseHTTPRequestHandler):
        # quiet per-request stderr lines; stats live at /stats
        def log_message(self, fmt, *args):  # noqa: N802
            pass

        def _reply(self, code: int, obj: dict) -> None:
            data = json.dumps(obj).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802
            path = urlparse(self.path).path
            if path == "/healthz":
                self._reply(200, {
                    "status": "ok",
                    "n_voxels": n_voxels,
                    "input_row_shape": (list(row_shape)
                                        if row_shape else None),
                    "default_decoder": default_decoder,
                    "max_batch": batcher.max_batch,
                })
            elif path == "/stats":
                with batcher._stats_lock:
                    n_req, n_b, n_rows = (batcher.n_requests,
                                          batcher.n_batches, batcher.n_rows)
                self._reply(200, {
                    "requests": n_req,
                    "batches": n_b,
                    "rows": n_rows,
                    "mean_batch_fill": (n_rows / n_b) if n_b else None,
                })
            else:
                self._reply(404, {"error": f"unknown path {path}"})

        def do_POST(self):  # noqa: N802
            url = urlparse(self.path)
            if url.path != "/caption":
                self._reply(404, {"error": f"unknown path {url.path}"})
                return
            decoder = parse_qs(url.query).get(
                "decoder", [default_decoder])[0]
            if decoder not in _DECODERS:
                self._reply(400, {
                    "error": f"decoder must be one of {_DECODERS}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                rows = _parse_body(
                    self.rfile.read(length),
                    self.headers.get("Content-Type", ""), row_shape)
            except Exception as e:
                self._reply(400, {"error": str(e)})
                return
            try:
                texts, batched_with = batcher.submit(rows, decoder).result()
            except Exception as e:
                self._reply(500, {"error": str(e)})
                return
            self._reply(200, {"captions": texts, "decoder": decoder,
                              "batched_with": batched_with})

    try:
        server = ThreadingHTTPServer((host, port), Handler)
    except OSError:
        # bind failure (EADDRINUSE etc.): without this, the batcher's
        # consumer thread — already started above — leaks with no handle
        # to close it, pinning the captioner; supervisors that retry
        # construction would leak one thread per attempt
        batcher.close()
        raise
    server.daemon_threads = True
    server.batcher = batcher
    return server
