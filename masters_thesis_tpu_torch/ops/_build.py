"""Build and load the port's CUDA kernels (``csrc/*.cu``) on first use.

Each source compiles with its own ``nvcc`` for ``sm_90a``, all started
together, and the objects link into one shared library with a plain C
interface, loaded with ``ctypes``. The library lands in
``build/torch_kernels/`` at the repo root, named by a hash of the sources and
flags, so an edit rebuilds and an unchanged tree reuses the build. Nothing
here runs at import time: the CPU tests import every module of the port on
machines without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# mtt_fused_greedy_decode: 25 pointers, 9 sizes, the plans (tile, feed,
# slices) of h W2, the cell, Wi and Wo, the two slopes, the device and the
# stream; mtt_fused_greedy_decode_gru: 24 pointers, 9 sizes, the zero-state
# flag, the plans of h W2, Wi and Wo, then as K2; mtt_greedy_decode_bf16: the array of its
# tensors' pointers, the launch record on the host and on the device
# (ops/decode_plan.py), the two slopes, the device and the stream;
# mtt_fused_seq_forward: 18 pointers, 7
# sizes, the attention's slope, the cell's and h W2's plans, the device and
# the stream; mtt_fused_seq_forward_bf16: the same less the plans, with a
# 19th pointer, the weights' transpose for the wgmma cell, or null;
# mtt_gather_rows: store, ids, out, the launch record (sizes,
# device and plan: ops/gather.py::_pack), stream; mtt_gather_rows_chunked: store, ids, out, 4 byte
# sizes, the chunk's bytes, rows, id width, device, stream;
# mtt_gather_rows_bulk: the same with the stages in place of the chunk
_SIGNATURES = {
    "mtt_fused_greedy_decode": ([_P] * 25 + [_I] * 21 + [_F, _F, _I, _P],
                                ctypes.c_int),
    "mtt_fused_greedy_decode_gru": ([_P] * 24 + [_I] * 19 + [_F, _F, _I, _P],
                                    ctypes.c_int),
    "mtt_greedy_decode_bf16": ([_P] * 3 + [_F, _F, _I, _P], ctypes.c_int),
    "mtt_fused_seq_forward": ([_P] * 18 + [_I] * 7 + [_F] + [_I] * 7 + [_P],
                              ctypes.c_int),
    "mtt_fused_seq_forward_bf16": ([_P] * 19 + [_I] * 7 + [_F, _I, _P],
                                   ctypes.c_int),
    "mtt_gather_rows": ([_P] * 5, ctypes.c_int),
    "mtt_gather_rows_chunked": ([_P] * 3 + [_L] * 5 + [_I] * 3 + [_P],
                                ctypes.c_int),
    "mtt_gather_rows_bulk": ([_P] * 3 + [_L] * 4 + [_I] * 4 + [_P],
                             ctypes.c_int),
    "mtt_error_string": ([_I], ctypes.c_char_p),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's CUDA kernels cannot be built")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"mtt_kernels_{digest.hexdigest()[:16]}.so"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernels; raise if nvcc fails."""
    out = library_path()
    if not out.exists():
        build(out)
    lib = ctypes.CDLL(str(out))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def build(out: Path) -> float:
    """Compile every ``csrc/*.cu`` into ``out``; returns the seconds taken.
    One ``nvcc`` a source, all running at once, then one link. The
    compilers' reports (registers, spills) go to ``out`` + ``.log``."""
    out.parent.mkdir(parents=True, exist_ok=True)
    cu = [s for s in _sources() if s.suffix == ".cu"]
    t0 = time.perf_counter()
    # compile to private names, then rename: a concurrent build never
    # loads a half-written library
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in cu]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", str(src),
                                   "-o", obj], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(cu, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(cu, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                    f"{log}")
        lib = os.path.join(tmp, out.name)
        link = subprocess.run([_nvcc(), "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):"
                               f"\n{link.stderr}")
        out.with_suffix(".log").write_text("".join(logs))
        os.replace(lib, out)
    return time.perf_counter() - t0


def check_error(code: int, what: str) -> None:
    if code != 0:
        msg = load_library().mtt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
