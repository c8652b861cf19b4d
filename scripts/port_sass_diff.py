#!/usr/bin/env python3
"""Compare the machine code (SASS) of the PyTorch port's decode kernels
between two builds of its kernel library, kernel by kernel.

    python3 scripts/port_sass_diff.py OLD.so NEW.so [--unit fused_decode]
        [--rename OLD_KEY=NEW_KEY ...]

Each ``.so`` is a library that ``masters_thesis_tpu_torch/ops/_build.py``
built into ``build/torch_kernels/``. The kernels of one translation unit
(``csrc/<unit>.cu``) are matched by name and template arguments, with the
unit's anonymous-namespace hash and a template flag that defaults to false
left out, and compared instruction by instruction: exactly, and with the
kernel-parameter offsets (``c[0x0][...]``) masked, which shift when a
kernel's parameter list changes. A kernel whose key changed between the
builds (a template flag removed, say) is paired by ``--rename``. Prints one
line a kernel with both verdicts and the number of instructions that
differ. Needs ``cuobjdump`` from the
CUDA toolkit (on PATH, or under CUDA_HOME or /usr/local/cuda).
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess

_PARAM = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")
_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
# a kernel's name (tile_kernel, tile_kernel_tma, ...) and its whole template
# argument list, in a mangled name
_KERNEL = re.compile(r"\d+([a-z_]+_kernel(?:_[a-z]+)?)(I(?:L[^E]*E)*E)?")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda",
                        "bin", "cuobjdump")


def kernels(lib: str, unit: str) -> dict[str, list[str]]:
    """Kernel key -> its SASS instructions, for the kernels of ``unit``."""
    sass = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out: dict[str, list[str]] = {}
    current = None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            current = None
            if f"_{unit}_cu_" in name:
                # e.g. ..._fused_decode_cu_<hash>11rows_kernelILi2EEEv...:
                # the name, then its whole template argument list; a name
                # the pattern does not take (digits, type arguments: the
                # bf16 decode's) is keyed by its mangled rest, hash left out
                m = _KERNEL.search(name)
                if m is None:
                    key = re.sub(r"^[0-9a-f]{8}", "",
                                 name.split(f"_{unit}_cu_", 1)[1])
                else:
                    args = (m.group(2) or "").replace("Lb0E", "")
                    key = m.group(1) + ("" if args == "IE" else args)
                current = out.setdefault(key, [])
            continue
        ins = _INSTRUCTION.search(line)
        if current is not None and ins:
            current.append(ins.group(1))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("old")
    parser.add_argument("new")
    parser.add_argument("--unit", default="fused_decode",
                        help="translation unit (csrc/<unit>.cu) to compare")
    parser.add_argument("--show", type=int, default=0, metavar="N",
                        help="print the first N instructions that differ, "
                        "offsets masked, of each kernel that differs")
    parser.add_argument("--rename", action="append", default=[],
                        metavar="OLD_KEY=NEW_KEY",
                        help="compare the old build's kernel OLD_KEY with the "
                        "new build's NEW_KEY (repeatable)")
    args = parser.parse_args(argv)
    old, new = kernels(args.old, args.unit), kernels(args.new, args.unit)
    for pair in args.rename:
        before, after = pair.split("=")
        if before in old:
            old[f"{before} -> {after}"] = old.pop(before)
        if after in new:
            new[f"{before} -> {after}"] = new.pop(after)
    for key in sorted(old.keys() | new.keys()):
        a, b = old.get(key), new.get(key)
        if a is None or b is None:
            print(f"{key}: only in {'new' if a is None else 'old'}")
            continue
        ma = [_PARAM.sub("c[0x0][P]", i) for i in a]
        mb = [_PARAM.sub("c[0x0][P]", i) for i in b]
        differ = sum(x != y for x, y in zip(ma, mb)) + abs(len(a) - len(b))
        print(f"{key}: {len(a)} and {len(b)} instructions; identical "
              f"{a == b}; identical with parameter offsets masked "
              f"{ma == mb} ({differ} differ)")
        shown = [(i, x, y) for i, (x, y) in enumerate(zip(ma, mb)) if x != y]
        for i, x, y in shown[:args.show]:
            print(f"  {i}: {x}  |  {y}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
