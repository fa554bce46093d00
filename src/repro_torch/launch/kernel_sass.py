"""What the card runs for a hand-written kernel: its SASS and opcode counts.

    python3 -m repro_torch.launch.kernel_sass wkv6_kernelI13__nv_bfloat16Li64E [--out DIR]

Builds the kernel library (``kernels/_build.py``), disassembles it with the
CUDA toolkit's ``cuobjdump -sass``, and for every function whose mangled
name holds the given fragment prints its instruction count by opcode, and
the same count inside each innermost loop (the SASS between a branch
target and the branch that jumps back to it, holding no other such
loop).  With ``--out`` the whole listing of each matched function is
written there.  Needs the CUDA toolkit (the card's machine); no GPU is
used.
"""
from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

from repro_torch.kernels import _build

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/cuobjdump")
    if default.exists():
        return str(default)
    raise SystemExit("kernel_sass: cuobjdump not found on PATH or in the CUDA toolkit")


def functions(sass: str) -> dict[str, list[tuple[int, str, str]]]:
    """{mangled name: [(address, opcode, operands), ...]} of a listing."""
    out: dict[str, list[tuple[int, str, str]]] = {}
    name = None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            out[name] = []
            continue
        m = _INSTR.search(line)
        if name and m:
            out[name].append((int(m.group(1), 16), m.group(3), m.group(4).strip()))
    return out


def loops(instrs: list[tuple[int, str, str]]) -> list[tuple[int, int]]:
    """(start, end) indices of the innermost backward branches' bodies, in
    address order (a branch to itself, the end of a kernel, is none)."""
    at = {addr: n for n, (addr, _, _) in enumerate(instrs)}
    spans = []
    for n, (addr, op, args) in enumerate(instrs):
        target = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and target and int(target.group(1), 16) < addr:
            spans.append((at.get(int(target.group(1), 16), 0), n))
    return sorted(s for s in spans
                  if not any(o != s and s[0] <= o[0] and o[1] <= s[1] for o in spans))


def histogram(instrs) -> str:
    counts = collections.Counter(op.split(".")[0] for _, op, _ in instrs)
    return ", ".join(f"{op} {n}" for op, n in counts.most_common())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("fragment", help="part of the kernel's mangled name")
    ap.add_argument("--out", type=Path, default=None, help="directory for the listings")
    args = ap.parse_args(argv)
    lib = _build.build()
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    found = {k: v for k, v in functions(sass).items() if args.fragment in k}
    if not found:
        print(f"kernel_sass: no function matches {args.fragment!r}", file=sys.stderr)
        return 1
    for name, instrs in found.items():
        print(f"[sass] {name}: {len(instrs)} instructions: {histogram(instrs)}")
        for start, end in loops(instrs):
            body = instrs[start:end + 1]
            print(f"[sass]   loop {instrs[start][0]:#06x}-{instrs[end][0]:#06x}: "
                  f"{len(body)} instructions: {histogram(body)}")
        if args.out:
            args.out.mkdir(parents=True, exist_ok=True)
            (args.out / f"{name[-60:]}.sass").write_text(
                "\n".join(f"{a:#06x} {op} {ops}" for a, op, ops in instrs) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
