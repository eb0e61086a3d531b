#!/usr/bin/env python3
"""Static instruction mix of the port's CUDA kernels, from their SASS.

Run from the repository root on a machine with the CUDA toolkit (and a
card, since the kernels are built the way the port builds them):

    python3 scripts/kernel_sass.py

For each kernel function it prints the number of SASS instructions and the
most frequent opcodes, first for the whole function and then for the body
of its main loop: the longest loop that holds a barrier or a wait for
asynchronous copies (``BAR``, ``DEPBAR`` for ``cp.async.wait_group``,
``SYNCS`` for an ``mbarrier``). For the Mamba scan it also prints counts per
time step (each step stores one y value, so a loop's counts over its
``STG`` count), of the main loop (staging and the tile's steps) and of the
shortest loop that stores y (one step and its loop overhead). The
flash-attention library holds one bf16 kernel per padded head dim and the
Mamba scan one per state size (and x type); only ``--head-dims`` (default
80 and 128) and N = 16 are shown. Counts are static: a branch that runs on
few tiles (the causal mask, the staging fallback for unaligned rows, the
ragged last tile) counts as much as one that runs on every tile.
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

WAITS = {"BAR", "DEPBAR", "SYNCS"}
INTEGER = {"LEA", "LOP3", "SHF", "SEL", "PRMT", "BMSK", "SGXT", "VIADD", "VIADDMNMX",
           "VIMNMX"}  # and every I*
INSTR = re.compile(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)([.\w]*)\s*([^;]*);")


def parse(block: str) -> list[tuple[int, str, str]]:
    """(address, opcode, operands) of each instruction of one function."""
    out = []
    for line in block.splitlines():
        m = INSTR.match(line)
        if m:
            out.append((int(m.group(1), 16), m.group(2), m.group(4)))
    return out


def loops(instrs: list[tuple[int, str, str]]) -> list[list[tuple[int, str, str]]]:
    """Every loop: the instructions from the target of a backward branch to
    that branch."""
    out = []
    for i, (addr, op, args) in enumerate(instrs):
        m = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
        if not m or int(m.group(1), 16) >= addr:
            continue
        start = next(j for j, (a, _, _) in enumerate(instrs) if a >= int(m.group(1), 16))
        out.append(instrs[start:i + 1])
    return out


def main_loop(instrs: list[tuple[int, str, str]]) -> list[tuple[int, str, str]]:
    """The longest loop that holds a barrier or a wait (one of ``WAITS``)."""
    held = [body for body in loops(instrs) if any(o in WAITS for _, o, _ in body)]
    return max(held, key=len, default=[])


def step_loop(instrs: list[tuple[int, str, str]]) -> list[tuple[int, str, str]]:
    """The Mamba scan's shortest loop that stores y: the loop over the time
    steps of one tile (the ragged last tile's, where full tiles are
    unrolled), the same step body as everywhere else."""
    held = [body for body in loops(instrs) if any(o == "STG" for _, o, _ in body)]
    return min(held, key=len, default=[])


def census(instrs: list[tuple[int, str, str]], top: int) -> str:
    counts = collections.Counter(op for _, op, _ in instrs)
    return f"{len(instrs)} instructions: " + ", ".join(f"{op} {n}" for op, n in counts.most_common(top))


def per_step(instrs: list[tuple[int, str, str]]) -> str:
    """Counts per y store (one a time step) of a loop of the Mamba scan."""
    counts = collections.Counter(op for _, op, _ in instrs)
    steps = counts["STG"]
    if not steps:
        return "no STG in the loop"
    groups = {
        "MUFU": counts["MUFU"], "FFMA": counts["FFMA"], "FMUL": counts["FMUL"],
        "FADD": counts["FADD"], "LDS": counts["LDS"], "LDGSTS": counts["LDGSTS"],
        "integer": sum(n for op, n in counts.items() if op.startswith("I") or op in INTEGER),
        "all": len(instrs),
    }
    return f"{steps} steps: " + ", ".join(f"{k} {v / steps:.2f}" for k, v in groups.items())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--head-dims", type=int, nargs="*", default=[80, 128])
    parser.add_argument("--top", type=int, default=16)
    args = parser.parse_args()

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import rwkv6 as wkv

    keep = {fa: {f"ILi{(d + 15) // 16}E" for d in args.head_dims}, ms: {"ILi16E"}, wkv: {""}}
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for mod in (fa, wkv, ms):
        path = mod.build().path
        sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                              check=True).stdout
        for block in sass.split("Function : ")[1:]:
            name = block.split("\n", 1)[0].strip()
            if "f32" not in name and not any(k in name for k in keep[mod]):
                continue
            instrs = parse(block)
            print(f"{path.stem} {name}")
            print(f"  function  {census(instrs, args.top)}")
            loop = main_loop(instrs)
            print(f"  main loop {census(loop, args.top)}")
            if mod is ms:
                print(f"  main loop per step  {per_step(loop)}")
                print(f"  step loop per step  {per_step(step_loop(instrs))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
