#!/usr/bin/env python3
"""Static instruction mix of the port's CUDA kernels, from their SASS.

Run from the repository root on a machine with the CUDA toolkit (and a
card, since the kernels are built the way the port builds them):

    python3 scripts/kernel_sass.py

For each kernel function it prints the number of SASS instructions and the
most frequent opcodes, first for the whole function and then for the body
of its main loop: the longest loop that holds a barrier. The
flash-attention library holds one bf16 kernel per padded head dim and the
Mamba scan one per state size; only ``--head-dims`` (default 80 and 128)
and N = 16 are shown. Counts are static: a branch that runs on few tiles
(the causal mask, the staging fallback for unaligned rows) counts as much
as one that runs on every tile.
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

INSTR = re.compile(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)([.\w]*)\s*([^;]*);")


def parse(block: str) -> list[tuple[int, str, str]]:
    """(address, opcode, operands) of each instruction of one function."""
    out = []
    for line in block.splitlines():
        m = INSTR.match(line)
        if m:
            out.append((int(m.group(1), 16), m.group(2), m.group(4)))
    return out


def main_loop(instrs: list[tuple[int, str, str]]) -> list[tuple[int, str, str]]:
    """The longest loop that holds a barrier: the instructions from the
    target of a backward branch to that branch, with a BAR among them."""
    best: list[tuple[int, str, str]] = []
    for i, (addr, op, args) in enumerate(instrs):
        m = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
        if not m or int(m.group(1), 16) >= addr:
            continue
        start = next(j for j, (a, _, _) in enumerate(instrs) if a >= int(m.group(1), 16))
        body = instrs[start:i + 1]
        if len(body) > len(best) and any(o == "BAR" for _, o, _ in body):
            best = body
    return best


def census(instrs: list[tuple[int, str, str]], top: int) -> str:
    counts = collections.Counter(op for _, op, _ in instrs)
    return f"{len(instrs)} instructions: " + ", ".join(f"{op} {n}" for op, n in counts.most_common(top))


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
            print(f"  main loop {census(main_loop(instrs), args.top)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
