"""Runs one cell of ``BENCHMARK.json`` once on the card and prints one JSON line.

    python3 colonybench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Exits non-zero, printing no result, without a
CUDA card (or with fewer than the cell asks for), without the port under
``src/``, or when this process holds ``jax``, ``jaxlib``, ``flax`` or
``repro`` once the window has closed. The build and kernel caches stay
inside the checkout (``build/``). With ``--trace 0`` the result's
metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from one traced batch cycle of the window. The
numbers compared to decide ``correct`` are printed beside their limits as
the last lines on standard error and under ``checks``, the result's last
key. ``--control 1`` also reads the control (the reference in TF32) on
the checked sample and prints it on standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _cache_dirs() -> None:
    """Every cache a library may write goes under the checkout's build/."""
    base = ROOT / "build" / "colonybench-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args()
    _cache_dirs()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from colonybench import harness

    entry = harness.cell_entry(harness.benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"colonybench: {args.workload} needs {entry['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("colonybench: the port (src/repro_torch) is not in this checkout", file=sys.stderr)
        return 3
    result, notes = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                     t_start=T_START, control=bool(args.control))
    loaded = sorted({n.split(".")[0] for n in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"colonybench: this process holds {loaded}", file=sys.stderr)
        return 4
    for line in notes:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
