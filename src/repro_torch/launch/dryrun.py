"""Multi-pod dry-run CLI: every (architecture x input shape) cell,
traced on the single-pod 16x16 mesh and the 2x16x16 multi-pod mesh.

Port of the reference's ``launch/dryrun.py``. It runs inside
``fake_world(512)``, torch's ``"fake"`` process group of 512 ranks in one
process: each cell traces the port's step on fake shards
(``launch.dryrun_lib``) and records what one H100 of the mesh would hold
and do (``launch.roofline``). The mesh is a ``"cuda"`` one where torch has
CUDA, a ``"cpu"`` one otherwise, and the trace takes the card's path
either way. Records go to ``--outdir`` (``results/dryrun_torch``, apart
from the reference's ``results/dryrun``), one JSON file a cell and a
``summary.json``; ``launch.report`` renders them. Exits 1 on any error.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b --shape prefill_32k --mesh single
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv: list[str] | None = None) -> list[dict]:
    import torch

    from ..configs import ARCH_IDS, SHAPES
    from .dryrun_lib import sweep
    from .mesh import fake_world, make_production_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--outdir", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    device_type = "cuda" if torch.cuda.is_available() else "cpu"

    all_results = []
    with fake_world(512):
        if args.mesh in ("single", "both"):
            mesh = make_production_mesh(multi_pod=False, device_type=device_type)
            all_results += sweep(archs, shapes, mesh, args.outdir, "single", force=args.force)
        if args.mesh in ("multi", "both"):
            mesh = make_production_mesh(multi_pod=True, device_type=device_type)
            all_results += sweep(archs, shapes, mesh, args.outdir, "multi", force=args.force)

    ok = sum(1 for r in all_results if r["status"] == "ok")
    skipped = sum(1 for r in all_results if r["status"] == "skipped")
    errors = [r for r in all_results if r["status"] == "error"]
    print(f"\n=== dry-run summary: ok={ok} skipped={skipped} errors={len(errors)} ===")
    for r in errors:
        print(f"  ERROR {r['arch']} {r['shape']} ({r['mesh']}): {r['error'][:200]}")
    os.makedirs(args.outdir, exist_ok=True)
    summary_path = os.path.join(args.outdir, "summary.json")
    with open(summary_path, "w") as f:
        json.dump(all_results, f, indent=1)
    print(f"wrote {summary_path}")
    if errors:
        raise SystemExit(1)
    return all_results


if __name__ == "__main__":
    main()
