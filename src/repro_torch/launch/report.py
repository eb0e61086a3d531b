"""Render the dry-run's tables from results/dryrun_torch/*.json.

    PYTHONPATH=src python -m repro_torch.launch.report [--outdir results/dryrun_torch]

A copy of the reference's ``launch/report.py`` (the port imports nothing of
the reference): the same tables over the port's records, whose
``compile_s`` holds a cell's trace seconds, and whose HBM GB a device
is what one H100 of the mesh would hold (of its 80 GB).
"""

from __future__ import annotations

import argparse
import json
import os


def load(outdir: str) -> list[dict]:
    recs = []
    for fname in sorted(os.listdir(outdir)):
        if fname.endswith(".json") and fname != "summary.json":
            with open(os.path.join(outdir, fname)) as f:
                recs.append(json.load(f))
    return recs


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def roofline_table(recs: list[dict], mesh_tag: str) -> str:
    rows = [
        "| arch | shape | compute | memory | collective | bottleneck | "
        "useful-FLOPs | roofline frac | HBM GB/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for rec in recs:
        tag = "single" if rec["mesh"].get("pod") is None else "multi"
        if tag != mesh_tag:
            continue
        if rec["status"] == "skipped":
            rows.append(
                f"| {rec['arch']} | {rec['shape']} | — | — | — | SKIP | — | — | — |"
            )
            continue
        if rec["status"] != "ok":
            rows.append(
                f"| {rec['arch']} | {rec['shape']} | ERROR | | | | | | |"
            )
            continue
        r = rec["roofline"]
        m = rec["memory_analysis"]
        hbm = (
            m.get("argument_size_in_bytes", 0) + m.get("temp_size_in_bytes", 0)
        ) / 1e9
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | {fmt_s(r['compute_s'])} "
            f"| {fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} "
            f"| {r['bottleneck']} | {r['useful_flops_fraction']:.2f} "
            f"| {r['roofline_fraction']:.4f} | {hbm:.1f} |"
        )
    return "\n".join(rows)


def dryrun_table(recs: list[dict]) -> str:
    rows = [
        "| arch | shape | mesh | status | compile | FLOPs/dev | bytes/dev | coll bytes/dev | dominant collectives |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for rec in recs:
        tag = "16x16" if rec["mesh"].get("pod") is None else "2x16x16"
        if rec["status"] == "skipped":
            rows.append(f"| {rec['arch']} | {rec['shape']} | {tag} | SKIP | | | | | |")
            continue
        if rec["status"] != "ok":
            rows.append(f"| {rec['arch']} | {rec['shape']} | {tag} | ERROR | | | | | |")
            continue
        r = rec["roofline"]
        counts = rec["collectives"]["counts"]
        dom = ", ".join(f"{k}x{v}" for k, v in sorted(counts.items()))
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | {tag} | ok | {rec['compile_s']}s "
            f"| {r['flops_per_device']/1e12:.2f}T | {r['bytes_per_device']/1e9:.1f}G "
            f"| {r['collective_bytes_per_device']/1e9:.2f}G | {dom} |"
        )
    return "\n".join(rows)


def interesting_cells(recs: list[dict]) -> list[tuple[str, str, str]]:
    ok = [r for r in recs if r["status"] == "ok" and r["mesh"].get("pod") is None]
    worst = min(ok, key=lambda r: r["roofline"]["roofline_fraction"])
    coll = max(ok, key=lambda r: r["roofline"]["collective_s"])
    return [
        (worst["arch"], worst["shape"], "worst roofline fraction"),
        (coll["arch"], coll["shape"], "most collective-bound"),
    ]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="results/dryrun_torch")
    args = ap.parse_args()
    recs = load(args.outdir)
    print("## Roofline (single-pod 16x16)\n")
    print(roofline_table(recs, "single"))
    print("\n## Dry-run records (both meshes)\n")
    print(dryrun_table(recs))
    print("\nmost interesting:", interesting_cells(recs))


if __name__ == "__main__":
    main()
