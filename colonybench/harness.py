"""One cell, run once: what ``run.py`` does after its checks, and what the
CPU tests drive at smoke size.

Everything is found by name. ``BENCHMARK.json`` gives the cell's
configuration and traffic mix; the configuration's file lies where its
entry says, the mix is ``traffic/<mix>.json``, whose ``kind`` names the
module that runs it (``colonybench.traffic.<kind>``), the cell's limits
are ``cells/<cell>.json``, and each per-layer metric is read by
``metrics/<metric>.py``'s ``read(run)``, which returns None where it finds
nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "colonybench"


@dataclass
class Context:
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: str
    src: Path
    t_start: float
    cfg: dict
    mix: dict
    limits: dict
    variant: str
    control: bool = False
    hooks: list[Callable[[Any], None]] = field(default_factory=list)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(bench: dict, name: str) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return load_json(ROOT / entry["file"])


def mix_file(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones, or with
    ``trace`` the per-layer ones."""
    section = bench["per_layer" if trace else "end_to_end"]
    return [m for m in section if cell in m.get("workloads", [cell])]


def reader(name: str) -> Callable[[dict], float | None]:
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"colonybench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def check_config(cfg: dict, variant: str) -> None:
    """The program's configuration of ``variant`` has the file's sizes."""
    from repro_torch.configs import get_config

    from .reference import models

    want, got = models.family(cfg).sizes(cfg, get_config(cfg["port"]["arch"], variant))
    if got != want:
        raise RuntimeError(f"the program's {cfg['port']['arch']} {variant} is {got}, "
                           f"the configuration file says {want}")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device: str = "cuda", cfg: dict | None = None, variant: str | None = None,
             mix: dict | None = None, limits: dict | None = None, hooks: list | None = None,
             control: bool = False) -> tuple[dict, list[str]]:
    """(the result line's object, notes for standard error)."""
    bench = benchmark()
    entry = cell_entry(bench, workload)
    cfg = cfg or config_file(bench, entry["config"])
    variant = variant or cfg["port"]["variant"]
    check_config(cfg, variant)
    mix = mix or mix_file(entry["traffic"])
    limits = limits or load_json(HERE / "cells" / f"{workload}.json")
    kind = importlib.import_module(f"colonybench.traffic.{mix['kind']}")
    ctx = Context(workload=workload, seed=seed, seconds=seconds, trace=trace, device=device,
                  src=ROOT / "src", t_start=t_start, cfg=cfg, mix=mix, limits=limits,
                  variant=variant, control=control, hooks=list(hooks or []))
    out = kind.run(ctx)

    values = dict(out["end_to_end"], setup_s=out["setup_s"])
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = reader(m["name"])(out["run"]) if trace else values.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {name: {"value": v, "limit": lim} for name, (v, lim) in out["checks"].items()}
    dev = {"platform": "gpu" if device == "cuda" else device, "count": entry["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"]}
    if device == "cuda":
        import torch

        dev["kind"] = torch.cuda.get_device_name(0)
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": dev}
    summary = out["run"]["trace"]
    if trace and summary is not None:
        from .trace import breakdown

        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = breakdown(summary)
    result["checks"] = checks
    notes = out["notes"] + [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
                            for name, c in checks.items()]
    return result, notes

