"""A kernel's share of its roofline over one traced window.

The least time of each call of the kernel's custom op, from its input
shapes (the reader's function from ``reference.counts``), summed over the
traced calls, over the
device time of the kernels that ``metrics/kernels/<kernel>.json`` names.
None where the trace holds no call, no such kernel, or another number of
launches than calls (the profiler lost some).
"""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def share(run: dict, kernel: str, least, every_call: list | None = None) -> float | None:
    """Percent of the roofline ``kernel`` reached in the traced window;
    ``least(shapes, itemsize)`` gives one call's least seconds. The calls'
    shapes come from the traced op calls, or, where the kernels ran inside
    a graph, where the profiler sees no op, each launch has the shapes
    ``every_call``."""
    trace = run.get("trace")
    if trace is None:
        return None
    spec = json.loads((HERE / "metrics" / "kernels" / f"{kernel}.json").read_text())
    ran = [(c, s) for name, c, s in trace["kernels"] if any(k in name for k in spec["kernels"])]
    launches, device_s = sum(c for c, _ in ran), sum(s for _, s in ran)
    calls = trace["ops"].get(spec["op"], []) if every_call is None else \
        [{"shapes": every_call}] * launches
    if not calls or device_s == 0 or launches != len(calls):
        return None
    itemsize = 4 if run["config"]["dtype"] == "float32" else 2
    return 100.0 * sum(least(call["shapes"], itemsize) for call in calls) / device_s
