"""One traced window of ``torch.profiler`` and what the metric readers
take from it.

The window is opened and closed on the executor's thread (``start``,
``stop``); the profile is read after the measured window has closed
(``summary``), so reading it delays no request. ``summary`` returns:

* ``window_s``: the traced window's length on the host clock;
* ``busy_s``: the union of the device's kernel, copy and fill intervals
  (the ranges' own device annotations left out);
* ``kernels``: [name, launches, device seconds] by device time;
* ``ranges``: per ``colonybench.*`` range (the harness's wrappers around
  the program's calls), its calls and the device's busy seconds inside the
  device spans the profiler gives it (graph replays included);
* ``ops``: each call of a custom op ``repro_torch::*``, its input shapes;
* ``gaps``: the idle gaps of the device, those before its first and after
  its last kernel included, each labelled with the innermost harness range
  on the host that covers most of it.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


class Tracer:
    def __init__(self) -> None:
        self.prof = None
        self.t0 = self.t1 = None

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                            record_shapes=True)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def summary(self) -> dict | None:
        if self.prof is None or self.t1 is None:
            return None
        kernels: dict[str, list] = defaultdict(lambda: [0, 0.0])
        intervals = []  # the device's kernels, copies and fills
        marks: dict[str, list] = defaultdict(list)  # the device span of each harness range
        ops: dict[str, list] = defaultdict(list)
        host = []
        first, last = float("inf"), float("-inf")  # the traced window on the profiler's clock
        for e in self.prof.events():
            span = (e.time_range.start, e.time_range.end)
            first, last = min(first, span[0]), max(last, span[1])
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if e.name.startswith("colonybench."):  # a range's annotation on the device
                    marks[e.name].append(span)
                    continue
                k = kernels[e.name]
                k[0] += 1
                k[1] += (span[1] - span[0]) / 1e6
                intervals.append(span)
            elif e.name.startswith("colonybench."):
                host.append((*span, e.name))
            elif e.name.startswith("repro_torch::"):
                ops[e.name].append({"shapes": e.input_shapes})
        intervals.sort()
        merged = _merge(intervals)
        gaps = []
        edges = [[first, first]] + merged + [[last, last]] if merged else []
        for (_, a), (b, _) in zip(edges, edges[1:]):
            if b - a < 50:  # under 50 us: launch spacing, not the host
                continue
            over = [(min(t, b) - max(s, a), t - s, name) for s, t, name in host]
            most = max((o for o, _, _ in over), default=0.0)
            # the innermost range that covers about as much of the gap as any
            inner = [(span, name) for o, span, name in over if o > 0 and o >= 0.9 * most]
            gaps.append([min(inner)[1] if inner else "host: no harness range", (b - a) / 1e6])
        return {
            "window_s": self.t1 - self.t0,
            "busy_s": sum(t - s for s, t in merged) / 1e6,
            "kernels": sorted(([n, c, s] for n, (c, s) in kernels.items()), key=lambda r: -r[2]),
            "ranges": {n: {"calls": len(spans), "device_s": _covered(merged, _merge(sorted(spans)))}
                       for n, spans in marks.items()},
            "ops": dict(ops),
            "gaps": sorted(gaps, key=lambda g: -g[1]),
        }


def _merge(spans: list) -> list[list[float]]:
    out: list[list[float]] = []
    for s, t in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _covered(busy: list[list[float]], spans: list[list[float]]) -> float:
    """Seconds of ``busy`` inside ``spans`` (both sorted and disjoint, in us)."""
    total, j = 0.0, 0
    for s, t in busy:
        while j < len(spans) and spans[j][1] <= s:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < t:
            total += min(t, spans[k][1]) - max(s, spans[k][0])
            k += 1
    return total / 1e6


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the 10 device operations that took
    most time and the 10 longest idle gaps, by what the host was doing."""
    gaps: dict[str, float] = defaultdict(float)
    for label, s in summary["gaps"]:
        gaps[label] += s
    return {"device_ops": [[n, s] for n, _, s in summary["kernels"][:10]],
            "idle_gaps": sorted(([n, s] for n, s in gaps.items()), key=lambda g: -g[1])[:10]}
