"""What the per-layer readers take from the program's own spans and
counters: the registry ``repro_torch.trace`` of the measured process,
where the serving executor runs. The harness's own client sends nothing
while the window is open (it waits on the clients' process), so every
span that starts in the window is the executor's. A program without that
registry, or one that holds nothing for the window, gives None."""

from __future__ import annotations

import sys


def registry():
    """The program's ``repro_torch.trace`` module, where this process loaded it."""
    return sys.modules.get("repro_torch.trace")


def window_spans(run: dict, name: str) -> list:
    """The spans named ``name`` that started in the run's window."""
    reg, window = registry(), run.get("window") or {}
    if reg is None or "open" not in window:
        return []
    return [s for s in reg.spans_between(window["open"], window["close"]) if s.name == name]


def mean_ms(run: dict, name: str) -> float | None:
    spans = window_spans(run, name)
    return 1e3 * sum(s.seconds for s in spans) / len(spans) if spans else None


def wasted_share(run: dict, used: str, slots: str) -> float | None:
    """1 - sum(``used``) / sum(``slots``) in percent, over the attributes of
    the window's ``serve.generate`` spans (one a batch)."""
    spans = [s for s in window_spans(run, "serve.generate") if s.attrs and slots in s.attrs]
    total = sum(s.attrs[slots] for s in spans)
    if not total:
        return None
    return 100.0 * (1.0 - sum(s.attrs[used] for s in spans) / total)


def device_share(part: str, whole: str) -> float | None:
    """The device time of the device span ``part`` over that of ``whole``,
    in percent, over every one the profiler saw."""
    reg = registry()
    if reg is None:
        return None
    device = reg.snapshot()["device"]
    if part not in device or not device.get(whole, {}).get("seconds"):
        return None
    return 100.0 * device[part]["seconds"] / device[whole]["seconds"]
