"""The work a window holds: every unit of work (a wave of requests, a train
step) that completed in it, and the unit in flight at its close credited
by the share of its span that fell inside the window.

A unit's span runs from the completion of the one before it (or the
window's opening) to its own completion, so the host's time between units
belongs to the next one. A rate over the window then moves with every
unit's length, a stall or a gain anywhere in the window included, and not
only when a whole unit crosses the close.
"""

from __future__ import annotations


def credits(ends: list[float], t_open: float, t_close: float) -> list[float]:
    """Each unit's share counted in the window, given the units' completion
    times in the order they complete: 1 for a unit that completed by the
    close, the share of its span inside the window for the first one after
    it, 0 for the rest."""
    out = []
    prev = t_open
    for end in ends:
        if end <= t_close:
            out.append(1.0)
        elif prev < t_close:
            out.append((t_close - prev) / (end - prev))
        else:
            out.append(0.0)
        prev = max(prev, end)
    return out
