"""Spans and counters of the port, kept in this process's memory.

``with span("serve.generate"):`` times one piece of work on the host. A
span records its name, its start on ``time.time()`` (the clock of the
broker's ``added`` times), its length on ``perf_counter``, the span that
encloses it on its thread (``parent``, a span id), its thread, a trace id
that its children inherit (a batch's process id, a request's id), and
attributes given by keyword. The last ``RING`` spans stay in a ring
(``spans_between``); per-name totals of every span, and the counters that
``count`` adds to, stay for the life of the process (``snapshot``).

While a torch profiler records on the span's thread, the span also opens
the profile range ``repro_torch.<name>``, so a profile puts the device's
idle gaps down to the program's spans. The range has the profile's
function scope, not a user annotation's: a user annotation gains a copy
on the device's timeline, which readers that sum the device's events
would take for device work. ``device_span`` also times the device while a
profiler records: a pair of CUDA events on the current stream (none while
the stream is capturing a graph), resolved by ``snapshot``; where CUDA is
not in use the host is the device, and the span's own length is its
device time. Events around eagerly launched kernels also time the host's
launches between them, so where the device must be timed alone, a graph
is captured inside ``graph_events``: its device spans become timing
events in the graph, read after each replay (``graph_replayed``). Without
a profiler a span costs two clock reads and a ring append, and makes no
range and no event.

Python's collector is traced too: every collection is a ``python.gc``
span (its generation under ``attrs``), a child of the span it interrupts.

Stdlib only at import: the broker and the clients load the port's client
modules without torch, so torch is reached only through ``sys.modules``.
"""

from __future__ import annotations

import atexit
import contextlib
import gc
import itertools
import sys
import threading
import time
from collections import deque
from typing import Any, Iterator

RING = 65_536
RANGE_PREFIX = "repro_torch."


class Span:
    """One finished (or open) span; ``seconds`` is None while it is open."""

    __slots__ = ("id", "name", "start", "seconds", "parent", "thread", "trace_id", "attrs")

    def __init__(self, name: str, start: float, parent: "Span | None", trace_id: Any,
                 attrs: dict | None, seconds: float | None = None) -> None:
        self.id = next(_ids)
        self.name = name
        self.start = start
        self.seconds = seconds
        self.parent = parent.id if parent is not None else None
        self.thread = threading.get_ident()
        self.trace_id = trace_id if trace_id is not None or parent is None else parent.trace_id
        self.attrs = attrs

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, start={self.start!r}, seconds={self.seconds!r}, "
                f"id={self.id}, parent={self.parent}, trace_id={self.trace_id!r})")


_ids = itertools.count(1)
_ring: deque[Span] = deque(maxlen=RING)
_totals: dict[str, list] = {}  # name -> [count, seconds]
_device: dict[str, list] = {}  # name -> [count, device seconds]
_counters: dict[str, int] = {}
_pending: list[tuple] = []  # (name, start event, end event), read by _resolve()
# re-entrant: a collection (and its span) can start on a thread inside the lock
_lock = threading.RLock()
_local = threading.local()
_profiler_enabled = None


def _stack() -> list[Span]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def current() -> Span | None:
    """The innermost open span on this thread."""
    stack = _stack()
    return stack[-1] if stack else None


def profiler_recording() -> bool:
    """Whether a torch profiler records on this thread (torch's private
    per-thread flag; False without torch, or while torch is half imported)."""
    global _profiler_enabled
    if _profiler_enabled is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return False
        try:
            _profiler_enabled = torch._C._autograd._profiler_enabled
        except AttributeError:
            return False
    return _profiler_enabled()


def open_range(name: str):
    """Enters and returns the profile range ``repro_torch.<name>`` of
    function scope (torch's private ``_RecordFunctionFast``); leave it with
    ``__exit__``."""
    rng = sys.modules["torch"]._C._profiler._RecordFunctionFast(RANGE_PREFIX + name)
    rng.__enter__()
    return rng


def _finish(rec: Span) -> None:
    with _lock:
        _ring.append(rec)
        total = _totals.get(rec.name)
        if total is None:
            _totals[rec.name] = [1, rec.seconds]
        else:
            total[0] += 1
            total[1] += rec.seconds


class _Span:
    __slots__ = ("rec", "device", "_t0", "_range", "_event", "_into")

    def __init__(self, name: str, trace_id: Any, attrs: dict | None, device: bool) -> None:
        self.rec = Span(name, 0.0, None, trace_id, attrs)
        self.device = device

    def __enter__(self) -> Span:
        rec, stack = self.rec, _stack()
        if stack:
            parent = stack[-1]
            rec.parent = parent.id
            if rec.trace_id is None:
                rec.trace_id = parent.trace_id
        stack.append(rec)
        self._range = self._event = self._into = None
        if self.device and getattr(_local, "graph_events", None) is not None:
            self._into = _local.graph_events  # timing events as nodes of the graph
            self._event = _cuda_event(external=True)
        elif profiler_recording():
            self._range = open_range(rec.name)
            if self.device:
                self._event = _device_event()
        rec.start = time.time()
        self._t0 = time.perf_counter()
        return rec

    def __exit__(self, *exc) -> None:
        rec = self.rec
        rec.seconds = time.perf_counter() - self._t0
        if self._into is not None:
            self._into.append((rec.name, self._event, _cuda_event(external=True)))
        elif self._range is not None:
            if self._event is _HOST:
                _add_device(rec.name, rec.seconds)
            elif self._event is not None:
                pair = (rec.name, self._event, _cuda_event())
                with _lock:
                    _pending.append(pair)
            self._range.__exit__(None, None, None)
        stack = _stack()
        if stack and stack[-1] is rec:
            stack.pop()
        elif rec in stack:
            stack.remove(rec)
        _finish(rec)


def span(name: str, trace_id: Any = None, **attrs: Any) -> _Span:
    """Context manager timing ``name`` on the host; yields its ``Span``."""
    return _Span(name, trace_id, attrs or None, False)


def device_span(name: str) -> _Span:
    """``span(name)`` that also times the device while a profiler records,
    or inside ``graph_events``: the device seconds go to
    ``snapshot()["device"]``."""
    return _Span(name, None, None, True)


@contextlib.contextmanager
def graph_events() -> Iterator[list]:
    """Around a CUDA graph's capture: every device span on this thread
    records its two timing events into the graph as nodes (external
    events), whatever the profiler does, and lists ``(name, start, end)``
    in the list this yields. After each replay, ``graph_replayed(list)``
    reads them. A graph replays its kernels back to back, so these time
    the device alone, without the host's launches between its kernels."""
    _local.graph_events = events = []
    try:
        yield events
    finally:
        _local.graph_events = None


def graph_replayed(events: list) -> None:
    """After a replay of a graph captured inside ``graph_events``: the
    earlier readings of every graph's events are read first (a replay
    overwrites them), then these wait for ``snapshot``."""
    _resolve()
    with _lock:
        _pending.extend(events)


_HOST = object()  # a device span's mark where the host is the device


def _cuda_event(external: bool = False):
    """A timing CUDA event recorded on the current stream."""
    event = sys.modules["torch"].cuda.Event(enable_timing=True, external=external)
    event.record()
    return event


def _device_event():
    """A started CUDA event on the current stream; ``_HOST`` where CUDA is
    not in use; None while the stream is capturing."""
    cuda = sys.modules["torch"].cuda
    if not cuda.is_initialized():
        return _HOST
    if cuda.is_current_stream_capturing():
        return None
    return _cuda_event()


def _add_device(name: str, seconds: float) -> None:
    with _lock:
        total = _device.setdefault(name, [0, 0.0])
        total[0] += 1
        total[1] += seconds


def _resolve() -> None:
    """Reads every pending pair of CUDA events into the device totals."""
    with _lock:
        pending = _pending[:]
        _pending.clear()
    for name, start, end in pending:
        end.synchronize()
        _add_device(name, start.elapsed_time(end) / 1e3)


def record(name: str, seconds: float, start: float) -> Span:
    """A span timed elsewhere (the broker's share of an RPC, read from its
    reply), recorded as a child of this thread's current span."""
    rec = Span(name, start, current(), None, None, seconds)
    _finish(rec)
    return rec


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def snapshot() -> dict:
    """``spans``: per name, ``count`` and ``seconds``; ``device``: the same
    for device spans' device time; ``counters``; ``launches``: the kernel
    modules' launch counts, read from ``kernels.launches`` (empty where that
    module is not loaded)."""
    _resolve()
    with _lock:
        out = {"spans": {n: {"count": c, "seconds": s} for n, (c, s) in _totals.items()},
               "device": {n: {"count": c, "seconds": s} for n, (c, s) in _device.items()},
               "counters": dict(_counters)}
    launches = sys.modules.get(f"{__package__}.kernels.launches")
    out["launches"] = launches.counts() if launches is not None else {}
    return out


def counters_since(before: dict[str, int]) -> dict[str, int]:
    """Each counter's growth since ``before``, an earlier
    ``snapshot()["counters"]``."""
    with _lock:
        return {n: c - before.get(n, 0) for n, c in _counters.items()}


def spans_between(t0: float, t1: float) -> list[Span]:
    """The ring's spans that start in [t0, t1] (``time.time()``), in the
    order they ended."""
    with _lock:
        ring = list(_ring)
    return [s for s in ring if t0 <= s.start <= t1]


def reset() -> None:
    """Empties the ring, the totals, the device times and the counters."""
    with _lock:
        _ring.clear()
        _totals.clear()
        _device.clear()
        _counters.clear()
        _pending.clear()


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        _local.gc = (time.time(), time.perf_counter(),
                     open_range("python.gc") if profiler_recording() else None)
        return
    started = getattr(_local, "gc", None)
    if started is None:
        return
    _local.gc = None
    wall, t0, rng = started
    seconds = time.perf_counter() - t0
    if rng is not None:
        rng.__exit__(None, None, None)
    _finish(Span("python.gc", wall, current(), None, {"generation": info["generation"]},
                 seconds))


gc.callbacks.append(_on_gc)
atexit.register(gc.callbacks.remove, _on_gc)  # no span while the interpreter winds down
