"""The port's spans and counters (``repro_torch.trace``): nesting, parents
and trace ids, the ring's bound, totals and counters, the launch counts
read through ``kernels.launches``, the module loading without torch, the
profile ranges under ``torch.profiler`` (and none without it), device
spans on the CPU, the collector's spans, and the ``Server-Timing``
header's parse. The ``cuda`` tests hold a device span under a capture to
no event, and the timing events a graph captures inside ``graph_events``
to one reading a replay."""

import gc
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from repro_torch import trace
from repro_torch.core.http_transport import server_timing
from repro_torch.kernels import launches

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def empty():
    trace.reset()
    yield
    trace.reset()


def _named(name):
    return [s for s in trace.spans_between(0.0, float("inf")) if s.name == name]


def test_nesting_parents_and_trace_ids():
    with trace.span("outer", trace_id="pid-1") as outer:
        assert trace.current() is outer
        with trace.span("middle") as middle:
            with trace.span("inner", trace_id="rid-7", rows=3) as inner:
                pass
        with trace.span("sibling") as sibling:
            pass
    assert trace.current() is None
    assert outer.parent is None and middle.parent == outer.id and inner.parent == middle.id
    assert sibling.parent == outer.id
    assert (outer.trace_id, middle.trace_id, inner.trace_id, sibling.trace_id) == \
        ("pid-1", "pid-1", "rid-7", "pid-1")
    assert inner.attrs == {"rows": 3} and outer.attrs is None
    assert outer.seconds >= middle.seconds >= inner.seconds >= 0
    assert outer.start <= middle.start <= inner.start
    assert {s.thread for s in (outer, middle, inner)} == {threading.get_ident()}
    # the ring holds them in the order they ended
    names = [s.name for s in trace.spans_between(0.0, float("inf")) if s.name != "python.gc"]
    assert names == ["inner", "middle", "sibling", "outer"]


def test_a_span_on_another_thread_has_no_parent_here():
    got = {}

    def worker():
        with trace.span("worker") as s:
            got["s"] = s

    with trace.span("main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert got["s"].parent is None and got["s"].thread != threading.get_ident()


def test_a_raising_span_is_recorded_and_leaves_the_stack():
    with pytest.raises(ValueError):
        with trace.span("fails"):
            raise ValueError("boom")
    assert trace.current() is None and len(_named("fails")) == 1


def test_the_ring_keeps_the_last_spans_and_the_totals_all():
    for i in range(trace.RING + 5):
        with trace.span("many", trace_id=i):
            pass
    ring = _named("many")
    assert len(trace.spans_between(0.0, float("inf"))) == trace.RING
    assert ring[-1].trace_id == trace.RING + 4 and ring[0].trace_id >= 5
    assert trace.snapshot()["spans"]["many"]["count"] == trace.RING + 5


def test_spans_between_selects_by_start():
    early = trace.record("a", 5.0, 100.0)  # ends after the next one starts
    late = trace.record("b", 1.0, 102.0)
    assert trace.spans_between(100.0, 101.0) == [early]
    assert trace.spans_between(101.0, 102.0) == [late]
    assert trace.spans_between(99.0, 103.0) == [early, late]
    assert trace.spans_between(102.5, 110.0) == []


def test_totals_counters_and_counters_since():
    for _ in range(3):
        with trace.span("t"):
            pass
    trace.count("c")
    trace.count("c", 4)
    before = trace.snapshot()["counters"]
    trace.count("c", 2)
    trace.count("d", 5)
    snap = trace.snapshot()
    assert snap["spans"]["t"]["count"] == 3 and snap["spans"]["t"]["seconds"] >= 0
    assert snap["counters"] == {"c": 7, "d": 5}
    assert trace.counters_since(before) == {"c": 2, "d": 5}
    trace.reset()
    assert trace.snapshot()["counters"] == {} and trace.snapshot()["spans"] == {}


def test_launch_counts_are_read_through_not_copied(monkeypatch):
    for i, mod in enumerate(launches.MODULES.values()):
        monkeypatch.setattr(mod, "launches", 10 + i)
    assert trace.snapshot()["launches"] == launches.counts() == \
        {name: 10 + i for i, name in enumerate(launches.MODULES)}
    monkeypatch.setattr(launches.MODULES["flash_attention"], "launches", 99)
    assert trace.snapshot()["launches"]["flash_attention"] == 99


def test_counters_and_totals_are_exact_across_threads():
    def work():
        for _ in range(1000):
            trace.count("threads")
            with trace.span("threads"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    snap = trace.snapshot()
    assert snap["counters"]["threads"] == snap["spans"]["threads"]["count"] == 1000 * len(threads)


def test_the_module_and_the_client_load_without_torch():
    """As the broker and the clients' processes load them: the package
    registered by its path, torch refused."""
    code = (
        "import sys, types\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'torch':\n"
        "            raise ImportError('torch refused')\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "pkg = types.ModuleType('repro_torch')\n"
        f"pkg.__path__ = [{str(ROOT / 'src' / 'repro_torch')!r}]\n"
        "sys.modules['repro_torch'] = pkg\n"
        "from repro_torch import trace\n"
        "import repro_torch.core.client, repro_torch.core.http_transport\n"
        "import repro_torch.broker.http_server\n"
        "with trace.span('x'):\n"
        "    with trace.device_span('y'):\n"
        "        trace.count('z')\n"
        "import gc; gc.collect()\n"
        "snap = trace.snapshot()\n"
        "assert not trace.profiler_recording()\n"
        "assert snap['counters'] == {'z': 1} and snap['launches'] == {} and snap['device'] == {}\n"
        "assert snap['spans']['x']['count'] == 1 and snap['spans']['python.gc']['count'] >= 1\n"
        "assert not [n for n in sys.modules if n.split('.')[0] == 'torch']\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_profiler_recording_is_this_threads_flag():
    from torch.profiler import ProfilerActivity, profile

    seen = {}
    assert not trace.profiler_recording()
    with profile(activities=[ProfilerActivity.CPU]):
        seen["here"] = trace.profiler_recording()
        t = threading.Thread(target=lambda: seen.setdefault("there", trace.profiler_recording()))
        t.start()
        t.join()
    assert seen == {"here": True, "there": False}
    assert not trace.profiler_recording()


def test_spans_are_function_scope_ranges_of_the_profile():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("serve.generate"):
            with trace.device_span("decode.step"):
                torch.ones(8, 8) @ torch.ones(8, 8)
        gc.collect()
    events = {e.name: e for e in prof.events() if e.name.startswith("repro_torch.")}
    assert {"repro_torch.serve.generate", "repro_torch.decode.step",
            "repro_torch.python.gc"} <= set(events)
    # not user annotations: those gain a copy on the device's timeline
    assert all(e.scope == int(torch._C._profiler.RecordScope.FUNCTION)
               for e in events.values())
    # the host is the device here: the device span's own length is its device time
    device = trace.snapshot()["device"]
    assert device["decode.step"]["count"] == 1
    assert device["decode.step"]["seconds"] == pytest.approx(
        trace.snapshot()["spans"]["decode.step"]["seconds"])


def test_without_a_profiler_no_range_and_no_device_time(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range opened for {name}")

    monkeypatch.setattr(trace, "open_range", refuse)
    with trace.span("a"):
        with trace.device_span("b"):
            gc.collect()
    assert trace.snapshot()["device"] == {} and len(_named("b")) == 1


def test_a_collection_is_a_span_of_the_span_it_interrupts():
    with trace.span("work") as work:
        gc.collect(1)
    (g,) = [s for s in _named("python.gc") if s.parent == work.id]
    assert g.attrs == {"generation": 1} and g.seconds >= 0 and g.start >= work.start


def test_record_places_a_span_under_the_current_one():
    with trace.span("rpc.x") as rpc:
        rec = trace.record("broker.recover", 0.25, rpc.start)
    assert rec.parent == rpc.id and rec.seconds == 0.25 and rec.start == rpc.start
    assert trace.snapshot()["spans"]["broker.recover"] == {"count": 1, "seconds": 0.25}


@pytest.mark.parametrize("header,want", [
    ("recover;dur=47.5, handle;dur=3.25", {"recover": 0.0475, "handle": 0.00325}),
    ("handle;dur=1", {"handle": 0.001}),
    ('recover;desc="sig";dur=2.0,handle;dur=x', {"recover": 0.002}),
    ("", {}),
    (None, {}),
])
def test_server_timing_parse(header, want):
    got = server_timing(header)
    assert got.keys() == want.keys()
    assert all(got[k] == pytest.approx(v) for k, v in want.items())


@pytest.mark.cuda
def test_cuda_a_device_span_under_capture_records_no_event():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.ones(256, 256, device="cuda")
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        x @ x  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(stream)
    # as though a profiler recorded, without one across the capture
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trace, "profiler_recording", lambda: True)
        with torch.cuda.graph(graph):
            with trace.device_span("captured"):
                y = x @ x
        with trace.device_span("eager"):
            y = x @ x
    graph.replay()
    torch.cuda.synchronize()
    device = trace.snapshot()["device"]
    assert "captured" not in device and device["eager"]["count"] == 1
    assert device["eager"]["seconds"] > 0 and y.shape == (256, 256)


@pytest.mark.cuda
def test_cuda_graph_events_time_each_replay():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.randn(1024, 1024, device="cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        x @ x  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with trace.graph_events() as events, torch.cuda.graph(graph):
        with trace.device_span("outer"):
            with trace.device_span("inner"):
                y = x @ x
            y = (y @ x) @ x
    assert [name for name, _, _ in events] == ["inner", "outer"]
    assert trace.snapshot()["device"] == {}  # nothing read until a replay
    for _ in range(3):
        graph.replay()
        trace.graph_replayed(events)  # the readings of the replay before are kept
    device = trace.snapshot()["device"]
    assert device["outer"]["count"] == device["inner"]["count"] == 3
    # three products against one
    assert 2.0 < device["outer"]["seconds"] / device["inner"]["seconds"] < 4.0
    assert y.shape == (1024, 1024)
