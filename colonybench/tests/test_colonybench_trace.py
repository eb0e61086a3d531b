"""The trace reduction and the metric readers, on hand-made records."""

from __future__ import annotations

import pytest
import torch

from colonybench import harness, trace


def test_merge_and_cover():
    assert trace._merge([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]
    # busy 0-3 and 5-6 (us); the range spans 1-5.5: 2 us of the first, 0.5 of the second
    assert trace._covered([[0, 3], [5, 6]], [[1, 5.5]]) == pytest.approx(2.5e-6)


def test_breakdown_sums_gaps_by_label():
    summary = {"kernels": [["k1", 3, 2.0], ["k2", 1, 1.0]],
               "gaps": [["colonybench.rpc.assign", 0.5], ["colonybench.rpc.addfile", 0.2],
                        ["colonybench.rpc.assign", 0.25]]}
    out = trace.breakdown(summary)
    assert out["device_ops"] == [["k1", 2.0], ["k2", 1.0]]
    assert out["idle_gaps"] == [["colonybench.rpc.assign", 0.75], ["colonybench.rpc.addfile", 0.2]]


def test_cpu_profile_reads_ranges_and_host():
    tracer = trace.Tracer()
    tracer.start()
    with torch.profiler.record_function("colonybench.demo"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    tracer.stop()
    s = tracer.summary()
    assert s["window_s"] > 0 and s["busy_s"] == 0.0  # no device here


RUN = {
    "seconds": 10.0, "config": harness.config_file(harness.benchmark(), "stablelm-3b"),
    "spans": [["pack", 0.0, 0.05], ["getfiles", 1.0, 0.07], ["other", 2.0, 9.0]],
    "batches": [{"start": 0.0, "end": 10.0, "engine_s": 8.0}],
    "requests": [{"prompt_len": 100, "max_new_tokens": 50, "credit": 1.0},
                 {"prompt_len": 60, "max_new_tokens": 20, "credit": 0.25}],
    "trace": {"window_s": 10.0, "busy_s": 7.5, "kernels": [], "ops": {},
              "ranges": {"colonybench.decode": {"calls": 1, "device_s": 0.5},
                         "colonybench.prefill": {"calls": 1, "device_s": 0.2}}},
    "trace_counts": {"decode_replays": 20, "prefill_tokens": 4000},
}


@pytest.mark.parametrize("name,value", [
    ("broker_rpc_ms.serve", 60.0), ("outside_engine_share.serve", 20.0),
    ("decode_step_ms.serve", 25.0), ("prefill_ms_per_ktok.serve", 50.0),
    ("device_idle_share.serve", 25.0)])
def test_readers_by_hand(name, value):
    assert harness.reader(name)(RUN) == pytest.approx(value)


def test_readers_find_nothing_without_a_trace():
    bare = dict(RUN, trace=None)
    for name in ("decode_step_ms.serve", "prefill_ms_per_ktok.serve", "device_idle_share.serve",
                 "flash_attention_roofline.serve", "rwkv6_wkv_roofline.serve"):
        assert harness.reader(name)(bare) is None


def test_mfu_by_hand():
    from colonybench.reference import counts

    want = 100 * (counts.request_flops(RUN["config"], 100, 50)
                  + 0.25 * counts.request_flops(RUN["config"], 60, 20)) / (10.0 * 989e12)
    assert harness.reader("mfu.serve")(RUN) == pytest.approx(want)
