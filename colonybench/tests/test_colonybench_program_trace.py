"""The readers of the program's own spans and counters
(``colonybench.program_trace``): each reads a value in a traced smoke-size
run of each serving cell on the CPU, the two shares exactly what the mix's
lengths give, and each reads None where the program keeps no registry or
its registry holds nothing."""

from __future__ import annotations

import sys
import time

import pytest

from colonybench import harness
from colonybench.traffic.requests import lengths

from smoke_cells import smoke_cell

BENCH = harness.benchmark()
SERVE = [w["name"] for w in BENCH["workloads"] if w["name"].startswith("serve-")]
READERS = ["rpc_sign_ms.serve", "broker_recover_ms.serve", "result_publish_ms.serve",
           "decode_mixer_share.serve", "prefill_padding_share.serve",
           "decode_overrun_share.serve"]


@pytest.fixture(scope="module")
def traced():
    """Per serving cell, the result of one traced smoke run."""
    from repro_torch import trace

    out = {}
    for cell in SERVE:
        trace.reset()
        kw = smoke_cell(cell)
        result, notes = harness.run_cell(cell, 2**33 + 17, 2.0, True,
                                         t_start=time.perf_counter(), **kw)
        out[cell] = (result, notes, kw["mix"])
    return out


def test_the_six_are_entries_of_both_serving_cells():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in READERS:
        assert entries[name]["workloads"] == SERVE


@pytest.mark.parametrize("cell", SERVE)
@pytest.mark.parametrize("name", READERS)
def test_reader_reads_a_traced_smoke_run(traced, cell, name):
    result, notes, _ = traced[cell]
    assert result["correct"], notes
    value = result["metrics"][name]["value"]
    assert value > 0
    if name.endswith("_share.serve"):
        assert value < 100


@pytest.mark.parametrize("cell", SERVE)
def test_the_shares_are_the_mixs(traced, cell):
    result, _, mix = traced[cell]
    prompts, asks = lengths(mix["prompt"], mix["clients"]), lengths(mix["output"], mix["clients"])
    padding = 100 * (1 - sum(prompts) / (len(prompts) * max(prompts)))
    overrun = 100 * (1 - sum(asks) / (len(asks) * max(asks)))
    assert result["metrics"]["prefill_padding_share.serve"]["value"] == pytest.approx(padding)
    assert result["metrics"]["decode_overrun_share.serve"]["value"] == pytest.approx(overrun)


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_in_an_empty_registry(name, monkeypatch):
    from repro_torch import trace

    now = time.time()
    run = {"window": {"open": now - 60.0, "close": now}}
    trace.reset()
    assert harness.reader(name)(run) is None
    # a program without the registry, as the port before it had one
    monkeypatch.delitem(sys.modules, "repro_torch.trace")
    assert harness.reader(name)(run) is None
