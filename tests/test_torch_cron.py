"""The port's cron (``repro_torch.broker.cron``) against the reference's
``repro.core.cron``: the same next deadline for a grid of expressions and
start times and for bounded hypothesis draws, the same error class for
invalid expressions, and a ``CronExtension`` on each broker that answers
one script of signed cron requests alike and fires the same workflows."""

import json
import time

import pytest
from hypothesis import given, settings, strategies as st

from repro.core.cluster import standalone_server as ref_standalone_server
from repro.core.cron import next_cron_deadline_ns as ref_next
from repro_torch.broker import standalone_server
from repro_torch.broker.cron import CronExtension, next_cron_deadline_ns
from repro_torch.core import errors
from repro_torch.core.client import Colonies, InProcTransport
from repro_torch.core.crypto import Crypto
from test_torch_broker import KEYS, _Numbering

EXPRESSIONS = [
    "* * * * *", "*/5 * * * *", "5/15 * * * *", "11-20/5 3 * * *", "3-10/3,30 */2 * * *",
    "0 0 * * 0", "0 0 * * 7", "0 0 * * 6-7", "0 0 13 * 5", "0 0 13 * *", "0 0 13 * */2",
    "30 12 1,15 * *", "0 9-17 * * 1-5", "15 4 * */3 *", "0 0 1 * *", "59 23 * * 6",
    "*/7 */3 */4 */5 */2",
]
STARTS = [1_700_000_000 * 10**9, 1_709_251_199 * 10**9 + 123, 1_735_689_540 * 10**9,
          1_719_791_999 * 10**9 + 999_999_999]


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_next_deadline_equals_the_reference_on_a_grid(expr):
    for start in STARTS:
        t_ours = t_ref = start
        for _ in range(3):  # the next three firings
            t_ours, t_ref = next_cron_deadline_ns(expr, t_ours), ref_next(expr, t_ref)
            assert t_ours == t_ref, (expr, start)
        assert t_ours > start and (t_ours // 10**9) % 60 == 0


def _field(lo: int, hi: int):
    num = st.integers(lo, hi)
    return st.one_of(
        st.just("*"),
        num.map(str),
        st.tuples(num, st.integers(1, 12)).map(lambda t: f"*/{t[1]}" if t[0] % 2 else
                                               f"{t[0]}/{t[1]}"),
        st.tuples(num, num).map(lambda t: f"{min(t)}-{max(t)}"),
        st.lists(num, min_size=1, max_size=3).map(lambda v: ",".join(map(str, v))),
    )


# Bounded: every month has the drawn days of the month (1-28), so each
# search ends within about a month of minutes.
@settings(max_examples=40, deadline=None)
@given(minute=_field(0, 59), hour=_field(0, 23), dom=st.one_of(st.just("*"), _field(1, 28)),
       dow=_field(0, 7), start=st.integers(1_600_000_000, 1_900_000_000))
def test_next_deadline_equals_the_reference_on_draws(minute, hour, dom, dow, start):
    expr = f"{minute} {hour} {dom} * {dow}"
    start_ns = start * 10**9 + 17
    assert next_cron_deadline_ns(expr, start_ns) == ref_next(expr, start_ns), expr


BAD = ["* * *", "", "* * * * * *", "99 * * * *", "* 24 * * *", "* * 0 * *", "* * * 13 *",
       "1-5/0 * * * *", "*/0 * * * *", "a * * * *", "5-1 * * * *", "1-2-3 * * * *",
       "* * 31 2 *"]


@pytest.mark.parametrize("expr", BAD)
def test_invalid_expressions_raise_the_same_error_class(expr):
    start = STARTS[0]
    with pytest.raises(Exception) as ours:
        next_cron_deadline_ns(expr, start)
    with pytest.raises(Exception) as theirs:
        ref_next(expr, start)
    assert type(ours.value).__name__ == type(theirs.value).__name__, expr
    assert type(ours.value).__name__ in ("ValidationError", "ValueError")


WF = {"colonyname": "dev", "functionspecs": [
    {"nodename": "fetch", "funcname": "fetch", "args": [1],
     "conditions": {"executortype": "worker", "dependencies": []}},
    {"nodename": "reduce", "funcname": "reduce",
     "conditions": {"executortype": "worker", "dependencies": ["fetch"]}}]}


def _cron_script(client: Colonies, srv) -> list:
    """The same cron requests and leader ticks for either broker."""
    log = []
    cron = next(e for e in srv.extensions if type(e).__name__ == "CronExtension")

    def call(fn, *args, **kwargs):
        try:
            log.append(fn(*args, **kwargs))
        except errors.ColoniesError as e:
            log.append({"error": type(e).__name__, "status": e.status})
        return log[-1]

    k, ident = KEYS, {n: Crypto.id(v) for n, v in KEYS.items()}
    colony = k["colony"]
    call(client.add_colony, "dev", ident["colony"], k["server"])
    c1 = call(client.add_cron, {"colonyname": "dev", "name": "every", "interval": 2.0,
                                "workflow": WF}, colony)
    call(client.add_cron, {"colonyname": "dev", "name": "daily", "cronexpr": "0 3 * * *",
                           "workflow": WF}, colony)
    call(client.add_cron, {"colonyname": "dev", "name": "none", "workflow": WF}, colony)  # 400
    call(client.add_cron, {"colonyname": "dev", "name": "empty", "interval": 1,
                           "workflow": {"colonyname": "dev", "functionspecs": []}}, colony)
    call(client.add_cron, {"colonyname": "dev", "name": "bad", "cronexpr": "99 * * * *",
                           "workflow": WF}, colony)  # 400
    call(client.add_cron, {"colonyname": "dev", "name": "x", "interval": 1, "workflow": WF},
         k["stranger"])  # 403
    call(client.get_crons, "dev", colony)
    log.append(cron.tick())  # the deadline is ahead: nothing fires
    time.sleep(max(0.0, (c1["deadline"] - time.time_ns()) / 1e9) + 0.05)
    log.append(cron.tick())  # fires "every" once, and re-arms it
    log.append(cron.tick())
    call(client._rpc, "runcron", {"cronid": c1["cronid"]}, colony)  # force-fire
    call(client._rpc, "runcron", {"cronid": "0" * 32}, colony)  # 404
    call(client.get_processes, "dev", colony, count=100)
    call(client.get_crons, "dev", colony)
    call(client.remove_cron, c1["cronid"], colony)
    call(client.remove_cron, c1["cronid"], colony)  # 404
    call(client.get_crons, "dev", colony)
    log.append(cron.triggered)
    return log


def _norm(obj):
    """Run times are set or not; the rest as ``tests/test_torch_broker.py``
    numbers it."""
    if isinstance(obj, dict):
        return {k: bool(v) if k == "lastrun" else _norm(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_norm(v) for v in obj]
    return obj


def test_cron_extension_fires_the_same_workflows_as_the_reference():
    server_id = Crypto.id(KEYS["server"])
    ours, theirs = standalone_server(server_id), ref_standalone_server(server_id)
    assert any(isinstance(e, CronExtension) for e in ours.extensions)
    try:
        got = _cron_script(Colonies(InProcTransport([ours])), ours)
        want = _cron_script(Colonies(InProcTransport([theirs])), theirs)
    finally:
        ours.stop()
        theirs.stop()
    got, want = _Numbering()(_norm(got)), _Numbering()(_norm(want))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"reply {i}: {json.dumps(a)} != {json.dumps(b)}"
    procs = got[-6]
    # two firings (the tick and runcron) of a two-node workflow
    assert len(procs) == 4 and got[-1] == 2
    assert got[8:11] == [0, 1, 0]
