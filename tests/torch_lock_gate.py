"""A pytest plugin that fails the run when the port's lock-order detector
recorded a violation, and prints its per-family hold times.

``REPRO_LOCK_CHECK=1 PYTHONPATH=src:tests python -m pytest -p
torch_lock_gate tests/test_torch_ha.py`` (``scripts/verify_torch.sh``
runs it so): the detector records violations rather than raising them,
so without this gate a run under it would pass whatever it found.
"""

import os
import sys


def pytest_sessionfinish(session, exitstatus):
    if os.environ.get("REPRO_LOCK_CHECK", "") in ("", "0"):
        return
    from repro_torch.analysis import locktrack

    stats = locktrack.hold_stats()
    print("\nrepro_torch lock holds (family: count, max ms):", file=sys.stderr)
    for fam, st in sorted(stats.items()):
        print(f"  {fam}: {st['count']}, {st['max_ns'] / 1e6:.3f}", file=sys.stderr)
    vs = locktrack.violations()
    if vs:
        print(f"repro_torch REPRO_LOCK_CHECK: {len(vs)} violation(s):", file=sys.stderr)
        for v in vs:
            print(f"  [{v['kind']}] ({v['thread']}) {v['msg']}", file=sys.stderr)
        session.exitstatus = 3
