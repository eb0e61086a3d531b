#!/usr/bin/env bash
# The port's contract planes on the CPU (see TORCH_CONTRACTS.md): the six
# static gates of repro_torch.analysis over src/repro_torch, then the
# port's broker, HA and chaos test files under the runtime detectors.
#
#   scripts/verify_torch.sh
#
# chip_smoke.py runs the same gates in its [contracts] phase and every
# broker process it starts under REPRO_LOCK_CHECK=1 and REPRO_AUTH_CHECK=1.
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}

# Static gates: concurrency lint, authorization lint and permission-matrix
# drift, replication lint and replicated-op-matrix drift, idempotency.
python -m repro_torch.analysis.lint
python -m repro_torch.analysis.authlint
python -m repro_torch.analysis.authmap --check
python -m repro_torch.analysis.replint
python -m repro_torch.analysis.replmap --check
python -m repro_torch.analysis.idemlint

# The analysis plane's own tests (seeded violations, parity with the
# reference's lints, the broker stress and every RPC under the detectors).
python -m pytest -q tests/test_torch_concurrency.py tests/test_torch_authz.py \
    tests/test_torch_replint.py tests/test_torch_idemlint.py

# The port's broker, databases, HA cluster, faults and chaos soak under all
# three runtime detectors: the lock-order detector (recorded violations
# fail the run through the torch_lock_gate plugin), the auth-fact
# contracts (a handler without its fact raises) and the replication
# digests (a divergence raises).
REPRO_LOCK_CHECK=1 REPRO_AUTH_CHECK=1 REPRO_REPL_CHECK=1 \
    PYTHONPATH=tests:$PYTHONPATH python -m pytest -q -p torch_lock_gate \
    tests/test_torch_broker.py tests/test_torch_database.py tests/test_torch_durable.py \
    tests/test_torch_faults.py tests/test_torch_raft.py tests/test_torch_blobstore.py \
    tests/test_torch_cron.py tests/test_torch_ha.py tests/test_torch_chaos_soak.py
