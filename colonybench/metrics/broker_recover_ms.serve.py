"""broker_recover_ms.serve (ms): the mean time the broker took to recover
the signer of the executor's RPCs that started in the window: the
program's ``broker.recover`` spans, which the executor's transport reads
from each reply's ``Server-Timing`` header (``colonybench.program_trace``)."""

from colonybench import program_trace


def read(run: dict) -> float | None:
    return program_trace.mean_ms(run, "broker.recover")
