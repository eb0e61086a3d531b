"""decode_overrun_share.serve (%): the share of the decode's token slots
that lie past their request's ask: 1 - the tokens the requests asked for
over the batch size times the largest ask, summed over the batches that
started in the window (the attributes of the program's ``serve.generate``
spans, which the counters ``serve.asked_tokens`` and
``serve.decode_slots`` add up; ``colonybench.program_trace``)."""

from colonybench import program_trace


def read(run: dict) -> float | None:
    return program_trace.wasted_share(run, "asked_tokens", "decode_slots")
