"""prefill_padding_share.serve (%): the share of the prefill's token slots
that are padding: 1 - the prompts' own tokens over the batch size times
the padded length, summed over the batches that started in the window
(the attributes of the program's ``serve.generate`` spans, which the
counters ``serve.prompt_tokens`` and ``serve.prefill_tokens`` add up;
``colonybench.program_trace``)."""

from colonybench import program_trace


def read(run: dict) -> float | None:
    return program_trace.wasted_share(run, "prompt_tokens", "prefill_tokens")
