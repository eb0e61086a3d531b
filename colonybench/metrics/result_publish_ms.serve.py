"""result_publish_ms.serve (ms): the mean time the batch handler took to
publish one request's tokens in CFS (the program's ``serve.publish``
spans), over the requests of the batches that started in the window
(``colonybench.program_trace``)."""

from colonybench import program_trace


def read(run: dict) -> float | None:
    return program_trace.mean_ms(run, "serve.publish")
