"""rpc_sign_ms.serve (ms): the mean time the executor's client took to sign
an RPC's envelope (the program's ``rpc.sign`` spans), over its RPCs that
started in the window (``colonybench.program_trace``)."""

from colonybench import program_trace


def read(run: dict) -> float | None:
    return program_trace.mean_ms(run, "rpc.sign")
