"""prefill_ms_per_ktok.serve (ms): device time of the engine's eager
prefill in the traced batch cycle (the kernels under the harness's
``colonybench.prefill`` range) per 1,000 padded prompt tokens."""


def read(run: dict) -> float | None:
    trace = run.get("trace")
    if trace is None:
        return None
    rng = trace["ranges"].get("colonybench.prefill")
    tokens = run["trace_counts"]["prefill_tokens"]
    if not rng or not tokens or rng["device_s"] <= 0:
        return None
    return 1e3 * rng["device_s"] / (tokens / 1e3)
