"""decode_step_ms.serve (ms): device time of the captured ``DecodeStep``
replays in the traced batch cycle, per replay: the kernels under the
harness's ``colonybench.decode`` range around ``DecodeStep.run``."""


def read(run: dict) -> float | None:
    trace = run.get("trace")
    if trace is None:
        return None
    rng = trace["ranges"].get("colonybench.decode")
    replays = run["trace_counts"]["decode_replays"]
    if not rng or not replays or rng["device_s"] <= 0:
        return None
    return 1e3 * rng["device_s"] / replays
