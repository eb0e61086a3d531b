"""device_idle_share.train (%): the share of the traced train steps (from
one step's start to the start of the step after the last) in which no
kernel, copy or fill ran on the device."""


def read(run: dict) -> float | None:
    trace = run.get("trace")
    if trace is None or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
