"""train_step_ms.train (ms): device time of a replayed train step: the
device's busy time over the steps replayed under the profiler after the
window (from one step's start to the start of the step after the last)."""


def read(run: dict) -> float | None:
    trace, steps = run.get("trace"), run["trace_counts"].get("train_steps", 0)
    if trace is None or not steps or trace["busy_s"] <= 0:
        return None
    return 1e3 * trace["busy_s"] / steps
