"""mfu.train (%): the model FLOPs of the steps that ended in the window,
and of the step in flight at its close by its credited share (6·N a
trained token, N the parameters a token passes through (its experts alone
where the family has experts), plus three times the forward's q·k and p·v
over the causal pairs in each attention layer,
``reference.counts.train_step_flops``) over the window's length times the
chip's 989e12 dense peak."""

from colonybench.reference import counts


def read(run: dict) -> float | None:
    steps = run["steps_in_window"]
    if not steps:
        return None
    shape = run["train_shape"]
    flops = steps * counts.train_step_flops(run["config"], shape["batch"], shape["seq_len"])
    return 100.0 * flops / (run["seconds"] * counts.PEAK_FLOPS)
