"""mfu.serve (%): the model FLOPs of the work the window counts (every
request of a batch published in it, and those of the batch in flight at
the close by its credited share: 2·N a token of its prompt and asked
output, N the parameters a token passes through (its experts alone where
the family has experts), plus each attention layer's q·k and p·v over the
positions each token sees, ``reference.counts.request_flops``) over the
window's length times the chip's 989e12 dense peak."""

from colonybench.reference import counts


def read(run: dict) -> float | None:
    requests = run["requests"]
    if not requests:
        return None
    flops = sum(r["credit"] * counts.request_flops(run["config"], r["prompt_len"],
                                                   r["max_new_tokens"]) for r in requests)
    return 100.0 * flops / (run["seconds"] * counts.PEAK_FLOPS)
