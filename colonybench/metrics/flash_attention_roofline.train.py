"""flash_attention_roofline.train (%): B1's share of its roofline in the
traced train steps. Inside the captured step the profiler sees kernels and
no op calls, so every launch of the kernels that
``metrics/kernels/flash_attention.json`` names is counted at the step's
one shape: q, k and v of (batch, seq_len, heads, head_dim), causal (the
forward and its recomputation under the backward)."""

from colonybench import roofline
from colonybench.reference import counts


def read(run: dict) -> float | None:
    cfg, shape = run["config"], run["train_shape"]
    h = cfg["num_attention_heads"]
    d = cfg["hidden_size"] // h
    q = [shape["batch"], shape["seq_len"], h, d]
    kv = [shape["batch"], shape["seq_len"], cfg["num_key_value_heads"], d]
    return roofline.share(run, "flash_attention", counts.flash_attention_least,
                          every_call=[q, kv, kv])
