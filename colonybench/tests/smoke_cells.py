"""Smoke-size stand-ins for the benchmark's cells, for the CPU tests: each
configuration at the port's ``smoke`` sizes, its mix cut to 4 clients and
short prompts (training: B=2 x 16), the limits set for this size."""

from __future__ import annotations

from colonybench import harness

SMOKE_DIMS = {
    "stablelm-3b": dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=4, intermediate_size=176, vocab_size=256),
    "rwkv6-7b": dict(hidden_size=64, num_hidden_layers=2, head_size=16, intermediate_size=224,
                     vocab_size=256, decay_lora=8, mix_lora=8),
}
SMOKE_MIX = {
    "chat": dict(clients=4, queuesize=4, max_len=64, grace_s=30.0,
                 prompt={"dist": "lognormal", "median": 12, "sigma": 0.6, "min": 4, "max": 32},
                 output={"dist": "lognormal", "median": 8, "sigma": 0.6, "min": 2, "max": 16}),
    "longdoc": dict(clients=4, queuesize=4, max_len=128, grace_s=30.0,
                    prompt={"dist": "lognormal", "median": 40, "sigma": 0.35, "min": 20,
                            "max": 80},
                    output={"dist": "lognormal", "median": 8, "sigma": 0.35, "min": 4,
                            "max": 16}),
    "train": dict(batch=2, seq_len=16),
}
# float32 against float32 at this size reads 0 (every served token the
# reference's argmax) or, training, about 1e-6; a fault reads 1e-3 or more
SMOKE_LIMIT = 1e-4
SMOKE_ERROR = 1e-3  # the program's logits against the reference's: about 1e-5 here
SMOKE_TRAIN_LIMITS = {"loss_gap": 1e-5, "grad_norm_gap": 1e-5, "change_norm_gap": 1e-5}


def smoke_config(name: str) -> dict:
    bench = harness.benchmark()
    return dict(harness.config_file(bench, name), **SMOKE_DIMS[name])


def at_file_widths(program, cfg: dict):
    """The program's configuration with the file's RWKV LoRA widths, which
    the port's model takes from the weights' shapes."""
    from dataclasses import replace

    if "mix_lora" not in cfg:
        return program
    return program.copy(rwkv=replace(program.rwkv, decay_lora=cfg["decay_lora"],
                                     mix_lora=cfg["mix_lora"]))


def smoke_cell(cell: str) -> dict:
    """run_cell's keyword arguments for ``cell`` at smoke size on the CPU."""
    entry = harness.cell_entry(harness.benchmark(), cell)
    limits = harness.load_json(harness.HERE / "cells" / f"{cell}.json")
    smoke = dict(SMOKE_TRAIN_LIMITS, max_logit_gap=SMOKE_LIMIT, max_logit_error=SMOKE_ERROR,
                 median_logit_error=SMOKE_ERROR)
    limits = {k: smoke.get(k, v) for k, v in limits.items()}  # the cell's own numbers
    return {"device": "cpu", "variant": "smoke", "cfg": smoke_config(entry["config"]),
            "mix": dict(harness.mix_file(entry["traffic"]), **SMOKE_MIX[entry["traffic"]]),
            "limits": limits}


