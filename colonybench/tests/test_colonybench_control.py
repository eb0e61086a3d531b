"""The control at a size a test run holds: the reference computed in TF32
(the nearest precision below the configurations' float32 with TF32 off),
put in the program's place, has to fail the check that the program's own
served tokens pass. 128 prompts of 24 tokens and 48 greedy tokens each
(6,144 checked positions), on three seeds, for both configurations at
smoke size; on the CPU, TF32 is float32 with the products' inputs rounded
to 10 mantissa bits."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from colonybench import weights
from colonybench.reference import check

from smoke_cells import SMOKE_LIMIT, smoke_config


@pytest.mark.parametrize("seed", [11, 2**31 + 3, 2**40 + 17])
@pytest.mark.parametrize("name", ["stablelm-3b", "rwkv6-7b"])
def test_control_fails_where_the_program_passes(name, seed):
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeEngine

    cfg = smoke_config(name)
    params, _ = weights.make(cfg, seed, torch.device("cpu"))
    prompts = np.random.default_rng(seed).integers(0, cfg["vocab_size"], (128, 24))
    port = get_config(name, "smoke").copy(param_dtype="float32", compute_dtype="float32")
    engine = ServeEngine(port, params, max_len=96, device="cpu")
    served = engine.generate(prompts, 48)
    with torch.inference_mode():
        first = engine._prefill(engine.params, {"tokens": torch.as_tensor(prompts)})[0]
    last = next(iter(engine.steps.values())).logits
    items = [{"prompt": p.tolist(), "padded_len": 24, "served": s.tolist(), "all": s.tolist(),
              "prefill": first[i, -1], "last": last[i, -1]}
             for i, (p, s) in enumerate(zip(prompts, served))]
    program = check.served(params, cfg, items, torch.device("cpu"), chunk=32)
    control = check.control(params, cfg, items, torch.device("cpu"), chunk=32)
    assert program["tokens"] == 128 * 48
    assert program["max_logit_gap"] <= SMOKE_LIMIT < control["max_logit_gap"]
    assert program["max_logit_error"] * 10 <= control["max_logit_error"]
    assert program["median_logit_error"] * 10 <= control["median_logit_error"]
