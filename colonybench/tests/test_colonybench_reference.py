"""The plain reference against the port at smoke size on the CPU, and the
benchmark's weights in the port's layout."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from colonybench import weights
from colonybench.reference import check, models

from smoke_cells import SMOKE_ERROR, SMOKE_LIMIT, at_file_widths, smoke_config

ARCHS = ["stablelm-3b", "rwkv6-7b"]
SEED = 2**33 + 5


def port_cfg(name: str):
    from repro_torch.configs import get_config

    return get_config(name, "smoke").copy(param_dtype="float32", compute_dtype="float32")


@pytest.mark.parametrize("name,variant", [(a, v) for a in ARCHS for v in ("smoke", "full")])
def test_layout_is_the_ports(name, variant):
    from repro_torch.configs import get_config
    from repro_torch.models import model_spec
    from repro_torch.models.spec import spec_shapes
    from repro_torch.tree import leaves_with_names

    from colonybench import harness

    cfg = smoke_config(name) if variant == "smoke" else harness.config_file(
        harness.benchmark(), name)
    port = {n.strip("[]'").replace("']['", "."): tuple(s) for n, s in leaves_with_names(
        spec_shapes(model_spec(at_file_widths(get_config(name, variant), cfg))),
        is_leaf=lambda x: isinstance(x, tuple))}
    assert port == {n: tuple(s) for n, s in weights.leaves(weights.layout(cfg))}


def test_weights_are_the_seeds():
    cfg = smoke_config("stablelm-3b")
    a, flat_a = weights.make(cfg, SEED, torch.device("cpu"))
    b, flat_b = weights.make(cfg, SEED, torch.device("cpu"))
    c, flat_c = weights.make(cfg, SEED + 1, torch.device("cpu"))
    assert torch.equal(flat_a, flat_b) and not torch.equal(flat_a, flat_c)
    assert a["groups"]["b0"]["mixer"]["wq"].data_ptr() >= flat_a.data_ptr()


@pytest.mark.parametrize("name", ARCHS)
def test_reference_logits_equal_the_ports_forward(name):
    from repro_torch.models.model import forward

    cfg = smoke_config(name)
    params, _ = weights.make(cfg, SEED, torch.device("cpu"))
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, 256, (3, 40)))
    with torch.no_grad():
        port = forward(params, port_cfg(name), {"tokens": tokens})[0]
    ref = models.logits_at(params, cfg, tokens, [list(range(40))] * 3)
    for b in range(3):
        torch.testing.assert_close(ref[b], port[b].float(), atol=2e-4, rtol=2e-4)
    assert port.float().std() > 0.3  # the weights give the logits a spread


@pytest.mark.parametrize("name", ARCHS)
def test_served_tokens_read_no_gap_and_an_altered_one_does(name):
    """The port's engine (prefill, then decode through the cache) serves the
    reference's argmax at every position, and its prefill's and last decode
    step's logits are the reference's; one token changed reads a gap, one
    logit changed an error."""
    from repro_torch.serve.batcher import pad_prompts
    from repro_torch.serve.engine import ServeEngine

    cfg = smoke_config(name)
    params, _ = weights.make(cfg, SEED, torch.device("cpu"))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n).tolist() for n in (9, 17, 30, 5)]
    engine = ServeEngine(port_cfg(name), params, max_len=64, device="cpu")
    padded = pad_prompts([{"prompt": p} for p in prompts])
    out = engine.generate(padded, max_new_tokens=12)
    with torch.inference_mode():
        first = engine._prefill(engine.params, {"tokens": torch.as_tensor(padded).long()})[0]
    last = next(iter(engine.steps.values())).logits
    items = [{"prompt": p, "padded_len": 30, "served": out[i][:10].tolist(),
              "all": out[i].tolist(), "prefill": first[i, -1], "last": last[i, -1]}
             for i, p in enumerate(prompts)]
    got = check.served(params, cfg, items, torch.device("cpu"), chunk=2)
    assert got["tokens"] == 40 and got["max_logit_gap"] <= SMOKE_LIMIT
    assert got["max_logit_error"] <= SMOKE_ERROR / 10
    items[2]["served"][5] = (items[2]["served"][5] + 1) % 256
    items[1]["last"] = items[1]["last"] + 0.01
    got = check.served(params, cfg, items, torch.device("cpu"), chunk=2)
    assert got["max_logit_gap"] > 100 * SMOKE_LIMIT and got["max_logit_error"] >= 0.01


def test_port_takes_rwkv_lora_widths_from_the_weights():
    """Weights at LoRA widths other than the port's configuration's (as
    rwkv6-7b's published ones are): the port's forward and its engine's
    prefill and captured-step decode give the reference's logits and
    argmax at those widths."""
    from repro_torch.models.model import forward
    from repro_torch.serve.batcher import pad_prompts
    from repro_torch.serve.engine import ServeEngine

    cfg = dict(smoke_config("rwkv6-7b"), decay_lora=16, mix_lora=12)
    program = port_cfg("rwkv6-7b")
    assert (program.rwkv.decay_lora, program.rwkv.mix_lora) != (16, 12)
    params, _ = weights.make(cfg, SEED, torch.device("cpu"))
    assert params["groups"]["b0"]["mixer"]["w_b"].shape[1] == 16
    tokens = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (2, 24)))
    with torch.no_grad():
        port = forward(params, program, {"tokens": tokens})[0]
    ref = models.logits_at(params, cfg, tokens, [list(range(24))] * 2)
    for b in range(2):
        torch.testing.assert_close(ref[b], port[b].float(), atol=2e-4, rtol=2e-4)
    prompts = [np.random.default_rng(4).integers(0, 256, n).tolist() for n in (7, 20)]
    engine = ServeEngine(program, params, max_len=48, device="cpu")
    padded = pad_prompts([{"prompt": p} for p in prompts])
    out = engine.generate(padded, max_new_tokens=8)
    items = [{"prompt": p, "padded_len": 20, "served": out[i].tolist(), "all": out[i].tolist(),
              "prefill": None, "last": None} for i, p in enumerate(prompts)]
    got = check.served(params, cfg, items, torch.device("cpu"), chunk=2)
    assert got["tokens"] == 16 and got["max_logit_gap"] <= SMOKE_LIMIT


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, 1.0 + 3 * 2**-12], dtype=torch.float32)
    assert models.round_tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0 + 2**-10]
