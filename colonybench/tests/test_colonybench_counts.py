"""The benchmark's operation and byte counts, against hand-worked shapes
and the program's own formulas."""

from __future__ import annotations

import pytest

from colonybench import harness, roofline, weights
from colonybench.reference import counts


def test_flash_attention_by_hand():
    # B=1, S=4, H=2, D=8, causal: 10 visible pairs, 4 ops a pair and element
    ops, nbytes = counts.flash_attention(1, 4, 2, 8, 4, 2, 4)
    assert ops == 4 * 1 * 2 * 8 * 10
    assert nbytes == 4 * (2 * 4 * 2 * 8 + 2 * 4 * 2 * 8)  # q and out; k and v


def test_flash_attention_against_the_port():
    from repro_torch.kernels import flash_attention as fa

    for b, s, h, d in ((4, 2048, 32, 80), (32, 466, 32, 80)):
        assert counts.flash_attention(b, s, h, d, s, h, 4)[0] == fa.operations(b, h, s, s, d)


def test_wkv_against_the_port_and_by_hand():
    from repro_torch.kernels import rwkv6

    for bh, t, k, chunk in ((256, 2048, 64, 32), (512, 1752, 64, 8), (4, 293, 16, 1)):
        assert counts.wkv(bh, t, k, k, chunk)[0] == rwkv6.operations(bh, t, k, k, chunk)
    # bytes: r k logw v in, u and s0 in, out and the final state out (all float32)
    bh, t, k = 2, 4, 3
    assert counts.wkv(bh, t, k, k, 2)[1] == 4 * (2 * 4 * 12 + 2 * 3 + 2 * 9 + 2 * 4 * 3 + 2 * 9)


@pytest.mark.parametrize("name,params,port_params", [
    ("stablelm-3b", 2_795_443_200, 2_795_443_200),
    # the published LoRA widths, which the weights give; the port's own
    # configuration has the narrower ones of the smaller Finch models
    ("rwkv6-7b", 7_635_738_624, 7_577_018_368)])
def test_param_counts(name, params, port_params):
    from repro_torch.configs import get_config
    from repro_torch.models import count_params, model_spec

    from smoke_cells import at_file_widths

    cfg = harness.config_file(harness.benchmark(), name)
    program = get_config(name, "full")
    assert counts.param_count(cfg) == params == cfg["parameters"]
    assert count_params(model_spec(program)) == port_params
    assert count_params(model_spec(at_file_widths(program, cfg))) == params
    assert sum(__import__("math").prod(s) for _, s in weights.leaves(weights.layout(cfg))) \
        == params


def test_request_flops_by_hand():
    cfg = harness.config_file(harness.benchmark(), "stablelm-3b")
    n = counts.param_count(cfg)
    per_pos = 4 * 32 * 2560
    # prompt of 2 sees 1 + 2 positions, one output token sees 3
    assert counts.request_flops(cfg, 2, 1) == 2 * n * 3 + per_pos * (1 + 2 + 3)


def test_roofline_share_by_hand():
    """One flash call of B=1, S=4, H=2, D=8 that took exactly its least time
    reads 100%; twice that, 50%; a lost launch reads nothing."""
    least = counts.least_seconds(*counts.flash_attention(1, 4, 2, 8, 4, 2, 4))
    call = {"shapes": [[1, 4, 2, 8], [1, 4, 2, 8], [1, 4, 2, 8], [], [], []]}
    run = {"config": {"dtype": "float32"},
           "trace": {"ops": {"repro_torch::flash_attention": [call]},
                     "kernels": [["void flash_fwd_f32_kernel<5>(...)", 1, least]]}}
    share = roofline.share
    assert share(run, "flash_attention", counts.flash_attention_least) == pytest.approx(100.0)
    run["trace"]["kernels"][0][2] = 2 * least
    assert share(run, "flash_attention", counts.flash_attention_least) == pytest.approx(50.0)
    run["trace"]["kernels"][0][1] = 2
    assert share(run, "flash_attention", counts.flash_attention_least) is None
