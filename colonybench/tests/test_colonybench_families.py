"""The contract between the harness and a configuration's family
(``reference/<family>.py``, found by name): the two accepted families
pinned to what they read before the hooks existed, and a family of new
files only, with a group of several block kinds, an RMS final norm without
bias, experts and attention in one block of a group, taken as it is."""

from __future__ import annotations

import hashlib
import json
import math
import sys
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from colonybench import harness, weights
from colonybench.reference import counts, models, train

from smoke_cells import smoke_config

SEED = 2**33 + 5

# Read at smoke size on the CPU from the tree before the family hooks: the
# hash of the leaves' names and shapes in buffer order, the float64 sum of
# the one buffer and its sum weighted by position (i / n), and the
# reference's logits at fixed tokens (sequence 0 at all 12 positions,
# sequence 1 at 0, 5 and 11): their sum, the sum of their magnitudes, four
# logits of sequence 0's fourth row and the last three of sequence 1's last.
PINNED = {
    "stablelm-3b": dict(
        leaves="bffa38f067f9844131c57ef4ecc4109beae941e2c57d905f0c129311c8e613c0",
        size=133_760, sum=159.2819477707912, weighted=286.2979609995228,
        logit_sum=36.1492335726507, logit_abs=2992.0221023765625,
        row0=[-0.008212443441152573, 0.5096311569213867, 0.7798300981521606,
              0.47427988052368164],
        row1=[0.3561286926269531, 0.3194238543510437, 1.2843297719955444]),
    "rwkv6-7b": dict(
        leaves="1a16139eeb2b69c62e0be8e9b7fd085ca0c55e794543d290e06fc9ea76bf66f2",
        size=153_728, sum=357.8661558760697, weighted=342.8645356104351,
        logit_sum=79.13047375262249, logit_abs=3043.5215734973317,
        row0=[0.08145196735858917, -1.0805671215057373, 0.7315586805343628,
              0.1591346710920334],
        row1=[-0.1764691025018692, -0.8745670318603516, 0.27059611678123474]),
}


def _request_by_hand(name: str, prompt: int, output: int) -> int:
    """2·N a token, and for stablelm-3b q·k and p·v, 4 x 32 layers x 2,560,
    for each position seen: a prompt of P sees 1 + ... + P, its O outputs
    P + 1 + ... + P + O."""
    if name == "rwkv6-7b":
        return 2 * 7_635_738_624 * (prompt + output)
    seen = (prompt + output) * (prompt + output + 1) // 2
    return 2 * 2_795_443_200 * (prompt + output) + 4 * 32 * 2560 * seen


def _train_by_hand(name: str, batch: int, seq_len: int) -> int:
    """6·N a token, and for stablelm-3b three times q·k and p·v over the
    S(S+1)/2 causal pairs of each sequence."""
    if name == "rwkv6-7b":
        return 6 * 7_635_738_624 * batch * seq_len
    pairs = seq_len * (seq_len + 1) // 2
    return 6 * 2_795_443_200 * batch * seq_len + 3 * 4 * 32 * 2560 * pairs * batch


@pytest.mark.parametrize("what", ["leaf_order", "buffer", "logits", "request_flops",
                                  "train_step_flops"])
@pytest.mark.parametrize("name", sorted(PINNED))
def test_accepted_family_reads_as_before(name, what):
    pin = PINNED[name]
    if what in ("request_flops", "train_step_flops"):
        cfg = harness.config_file(harness.benchmark(), name)
        for prompt, output in ((466, 256), (35, 26), (1752, 55), (599, 19), (1, 1)):
            assert counts.request_flops(cfg, prompt, output) == _request_by_hand(
                name, prompt, output)
        assert counts.train_step_flops(cfg, 4, 1024) == _train_by_hand(name, 4, 1024)
        assert counts.train_step_flops(cfg, 2, 16) == _train_by_hand(name, 2, 16)
        return
    cfg = smoke_config(name)
    tree, flat = weights.make(cfg, SEED, torch.device("cpu"))
    if what == "leaf_order":  # the leaves as they lie in the buffer
        placed = sorted(weights.leaves(tree), key=lambda leaf: leaf[1].data_ptr())
        order = [[n, list(t.shape)] for n, t in placed]
        assert hashlib.sha256(json.dumps(order).encode()).hexdigest() == pin["leaves"]
        assert placed[0][1].data_ptr() == flat.data_ptr()
        return
    if what == "buffer":
        f = flat.double()
        assert f.numel() == pin["size"]
        at = torch.arange(1, f.numel() + 1, dtype=torch.float64) / f.numel()
        # float64 sums of float32 values: 1e-10 leaves room for the order of
        # the summation alone, not for one value changed or moved
        assert f.sum().item() == pytest.approx(pin["sum"], rel=1e-10)
        assert (f * at).sum().item() == pytest.approx(pin["weighted"], rel=1e-10)
        return
    tokens = torch.as_tensor(np.random.default_rng(7).integers(0, 256, (2, 12)))
    logits = models.logits_at(tree, cfg, tokens, [list(range(12)), [0, 5, 11]])
    both = torch.cat(logits).double()
    # float32 products may round differently on another CPU's kernels
    assert both.sum().item() == pytest.approx(pin["logit_sum"], rel=1e-5)
    assert both.abs().sum().item() == pytest.approx(pin["logit_abs"], rel=1e-6)
    assert logits[0][3, :4].tolist() == pytest.approx(pin["row0"], rel=1e-5, abs=1e-6)
    assert logits[1][2, -3:].tolist() == pytest.approx(pin["row1"], rel=1e-5, abs=1e-6)


# A family of new files only: a group of ``blocks`` blocks, ``b1`` attention
# (one head, no positions) and every other block a gated linear mixer with
# a top-2 MoE; RMS norms with a scale alone, the final one too.
TOY = "toy_hybrid"
ATTN = "b1"


def _rms(h: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return h * torch.rsqrt(h.square().mean(-1, keepdim=True) + eps) * scale


def toy_module(calls: list) -> types.ModuleType:
    fam = types.ModuleType(f"colonybench.reference.{TOY}")

    def groups(cfg):
        d, e, f, n = cfg["hidden_size"], cfg["num_experts"], cfg["expert_width"], cfg["blocks"]
        g = cfg["num_hidden_layers"] // n
        attn = {"norm": {"scale": (g, d)},
                "mixer": {"wq": (g, d, d), "wk": (g, d, d), "wv": (g, d, d), "wo": (g, d, d)}}
        mix = {"norm": {"scale": (g, d)}, "mixer": {"w": (g, d, d), "gate": (g, d, d)},
               "moe": {"router": (g, d, e), "w_in": (g, e, d, f), "w_out": (g, e, f, d)}}
        return {f"b{i}": attn if f"b{i}" == ATTN else mix for i in range(n)}

    def fill(name, t, cfg):
        if name.endswith(("moe.w_in", "moe.w_out")):  # (groups, experts, in, out)
            t.mul_(1.0 / math.sqrt(t.shape[2]))
            return True
        return False

    def attention(key, p, x, cfg):
        calls.append((key, p["norm"]["scale"].data_ptr()))
        h = _rms(x, p["norm"]["scale"], cfg["rms_norm_eps"])
        q, k, v = (models._einsum("bsd,de->bse", h, p["mixer"][w]) for w in ("wq", "wk", "wv"))
        s = x.shape[1]
        scores = models._einsum("bqd,bkd->bqk", q, k) / math.sqrt(q.shape[-1])
        causal = torch.ones(s, s, dtype=torch.bool).tril()
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
        return x + models._einsum("bse,ed->bsd", models._einsum("bqk,bkd->bqd", probs, v),
                                  p["mixer"]["wo"])

    def mixer(key, p, x, cfg):
        calls.append((key, p["norm"]["scale"].data_ptr()))
        h = _rms(x, p["norm"]["scale"], cfg["rms_norm_eps"])
        x = x + models._einsum("bsd,de->bse", h, p["mixer"]["w"]) * torch.sigmoid(
            models._einsum("bsd,de->bse", h, p["mixer"]["gate"]))
        h = _rms(x, p["norm"]["scale"], cfg["rms_norm_eps"])
        top = torch.topk(models._einsum("bsd,de->bse", h, p["moe"]["router"]),
                         cfg["experts_per_token"], -1)
        gates = torch.zeros(*h.shape[:2], cfg["num_experts"]).scatter(
            -1, top.indices, torch.softmax(top.values, -1))
        up = F.silu(models._einsum("bsd,edf->bsef", h, p["moe"]["w_in"]))
        return x + models._einsum("bsef,efd->bsd", up * gates[..., None], p["moe"]["w_out"])

    def blocks(cfg):
        return {key: (lambda p, x, cfg, key=key: (attention if key == ATTN else mixer)(
            key, p, x, cfg)) for key in groups(cfg)}

    def apply_final_norm(p, h, cfg):
        calls.append(("norm_f", p["scale"].data_ptr()))
        return _rms(h, p["scale"], cfg["rms_norm_eps"])

    def active_params(cfg):
        d, e, f, k = (cfg[key] for key in ("hidden_size", "num_experts", "expert_width",
                                            "experts_per_token"))
        idle = (cfg["blocks"] - 1) * (e - k) * 2 * d * f
        return counts.param_count(cfg) - idle * cfg["num_hidden_layers"] // cfg["blocks"]

    def attention_layers(cfg):
        return cfg["num_hidden_layers"] // cfg["blocks"]

    fam.EPS_KEY, fam.ATTENTION = "rms_norm_eps", True
    for fn in (groups, fill, blocks, apply_final_norm, active_params, attention_layers):
        setattr(fam, fn.__name__, fn)
    fam.final_norm = lambda cfg: {"scale": (cfg["hidden_size"],)}
    return fam


@pytest.fixture
def toy(monkeypatch):
    """(its configuration maker, the calls its blocks and final norm record)."""
    calls: list = []
    monkeypatch.setitem(sys.modules, f"colonybench.reference.{TOY}", toy_module(calls))

    def cfg(blocks: int = 2, groups: int = 3) -> dict:
        return {"family": TOY, "hidden_size": 16, "vocab_size": 32, "blocks": blocks,
                "num_hidden_layers": blocks * groups, "num_experts": 4, "experts_per_token": 2,
                "expert_width": 24, "rms_norm_eps": 1e-6}
    return cfg, calls


def _expected(params: dict, blocks: int, groups: int, norms: int) -> list:
    """Group-major, each group's blocks in index order, then the final norm
    (once a sequence where rows are picked)."""
    order = [(f"b{i}", params["groups"][f"b{i}"]["norm"]["scale"][g].data_ptr())
             for g in range(groups) for i in range(blocks)]
    return order + [("norm_f", params["norm_f"]["scale"].data_ptr())] * norms


def test_layout_places_the_familys_groups_and_final_norm(toy):
    cfg_of, _ = toy
    cfg = cfg_of()
    fam = models.family(cfg)
    tree = weights.layout(cfg)
    assert tree["groups"] == fam.groups(cfg) and set(tree["groups"]) == {"b0", "b1"}
    assert tree["norm_f"] == {"scale": (16,)}
    params, flat = weights.make(cfg, SEED, torch.device("cpu"))
    assert set(params["norm_f"]) == {"scale"}
    assert params["groups"]["b0"]["moe"]["w_in"].shape == (3, 4, 16, 24)
    assert "moe" not in params["groups"]["b1"]
    assert flat.numel() == counts.param_count(cfg) == sum(
        math.prod(s) for _, s in weights.leaves(tree))
    # the family's fill scaled the experts over their input width, 16, not over
    # the default's shape[1], the 4 experts
    assert params["groups"]["b0"]["moe"]["w_in"].std().item() == pytest.approx(0.25, rel=0.1)
    assert params["norm_f"]["scale"].mean().item() == pytest.approx(1.0, abs=0.1)


@pytest.mark.parametrize("blocks", [2, 11])
@pytest.mark.parametrize("entry", ["logits_at", "train.loss"])
def test_the_walk_is_group_major_in_index_order(toy, entry, blocks):
    cfg_of, calls = toy
    cfg = cfg_of(blocks=blocks)
    params, _ = weights.make(cfg, SEED, torch.device("cpu"))
    tokens = torch.as_tensor(np.random.default_rng(5).integers(0, 32, (2, 6)))
    if entry == "logits_at":
        out = models.logits_at(params, cfg, tokens, [[0, 5], [2]])
        assert [o.shape for o in out] == [(2, 32), (1, 32)]
    else:
        assert torch.isfinite(train.loss(params, cfg, tokens))
    assert calls == _expected(params, blocks, 3, norms=2 if entry == "logits_at" else 1)
    if blocks == 11:
        assert [key for key, _ in calls[8:12]] == ["b8", "b9", "b10", "b0"]


def test_the_familys_final_norm_is_applied(toy):
    """logits_at is the embedding through the family's blocks in order, its
    RMS norm with no bias, then the head."""
    cfg_of, _ = toy
    cfg = cfg_of()
    fam = models.family(cfg)
    params, _ = weights.make(cfg, SEED, torch.device("cpu"))
    tokens = torch.as_tensor(np.random.default_rng(6).integers(0, 32, (2, 6)))
    x = params["embed"][tokens]
    for g in range(3):
        for key in ("b0", "b1"):
            x = fam.blocks(cfg)[key](models._layer(params["groups"][key], g), x, cfg)
    want = _rms(x, params["norm_f"]["scale"], 1e-6) @ params["lm_head"]
    got = models.logits_at(params, cfg, tokens, [list(range(6))] * 2)
    for b in range(2):
        torch.testing.assert_close(got[b], want[b], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("count", ["request_flops", "train_step_flops"])
def test_counts_take_active_params_and_attention_layers(toy, count):
    """2·N (6·N training) of the active parameters, all but the 2 idle
    experts of each MoE block, and q·k and p·v in the 3 attention blocks
    alone; the parameter count stays the total."""
    cfg_of, _ = toy
    cfg = cfg_of()
    total = counts.param_count(cfg)
    active = total - 3 * 2 * 2 * 16 * 24
    assert counts.active_params(cfg) == active and counts.attention_layers(cfg) == 3
    if count == "request_flops":
        seen = 12 * 13 // 2  # a prompt of 7 and 5 outputs: positions 1..12 seen
        assert counts.request_flops(cfg, 7, 5) == 2 * active * 12 + 4 * 3 * 16 * seen
    else:
        assert counts.train_step_flops(cfg, 2, 8) == (6 * active * 2 * 8
                                                      + 3 * 4 * 3 * 16 * 36 * 2)
