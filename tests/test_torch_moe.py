"""``models/moe.py`` against the reference's ``moe_fwd`` on the same
weights and tokens (numpy, float32): the output, ``lb_loss``, ``z_loss``
and ``dropped_frac`` at atol 1e-5, for mixtral's and jamba's smoke
``MoEConfig``, a padded group (B·S not a multiple of ``group_size``: the
padded rows' probabilities tie at exactly 1/E, ROADMAP C7), a capacity
that drops choices (cf 0.5: slots past C get a zero one-hot row) and
shared experts; and the gradients of the output and the weighted aux
losses against ``jax.grad`` at atol 1e-5 / rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro.models.sharding import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.interop import params_from_reference
from repro_torch.models import moe
from repro_torch.models.spec import init_params, moe_spec

ATOL = 1e-5

# (arch, B, S, group_size or None (the config's), capacity_factor or None, shared experts)
CASES = {
    "mixtral smoke": ("mixtral-8x7b", 2, 32, None, None, 0),
    "jamba smoke": ("jamba-1.5-large-398b", 2, 32, None, None, 0),
    "padded group": ("mixtral-8x7b", 3, 7, 8, None, 0),
    "drops at cf 0.5": ("mixtral-8x7b", 2, 32, None, 0.5, 0),
    "padded group, drops": ("jamba-1.5-large-398b", 1, 45, 16, 0.5, 0),
    "shared experts": ("mixtral-8x7b", 2, 16, None, None, 1),
}


def _cfgs(arch, group, cf, shared):
    def fix(cfg):
        m = cfg.moe
        m = type(m)(**{**m.__dict__, **({"group_size": group} if group else {}),
                       **({"capacity_factor": cf} if cf else {}),
                       "num_shared_experts": shared})
        return cfg.copy(param_dtype="float32", compute_dtype="float32", moe=m)

    return fix(ref_get_config(arch, "smoke")), fix(get_config(arch, "smoke"))


def _setup(arch, b, s, group, cf, shared, seed=0):
    rcfg, cfg = _cfgs(arch, group, cf, shared)
    rparams = ref_init_params(jax.random.key(seed), ref_moe.moe_spec(rcfg), jnp.float32)
    np_params = jax.tree.map(np.asarray, rparams)
    # a router of scale 0.2 (logits of std ~1.6) spreads the probabilities, so
    # choices differ per token, where the init's 0.02 leaves them near 1/E
    np_params["router"] = (np.random.default_rng(seed).standard_normal(
        np_params["router"].shape) * 0.2).astype(np.float32)
    x = np.random.default_rng(seed + 1).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return rcfg, cfg, np_params, x


@pytest.mark.parametrize("case", list(CASES))
def test_moe_fwd_matches_reference(case):
    arch, b, s, group, cf, shared = CASES[case]
    rcfg, cfg, np_params, x = _setup(arch, b, s, group, cf, shared)
    want, waux = ref_moe.moe_fwd(jax.tree.map(jnp.asarray, np_params), jnp.asarray(x), rcfg)
    got, aux = moe.moe_fwd(params_from_reference(np_params), torch.from_numpy(x), cfg)
    assert got.shape == (b, s, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert set(aux) == set(waux) == {"lb_loss", "z_loss", "dropped_frac"}
    for key in waux:
        assert float(aux[key]) == pytest.approx(float(waux[key]), abs=ATOL), key
    if cf == 0.5:
        assert float(aux["dropped_frac"]) > 0.1  # the case does drop
    else:
        assert float(aux["dropped_frac"]) == 0.0


def test_padded_rows_break_ties_toward_the_lower_expert():
    """A padded row is zeros: its router logits are 0 and its probabilities
    exactly 1/E, so top-2 must be experts 0 and 1, as jax.lax.top_k
    orders ties (the load-balance loss counts padded rows, C7)."""
    _, cfg = _cfgs("mixtral-8x7b", 8, None, 0)
    router = torch.randn((cfg.d_model, cfg.moe.num_experts))
    x = torch.zeros((1, 8, cfg.d_model))
    dispatch, combine, aux = moe._route(x, router, cfg)
    first = dispatch.sum(-1)  # (G, S, E): which experts took each token
    assert torch.equal(first[0, :, :2], torch.ones(8, 2))
    assert not first[0, :, 2:].any()
    # capacity int(8*2*2.0/4) = 8: every choice kept, each gate 1/2
    assert float(aux["dropped_frac"]) == 0.0
    assert torch.allclose(combine.sum(-1)[0, :, :2], torch.full((8, 2), 0.5))


def test_capacity_and_group_follow_the_reference_rule():
    """C16: decode groups hold one token per sequence; mixtral's published
    MoE at batch 4 then gets 1 slot per expert, at batch 1 no drop."""
    cfg = get_config("mixtral-8x7b", "full")
    for b, want in ((4, 1), (1, 1), (300, 93)):
        s = min(cfg.moe.group_size, b)
        assert max(1, int(s * cfg.moe.top_k * cfg.moe.capacity_factor / cfg.moe.num_experts)) == want
    small = cfg.copy(d_model=16, moe=type(cfg.moe)(**{**cfg.moe.__dict__, "expert_d_ff": 8}))
    router = torch.randn((16, 8), generator=torch.Generator().manual_seed(0))
    x = torch.randn((1, 1, 16), generator=torch.Generator().manual_seed(1))
    _, _, aux = moe._route(x, router, small)  # one token, two distinct experts
    assert float(aux["dropped_frac"]) == 0.0


@pytest.mark.parametrize("case", ["mixtral smoke", "drops at cf 0.5", "shared experts"])
def test_moe_gradients_match_jax_grad(case):
    arch, b, s, group, cf, shared = CASES[case]
    rcfg, cfg, np_params, x = _setup(arch, b, s, group, cf, shared, seed=3)
    w = np.random.default_rng(7).standard_normal((b, s, cfg.d_model)).astype(np.float32)

    def ref_loss(params, x):
        out, aux = ref_moe.moe_fwd(params, x, rcfg)
        return jnp.sum(out * w) + ref_moe.moe_aux_loss(aux, rcfg)

    want = jax.grad(ref_loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, np_params), jnp.asarray(x))
    params = {k: v.requires_grad_() for k, v in params_from_reference(np_params).items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_fwd(params, tx, cfg)
    loss = (out * torch.from_numpy(w)).sum() + moe.moe_aux_loss(aux, cfg)
    grads = torch.autograd.grad(loss, [*params.values(), tx])
    for name, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[0][name]), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(want[1]), atol=1e-5, rtol=1e-5)


def test_spec_and_init_follow_the_reference():
    """Leaf shapes, the router's 0.02 scale and shared experts' leaves."""
    _, cfg = _cfgs("mixtral-8x7b", None, None, 1)
    spec = moe_spec(cfg)
    rspec = ref_moe.moe_spec(_cfgs("mixtral-8x7b", None, None, 1)[0])
    assert {k: v.shape for k, v in spec.items()} == {k: v.shape for k, v in rspec.items()}
    params = init_params(spec, torch.Generator().manual_seed(0), torch.float32, "cpu")
    assert abs(params["router"].std().item() - 0.02) < 4e-3
