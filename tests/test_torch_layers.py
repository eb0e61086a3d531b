"""Port parity: norms, activations, RoPE and masks against the reference
(``repro.models.layers``), float32, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref
from repro_torch.models import layers

ATOL = 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-6)


def test_layer_norm():
    r = _rng(1)
    x, scale, bias = r.standard_normal((2, 5, 64)), r.standard_normal(64), r.standard_normal(64)
    x, scale, bias = (a.astype(np.float32) for a in (x, scale, bias))
    got = layers.layer_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    _close(got, ref.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))


def test_rms_norm():
    r = _rng(2)
    x, scale = r.standard_normal((3, 4, 48)).astype(np.float32), r.standard_normal(48).astype(np.float32)
    got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), eps=1e-6)
    _close(got, ref.rms_norm(jnp.asarray(x), jnp.asarray(scale), eps=1e-6))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_activate(kind):
    r = _rng(3)
    gate = (r.standard_normal((2, 7, 32)) * 2).astype(np.float32)
    up = r.standard_normal((2, 7, 32)).astype(np.float32)
    up_t = None if kind == "gelu" else torch.from_numpy(up)
    up_j = None if kind == "gelu" else jnp.asarray(up)
    got = layers.activate(torch.from_numpy(gate), up_t, kind)
    _close(got, ref.activate(jnp.asarray(gate), up_j, kind))


def test_gelu_is_the_tanh_form():
    x = torch.linspace(-4, 4, 101)
    exact = torch.nn.functional.gelu(x)
    assert (layers.gelu(x) - exact).abs().max() > 1e-4  # not the erf form
    _close(layers.gelu(x), ref.activate(jnp.asarray(x.numpy()), None, "gelu"))


@pytest.mark.parametrize("shape,pos_shape", [((2, 9, 3, 16), (9,)), ((2, 9, 3, 16), (2, 9)), ((2, 9, 16), (9,))])
def test_apply_rope(shape, pos_shape):
    r = _rng(4)
    x = r.standard_normal(shape).astype(np.float32)
    pos = r.integers(0, 64, pos_shape).astype(np.int32)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    _close(got, ref.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))


@pytest.mark.parametrize("q_len,kv_len,offset,window", [(8, 8, 0, 0), (4, 16, 12, 0), (16, 16, 0, 5), (1, 20, 19, 8)])
def test_causal_mask(q_len, kv_len, offset, window):
    got = layers.causal_mask(q_len, kv_len, q_offset=offset, window=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.causal_mask(q_len, kv_len, offset, window)))
