"""Port parity for the dry-run's cells (``repro_torch.configs.shapes``,
``ShapeConfig``/``SHAPES`` and ``models.model.abstract_cache``).

For each of the ten archs at full size and each of the four cells, the
port's ``input_specs`` (tensors on the meta device) has the reference's
leaves: the same paths, shapes and dtypes, or the same ``CellSkip``. The
reference's own tests of the cells (``tests/test_sharding_roofline.py``)
are carried over, and the abstract cache is held to what the port's own
``prefill(..., max_len)`` returns for every smoke arch, in the configs'
own dtypes."""

import dataclasses

import jax
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs.shapes import CellSkip as RefCellSkip
from repro.configs.shapes import input_specs as ref_input_specs
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.shapes import CellSkip, cell_skip_reason, decode_specs, input_specs
from repro_torch.models import init_params, model_spec, prefill
from repro_torch.models.model import abstract_cache
from repro_torch.tree import leaves_with_names


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[-1]


def _port(tree) -> list:
    return [(name, tuple(t.shape), _dtype(t), t.device.type) for name, t in leaves_with_names(tree)]


def test_shapes_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    assert [s.is_train for s in SHAPES.values()] == [s.is_train for s in REF_SHAPES.values()]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_reference(arch, shape):
    rcfg, cfg = ref_get_config(arch, "full"), get_config(arch, "full")
    try:
        want = ref_input_specs(rcfg, shape)
    except RefCellSkip as e:
        with pytest.raises(CellSkip) as got:
            input_specs(cfg, shape)
        assert got.value.reason == e.reason
        return
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert _port(input_specs(cfg, SHAPES[shape])) == [
        (jax.tree_util.keystr(p), tuple(s.shape), str(s.dtype), "meta") for p, s in flat]


def test_cell_skip_policy():
    for arch, skipped in (
        ("qwen2.5-14b", True), ("starcoder2-15b", True), ("deepseek-v3-671b", True),
        ("rwkv6-7b", False), ("jamba-1.5-large-398b", False), ("mixtral-8x7b", False),
    ):
        cfg = get_config(arch, "full")
        reason = cell_skip_reason(cfg, SHAPES["long_500k"])
        assert (reason is not None) == skipped, arch
    with pytest.raises(CellSkip):
        input_specs(get_config("granite-3-8b", "full"), "long_500k")


def test_decode_specs_cache_matches_prefill_structure():
    """The dry-run's abstract cache tree must match what prefill returns."""
    cfg = get_config("mixtral-8x7b", "smoke").copy(param_dtype="float32", compute_dtype="float32")
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0), torch.float32, "cpu")
    with torch.inference_mode():
        _, cache = prefill(params, cfg, {"tokens": torch.zeros((2, 16), dtype=torch.long)},
                           max_len=16)
    abstract = decode_specs(cfg, SHAPES["decode_32k"])["cache"]
    assert [n for n, _ in leaves_with_names(cache)] == [n for n, _ in leaves_with_names(abstract)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_cache_equals_the_prefill_cache(arch):
    """Paths, shapes and dtypes (bf16 compute; Mamba's ``h`` and RWKV's
    ``wkv`` in float32), with a memory where the arch cross-attends."""
    cfg = get_config(arch, "smoke")
    b, s, max_len, frames = 2, 12, 16, 5
    batch = {"tokens": torch.zeros((b, s), dtype=torch.long)}
    mem_len = 0
    if cfg.cross_attn_every > 0:
        mem_len = cfg.num_patches
        batch["image_embeds"] = torch.zeros((b, mem_len, cfg.vision_embed_dim))
    if cfg.is_encdec:
        mem_len = frames
        batch["src_frames"] = torch.zeros((b, mem_len, cfg.audio_embed_dim))
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    with torch.inference_mode():
        _, cache = prefill(params, cfg, batch, max_len=max_len)
    got = abstract_cache(cfg, b, max_len, mem_len)
    assert [x[:3] for x in _port(got)] == [x[:3] for x in _port(cache)]
    assert {x[3] for x in _port(got)} == {"meta"}
    assert (got["memory"] is None) == (cache["memory"] is None)
