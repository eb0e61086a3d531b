"""Port parity for the distribution plane's rules and plans
(``repro_torch.models.sharding``, ``repro_torch.launch.{mesh,sharding_plan}``).

The reference's unit tests (``tests/test_sharding_roofline.py``: axis
resolution, divisibility, optimizer state, the cache's sequence fallback)
carried over to the port; then, for all ten full-size archs on both
production mesh shapes, every parameter's, AdamW and Adafactor state's and
``decode_32k`` cache leaf's placements, read back as mesh axes per tensor
dim, equal the reference's ``PartitionSpec``. The reference's specs are
built on a ``jax.sharding.Mesh`` of one CPU device repeated, and the
port's on a ``MeshShape``: a plan reads only the mesh's names and sizes.
Last, a real (2, 16, 16) ``DeviceMesh`` on torch's fake backend (512
ranks, one process) distributes a few leaves under ``FakeTensorMode`` to
the local shapes their placements imply."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro import models as R
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import TrainConfig as RefTrainConfig
from repro.configs import get_config as ref_get_config
from repro.configs.shapes import decode_specs as ref_decode_specs
from repro.launch import sharding_plan as ref_plan
from repro.models import sharding as ref_sharding
from repro_torch.configs import ARCH_IDS, SHAPES, TrainConfig, get_config
from repro_torch.configs.shapes import decode_specs
from repro_torch.launch import sharding_plan as plan
from repro_torch.launch.mesh import (
    MeshShape, fake_world, make_production_mesh, make_smoke_mesh, mesh_devices,
    production_mesh_shape,
)
from repro_torch.models import model_spec
from repro_torch.models.sharding import (
    DEFAULT_RULES, ParamLeaf, abstract_params, axes_to_placements, param_placements,
    placements_to_axes, resolve_axes, rules_for,
)
from repro_torch.tree import leaves_with_names

MESH22 = MeshShape((2, 2), ("data", "model"))


def _norm(spec) -> tuple:
    """A PartitionSpec or axis spec as a tuple: 1-tuples as the name, empty
    tuples as None, trailing Nones dropped."""
    out = [s[0] if isinstance(s, tuple) and len(s) == 1 else
           None if isinstance(s, tuple) and not s else s for s in tuple(spec)]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _axes(placements, mesh=MESH22) -> tuple:
    return _norm(placements_to_axes(placements, mesh))


# ---------------------------------------------------------------------------
# The reference's unit tests, carried over
# ---------------------------------------------------------------------------


def test_resolve_axes_basic():
    assert resolve_axes(("embed", "ffn"), DEFAULT_RULES, MESH22) == (None, "model")
    assert resolve_axes(("vocab", "embed"), DEFAULT_RULES, MESH22) == ("model", None)
    # batch -> (pod, data): pod absent on this mesh -> data only
    assert resolve_axes(("batch", None), DEFAULT_RULES, MESH22) == (("data",), None)


def test_resolve_axes_never_repeats_mesh_axis():
    spec = resolve_axes(("heads", "ffn"), DEFAULT_RULES, MESH22)
    assert [a for a in spec if a is not None].count("model") == 1


def test_param_placements_divisibility():
    spec = {
        "even": ParamLeaf((8, 4), ("embed", "ffn")),
        "odd": ParamLeaf((8, 5), ("embed", "ffn")),  # 5 % 2 != 0 -> replicated
    }
    pps = param_placements(spec, rules_for(get_config("stablelm-3b", "smoke")), MESH22)
    assert pps["even"] == (Replicate(), Shard(1))
    assert pps["odd"] == (Replicate(), Replicate())


def test_opt_placements_adamw_mirrors_params():
    spec = {"w": ParamLeaf((8, 4), ("embed", "ffn"))}
    pps = param_placements(spec, DEFAULT_RULES, MESH22)
    opt = plan.opt_placements(spec, pps, TrainConfig(optimizer="adamw"), MESH22)
    assert opt["m"]["w"] == pps["w"] and opt["v"]["w"] == pps["w"]


def test_opt_placements_adafactor_drops_factored_axis():
    spec = {"w": ParamLeaf((8, 4), ("embed", "ffn")), "b": ParamLeaf((4,), ("ffn",))}
    pps = param_placements(spec, DEFAULT_RULES, MESH22)
    opt = plan.opt_placements(spec, pps, TrainConfig(optimizer="adafactor"), MESH22)
    assert _axes(opt["v"]["w"]["vr"]) == ()  # row stats drop the last (sharded) dim
    assert _axes(opt["v"]["w"]["vc"]) == ("model",)  # column stats keep it, now dim 0
    assert opt["v"]["b"] == {"v": pps["b"]}  # a vector is not factored


def test_cache_placements_kv_heads_vs_seq_fallback():
    cfg = get_config("stablelm-3b", "full")

    def cache(kv):
        leaf = torch.empty((2, 4, 8, kv, 16), dtype=torch.bfloat16, device="meta")
        return {"layers": {"b0": {"k": leaf, "v": leaf}}, "memory": None}

    ps = plan.cache_placements(cfg, cache(2), MESH22)
    assert _axes(ps["layers"]["b0"]["k"])[3] == "model"  # kv=2 % 2 == 0
    assert ps["memory"] is None
    ps = plan.cache_placements(cfg, cache(3), MESH22)
    assert _axes(ps["layers"]["b0"]["k"])[2] == "model"  # seq fallback


def test_placements_round_trip_in_mesh_order():
    mesh = production_mesh_shape(multi_pod=True)
    spec = (("pod", "data"), None, "model")
    pl = axes_to_placements(spec, mesh)
    assert pl == (Shard(0), Shard(0), Shard(2))
    assert placements_to_axes(pl, mesh) == spec
    with pytest.raises(ValueError, match="order"):
        axes_to_placements((("data", "pod"),), mesh)


# ---------------------------------------------------------------------------
# Every leaf of the ten full-size archs, on both production mesh shapes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[False, True], ids=["16x16", "2x16x16"])
def meshes(request):
    """(reference jax Mesh of one CPU device repeated, the port's MeshShape)."""
    ms = production_mesh_shape(multi_pod=request.param)
    n = int(np.prod(ms.shape))
    ref = Mesh(np.array(jax.devices() * n).reshape(ms.shape), ms.mesh_dim_names)
    return ref, ms


def _ref_leaves(tree) -> list:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return [(jax.tree_util.keystr(p), _norm(s)) for p, s in flat]


def _port_leaves(tree, mesh) -> list:
    return [(name, _norm(placements_to_axes(pl, mesh))) for name, pl in leaves_with_names(tree)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_optimizer_plans_equal_reference(arch, meshes):
    ref_mesh, mesh = meshes
    rcfg, cfg = ref_get_config(arch, "full"), get_config(arch, "full")
    rspec, spec = R.model_spec(rcfg), model_spec(cfg)
    rpps = ref_sharding.param_pspecs(rspec, ref_sharding.rules_for(rcfg), ref_mesh)
    pps = param_placements(spec, rules_for(cfg), mesh)
    assert _port_leaves(pps, mesh) == _ref_leaves(rpps)
    for opt in ("adamw", "adafactor"):
        want = ref_plan.opt_pspecs(rspec, rpps, RefTrainConfig(optimizer=opt))
        got = plan.opt_placements(spec, pps, TrainConfig(optimizer=opt), mesh)
        assert _port_leaves(got, mesh) == _ref_leaves(want), opt
    state = plan.state_placements(cfg, spec, mesh, TrainConfig())
    assert state["params"] == pps and state["step"] == (Replicate(),) * len(mesh.shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_cache_plan_equals_reference(arch, meshes):
    ref_mesh, mesh = meshes
    rcfg, cfg = ref_get_config(arch, "full"), get_config(arch, "full")
    rspecs = ref_decode_specs(rcfg, REF_SHAPES["decode_32k"])
    specs = decode_specs(cfg, SHAPES["decode_32k"])
    want = ref_plan.decode_in_pspecs(rcfg, rspecs, ref_mesh)
    got = plan.decode_in_placements(cfg, specs, mesh)
    assert _port_leaves(got, mesh) == _ref_leaves(want)
    assert (got["cache"]["memory"] is None) == (want["cache"]["memory"] is None)


def test_batch_and_microbatch_plans_equal_reference(meshes):
    ref_mesh, mesh = meshes
    from repro.configs.shapes import batch_specs as ref_batch_specs
    from repro_torch.configs.shapes import batch_specs

    for arch in ("llama-3.2-vision-11b", "seamless-m4t-large-v2", "stablelm-3b"):
        rcfg, cfg = ref_get_config(arch, "full"), get_config(arch, "full")
        rb, b = ref_batch_specs(rcfg, REF_SHAPES["train_4k"]), batch_specs(cfg, SHAPES["train_4k"])
        assert (_port_leaves(plan.batch_placements(cfg, b, mesh), mesh)
                == _ref_leaves(ref_plan.batch_pspecs(rcfg, rb, ref_mesh)))
        rmb, mb = ref_plan.microbatch_specs(rb, 8), plan.microbatch_specs(b, 8)
        assert [tuple(t.shape) for _, t in leaves_with_names(mb)] == [
            s.shape for s in jax.tree.leaves(rmb)]
        assert (_port_leaves(plan.batch_placements(cfg, mb, mesh, batch_dim=1), mesh)
                == _ref_leaves(ref_plan.batch_pspecs(rcfg, rmb, ref_mesh, batch_dim=1)))
    with pytest.raises(ValueError, match="microbatches"):
        plan.microbatch_specs(b, 3)


# ---------------------------------------------------------------------------
# A real DeviceMesh of 512 ranks on the fake backend
# ---------------------------------------------------------------------------


def test_smoke_mesh_on_a_world_of_one():
    with fake_world(1):
        mesh = make_smoke_mesh()
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        assert plan.batch_axes(mesh) == ("data",) and mesh_devices(mesh) == 1


@pytest.fixture(scope="module")
def fake_mesh():
    with fake_world(512):
        yield make_production_mesh(multi_pod=True)


def test_production_mesh_on_the_fake_backend(fake_mesh):
    assert fake_mesh.mesh_dim_names == ("pod", "data", "model")
    assert tuple(fake_mesh.shape) == (2, 16, 16) and mesh_devices(fake_mesh) == 512


@pytest.mark.parametrize("arch,leaf,local", [
    ("llama-3.2-vision-11b", "embed", (128256 // 16, 4096 // 16)),  # FSDP: vocab on model, embed on data
    ("qwen2.5-14b", "cache k", (48, 128 // 32, 32768 // 16, 8, 128)),  # 8 kv heads: seq fallback
])
def test_distribute_tensor_gives_the_planned_local_shapes(fake_mesh, arch, leaf, local):
    cfg = get_config(arch, "full")
    if leaf == "embed":
        spec = model_spec(cfg)
        tensor = abstract_params(spec, torch.bfloat16)["embed"]
        pl = param_placements(spec, rules_for(cfg), fake_mesh)["embed"]
    else:
        specs = decode_specs(cfg, SHAPES["decode_32k"])
        tensor = specs["cache"]["layers"]["b0"]["k"]
        pl = plan.decode_in_placements(cfg, specs, fake_mesh)["cache"]["layers"]["b0"]["k"]
    with FakeTensorMode():
        dt = distribute_tensor(torch.empty(tensor.shape, dtype=tensor.dtype), fake_mesh, pl)
        assert tuple(dt.to_local().shape) == local and tuple(dt.shape) == tuple(tensor.shape)
