"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's, and a traced cell's FLOPs against the reference's count.

Carried over from ``tests/test_sharding_roofline.py``: ``active_params``
and ``model_flops`` equal the reference's exactly for all ten archs at
full size; experts are discounted; the ``Roofline`` terms and bottleneck,
here with the H100's constants (989e12 FLOP/s, 3.35e12 B/s, 50e9 B/s a
card).

New: per-device FLOPs of three smoke cells on a (2, 4) world against the
reference's ``dot_flops`` (``repro.launch.dryrun_lib.run_cell`` in a
subprocess of its own on 8 host devices, as ``tests/test_dryrun_cells.py``
runs it). The port traces its CPU path (fake CPU tensors, the reference's
``use_pallas=False``), so both count the same products. Both take the
same ``q_chunk`` override of 4,096 for stablelm-3b: at train_4k's 4,096
tokens that is the unchunked path, where the reference's chunked one
wraps each query block in a ``jax.checkpoint`` of its own that the port's
Python loop has not, and at prefill it only cuts the port's trace from 64
query blocks a layer to 8 (the count is the same at any chunk). The bar
is 2%: prefill and train agree exactly; mixtral's decode step lays out
its attention and MoE products differently in the two programs (1.5%
apart).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import roofline as ref_roofline
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch.dryrun_lib import run_cell
from repro_torch.launch.mesh import MeshShape, fake_world, make_mesh
from repro_torch.launch.roofline import (
    HBM_BW, NET_BW, PEAK_FLOPS, Roofline, active_params, model_flops,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_and_model_flops_equal_the_reference(arch):
    cfg, rcfg = get_config(arch, "full"), ref_get_config(arch, "full")
    assert active_params(cfg) == ref_roofline.active_params(rcfg)
    for name in SHAPES:
        assert model_flops(cfg, SHAPES[name]) == ref_roofline.model_flops(rcfg, REF_SHAPES[name])


def test_active_params_discounts_experts():
    total, active = active_params(get_config("mixtral-8x7b", "full"))
    assert active < total  # top-2 of 8
    assert active > total * 0.25  # attention/embeddings not discounted
    t2, a2 = active_params(get_config("granite-3-8b", "full"))
    assert t2 == a2  # dense: no discount


def test_model_flops_kinds():
    cfg = get_config("stablelm-3b", "full")
    train = model_flops(cfg, SHAPES["train_4k"])
    prefill = model_flops(cfg, SHAPES["prefill_32k"])
    decode = model_flops(cfg, SHAPES["decode_32k"])
    _, n = active_params(cfg)
    assert train == 6.0 * n * 256 * 4096
    assert prefill == 2.0 * n * 32 * 32768
    assert decode == 2.0 * n * 128  # one token per sequence


def test_roofline_terms_and_bottleneck():
    assert (PEAK_FLOPS, HBM_BW, NET_BW) == (989e12, 3.35e12, 50e9)  # one H100 SXM
    r = Roofline(
        flops_per_device=PEAK_FLOPS,  # exactly 1 s of compute
        bytes_per_device=3.35e12 * 2,  # 2 s of memory
        collective_bytes_per_device=50e9 * 0.5,  # 0.5 s of wire
        chips=4,
        model_flops_total=PEAK_FLOPS * 4,  # ideal 1 s
    )
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(0.5)
    assert r.bottleneck == "memory"
    assert r.roofline_fraction == pytest.approx(0.5)  # ideal 1s / max 2s
    assert r.useful_flops_fraction == pytest.approx(1.0)
    d = r.to_dict()
    assert d["bottleneck"] == "memory" and d["memory_s"] == pytest.approx(2.0)


CELLS = [("stablelm-3b", "prefill_32k", {"q_chunk": 4096}),
         ("stablelm-3b", "train_4k", {"q_chunk": 4096}),
         ("mixtral-8x7b", "decode_32k", {})]

_REFERENCE = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax
    from repro.launch.dryrun_lib import run_cell
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    recs = [run_cell(arch, shape, mesh, variant="smoke", cfg_overrides=ov)
            for arch, shape, ov in {cells}]
    print("RESULT::" + json.dumps([r["roofline"]["flops_per_device"] for r in recs]))
    """
)


def test_flops_per_device_against_the_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("JAX_PLATFORMS", None)
    # the reference compiles in its own process while the port traces here
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE.format(cells=repr(CELLS))],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    try:
        with fake_world(8):
            mesh = make_mesh(MeshShape((2, 4), ("data", "model")), "cpu")
            recs = [run_cell(arch, shape, mesh, variant="smoke", cfg_overrides=ov, card=False)
                    for arch, shape, ov in CELLS]
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, stderr[-3000:]
    line = [ln for ln in stdout.splitlines() if ln.startswith("RESULT::")][0]
    ref = json.loads(line[len("RESULT::"):])
    for (arch, shape, _), rec, want in zip(CELLS, recs, ref):
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["path"] == "cpu"
        assert rec["roofline"]["flops_per_device"] == pytest.approx(want, rel=0.02), (arch, shape)
