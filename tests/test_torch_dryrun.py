"""The port's dry-run plane (``repro_torch.launch.{costs,dryrun_lib,dryrun,
report}``) and what it stands on: the kernels as custom ops, the models'
activation constraints, and decode at a tensor position.

Cells trace on a (2, 4) world of torch's fake process group, one process,
at the published widths; the depth is cut to 1 or 2 layers (the
reference's ``cfg_overrides``), which changes no per-layer count. The reference's
own dry-run tests (``tests/test_dryrun_cells.py``) are carried over
(status, positive FLOPs and bytes, a named bottleneck, collective traffic,
the long-context skip policy). New: FLOPs are per device (a (2, 4) world's
are the (1, 1) world's over 8, within 1%, for a cell whose products all
shard eight ways), and a plain ``FlopCounterMode`` around the DTensor
program would count the global product, which is what that check guards
against; the fake trace of a cell counts exactly what
``FlopCounterMode`` counts on a real run of the same step (the check
``chip_smoke.py`` makes on the card); the CLI writes a record with the
reference's keys that the report renders. The custom ops: bit for bit the
twins on CPU tensors, forward and gradients; their fakes' shapes and
dtypes; B1's sharding rule never pairs head-sharded queries with
replicated kv heads (mixtral, KV 8, and stablelm, KV = H, on the
(2, 16, 16) mesh). Decode at an int position and at a 0-dim tensor
position gives identical logits (stablelm, mixtral's ring cache,
deepseek's MLA), and a sequence-sharded cache takes a decode's row on the
rank that holds the slot only."""

import json

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6 as wkv
from repro_torch.launch import report
from repro_torch.launch.costs import CellCosts, CountedFakeMode
from repro_torch.launch.dryrun_lib import run_cell
from repro_torch.launch.mesh import MeshShape, fake_world, make_mesh
from repro_torch.models import decode_step, init_params, model_spec, prefill
from repro_torch.serve.engine import make_prefill, make_serve_step
from repro_torch.tree import leaves, map_leaves

MESH24 = MeshShape((2, 4), ("data", "model"))
TWO_LAYERS = {"num_layers": 2}


def _cells(cells, dims=MESH24, **kw):
    n = 1
    for d in dims.shape:
        n *= d
    with fake_world(n):
        mesh = make_mesh(dims, "cpu")
        return [run_cell(arch, shape, mesh, cfg_overrides=ov, **kw) for arch, shape, ov in cells]


# ---------------------------------------------------------------------------
# carried over from tests/test_dryrun_cells.py
# ---------------------------------------------------------------------------


def test_train_prefill_decode_cells_trace():
    recs = _cells([
        ("seamless-m4t-large-v2", "train_4k", {"num_layers": 1, "encoder_layers": 1}),
        ("stablelm-3b", "prefill_32k", TWO_LAYERS),
        ("mixtral-8x7b", "decode_32k", {"num_layers": 1}),
    ])
    for rec in recs:
        assert rec["status"] == "ok", rec.get("traceback")
        r = rec["roofline"]
        assert r["flops_per_device"] > 0
        assert r["bytes_per_device"] > 0
        assert r["bottleneck"] in ("compute", "memory", "collective")
        # collective traffic must exist on a sharded mesh
        assert rec["collectives"]["total_bytes"] > 0
        m = rec["memory_analysis"]
        assert m["argument_size_in_bytes"] > 0 and m["temp_size_in_bytes"] > 0
        assert rec["loop_trip_counts"] == {}  # eager tracing unrolls every layer


def test_long_context_skip_policy():
    recs = _cells([
        ("qwen2.5-14b", "long_500k", {}),  # pure attention -> skipped
        ("rwkv6-7b", "long_500k", TWO_LAYERS),  # SSM -> runs
    ])
    assert recs[0]["status"] == "skipped"
    assert "sub-quadratic" in recs[0]["reason"]
    assert recs[1]["status"] == "ok", recs[1].get("traceback")


# ---------------------------------------------------------------------------
# per-device counts
# ---------------------------------------------------------------------------


def test_flops_are_per_device():
    """stablelm-3b's widths: batch 8 over data 2, 32 heads, d_ff 6,912 and
    the vocab over model 4, so every product shards eight ways."""
    shape = ShapeConfig("prefill_1k", 1024, 8, "prefill")
    one = _cells([("stablelm-3b", shape, TWO_LAYERS)], MeshShape((1, 1), ("data", "model")))[0]
    eight = _cells([("stablelm-3b", shape, TWO_LAYERS)])[0]
    assert one["status"] == eight["status"] == "ok"
    f1, f8 = one["roofline"]["flops_per_device"], eight["roofline"]["flops_per_device"]
    assert f8 == pytest.approx(f1 / 8, rel=0.01)
    for op, f in one["flops_by_op"].items():
        assert eight["flops_by_op"][op] == pytest.approx(f / 8, rel=0.01), op
    # a small model's weights shard over model only (no FSDP): a quarter of them a device
    assert eight["memory_analysis"]["argument_size_in_bytes"] == pytest.approx(
        one["memory_analysis"]["argument_size_in_bytes"] / 4, rel=0.01)


def test_a_mode_outside_dtensor_would_count_the_global_product():
    """The trap the per-device count avoids: ``FlopCounterMode`` around a
    DTensor program sees the global op; ``CellCosts`` sees the local one."""
    m, k, n = 64, 32, 128
    with fake_world(8):
        mesh = make_mesh(MESH24, "cpu")
        fake = CountedFakeMode(allow_non_fake_inputs=True)
        with fake:
            x = DTensor.from_local(torch.empty(m // 2, k), mesh, [Shard(0), Replicate()],
                                   run_check=False, shape=(m, k), stride=(k, 1))
            w = DTensor.from_local(torch.empty(k, n // 4), mesh, [Replicate(), Shard(1)],
                                   run_check=False, shape=(k, n), stride=(n, 1))
        with FlopCounterMode(display=False) as outside:
            x @ w
        costs = CellCosts(fake)
        with costs:
            x @ w
    assert outside.get_total_flops() == 2 * m * k * n
    assert costs.flops == 2 * m * k * n / 8


def _smoke_f32(arch):
    return get_config(arch, "smoke").copy(param_dtype="float32", compute_dtype="float32")


def _f32_params(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return init_params(model_spec(cfg), gen, torch.float32, "cpu")


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_fake_trace_counts_what_a_real_run_counts(kind):
    """The check ``chip_smoke.py`` makes on the card, here on CPU tensors
    taking the card's path (the kernels' ops, run by their twins): the
    (1, 1) world's fake trace counts exactly the FLOPs that
    ``FlopCounterMode`` counts on a real run of the same step."""
    cfg = _smoke_f32("stablelm-3b")
    b, s = 2, 24
    shape = ShapeConfig("cell", s, b, kind)
    rec = _cells([("stablelm-3b", shape, {"param_dtype": "float32", "compute_dtype": "float32"})],
                 MeshShape((1, 1), ("data", "model")), variant="smoke")[0]
    assert rec["status"] == "ok", rec.get("traceback")
    params = _f32_params(cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)))
    with ops.card_path(), torch.no_grad():
        if kind == "prefill":
            with FlopCounterMode(display=False) as real:
                make_prefill(cfg)(params, {"tokens": tokens})
        else:
            _, cache = prefill(params, cfg, {"tokens": tokens[:, : s - 8]}, max_len=s)
            with FlopCounterMode(display=False) as real:
                make_serve_step(cfg)(params, tokens[:, :1], cache, torch.tensor(s - 8))
    assert real.get_total_flops() == rec["roofline"]["flops_per_device"]


def test_cli_writes_a_record_the_report_renders(tmp_path):
    from repro_torch.launch import dryrun

    recs = dryrun.main(["--arch", "stablelm-3b", "--shape", "prefill_32k", "--mesh", "single",
                        "--outdir", str(tmp_path)])
    assert [r["status"] for r in recs] == ["ok"]
    rec = json.loads((tmp_path / "single__stablelm-3b__prefill_32k.json").read_text())
    for key in ("status", "arch", "shape", "mesh", "chips", "variant", "memory_analysis",
                "collectives", "roofline", "compile_s"):
        assert key in rec, key
    assert rec["mesh"] == {"data": 16, "model": 16} and rec["chips"] == 256
    assert set(rec["collectives"]) >= {"counts", "total_bytes"}
    for key in ("compute_s", "memory_s", "collective_s", "bottleneck", "roofline_fraction",
                "useful_flops_fraction", "flops_per_device"):
        assert key in rec["roofline"], key
    recs = report.load(str(tmp_path))
    assert "| stablelm-3b | prefill_32k |" in report.roofline_table(recs, "single")
    assert "| stablelm-3b | prefill_32k | 16x16 | ok |" in report.dryrun_table(recs)


# ---------------------------------------------------------------------------
# the kernels as custom ops
# ---------------------------------------------------------------------------


def _rand(gen, *shape):
    return torch.randn(*shape, generator=gen)


def _flash_inputs(gen, b=2, s=40, h=4, kv=2, d=16, s_kv=None):
    return (_rand(gen, b, s, h, d), _rand(gen, b, s_kv or s, kv, d), _rand(gen, b, s_kv or s, kv, d))


def _wkv_inputs(gen, b=2, t=32, h=3, k=8):
    r, kk, v = (_rand(gen, b, t, h, k) for _ in range(3))
    logw = -torch.exp(_rand(gen, b, t, h, k) * 0.5)
    return r, kk, v, logw, _rand(gen, h, k) * 0.1, _rand(gen, b, h, k, k) * 0.1


def _scan_inputs(gen, b=2, t=24, di=12, n=4):
    dt = torch.nn.functional.softplus(_rand(gen, b, t, di))
    return (dt, _rand(gen, b, t, n), _rand(gen, b, t, n), -torch.exp(_rand(gen, di, n)),
            _rand(gen, b, t, di), _rand(gen, b, di, n) * 0.1)


def _twin_flash(q, k, v, causal, window, block_k):
    b, s, h, d = q.shape
    out = fa.flash_attention_plain(*(x.transpose(1, 2).reshape(-1, x.shape[1], d)
                                     for x in (q, k, v)),
                                   group=h // k.shape[2], causal=causal, window=window,
                                   block_k=block_k)
    return out.reshape(b, h, s, d).transpose(1, 2)


@pytest.mark.parametrize("causal,window,s_kv", [(True, 0, None), (True, 16, None),
                                                (False, 0, 56)])
def test_flash_op_is_the_twin_on_cpu(causal, window, s_kv):
    gen = torch.Generator().manual_seed(1)
    q, k, v = (t.requires_grad_() for t in _flash_inputs(gen, s_kv=s_kv))
    got = torch.ops.repro_torch.flash_attention(q, k, v, causal, window, 8)
    want = _twin_flash(q, k, v, causal, window, 8)
    assert torch.equal(got, want)
    g = torch.randn(got.shape, generator=gen)
    for a, b in zip(torch.autograd.grad(got, (q, k, v), g), torch.autograd.grad(want, (q, k, v), g)):
        assert torch.equal(a, b)
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro_torch.flash_attention(q, k, v, causal, window, 8)
    assert fc.get_total_flops() == fa.operations(2, 4, 40, s_kv or 40, 16, causal, window)


def test_wkv_and_scan_ops_are_the_twins_on_cpu():
    gen = torch.Generator().manual_seed(2)
    args = [t.requires_grad_() for t in _wkv_inputs(gen)]
    got = torch.ops.repro_torch.rwkv6_chunked(*args, 8)
    b, t, h, k = args[0].shape
    flat = [x.transpose(1, 2).reshape(b * h, t, -1) for x in args[:4]]
    u = args[4][None].expand(b, h, k).reshape(b * h, 1, k)
    out, s_final = wkv.rwkv6_plain(*flat, u, args[5].reshape(b * h, k, k), chunk=8)
    want = (out.reshape(b, h, t, k).transpose(1, 2), s_final.reshape(b, h, k, k))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    g = [torch.randn(x.shape, generator=gen) for x in got]
    for a, b in zip(torch.autograd.grad(got, args, g), torch.autograd.grad(want, args, g)):
        assert torch.equal(a, b)

    args = [t.requires_grad_() for t in _scan_inputs(gen)]
    got = torch.ops.repro_torch.mamba_chunk_scan(*args, 8, 5)
    want = ms.mamba_scan_plain(*args[:4], args[4].float(), args[5], chunk=8, d_block=4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))  # d_block 5 shrinks to 4
    g = [torch.randn(x.shape, generator=gen) for x in got]
    for a, b in zip(torch.autograd.grad(got, args, g), torch.autograd.grad(want, args, g)):
        assert torch.equal(a, b)
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro_torch.mamba_chunk_scan(*args, 8, 5)
    assert fc.get_total_flops() == ms.operations(2, 24, 12, 4)


def test_fakes_give_the_kernels_shapes_and_dtypes():
    gen = torch.Generator().manual_seed(3)
    real = {"flash": _flash_inputs(gen, s_kv=56), "wkv": _wkv_inputs(gen), "scan": _scan_inputs(gen)}
    real["scan"] = real["scan"][:4] + (real["scan"][4].bfloat16(),) + real["scan"][5:]
    want = {
        "flash": ops._flash_cpu(*real["flash"], False, 0, 8),
        "wkv": ops._wkv_cpu(*real["wkv"], 8),
        "scan": ops._scan_cpu(*real["scan"], 8, 4),
    }
    with FakeTensorMode() as mode:
        fake = {name: tuple(mode.from_tensor(t) for t in args) for name, args in real.items()}
        got = {
            "flash": torch.ops.repro_torch.flash_attention(*fake["flash"], False, 0, 8),
            "wkv": torch.ops.repro_torch.rwkv6_chunked(*fake["wkv"], 8),
            "scan": torch.ops.repro_torch.mamba_chunk_scan(*fake["scan"], 8, 4),
        }
        grads = {
            "flash": torch.ops.repro_torch.flash_attention_backward(got["flash"], *fake["flash"],
                                                                     False, 0, 8),
            "wkv": torch.ops.repro_torch.rwkv6_chunked_backward(*got["wkv"], *fake["wkv"], 8),
            "scan": torch.ops.repro_torch.mamba_chunk_scan_backward(*got["scan"], *fake["scan"],
                                                                    8, 4),
        }
    for name in want:
        outs = (want[name],) if isinstance(want[name], torch.Tensor) else want[name]
        fakes = (got[name],) if isinstance(got[name], torch.Tensor) else got[name]
        assert [(tuple(t.shape), t.dtype) for t in fakes] == [(tuple(t.shape), t.dtype)
                                                                for t in outs], name
        assert [(tuple(t.shape), t.dtype) for t in grads[name]] == [
            (tuple(t.shape), t.dtype) for t in real[name]], name


class _Spec:
    """What a sharding rule reads of an argument: its shape and mesh."""

    def __init__(self, shape, mesh):
        self.shape, self.mesh = shape, mesh


@pytest.mark.parametrize("arch,heads_split", [("mixtral-8x7b", False), ("stablelm-3b", True)])
def test_flash_rule_never_pairs_sharded_heads_with_replicated_kv(arch, heads_split):
    """On the (2, 16, 16) mesh: mixtral's 8 kv heads do not divide the
    16-wide model axis (its plan replicates them), stablelm's 32 do."""
    cfg = get_config(arch, "full")
    b, s, h, kv, d = 32, 4096, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    mesh = MeshShape((2, 16, 16), ("pod", "data", "model"))
    q, k = _Spec((b, s, h, d), mesh), _Spec((b, s, kv, d), mesh)
    for rules in (ops._flash_sharding(q, k, k, True, 0, 128),
                  ops._flash_bwd_sharding(q, q, k, k, True, 0, 128)):
        for outs, ins in rules:
            tensors = [p for p in ins if p is not None]
            assert len({str(p) for p in tensors + outs}) == 1  # q, k, v and out alike
        assert any(Shard(2) in outs for outs, _ in rules) == heads_split
    with fake_world(512):
        dmesh = make_mesh(mesh, "cpu")
        with CountedFakeMode(allow_non_fake_inputs=True):
            qd = DTensor.from_local(torch.empty(b // 32, s, h // 16, d), dmesh,
                                    [Shard(0), Shard(0), Shard(2)], run_check=False,
                                    shape=(b, s, h, d), stride=(s * h * d, h * d, d, 1))
            kv_split = 16 if kv % 16 == 0 else 1
            kd = DTensor.from_local(torch.empty(b // 32, s, kv // kv_split, d), dmesh,
                                    [Shard(0), Shard(0), Shard(2) if kv_split > 1 else Replicate()],
                                    run_check=False, shape=(b, s, kv, d),
                                    stride=(s * kv * d, kv * d, d, 1))
        with ops.card_path():
            out = ops.flash_attention(qd, kd, kd)
    assert (out.placements[2] == Shard(2)) == heads_split
    assert out._local_tensor.shape[2] == (h // 16 if heads_split else h)


def test_wrappers_take_the_op_only_on_the_cards_path():
    gen = torch.Generator().manual_seed(4)
    q, k, v = _flash_inputs(gen)
    with FlopCounterMode(display=False) as plain:
        ops.flash_attention(q, k, v)
    with ops.card_path(), FlopCounterMode(display=False) as card:
        ops.flash_attention(q, k, v)
    assert "repro_torch.flash_attention" not in {str(o) for o in plain.get_flop_counts()["Global"]}
    assert "repro_torch.flash_attention" in {str(o) for o in card.get_flop_counts()["Global"]}


@pytest.mark.cuda
def test_flash_op_on_the_card_is_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(2, 128, 8, 64, device="cuda", generator=gen).bfloat16()
    k, v = (torch.randn(2, 128, 2, 64, device="cuda", generator=gen).bfloat16() for _ in range(2))
    fa.launches = 0
    got = torch.ops.repro_torch.flash_attention(q, k, v, True, 0, 128)
    assert fa.launches == 1
    flat = [x.transpose(1, 2).reshape(-1, 128, 64) for x in (q, k, v)]
    want = fa.flash_attention_cuda(*flat, group=4, causal=True, window=0)
    assert torch.equal(got, want.reshape(2, 8, 128, 64).transpose(1, 2))
    assert fa.launches == 2


# ---------------------------------------------------------------------------
# decode at an int and at a tensor position
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,prompt", [("stablelm-3b", 12), ("mixtral-8x7b", 12),
                                         ("deepseek-v3-671b", 12)])
def test_tensor_position_decodes_as_an_int(arch, prompt):
    """mixtral's smoke window is 8: position 12 writes ring slot 4."""
    cfg = _smoke_f32(arch)
    params = _f32_params(cfg)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, prompt + 3)))
    with torch.no_grad():
        _, cache = prefill(params, cfg, {"tokens": tokens[:, :prompt]}, max_len=prompt + 4)
        by_int, by_tensor = cache, map_leaves(torch.clone, cache)
        for i in range(3):
            tok = tokens[:, prompt + i: prompt + i + 1]
            a, by_int = decode_step(params, cfg, tok, by_int, prompt + i)
            b, by_tensor = decode_step(params, cfg, tok, by_tensor,
                                       torch.tensor(prompt + i, dtype=torch.int32))
            assert torch.equal(a, b), i
    for x, y in zip(leaves(by_int), leaves(by_tensor)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("slot,row", [(3, None), (8, 0), (9, 1), (11, 3), (12, None)])
def test_sequence_sharded_cache_takes_the_row_on_its_owner_only(slot, row):
    """A cache (2, 16, 2, 3) sharded four ways along the sequence, seen
    from rank 2 of a fake world of 4 (it holds positions 8..11): a write
    at ``slot`` changes local row ``row`` and nothing else, or nothing
    when another rank holds the slot."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.models.attention import write_slot

    dist.init_process_group("fake", store=FakeStore(), rank=2, world_size=4)
    try:
        mesh = make_mesh(MeshShape((4,), ("model",)), "cpu")
        before = torch.arange(2 * 4 * 2 * 3, dtype=torch.float32).reshape(2, 4, 2, 3)
        cache = DTensor.from_local(before.clone(), mesh, [Shard(1)], run_check=False,
                                   shape=torch.Size((2, 16, 2, 3)), stride=(96, 6, 3, 1))
        new = DTensor.from_local(-torch.ones(2, 1, 2, 3), mesh, [Replicate()], run_check=False)
        write_slot(cache, torch.tensor([slot]), new)
        want = before.clone()
        if row is not None:
            want[:, row] = -1.0
        assert torch.equal(cache.to_local(), want)
    finally:
        dist.destroy_process_group()
