"""B4, the decode-attention kernel (``repro_torch.kernels.decode_attention``)
and its custom op ``repro_torch::decode_attention``.

On the CPU: the op's CPU kernel against the reference's masked
``gqa_scores_softmax_out``, bit for bit, over int and tensor positions,
contiguous and ring caches, positions at 0, in the middle, at T - 1 and
past T; whole decode steps of smoke models taking the card's path against
the CPU path; the fake, the FLOP count, the sharding rule on a CPU mesh
and the wrapper's refusals; the partials of a cache sharded along its rows,
joined, against the twin, on plain shards and as DTensors over four gloo
processes, and a dry-run of such a cache that gathers none of it.

On the card (``-m cuda``, skipped without one): the kernel against its twin
at chat's shape (float32, B = 32, T = 768, H = KV = 32, D = 80) and at GQA
bfloat16 and ring shapes, the splits of the rows, a captured graph replayed
at advancing positions against eager calls, and the launches a replay adds.
"""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import launches as kl
from repro_torch.kernels import ops
from repro_torch.launch.costs import CountedFakeMode
from repro_torch.launch.mesh import MeshShape, fake_world, make_mesh
from repro_torch.models import decode_step, init_params, model_spec, prefill
from repro_torch.models.attention import gqa_scores_softmax_out
from repro_torch.tree import leaves, map_leaves

T = 12


def _inputs(gen, b, t, kv, g, d, dtype, device="cpu"):
    q = torch.randn(b, 1, kv * g, d, generator=gen, device=device).to(dtype)
    k, v = (torch.randn(b, t, kv, d, generator=gen, device=device).to(dtype) for _ in range(2))
    return q, k, v


def _attn_decode_mask(pos, t, ring):
    """The reference ``attn_decode``'s mask, for an int or a (1,) tensor:
    a ring's slots written so far, a contiguous cache's rows <= pos."""
    idx = torch.arange(t)
    if isinstance(pos, torch.Tensor):
        return idx < (pos + 1).clamp(max=t) if ring else idx <= pos
    return idx < min(pos + 1, t) if ring else idx <= pos


# ---------------------------------------------------------------------------
# CPU: the op against the CPU path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 64, 80, 128])
@pytest.mark.parametrize("g", [1, 4, 8])
def test_cpu_kernel_is_attn_decodes_masked_softmax(g, d, dtype):
    gen = torch.Generator().manual_seed(g * 1000 + d)
    q, k, v = _inputs(gen, 2, T, 2, g, d, dtype)
    for pos in (0, T // 2, T - 1, T, T + 5):
        for ring in (False, True):
            for as_tensor in (False, True):
                p = torch.tensor([pos]) if as_tensor else pos
                want = gqa_scores_softmax_out(q, k, v, _attn_decode_mask(p, T, ring)[None, None,
                                                                                    None, None])
                got = torch.ops.repro_torch.decode_attention(q, k, v, torch.tensor([pos]))
                assert got.dtype == dtype and got.shape == q.shape
                assert torch.equal(got, want), (pos, ring, as_tensor)


def test_live_mask_is_both_caches_mask():
    for pos in range(0, 2 * T):
        p = torch.tensor([pos])
        for ring in (False, True):
            assert torch.equal(da.live_mask(p, T), _attn_decode_mask(p, T, ring)), (pos, ring)


def _smoke_f32(arch):
    return get_config(arch, "smoke").copy(param_dtype="float32", compute_dtype="float32")


@pytest.mark.parametrize("arch", ["stablelm-3b", "granite-3-8b", "qwen2.5-14b", "mixtral-8x7b"])
def test_decode_on_the_cards_path_equals_the_cpu_path(arch):
    """Whole decode steps (G 1, 2, 5; mixtral's smoke window 8 makes its
    cache a ring, wrapped by the last steps) at int and tensor positions:
    taking the op changes no bit."""
    cfg = _smoke_f32(arch)
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0), torch.float32, "cpu")
    prompt, steps = 6, 5
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                                (2, prompt + steps)))
    with torch.no_grad():
        _, cache = prefill(params, cfg, {"tokens": tokens[:, :prompt]}, max_len=prompt + steps)
        caches = [cache] + [map_leaves(torch.clone, cache) for _ in range(3)]
        for i in range(steps):
            tok, pos = tokens[:, prompt + i: prompt + i + 1], prompt + i
            want, caches[0] = decode_step(params, cfg, tok, caches[0], pos)
            outs = []
            with ops.card_path():
                for j, p in enumerate((pos, torch.tensor(pos))):
                    out, caches[1 + j] = decode_step(params, cfg, tok, caches[1 + j], p)
                    outs.append(out)
            out, caches[3] = decode_step(params, cfg, tok, caches[3], torch.tensor(pos))
            outs.append(out)
            for out in outs:
                assert torch.equal(out, want), (arch, i)
    for c in caches[1:]:
        for x, y in zip(leaves(c), leaves(caches[0])):
            assert torch.equal(x, y)


def test_fake_gives_the_kernels_shape_and_dtype():
    gen = torch.Generator().manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        real = (*_inputs(gen, 3, T, 2, 4, 16, dtype), torch.tensor([5]))
        want = ops._decode_cpu(*real)
        with FakeTensorMode() as mode:
            got = torch.ops.repro_torch.decode_attention(*(mode.from_tensor(t) for t in real))
        assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype)


def test_flop_count_is_every_row_of_the_cache():
    gen = torch.Generator().manual_seed(4)
    q, k, v = _inputs(gen, 2, T, 2, 4, 16, torch.float32)
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro_torch.decode_attention(q, k, v, torch.tensor([3]))
    assert fc.get_total_flops() == da.operations(2, 8, T, 16) == 4 * 2 * 8 * T * 16


def test_wrapper_takes_the_op_only_on_the_cards_path():
    gen = torch.Generator().manual_seed(5)
    q, k, v = _inputs(gen, 2, T, 2, 4, 16, torch.float32)
    pos = torch.tensor([4])
    with FlopCounterMode(display=False) as plain:
        ops.decode_attention(q, k, v, pos)
    with ops.card_path(), FlopCounterMode(display=False) as card:
        ops.decode_attention(q, k, v, pos)
    assert "repro_torch.decode_attention" not in {str(o) for o in plain.get_flop_counts()["Global"]}
    assert "repro_torch.decode_attention" in {str(o) for o in card.get_flop_counts()["Global"]}


class _Spec:
    """What a sharding rule reads of an argument: its shape and mesh."""

    def __init__(self, shape, mesh):
        self.shape, self.mesh = shape, mesh


@pytest.mark.parametrize("arch,heads_split", [("mixtral-8x7b", False), ("stablelm-3b", True)])
def test_sharding_rule_keeps_heads_with_their_kv_and_the_sequence_whole(arch, heads_split):
    """On the (2, 16, 16) mesh, as B1's rule: mixtral's 8 kv heads do not
    divide the 16-wide model axis, stablelm's 32 do. No strategy shards the
    sequence; pos is always replicated."""
    cfg = get_config(arch, "full")
    b, t, h, kv, d = 32, 2048, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    mesh = MeshShape((2, 16, 16), ("pod", "data", "model"))
    q, k, p = _Spec((b, 1, h, d), mesh), _Spec((b, t, kv, d), mesh), _Spec((1,), mesh)
    rules = ops._decode_sharding(q, k, k, p)
    for outs, ins in rules:
        assert ins[3] == Replicate()
        assert len({str(x) for x in ins[:3] + outs}) == 1  # q, k, v and out alike
        assert Shard(1) not in ins
    assert any(Shard(2) in outs for outs, _ in rules) == heads_split
    with fake_world(512):
        dmesh = make_mesh(mesh, "cpu")
        with CountedFakeMode(allow_non_fake_inputs=True):
            qd = DTensor.from_local(torch.empty(b // 32, 1, h // 16, d), dmesh,
                                    [Shard(0), Shard(0), Shard(2)], run_check=False,
                                    shape=(b, 1, h, d), stride=(h * d, h * d, d, 1))
            kv_split = 16 if kv % 16 == 0 else 1
            kd = DTensor.from_local(torch.empty(b // 32, t, kv // kv_split, d), dmesh,
                                    [Shard(0), Shard(0), Shard(2) if kv_split > 1 else Replicate()],
                                    run_check=False, shape=(b, t, kv, d),
                                    stride=(t * kv * d, kv * d, d, 1))
            pd = DTensor.from_local(torch.zeros(1, dtype=torch.int64), dmesh, [Replicate()] * 3,
                                    run_check=False)
        with ops.card_path():
            out = ops.decode_attention(qd, kd, kd, pd)
    assert tuple(out.shape) == (b, 1, h, d)
    assert (out.placements[2] == Shard(2)) == heads_split
    assert out._local_tensor.shape[2] == (h // 16 if heads_split else h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 12, 2, 4, 16), (3, 300, 4, 8, 128), (1, 4096, 8, 4, 128)],
                         ids=["small", "GQA 8", "ring"])
def test_partials_of_row_shards_join_to_the_twin(shape, dtype):
    """The partial op on 1, 2 and 4 shards of the rows, each given its own
    live rows (none for a shard past pos), joined by ``combine_partials``,
    equals the twin over the whole cache."""
    b, t, kv, g, d = shape
    gen = torch.Generator().manual_seed(t + g)
    q, k, v = _inputs(gen, b, t, kv, g, d, dtype)
    for pos in (0, t // 3, t - 1, t + 5):
        want = _f32_twin(q, k, v, torch.tensor([pos]))
        n = min(pos + 1, t)
        for shards in (1, 2, 4):
            per = t // shards
            parts = [torch.ops.repro_torch.decode_attention_partial(
                q, k[:, i * per:(i + 1) * per], v[:, i * per:(i + 1) * per],
                torch.tensor([min(max(n - i * per, 0), per)])) for i in range(shards)]
            assert parts[0].shape == (b, kv * g, da.splits_for(b * kv, per), d + 2)
            got = da.combine_partials(torch.cat(parts, 2), torch.float32)
            torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# placements of the cache on a (2, 2) mesh: rows on one mesh dim, with the
# batch or the kv heads on the other; rows on both
ROW_SHARDED = [(Shard(0), Shard(1)), (Shard(1), Shard(2)), (Shard(1), Shard(1))]


def _row_sharded_worker(rank: int, world: int, port: int) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(MeshShape((2, 2), ("data", "model")), "cpu")
        b, t, kv, g, d = 4, 64, 2, 4, 16
        q, k, v = _inputs(torch.Generator().manual_seed(13), b, t, kv, g, d, torch.float32)
        for placements in ROW_SHARDED:
            kd, vd = (distribute_tensor(x, mesh, list(placements)) for x in (k, v))
            qd = distribute_tensor(q, mesh, [Replicate()] * 2)
            for pos in (0, 20, t - 1, t + 7):
                p = torch.tensor([pos])
                with ops.card_path():
                    out = ops.decode_attention(qd, kd, vd, distribute_tensor(p, mesh,
                                                                             [Replicate()] * 2))
                assert isinstance(out, DTensor) and tuple(out.shape) == (b, 1, kv * g, d)
                torch.testing.assert_close(out.full_tensor(), _f32_twin(q, k, v, p), atol=2e-5,
                                           rtol=1e-4, msg=f"{placements} pos {pos}")
    finally:
        dist.destroy_process_group()


def test_row_sharded_cache_on_four_gloo_processes():
    """DTensor caches sharded along their rows over a (2, 2) CPU mesh of four
    processes (``ROW_SHARDED``), taking the card's path: each shard's
    partials, joined across the mesh, equal the twin at every position."""
    mp.spawn(_row_sharded_worker, args=(4, _free_port()), nprocs=4, join=True)


def test_dry_run_reads_a_row_sharded_cache_in_place():
    """mixtral's 8 kv heads do not divide the 16-wide model axis, so its
    decode cache is sharded along its rows there. Traced on the (2, 16, 16)
    mesh, the card's path gathers less than one layer's row shard of K in
    all, and no more than the plain path, which gathers the scores: the
    shards' partials are joined, not the cache gathered."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun_lib import run_cell

    shape = SHAPES["decode_32k"]
    with fake_world(512):
        mesh = make_mesh(MeshShape((2, 16, 16), ("pod", "data", "model")), "cpu")
        recs = [run_cell("mixtral-8x7b", shape, mesh, cfg_overrides={"num_layers": 2}, card=card)
                for card in (True, False)]
    assert all(r["status"] == "ok" for r in recs), [r.get("traceback") for r in recs]
    cfg = get_config("mixtral-8x7b", "full")
    shard_bytes = ((shape.global_batch // 32) * (shape.seq_len // 16) * cfg.num_kv_heads
                   * cfg.head_dim * 2)
    card, plain = (r["collectives"]["bytes_by_kind"].get("all-gather", 0.0) for r in recs)
    assert card < shard_bytes and card <= plain, (card, plain, shard_bytes)
    assert (recs[0]["memory_analysis"]["temp_size_in_bytes"]
            <= recs[1]["memory_analysis"]["temp_size_in_bytes"])


def test_splits_follow_the_shapes():
    assert da.splits_for(32 * 32, 768) == 1  # chat: B 32 x KV 32 fill the card unsplit
    assert da.splits_for(4 * 8, 2064) == 9  # GQA, B 4 x KV 8
    assert da.splits_for(1 * 8, 4096) == 33  # one sequence's window
    assert da.splits_for(4 * 4, 20) == 1  # a short cache is never split
    for bkv in (1, 7, 64, 1024, 65535):
        for t in (1, 63, 64, 768, 32768):
            s = da.splits_for(bkv, t)
            assert 1 <= s <= max(1, t // da.MIN_SPLIT_ROWS)


@pytest.mark.parametrize("shape,match", [
    (dict(b=2, t=T, kv=2, g=4, d=32), "unsupported D=32"),
    (dict(b=2, t=T, kv=2, g=4, d=16), "unsupported D=16 G=4"),
    (dict(b=2, t=T, kv=2, g=5, d=16), "one CUDA device"),
])
def test_cuda_wrapper_refuses_what_it_does_not_take(shape, match):
    gen = torch.Generator().manual_seed(6)
    q, k, v = _inputs(gen, shape["b"], shape["t"], shape["kv"], shape["g"], shape["d"],
                      torch.float32)
    with pytest.raises(ValueError, match=match):
        da.decode_attention_cuda(q, k, v, torch.tensor([3]))


def test_instances_cover_every_attention_config():
    """``SHAPES`` (read from the source's ``by_shape``) holds the (D, G) pair
    of every config that decodes through ``attn_decode``, smoke and full."""
    from repro_torch.configs import ARCH_IDS

    pairs = set()
    for arch in ARCH_IDS:
        for variant in ("smoke", "full"):
            cfg = get_config(arch, variant)
            if cfg.attention == "gqa":
                pairs.add((cfg.head_dim, cfg.num_heads // cfg.num_kv_heads))
    assert (80, 1) in pairs and pairs <= da.SHAPES, sorted(pairs - da.SHAPES)


def test_launch_counter_is_read_with_the_other_kernels():
    assert kl.MODULES["decode_attention"] is da
    assert "decode_attention" in kl.counts()
    assert all("flash_fwd_" not in n for n in ("decode_attn_split_kernel",
                                               "decode_attn_combine_kernel"))
    src = da.SOURCE.read_text()
    assert "decode_attn_split_kernel" in src and "flash_fwd_" not in src


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _f32_twin(q, k, v, pos):
    return da.decode_attention_plain(q.float(), k.float(), v.float(), pos).float()


def _plant_newest_row(q, k, pos):
    """k's row ``pos`` made 3 x the first query head of each even kv head's
    group, so that row outweighs the rest for those heads: a twin one row
    short then misses any bar, however many rows the softmax averages. The
    odd kv heads keep random keys and average over every live row."""
    b, _, h, d = q.shape
    kv = k.shape[2]
    k[:, pos, ::2] = 3 * q[:, 0].reshape(b, kv, h // kv, d)[:, ::2, 0]


def _f32_rows_twin(q, k, v, lo, hi):
    """The float32 twin over the cache's rows lo..hi - 1 alone."""
    rows = torch.zeros(k.shape[1], dtype=torch.bool, device=k.device)
    rows[lo:hi] = True
    return da.gqa_scores_softmax_out(q.float(), k.float(), v.float(),
                                     rows[None, None, None, None]).float()


LAST_ROWS = 32  # a twin over the newest rows alone must miss the bar once more rows live


# (B, T, KV, G, D, dtype, positions, atol, rtol, label), unsplit (chat, the
# smoke shape) and split into 9 or 33 (the rest). Float32: the kernel
# sums in another order than the twin's GEMVs, a few float32 ulps of outputs
# of size ~1. bfloat16: the kernel computes in float32 and rounds the output
# once (half a bf16 ulp is 2^-8 of the value); it is held to the float32 twin
# of the same bf16 inputs, since the bf16 twin rounds its scores to bf16.
CARD_CASES = [
    (32, 768, 32, 1, 80, torch.float32, (466, 720), 2e-5, 1e-4, "chat float32"),
    (4, 2064, 8, 4, 128, torch.bfloat16, (0, 1000, 2063), 1e-2, 1e-2, "GQA 4 bf16"),
    (2, 4096, 8, 4, 128, torch.bfloat16, (4095, 6000), 1e-2, 1e-2, "ring, wrapped, bf16"),
    (3, 300, 4, 8, 128, torch.float32, (0, 150, 299, 400), 2e-5, 1e-4, "GQA 8 float32"),
    (4, 40, 2, 5, 16, torch.bfloat16, (0, 17, 39), 1e-2, 1e-2, "smoke qwen bf16"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[-1] for c in CARD_CASES])
def test_cuda_kernel_against_its_twin(case):
    _card()
    b, t, kv, g, d, dtype, positions, atol, rtol, _ = case
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = _inputs(gen, b, t, kv, g, d, dtype, "cuda")
    for pos in positions:
        p = torch.tensor([pos], device="cuda")
        if pos < t:
            _plant_newest_row(q, k, pos)
        want = _f32_twin(q, k, v, p)
        got = da.decode_attention_cuda(q, k, v, p)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)
        n = min(pos + 1, t)
        if pos < t:  # the bar sees the newest live row (the planted heads)
            short = _f32_twin(q, k, v, p - 1)
            assert not torch.allclose(short, want, atol=atol, rtol=rtol)
        if n > LAST_ROWS:  # and the older rows (the heads left random)
            newest = _f32_rows_twin(q, k, v, n - LAST_ROWS, n)
            assert not torch.allclose(newest, want, atol=atol, rtol=rtol)


# (B, T, KV, G, D, dtype, shards, positions, atol, rtol, label): the kernel's
# partial mode on row shards of the cache (views of it, its strides), one
# split a shard (chat) and nine (GQA); positions leave later shards empty.
CARD_PARTIAL_CASES = [
    (32, 768, 32, 1, 80, torch.float32, 4, (100, 466, 767), 2e-5, 1e-4, "chat float32"),
    (4, 2064, 8, 4, 128, torch.bfloat16, 2, (0, 1000, 2063), 1e-2, 1e-2, "GQA 4 bf16"),
    (2, 4096, 8, 4, 128, torch.bfloat16, 4, (5000,), 1e-2, 1e-2, "ring, wrapped, bf16"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_PARTIAL_CASES, ids=[c[-1] for c in CARD_PARTIAL_CASES])
def test_cuda_partials_of_row_shards_join_to_the_twin(case):
    """Each shard's partials equal the plain partials where the split has
    live rows (float32 sums in another order) and are empty (m = NEG_INF,
    l = 0, acc = 0) where it has none; joined, they equal the twin."""
    _card()
    b, t, kv, g, d, dtype, shards, positions, atol, rtol, _ = case
    gen = torch.Generator(device="cuda").manual_seed(10)
    q, k, v = _inputs(gen, b, t, kv, g, d, dtype, "cuda")
    per = t // shards
    for pos in positions:
        n = min(pos + 1, t)
        parts = []
        for i in range(shards):
            live = torch.tensor([min(max(n - i * per, 0), per)], device="cuda")
            ks, vs = k[:, i * per:(i + 1) * per], v[:, i * per:(i + 1) * per]
            got = da.decode_partial_cuda(q, ks, vs, live)
            want = da.decode_partial_plain(q, ks, vs, live)
            torch.cuda.synchronize()
            assert got.shape == want.shape == (b, kv * g, da.splits_for(b * kv, per), d + 2)
            empty = want[..., d + 1] == 0
            assert torch.equal(got[empty], want[empty])
            torch.testing.assert_close(got[~empty], want[~empty], atol=2e-5, rtol=1e-4)
            parts.append(got)
        out = da.combine_partials(torch.cat(parts, 2), dtype)
        want = _f32_twin(q, k, v, torch.tensor([pos], device="cuda"))
        torch.testing.assert_close(out.float(), want, atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_cuda_kernel_reads_a_layer_view_of_the_stacked_cache():
    """``_decode_stack`` hands each layer ``cache[g]``: strides of the stack."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(8)
    stack = torch.randn(3, 4, 200, 2, 80, generator=gen, device="cuda")
    vstack = torch.randn(3, 4, 200, 2, 80, generator=gen, device="cuda")
    q = torch.randn(4, 1, 2, 80, generator=gen, device="cuda")
    p = torch.tensor([150], device="cuda")
    got = ops.decode_attention(q, stack[1], vstack[1], p)
    torch.testing.assert_close(got, _f32_twin(q, stack[1].clone(), vstack[1].clone(), p),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_graph_replays_at_the_advancing_position():
    """A captured step writes its row at ``pos`` and attends; replayed with
    ``pos`` advanced on the device between replays it equals eager calls.
    Each replay adds one launch (``GraphLaunches``)."""
    _card()
    b, t, kv, g, d = 4, 256, 2, 4, 128
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = _inputs(gen, b, t, kv, g, d, torch.float32, "cuda")
    rows = torch.randn(8, b, 1, kv, d, generator=gen, device="cuda")
    k_eager, v_eager = k.clone(), v.clone()
    pos = torch.full((1,), 100, dtype=torch.int64, device="cuda")
    row = torch.empty(b, 1, kv, d, device="cuda")

    def body():
        k.index_copy_(1, pos, row)
        v.index_copy_(1, pos, -row)
        return ops.decode_attention(q, k, v, pos)

    graph_launches = kl.GraphLaunches()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        row.copy_(rows[0])
        body()  # warm-up: writes row 100 again below
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with graph_launches.capturing(), torch.cuda.graph(graph):
        out = body()
    assert graph_launches.per_replay["decode_attention"] == 1
    before = kl.counts()
    for i in range(8):
        pos.fill_(100 + i)
        row.copy_(rows[i])
        graph.replay()
        graph_launches.replayed()
        k_eager[:, 100 + i] = rows[i][:, 0]
        v_eager[:, 100 + i] = -rows[i][:, 0]
        want = da.decode_attention_cuda(q, k_eager, v_eager,
                                        torch.tensor([100 + i], device="cuda"))
        torch.cuda.synchronize()
        assert torch.equal(out, want), i
    after = kl.counts()
    assert after["decode_attention"] - before["decode_attention"] == 8 + 8  # replays, eager
