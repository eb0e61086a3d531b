"""Sharding plans for the dry-run: state, batch and cache placements.

Port of the reference's ``launch/sharding_plan.py``. Parameters use the
logical-axis rules (``models/sharding.py``). Optimizer state mirrors the
parameters' placements (AdamW) or drops the factored axis (Adafactor,
by ``train/optimizer.py``'s factoring rule). Caches get explicit per-leaf
axis specs with divisibility-aware fallbacks: when KV heads don't divide
the model axis (qwen's 8 kv heads on a 16-wide axis), the cache shards
its *sequence* dim instead — sequence-parallel attention; MLA's latent
``c_kv`` and ``k_rope`` shard the sequence too.

Every plan is a tree of DTensor placement tuples, one placement per mesh
dim, as ``distribute_tensor(t, mesh, placements)`` takes them. So the
reference's ``to_shardings`` (PartitionSpec -> NamedSharding) has no
counterpart here. A plan reads only the mesh's dim names and sizes.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import Placement, Replicate

from ..configs.base import ModelConfig, TrainConfig
from ..models.sharding import (
    AxisSpec, axes_to_placements, axis_sizes, param_placements, placements_to_axes, rules_for,
)
from ..train.optimizer import _factored
from ..tree import map_leaves


def _axis_size(mesh, axes: tuple[str, ...]) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in tuple(mesh.mesh_dim_names))


def _full(spec: AxisSpec, ndim: int) -> AxisSpec:
    return tuple(spec) + (None,) * (ndim - len(spec))


def _replicated(mesh) -> tuple[Placement, ...]:
    return (Replicate(),) * len(tuple(mesh.mesh_dim_names))


# ---------------------------------------------------------------------------
# Train-state sharding
# ---------------------------------------------------------------------------


def opt_placements(spec_tree: Any, placements: Any, tcfg: TrainConfig, mesh) -> Any:
    """Optimizer-state placements mirroring the param tree's."""
    if tcfg.optimizer == "adafactor":
        def per_leaf(leaf, pl):
            t = _full(placements_to_axes(pl, mesh), len(leaf.shape))
            if _factored(tuple(leaf.shape)):
                return {"vr": axes_to_placements(t[:-1], mesh),
                        "vc": axes_to_placements(t[:-2] + t[-1:], mesh)}
            return {"v": pl}

        return {"v": map_leaves(per_leaf, spec_tree, placements)}
    return {"m": placements, "v": placements}


def state_placements(cfg: ModelConfig, spec_tree: Any, mesh, tcfg: TrainConfig) -> dict:
    pps = param_placements(spec_tree, rules_for(cfg), mesh)
    return {
        "step": _replicated(mesh),
        "params": pps,
        "opt": opt_placements(spec_tree, pps, tcfg, mesh),
    }


def batch_placements(cfg: ModelConfig, batch_tree: Any, mesh, batch_dim: int = 0) -> Any:
    """batch_dim=1 for pre-split microbatch leaves shaped (k, B/k, ...)."""
    baxes = batch_axes(mesh)

    def per_leaf(leaf):
        if (baxes and leaf.ndim > batch_dim
                and leaf.shape[batch_dim] % max(_axis_size(mesh, baxes), 1) == 0):
            return axes_to_placements((None,) * batch_dim + (baxes,), mesh)
        return _replicated(mesh)

    return map_leaves(per_leaf, batch_tree)


def microbatch_specs(batch_tree: Any, k: int) -> Any:
    """Reshape abstract batch leaves (B, ...) -> (k, B/k, ...)."""

    def per_leaf(leaf):
        b = leaf.shape[0]
        if b % k:
            raise ValueError(f"batch {b} not divisible by microbatches {k}")
        return torch.empty((k, b // k, *leaf.shape[1:]), dtype=leaf.dtype, device="meta")

    return map_leaves(per_leaf, batch_tree)


# ---------------------------------------------------------------------------
# Decode-cache sharding
# ---------------------------------------------------------------------------


def _cache_axes(name: str, shp: tuple[int, ...], bspec, model_n: int) -> AxisSpec:
    """One cache leaf's axis spec, by its name and divisibility."""
    if name in ("k", "v"):  # (L, B, S, KV, HD)
        _, b, seq, kv, _ = shp
        if kv % model_n == 0:
            return (None, bspec(b), None, "model", None)
        if seq % model_n == 0:  # sequence-parallel KV cache
            return (None, bspec(b), "model", None, None)
        return (None, bspec(b))
    if name in ("xk", "xv"):  # (L, B, M, KV, HD)
        _, b, _, kv, _ = shp
        if kv % model_n == 0:
            return (None, bspec(b), None, "model", None)
        return (None, bspec(b))
    if name in ("c_kv", "k_rope"):  # (L, B, S, R|dr): MLA's latent, sequence-parallel
        _, b, seq, _ = shp
        if seq % model_n == 0:
            return (None, bspec(b), "model", None)
        return (None, bspec(b))
    if name == "h":  # mamba state (L, B, DI, N)
        _, b, di, _ = shp
        if di % model_n == 0:
            return (None, bspec(b), "model", None)
        return (None, bspec(b))
    if name == "conv":  # (L, B, CW-1, DI)
        _, b, _, di = shp
        if di % model_n == 0:
            return (None, bspec(b), None, "model")
        return (None, bspec(b))
    if name == "wkv":  # rwkv state (L, B, H, K, V)
        _, b, h, *_ = shp
        if h % model_n == 0:
            return (None, bspec(b), "model", None, None)
        return (None, bspec(b))
    if name == "x_prev":  # (L, B, D)
        _, b, d = shp
        return (None, bspec(b), "model" if d % model_n == 0 else None)
    return ()  # replicate small/unknown leaves


def cache_placements(cfg: ModelConfig, cache_tree: dict, mesh) -> dict:
    """Walk the cache dict; assign placements by leaf name + divisibility."""
    baxes = batch_axes(mesh)
    model_n = axis_sizes(mesh).get("model", 1)
    batch_n = _axis_size(mesh, baxes)

    def bspec(b: int):
        return baxes if (baxes and b % batch_n == 0) else None

    def walk(tree: dict) -> dict:
        return {k: walk(v) if isinstance(v, dict) else
                axes_to_placements(_cache_axes(k, tuple(v.shape), bspec, model_n), mesh)
                for k, v in tree.items()}

    out = {"layers": walk(cache_tree["layers"])}
    if "prefix_layers" in cache_tree:
        out["prefix_layers"] = walk(cache_tree["prefix_layers"])
    mem = cache_tree.get("memory")
    out["memory"] = None if mem is None else axes_to_placements((bspec(mem.shape[0]),), mesh)
    return out


def decode_in_placements(cfg: ModelConfig, specs: dict, mesh) -> dict:
    baxes = batch_axes(mesh)
    b = specs["tokens"].shape[0]
    tokens = (baxes,) if (baxes and b % _axis_size(mesh, baxes) == 0) else ()
    return {
        "tokens": axes_to_placements(tokens, mesh),
        "cache": cache_placements(cfg, specs["cache"], mesh),
        "pos": _replicated(mesh),
    }
