"""Logical-axis sharding rules (MaxText-style), as DTensor placements.

Port of the rules half of the reference's ``models/sharding.py``. Every
parameter leaf (``spec.ParamLeaf``) names its dims with *logical* axes
("embed", "heads", "ffn", "experts", ...). A per-architecture *rules*
table maps logical names to mesh axes; ``None`` replicates. The same
definition plans the single-pod (data, model) mesh, the multi-pod (pod,
data, model) mesh and the 1-device smoke mesh.

Conventions (Megatron/MaxText-ish):
  * "batch"   -> ("pod", "data")   — pure DP
  * "vocab"   -> "model"           — sharded embeddings/logits
  * "heads"   -> "model"           — tensor parallel attention
  * "ffn"     -> "model"           — tensor parallel MLP
  * "experts" -> "model"           — expert parallel MoE
  * "embed"   -> "data" (FSDP) for big configs, None for small

A plan reads only the mesh's dim names and sizes (``mesh.mesh_dim_names``
and ``mesh.shape``, as a ``DeviceMesh`` has them), as the reference's
reads only ``mesh.shape``. Internally a leaf's sharding is an *axis spec*,
one entry per tensor dim (None, a mesh axis, or a tuple of mesh axes), the
reference's ``PartitionSpec``; what the plan hands out is DTensor
placements, one per mesh dim, which ``distribute_tensor`` takes. A tensor
dim sharded over several mesh axes is split in mesh order, which every
rule table here follows.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import Placement, Replicate, Shard

from ..tree import map_leaves
from .spec import ParamLeaf

Rules = dict[str, Any]  # logical name -> mesh axis | tuple | None
AxisSpec = tuple  # per tensor dim: None | mesh axis | tuple of mesh axes

# Default tensor-parallel rules (small models: no FSDP).
DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "embed_noshard": None,
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qk_dim": None,
    "ffn": "model",
    "experts": "model",
    "expert_ffn": None,
    "expert_embed": None,
    "layers": None,
    "state": None,
    "conv": None,
    "dt_rank": None,
    "lora": None,
    "inner": "model",  # mamba/rwkv expanded inner channels
    "frames": None,
    "patches": None,
    "vision_embed": None,
}

# FSDP rules for >=100B configs: weights' "embed" axis sharded over data.
FSDP_RULES: Rules = dict(DEFAULT_RULES, embed="data")


def rules_for(cfg) -> Rules:
    """Resolve an architecture's rules: base table + per-arch overrides."""
    base = FSDP_RULES if getattr(cfg, "sharding_rules", "tp") == "fsdp" else DEFAULT_RULES
    overrides = getattr(cfg, "rules_overrides", None) or {}
    return {**base, **overrides}


def axis_sizes(mesh) -> dict[str, int]:
    """Mesh axis name -> its size."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def resolve_axes(axes: tuple[str | None, ...], rules: Rules, mesh) -> AxisSpec:
    """Map logical axes to an axis spec valid on this mesh."""
    names = tuple(mesh.mesh_dim_names)
    spec: list[Any] = []
    for name in axes:
        target = None if name is None else rules.get(name, None)
        if target is None:
            spec.append(None)
        elif isinstance(target, (tuple, list)):
            present = tuple(a for a in target if a in names)
            spec.append(present if present else None)
        else:
            spec.append(target if target in names else None)
    # a mesh axis shards at most one tensor dim; keep the first occurrence
    used: set[str] = set()
    cleaned: list[Any] = []
    for s in spec:
        if s is None:
            cleaned.append(None)
        elif isinstance(s, tuple):
            keep = tuple(a for a in s if a not in used)
            used.update(keep)
            cleaned.append(keep if keep else None)
        elif s in used:
            cleaned.append(None)
        else:
            used.add(s)
            cleaned.append(s)
    return tuple(cleaned)


def _divisible(shape: tuple[int, ...], spec: AxisSpec, mesh) -> AxisSpec:
    """Shard a dim only where the mesh axes divide it evenly; replicate it
    otherwise (the reference's rule for parameters, whose input shardings
    must divide exactly)."""
    sizes = axis_sizes(mesh)
    out: list[Any] = []
    for dim, s in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if s is None:
            out.append(None)
            continue
        total = 1
        for a in (s if isinstance(s, tuple) else (s,)):
            total *= sizes[a]
        out.append(s if dim % total == 0 else None)
    return tuple(out)


def axes_to_placements(spec: AxisSpec, mesh) -> tuple[Placement, ...]:
    """An axis spec as DTensor placements, one per mesh dim: ``Shard(d)``
    where mesh axis i splits tensor dim d, else ``Replicate()``."""
    names = tuple(mesh.mesh_dim_names)
    out: list[Placement] = [Replicate()] * len(names)
    for d, s in enumerate(spec):
        if s is None:
            continue
        group = s if isinstance(s, tuple) else (s,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"{group} is not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def placements_to_axes(placements: tuple[Placement, ...], mesh) -> AxisSpec:
    """The tensor dims' mesh axes, up to the last sharded dim: None, one
    axis name, or a tuple of names in mesh order (the inverse of
    ``axes_to_placements``, comparable with a ``PartitionSpec``)."""
    names = tuple(mesh.mesh_dim_names)
    dims: dict[int, list[str]] = {}
    for name, p in zip(names, placements):
        if isinstance(p, Shard):
            dims.setdefault(p.dim, []).append(name)
    out: list[Any] = [None] * (max(dims) + 1 if dims else 0)
    for d, group in dims.items():
        out[d] = group[0] if len(group) == 1 else tuple(group)
    return tuple(out)


def abstract_params(spec: Any, dtype: torch.dtype) -> Any:
    """The parameter tree as tensors on the meta device (no memory)."""
    return map_leaves(lambda leaf: torch.empty(leaf.shape, dtype=dtype, device="meta"), spec)


def param_placements(spec: Any, rules: Rules, mesh) -> Any:
    """Placements tree matching the param tree: each leaf's logical axes
    resolved, and kept where they divide its dims."""

    def per_leaf(leaf: ParamLeaf) -> tuple[Placement, ...]:
        return axes_to_placements(
            _divisible(leaf.shape, resolve_axes(leaf.axes, rules, mesh), mesh), mesh)

    return map_leaves(per_leaf, spec)
