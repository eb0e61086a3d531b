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

import contextlib
import threading
from typing import TYPE_CHECKING, Any, Iterator

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from ..tree import map_leaves

if TYPE_CHECKING:
    from .spec import ParamLeaf



def __getattr__(name: str):
    # ``ParamLeaf`` for importers of this module, loaded late: the models
    # import this module, and ``spec`` imports the models
    if name == "ParamLeaf":
        from .spec import ParamLeaf
        return ParamLeaf
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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


_MESH_CTX = threading.local()


@contextlib.contextmanager
def activation_mesh(mesh) -> Iterator[None]:
    """Make ``mesh`` the one ``shard_activation`` constrains to while a
    dry-run traces a cell on it (the reference's context around lowering)."""
    prev = getattr(_MESH_CTX, "mesh", None)
    _MESH_CTX.mesh = mesh
    try:
        yield
    finally:
        _MESH_CTX.mesh = prev


def current_activation_mesh():
    return getattr(_MESH_CTX, "mesh", None)


def shard_activation(x: torch.Tensor, axes: tuple[str | None, ...], cfg) -> torch.Tensor:
    """Redistribute the DTensor ``x`` to the placements of its logical
    ``axes`` (where they divide its dims), as the reference's
    ``with_sharding_constraint`` by logical names, under ``cfg``'s rules
    (resolved only then). A no-op outside ``activation_mesh`` or on a
    plain tensor. Where no axis shards, the
    reference sets no constraint: only a pending partial sum is reduced
    (a vocab-parallel embedding's), the shards stay as they are."""
    mesh = current_activation_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = _divisible(tuple(x.shape), resolve_axes(axes, rules_for(cfg), mesh), mesh)
    if all(s is None for s in spec):
        placements = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    else:
        placements = axes_to_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    out = x.redistribute(mesh, placements)
    # a partial sum reduced here (a vocab-parallel embedding's masked one)
    # takes its gradient back only whole, as Megatron's all-reduce in a
    # column-parallel layer's backward hands it over
    return grad_as_placed(out) if any(p.is_partial() for p in x.placements) else out


def grad_as_placed(x: torch.Tensor) -> torch.Tensor:
    """The DTensor ``x`` (an identity) whose gradient is redistributed to
    ``x``'s own placements (replicated where ``x`` is a partial sum), and
    made contiguous, on the way back, so the op
    that made ``x`` gets the layout its forward saw: DTensor hands back
    what the consumers' strategies left, which a view's backward may not
    take. A no-op on a plain tensor."""
    return _GradAsPlaced.apply(x) if isinstance(x, DTensor) else x


class _GradAsPlaced(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        # a partial sum's gradient is whole on every rank
        ctx.placements = tuple(Replicate() if p.is_partial() else p for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if not isinstance(g, DTensor):
            return g.contiguous()
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        # the local shard laid out as the global strides say (a DTensor's
        # gradient may carry contiguous strides over a transposed shard)
        return DTensor.from_local(g.to_local().contiguous(), g.device_mesh, g.placements,
                                  run_check=False, shape=g.shape,
                                  stride=torch.empty(g.shape, device="meta").stride())


def split_sharded(x: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """The DTensor ``x`` with tensor dim ``dim`` replicated unless the mesh
    dims that shard it split ``parts`` evenly: a reshape of that dim into
    (``parts``, -1) needs it (GQA's query heads into kv groups). A no-op on
    a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    dim = dim % x.ndim
    split = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            split *= mesh.size(i)
    if parts % split == 0:
        return x
    return x.redistribute(mesh, [Replicate() if isinstance(p, Shard) and p.dim == dim else p
                                 for p in x.placements])


def as_contiguous(x: torch.Tensor) -> torch.Tensor:
    """The DTensor ``x`` with its local shard contiguous and its global
    strides contiguous too: an elementwise op whose inputs DTensor had to
    redistribute can leave a contiguous shard under the permuted strides
    of its inputs, and a later reshape then views what it must copy. A
    no-op on a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    return DTensor.from_local(x.to_local().contiguous(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=torch.empty(x.shape, device="meta").stride())
