"""Per-device costs of a traced cell: FLOPs, bytes, collectives, memory.

The counterpart of the role the reference's ``hlo_analysis.analyze_hlo``
plays for the dry-run (not of its HLO parser, which has no torch
counterpart). A cell runs eagerly on ``DTensor``s whose local shards are
fake tensors (``FakeTensorMode``); DTensor turns each op on the global
tensors into ops on the local shards, plus the ``_c10d_functional``
collectives its redistributions need. ``CellCosts`` is a dispatch mode
that sees those **local** ops only, so everything it counts is per device:

* it steps aside for an op on DTensors (returning ``NotImplemented`` lets
  DTensor's dispatch run, which issues the local ops this mode then
  sees). A mode outside DTensor would count the global op, eight times a
  device's work on a (2, 4) mesh;
* it skips the ops DTensor runs at global shapes to propagate an op's
  output shape, in a fake mode of its own or in the trace's entered again
  (``CountedFakeMode`` knows its depth): no device runs them.

The trace runs with the fake mode not entered: the shards are fake
tensors made under it, and their ops enter it each on its own. DTensor's
own bookkeeping (the local sizes of a strided shard, which a reshape
merging two sharded dims makes) then computes on real tensors, as it
must; a factory call in the model (``torch.arange``, ``torch.zeros``)
makes a real tensor, which DTensor replicates (``implicit_replication``),
as each device of the program would hold it.

What it counts, in the reference's models:

* ``flops``: ``torch.utils.flop_counter``'s count of each op (the
  products, and the kernels' ops through the counts registered in
  ``kernels/ops.py``);
* ``bytes_fused``: the traffic of the fused model ``hlo_analysis``
  approximates, where elementwise chains fuse away: the operands and
  results of products and kernels, copies, cache updates (the written
  slice, not the whole buffer) and gathers (the rows read), and
  collectives;
* ``bytes_all``: every op's inputs and outputs (the pessimistic model);
* ``collectives``: count and wire bytes by kind, the result's bytes with
  all-reduce counted twice (``hlo_analysis``'s convention);
* memory: the bytes of live local storage, from the argument shards the
  caller registers through every op's outputs, freed as their storages
  die; ``peak`` is its largest value.

``scale`` multiplies what is counted while it is set (``scaled``): a train
step traces one microbatch and counts it k times, as ``hlo_analysis``
scales a while loop's body by its trip count.
"""

from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import Any, Iterator

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter", "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_WIRE_FACTOR = {"all-reduce": 2.0}

# the fused model's products and kernels: operands and results hit memory
_PRODUCTS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution,
             aten._scaled_dot_product_flash_attention, aten._scaled_dot_product_efficient_attention}
_KERNEL_NAMESPACE = "repro_torch"
_COPIES = {aten.copy_, aten._to_copy, aten.clone, aten.cat, aten.stack}
_UPDATES = {aten.index_copy_, aten.index_copy, aten.index_put_, aten.index_put,
            aten.slice_scatter, aten.select_scatter, aten.scatter_, aten.scatter}
_GATHERS = {aten.embedding, aten.index_select, aten.gather, aten.index}
# allocations without traffic
_NO_TRAFFIC = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
               aten.new_empty_strided}


class CountedFakeMode(FakeTensorMode):
    """A ``FakeTensorMode`` that knows how deep it is entered from outside
    an op: DTensor enters the active fake mode to compute an op's global
    output shape, and ``CellCosts`` skips what runs there."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.depth = 0

    def __enter__(self):
        self.depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self.depth -= 1
        return super().__exit__(*exc)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree: Any) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class CellCosts(TorchDispatchMode):
    """Per-device FLOPs, bytes, collectives and live memory of the local
    ops of a trace under ``fake_mode`` (see the module docstring)."""

    def __init__(self, fake_mode: CountedFakeMode):
        super().__init__()
        self.fake_mode = fake_mode
        self.scale = 1.0
        self.flops = 0.0
        self.bytes_fused = 0.0
        self.bytes_all = 0.0
        self.coll_bytes: dict[str, float] = defaultdict(float)
        self.coll_counts: dict[str, int] = defaultdict(int)
        self.ops = 0
        self.dots = 0  # products and kernels
        self.flops_by_op: dict[str, float] = defaultdict(float)
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}  # storage key -> bytes

    @contextlib.contextmanager
    def scaled(self, k: float) -> Iterator[None]:
        prev, self.scale = self.scale, self.scale * k
        try:
            yield
        finally:
            self.scale = prev

    # -- memory ------------------------------------------------------------

    def track(self, tree: Any) -> int:
        """Count the storages of ``tree``'s tensors (their local shards for
        DTensors) as live until they die; returns the bytes newly tracked."""
        added = 0
        for t in _tensors(tree):
            if isinstance(t, DTensor):
                t = t._local_tensor
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            weakref.finalize(st, self._free, key)
            self.live += n
            added += n
        self.peak = max(self.peak, self.live)
        return added

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def storage_bytes(self, tree: Any) -> int:
        """The bytes of the distinct storages under ``tree``."""
        seen: dict[int, int] = {}
        for t in _tensors(tree):
            if isinstance(t, DTensor):
                t = t._local_tensor
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
        return sum(seen.values())

    # -- ops ---------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor's dispatch issues the local ops, which come back here
        out = func(*args, **kwargs)
        if not self._propagating(out):
            self._count(func, args, kwargs, out)
        return out

    def _propagating(self, out: Any) -> bool:
        """DTensor computing an op's global output shape: in this trace's
        fake mode entered again, or in a fake mode of its own."""
        return self.fake_mode.depth > 0 or any(
            isinstance(t, FakeTensor) and t.fake_mode is not self.fake_mode
            for t in _tensors(out))

    def _count(self, func, args, kwargs, out) -> None:
        self.ops += 1
        packet = func._overloadpacket
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if func.is_view or packet in _NO_TRAFFIC:
            self.track(out)
            return
        scale = self.scale
        in_bytes = sum(_nbytes(t) for t in ins)
        out_bytes = sum(_nbytes(t) for t in outs)
        total = in_bytes + out_bytes  # the result and the operands, as hlo_analysis counts
        if packet in _UPDATES:  # the written slice and its indices: the buffer is updated in place
            total -= 2 * max((_nbytes(t) for t in ins), default=0)
        elif packet in _GATHERS:  # the rows read, not the whole table
            total -= _nbytes(ins[0])
        total = max(total, 0)
        formula = flop_registry.get(packet)
        if formula is not None:
            f = formula(*args, **kwargs, out_val=out) * scale
            self.flops += f
            self.flops_by_op[str(packet)] += f
        kind = _COLLECTIVES.get(func._opname) if func.namespace.startswith("_c10d_functional") else None
        if kind is not None:
            self.coll_bytes[kind] += out_bytes * _WIRE_FACTOR.get(kind, 1.0) * scale
            self.coll_counts[kind] += 1
        if packet in _PRODUCTS or func.namespace == _KERNEL_NAMESPACE:
            self.dots += 1
        if (kind is not None or packet in _PRODUCTS or packet in _COPIES or packet in _UPDATES
                or packet in _GATHERS or func.namespace == _KERNEL_NAMESPACE):
            self.bytes_fused += total * scale
        self.bytes_all += total * scale
        self.track(out)

    def collectives(self) -> dict:
        """The record's ``collectives``: bytes and counts by kind, total bytes."""
        return {"bytes_by_kind": dict(self.coll_bytes), "counts": dict(self.coll_counts),
                "total_bytes": float(sum(self.coll_bytes.values()))}
