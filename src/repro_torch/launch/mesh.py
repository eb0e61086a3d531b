"""Production mesh definitions, with the reference's shapes and axis names.

Port of the reference's ``launch/mesh.py``. A production mesh is (16, 16)
over ``("data", "model")``: 256 H100s, or (2, 16, 16) over ``("pod",
"data", "model")`` with ``multi_pod``: 512 H100s. Both are ``DeviceMesh``es
over whatever process group is initialized, so nothing here touches a
card or a process group when it is imported. ``fake_world`` initializes
torch's ``"fake"`` backend at a world size of its own, which builds such a
mesh in one process without cards, for planning.

A plan reads only a mesh's dim names and sizes; ``MeshShape`` carries
just those, so a plan needs no process group at all.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


@dataclass(frozen=True)
class MeshShape:
    """What a plan reads of a ``DeviceMesh``: its dim sizes and names."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """16x16 cards per pod; 2 pods when multi_pod."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def _device_type() -> str:
    """CPU tensors under the fake backend (or gloo), the card's otherwise."""
    return "cpu" if dist.get_backend() in ("fake", "gloo") else "cuda"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    ms = production_mesh_shape(multi_pod=multi_pod)
    return init_device_mesh(_device_type(), ms.shape, mesh_dim_names=ms.mesh_dim_names)


def make_smoke_mesh() -> DeviceMesh:
    """1-device mesh with the production axis names (a world of one)."""
    return init_device_mesh(_device_type(), (1, 1), mesh_dim_names=("data", "model"))


def mesh_devices(mesh) -> int:
    n = 1
    for v in tuple(mesh.shape):
        n *= v
    return n


@contextlib.contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """A ``"fake"`` process group of ``world_size`` ranks (this process is
    rank 0) for planning without cards; destroyed on exit. Collectives on
    it do nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
