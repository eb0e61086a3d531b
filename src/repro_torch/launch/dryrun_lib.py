"""Dry-run core: trace every (arch x shape x mesh) cell, per device.

Port of the reference's ``launch/dryrun_lib.py``. Where the reference
lowers and compiles a jitted step with shardings and reads XLA's HLO, a
cell here runs the port's own step function (``make_train_step``,
``make_prefill`` or ``make_serve_step``) once, eagerly, on ``DTensor``s
whose local shards are fake tensors (``FakeTensorMode``): the parameters,
optimizer state, batch and cache are built from ``sharding_plan``'s
placements with ``DTensor.from_local``, and nothing is allocated.
``launch.costs`` counts the local ops DTensor issues, so every number is
per device. The trace runs inside ``activation_mesh`` (the models'
``shard_activation`` constraints) and, for the card, on its path: the
kernels' custom ops (``kernels.ops.card_path``), whatever the fake
tensors' device. On a torch built with CUDA the mesh can be a ``"cuda"``
mesh, whose fake tensors are CUDA tensors; a torch without CUDA cannot
index fake CUDA tensors, so there the mesh is a ``"cpu"`` one.

A train cell with k microbatches traces one microbatch's forward and
backward, counted k times, and the optimizer update once (``hlo_analysis``
scales a while loop's body by its trip count the same way). Eager tracing
runs every layer, so ``loop_trip_counts`` is ``{}``. The record keeps the
keys ``launch.report`` and the benchmarks read; ``compile_s`` holds the
trace's seconds (nothing compiles), so the copied report works unchanged.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import traceback
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._pytree import tree_leaves

from ..configs import SHAPES, TrainConfig, get_config
from ..configs.base import ModelConfig, ShapeConfig
from ..configs.shapes import batch_specs, cell_skip_reason, decode_specs
from ..kernels import ops
from ..models.model import dtype_of
from ..models.sharding import abstract_params, activation_mesh, param_placements, rules_for
from ..models.spec import model_spec
from ..serve.engine import make_prefill, make_serve_step
from ..train.train_step import init_state, make_train_step
from ..tree import map_leaves
from .costs import CellCosts, CountedFakeMode
from .mesh import mesh_devices
from .roofline import Roofline, model_flops
from .sharding_plan import (
    batch_placements, decode_in_placements, microbatch_specs, state_placements,
)


def mesh_dict(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _dtensor(meta: torch.Tensor, placements, mesh) -> torch.Tensor:
    """A DTensor of ``meta``'s global shape and dtype over a fake local
    shard (this rank's: the first of each split, the largest). On a mesh
    of one device the shard is the tensor: a plain fake tensor, and the
    cell traces the program one card runs (no DTensor, whose rules differ
    between torch versions even where every mesh dim has size 1)."""
    if mesh_devices(mesh) == 1:
        return torch.empty(meta.shape, dtype=meta.dtype, device=mesh.device_type)
    local = list(meta.shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] = -(-local[p.dim] // mesh.size(i))
    shard = torch.empty(local, dtype=meta.dtype, device=mesh.device_type)
    return DTensor.from_local(shard, mesh, placements, run_check=False, shape=meta.shape,
                              stride=meta.stride())


def _distribute(metas: Any, placements: Any, mesh) -> Any:
    return map_leaves(lambda m, p: _dtensor(m, p, mesh), metas, placements)


def _inputs(cfg: ModelConfig, shape: ShapeConfig, mesh, tcfg: TrainConfig) -> tuple:
    """The step's inputs as DTensors on fake shards (call under the fake mode)."""
    spec = model_spec(cfg)
    params = abstract_params(spec, dtype_of(cfg.param_dtype))
    if shape.kind == "train":
        state = init_state(params, tcfg)  # meta tensors
        batch, bdim = batch_specs(cfg, shape), 0
        if tcfg.microbatches > 1:
            batch, bdim = microbatch_specs(batch, tcfg.microbatches), 1
        return (_distribute(state, state_placements(cfg, spec, mesh, tcfg), mesh),
                _distribute(batch, batch_placements(cfg, batch, mesh, batch_dim=bdim), mesh))
    pparams = _distribute(params, param_placements(spec, rules_for(cfg), mesh), mesh)
    if shape.kind == "prefill":
        batch = batch_specs(cfg, shape)
        return pparams, _distribute(batch, batch_placements(cfg, batch, mesh), mesh)
    specs = decode_specs(cfg, shape)
    pl = decode_in_placements(cfg, specs, mesh)
    return (pparams, _distribute(specs["tokens"], pl["tokens"], mesh),
            _distribute(specs["cache"], pl["cache"], mesh), _distribute(specs["pos"], pl["pos"], mesh))


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, tcfg: TrainConfig | None = None,
               *, card: bool = True) -> dict:
    """Run this cell's step once on fake shards; returns its per-device
    costs (``analyze``'s input). ``card``: trace the card's path, the
    kernels' ops, on a mesh of any device type; False traces the CPU path
    on a ``"cpu"`` mesh (the plain twins and the models' ``use_pallas``)."""
    tcfg = tcfg or TrainConfig()
    fake = CountedFakeMode(allow_non_fake_inputs=True)
    with fake:
        inputs = _inputs(cfg, shape, mesh, tcfg)
    path = ops.card_path() if card else contextlib.nullcontext()
    with activation_mesh(mesh), path, implicit_replication():
        costs = CellCosts(fake)
        args = costs.track(inputs)
        t0 = time.perf_counter()
        with costs:
            if shape.kind == "train":
                def first_counted_k_times(k: int):
                    with costs.scaled(k):
                        yield 0

                step = make_train_step(cfg, tcfg, microbatch_indices=first_counted_k_times)
                out = step(*inputs)
            else:
                with torch.no_grad():
                    step = make_prefill(cfg) if shape.kind == "prefill" else make_serve_step(cfg)
                    out = step(*inputs)
        seconds = time.perf_counter() - t0
        outs = costs.storage_bytes(out)
        in_keys = {id(t) for t in tree_leaves(inputs)}
        alias = costs.storage_bytes([t for t in tree_leaves(out)
                                     if id(t) in in_keys])
    return {"costs": costs, "seconds": seconds, "memory": {
        "argument_size_in_bytes": args,
        "output_size_in_bytes": outs,
        "temp_size_in_bytes": costs.peak - args,
        "alias_size_in_bytes": alias,
    }}


def analyze(traced: dict, cfg: ModelConfig, shape: ShapeConfig, chips: int) -> dict:
    costs: CellCosts = traced["costs"]
    coll = costs.collectives()
    roof = Roofline(
        flops_per_device=costs.flops,
        bytes_per_device=costs.bytes_fused,
        collective_bytes_per_device=coll["total_bytes"],
        chips=chips,
        model_flops_total=model_flops(cfg, shape),
        bytes_per_device_pessimistic=costs.bytes_all,
    )
    return {
        "memory_analysis": traced["memory"],
        "collectives": coll,
        "loop_trip_counts": {},  # eager tracing unrolls every loop
        "dot_count": costs.dots,
        "op_count": costs.ops,
        "flops_by_op": dict(costs.flops_by_op),
        "roofline": roof.to_dict(),
    }


_BIG_ARCHS = {"jamba-1.5-large-398b", "deepseek-v3-671b"}  # adafactor state


def default_tcfg(arch: str, shape: ShapeConfig) -> TrainConfig:
    """Per-cell training policy of the baseline dry-run sweep, the
    reference's: 8 microbatches for train_4k, Adafactor for the >=100B
    configs (factored optimizer state)."""
    return TrainConfig(
        microbatches=8 if shape.kind == "train" else 1,
        optimizer="adafactor" if arch in _BIG_ARCHS else "adamw",
    )


def run_cell(
    arch: str,
    shape_name: str | ShapeConfig,
    mesh,
    *,
    variant: str = "full",
    tcfg: TrainConfig | None = None,
    cfg_overrides: dict | None = None,
    card: bool = True,
) -> dict:
    """Trace one cell; returns the result record (never raises). A shape
    may be a ``ShapeConfig`` of the caller's, outside ``SHAPES``."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if tcfg is None:
        tcfg = default_tcfg(arch, shape)
    chips = mesh_devices(mesh)
    record: dict[str, Any] = {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_dict(mesh),
        "chips": chips,
        "variant": variant,
        "path": "card" if card or mesh.device_type == "cuda" else "cpu",
    }
    try:
        cfg = get_config(arch, variant)
        if cfg_overrides:
            cfg = cfg.copy(**cfg_overrides)
        reason = cell_skip_reason(cfg, shape)
        if reason:
            record["status"] = "skipped"
            record["reason"] = reason
            return record
        traced = trace_cell(cfg, shape, mesh, tcfg, card=card)
        record.update(analyze(traced, cfg, shape, chips))
        record["status"] = "ok"
        record["compile_s"] = round(traced["seconds"], 2)  # the trace's seconds
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc(limit=20)
    return record


def sweep(
    archs: list[str],
    shapes: list[str],
    mesh,
    outdir: str,
    mesh_tag: str,
    *,
    force: bool = False,
    cfg_overrides: dict | None = None,
) -> list[dict]:
    os.makedirs(outdir, exist_ok=True)
    results = []
    for arch in archs:
        for shape_name in shapes:
            path = os.path.join(outdir, f"{mesh_tag}__{arch}__{shape_name}.json")
            if os.path.exists(path) and not force:
                with open(path) as f:
                    results.append(json.load(f))
                continue
            rec = run_cell(arch, shape_name, mesh, cfg_overrides=cfg_overrides)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            status = rec["status"]
            extra = ""
            if status == "ok":
                r = rec["roofline"]
                extra = (
                    f" bottleneck={r['bottleneck']}"
                    f" frac={r['roofline_fraction']:.3f}"
                    f" trace={rec['compile_s']}s"
                )
            elif status == "error":
                extra = " " + rec["error"][:120]
            print(f"[dryrun] {mesh_tag} {arch} {shape_name}: {status}{extra}", flush=True)
            results.append(rec)
    return results
