"""Roofline terms of one NVIDIA H100 for a traced dry-run cell.

Port of the reference's ``launch/roofline.py`` with this card's terms:

  compute term    = per-device FLOPs / PEAK_FLOPS
  memory term     = per-device bytes / HBM_BW
  collective term = per-device wire bytes / NET_BW

* ``PEAK_FLOPS`` 989e12: the H100 SXM's dense bf16 tensor-core rate, and
  ``HBM_BW`` 3.35e12 B/s: its HBM3 (NVIDIA's H100 data sheet; the bounds
  of the kernel table in ``PERF.md`` §6 use the same two). The kernels'
  float32 work outside the tensor cores (B2, B3) is counted at the same
  peak, so their compute term is a lower bound.
* ``NET_BW`` 50e9 B/s per card: one 400 Gb/s NDR InfiniBand link per GPU,
  as a DGX H100 has (eight ConnectX-7 adapters for eight GPUs; NVIDIA's
  DGX H100 user guide). The 16-wide ``model`` axis spans two 8-GPU
  nodes, so its collectives cross the network, not NVLink.

The cell's counts are per device (``launch.costs``), so a term divided by
the per-card peak is the brief's global / (chips x peak).

MODEL_FLOPS uses 6·N_active·D for training (fwd+bwd) and 2·N_active·D for
inference; N_active discounts routed experts to top_k/E (+ shared).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..configs.base import ModelConfig, ShapeConfig
from ..models.spec import model_spec
from ..tree import leaves

PEAK_FLOPS = 989e12  # bf16, dense
HBM_BW = 3.35e12  # bytes/s
NET_BW = 50e9  # bytes/s per card


def active_params(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active) parameter counts; routed experts discounted."""
    total = 0
    active = 0
    e = max(cfg.moe.num_experts, 1)
    frac = cfg.moe.top_k / e if cfg.moe.num_experts else 1.0
    for leaf in leaves(model_spec(cfg)):
        n = 1
        for d in leaf.shape:
            n *= d
        total += n
        active += int(n * frac) if "experts" in leaf.axes else n
    return total, active


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    _, n_active = active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1  # decode: one token per sequence
    return 2.0 * n_active * tokens


@dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float  # fused traffic model (products/kernels/copies/collectives)
    collective_bytes_per_device: float
    chips: int
    model_flops_total: float
    bytes_per_device_pessimistic: float = 0.0  # every op's inputs and outputs

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def memory_s_pessimistic(self) -> float:
        return self.bytes_per_device_pessimistic / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / NET_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (counted FLOPs x chips) — remat/redundancy waste."""
        total = self.flops_per_device * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs throughput vs peak, if the dominant term binds:
        (MODEL_FLOPS / chips / peak) / max(term) — an MFU-style score."""
        ideal_s = self.model_flops_total / self.chips / PEAK_FLOPS
        worst = max(self.compute_s, self.memory_s, self.collective_s)
        return ideal_s / worst if worst else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "bytes_per_device_pessimistic": self.bytes_per_device_pessimistic,
            "memory_s_pessimistic": self.memory_s_pessimistic,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "chips": self.chips,
            "model_flops_total": self.model_flops_total,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }
