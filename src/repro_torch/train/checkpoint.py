"""Checkpointing through CFS (the paper's data plane).

Port of the reference's ``train/checkpoint.py``, with its layout:
``<prefix>/<run>/step-N/leaf-%05d.npy`` (one ``np.save`` file per leaf,
in the reference's flatten order), ``manifest.json`` naming each leaf by
its ``jax.tree_util.keystr`` path, one CFS snapshot per step, and the
``<prefix>/<run>/latest.json`` pointer. A checkpoint written by either
package restores in the other.

The manager takes any object with the four members it calls:
``upload_bytes``, ``download_bytes``, ``client.create_snapshot`` and
``prvkey`` (the reference's ``CFSClient``, or
``runtime.store.MemoryStore``). bfloat16 leaves are refused: the
reference reads them back as ``|V2`` and cannot restore them.
"""

from __future__ import annotations

import io
import json
import threading
from typing import Any

import numpy as np
import torch

from ..tree import leaves_with_names, rebuild


def _to_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _from_bytes(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


class CheckpointManager:
    def __init__(self, cfs: Any, colony: str, prefix: str = "/checkpoints", run: str = "run0"):
        self.cfs = cfs
        self.colony = colony
        self.prefix = f"{prefix}/{run}"
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # ------------------------------------------------------------------ save
    def save(self, state: Any, step: int, async_: bool = False) -> dict | None:
        """Snapshot the full state tree at ``step``. The leaves are copied to
        the host before this returns; ``async_`` uploads them in a
        background thread (one save in flight; ``wait`` joins it)."""
        named = leaves_with_names(state)
        bf16 = [name for name, t in named if t.dtype == torch.bfloat16]
        if bf16:
            raise ValueError(
                f"bfloat16 leaves cannot be checkpointed (the reference reads them back as |V2 "
                f"and cannot restore them; ROADMAP C1): {bf16[:3]}... of {len(bf16)}; "
                f"keep the train state in float32")
        names = [name for name, _ in named]
        host = [t.detach().to("cpu", copy=True).numpy() for _, t in named]

        def upload() -> dict:
            label = f"{self.prefix}/step-{step}"
            manifest = {"step": step, "leaves": []}
            for i, (name, arr) in enumerate(zip(names, host)):
                fname = f"leaf-{i:05d}.npy"
                self.cfs.upload_bytes(self.colony, label, fname, _to_bytes(arr))
                manifest["leaves"].append(
                    {"name": name, "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
                )
            self.cfs.upload_bytes(self.colony, label, "manifest.json", json.dumps(manifest).encode())
            snap = self.cfs.client.create_snapshot(
                self.colony, label, f"ckpt-step-{step}", self.cfs.prvkey
            )
            # latest pointer — a new immutable revision, atomically visible
            self.cfs.upload_bytes(
                self.colony, self.prefix, "latest.json",
                json.dumps({"step": step, "snapshotid": snap["snapshotid"]}).encode(),
            )
            return snap

        if async_:
            self.wait()  # only one in-flight save

            def run() -> None:
                try:
                    upload()
                except Exception as e:  # noqa: BLE001 — surfaced via wait()
                    self._error = e

            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
            return None
        return upload()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # --------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        try:
            data = self.cfs.download_bytes(self.colony, self.prefix, "latest.json")
        except Exception:  # noqa: BLE001 — no checkpoint yet
            return None
        return json.loads(data)["step"]

    def restore_latest(self, like: Any) -> tuple[Any, int] | None:
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, like), step

    def restore(self, step: int, like: Any) -> Any:
        """The checkpoint of ``step`` as a tree shaped like ``like``, each leaf
        on ``like``'s device in its dtype."""
        label = f"{self.prefix}/step-{step}"
        manifest = json.loads(self.cfs.download_bytes(self.colony, label, "manifest.json"))
        named = leaves_with_names(like)
        if len(manifest["leaves"]) != len(named):
            raise ValueError(f"state structure changed: {len(manifest['leaves'])} leaves saved, "
                             f"{len(named)} expected")
        out = []
        for entry, (name, ref) in zip(manifest["leaves"], named):
            if entry["name"] != name:
                raise ValueError(f"leaf {entry['file']} is {entry['name']}, expected {name}")
            arr = _from_bytes(self.cfs.download_bytes(self.colony, label, entry["file"]))
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"{name}: saved shape {arr.shape}, expected {tuple(ref.shape)}")
            out.append(torch.from_numpy(arr).to(device=ref.device, dtype=ref.dtype))
        return rebuild(like, out)
