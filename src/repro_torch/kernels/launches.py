"""Kernel launch counts that stay true across CUDA graph replays.

Each kernel module counts its launches in ``launches``, on the host, where
its wrapper launches the kernel. A capture runs the wrappers but launches
nothing, and a replay launches the captured kernels without running a
wrapper. ``GraphLaunches`` keeps the counts what the card did: a capture
records each module's launches the captured work makes and takes them off
again, and each replay adds them.

Launches that other threads make while a capture is under way are taken
off with the capture's. The wrappers that a backward runs on the autograd
engine's own thread (a remat recomputation) are the capture's and are
counted.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

from . import decode_attention, flash_attention, mamba_scan, rwkv6

# each kernel's module, by the name chip_smoke.py's kernels line gives it
MODULES = {"flash_attention": flash_attention, "rwkv6_wkv": rwkv6, "mamba_scan": mamba_scan,
           "decode_attention": decode_attention}


def counts() -> dict[str, int]:
    """Each kernel module's ``launches``."""
    return {name: mod.launches for name, mod in MODULES.items()}


class GraphLaunches:
    """The launches of each kernel one replay of a captured graph makes."""

    def __init__(self) -> None:
        self.per_replay = {name: 0 for name in MODULES}

    @contextlib.contextmanager
    def capturing(self) -> Iterator[None]:
        """Around a capture: records the launches its wrappers count, then
        puts every module's count back to what it was before."""
        before = counts()
        try:
            yield
        finally:
            after = counts()
            self.per_replay = {name: after[name] - before[name] for name in MODULES}
            for name, mod in MODULES.items():
                mod.launches = before[name]

    def replayed(self, times: int = 1) -> None:
        """Adds ``times`` replays' launches to each module's count."""
        for name, mod in MODULES.items():
            mod.launches += self.per_replay[name] * times
