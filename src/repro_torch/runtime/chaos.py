"""Chaos engineering utilities (paper §3.4: "a Chaos monkey can be used
to deliberately terminate executors... the constant flux of executor
replacements ensures the system gracefully tolerates failures").

A copy of the reference's ``repro/runtime/chaos.py``. Stdlib only: the
broker side and the torch executors import ``SimulatedCrash`` from here.
"""

from __future__ import annotations

import random
import threading
from typing import Callable


class SimulatedCrash(Exception):
    """Raised inside a handler to emulate sudden executor death:
    the process is NOT closed/failed — the broker's maxexectime failsafe
    must detect the lost lease and re-queue the process."""

    simulate_crash = True  # ExecutorBase re-raises instead of closing


class ChaosMonkey:
    """Randomly kills (stops) executors from a pool and spawns replacements."""

    def __init__(
        self,
        kill: Callable[[], None],
        spawn: Callable[[], None],
        interval: tuple[float, float] = (0.5, 2.0),
        seed: int = 0,
    ) -> None:
        self.kill = kill
        self.spawn = spawn
        self.interval = interval
        self.rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.kills = 0

    def start(self) -> None:
        def loop() -> None:
            while not self._stop.wait(self.rng.uniform(*self.interval)):
                try:
                    self.kill()
                    self.kills += 1
                    self.spawn()
                except Exception:  # noqa: BLE001 — chaos must not crash itself
                    pass

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
