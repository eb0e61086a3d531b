"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of ColonyOS.

``python colonybench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell needs is found by name: its configuration
under ``configs/``, its traffic mix under ``traffic/`` (read by the
traffic kind's module beside it), its limits under ``cells/`` and each
per-layer metric's reader under ``metrics/``. ``reference/`` holds the
plain float32 models that decide ``correct`` and the operation and byte
counts of the rooflines. Nothing here imports ``jax`` or ``repro``.
"""
