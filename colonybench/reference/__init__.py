"""The benchmark's yardstick: plain float32 models in PyTorch (``models``),
the comparison that decides ``correct`` (``check``) and the operations and
bytes behind each roofline and each model-FLOP share (``counts``).

Nothing here imports ``jax``, ``repro`` or ``repro_torch``: the reference
works everything out again from the configuration file and the
benchmark's own seeded weights.
"""
