"""PyTorch/CUDA port of the compute plane (models, kernels, serving).

Imports only torch, numpy and the standard library; never JAX and never
the reference package ``repro``.
"""

from .device import warm_cpu_exp

warm_cpu_exp()
