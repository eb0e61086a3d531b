"""Device resolution for the port's entry points."""

from __future__ import annotations

import threading

import torch

# torch allows one CUDA graph capture at a time in a process, and every
# capture of the port (the engine's decode steps, the train and eval steps)
# runs on torch's one default capture stream: cuBLAS keeps a workspace for
# each stream it has run on for the life of the process (64 MiB on an
# H100), so a stream of each step's own would leave one behind per step.
# Whoever runs work on that stream or captures holds this lock; so does a
# step that empties the allocator's cache as it closes, so that no cache is
# emptied beside another thread's capture.
CAPTURE_LOCK = threading.Lock()


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it names a card
    that is not there. The port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for but no CUDA device is available; "
                "pass device='cpu' to run on the CPU"
            )
        # Float32 products and convolutions run in full float32, never TF32:
        # the reference computes in float32, and TF32 keeps ~3 digits.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def warm_cpu_exp() -> None:
    """Run float32 ``exp`` once on every intra-op CPU thread.

    torch computes float32 ``exp`` on the CPU with MKL's ``vmsExp``, in
    chunks of 2,048 values spread over its OpenMP threads, and a thread's
    first call can come back at about 1.5e-4 relative error instead of full
    float32 accuracy (ROADMAP C11). The port's CPU paths (the plain twins,
    the CPU side of every cross-device check) run after one such call on
    each thread; the package calls this once, when it is imported."""
    torch.exp(torch.zeros(2048 * max(32, torch.get_num_threads())))
