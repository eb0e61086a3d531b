"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` file under ``csrc/`` with a plain C interface.
``build`` compiles it with ``nvcc`` for ``sm_90a`` into a shared library
under ``build/kernels/`` (named by a hash of the source, the local headers
it includes and the flags, so a changed source or header builds anew) and
loads it with ``ctypes``. Nothing is compiled when a module is imported:
the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class KernelBuild:
    lib: ctypes.CDLL
    path: Path
    command: tuple[str, ...] | None  # None when an earlier build was reused
    log: str  # nvcc's output, with ptxas' registers, shared memory, spills


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def local_includes(source: Path) -> list[Path]:
    """The files ``source`` includes with ``#include "..."``, transitively,
    resolved beside the including file, in first-seen order."""
    seen: list[Path] = []
    todo = [source]
    while todo:
        including = todo.pop(0)
        for name in _LOCAL_INCLUDE.findall(including.read_bytes()):
            path = (including.parent / name.decode()).resolve()
            if path not in seen:
                seen.append(path)
                todo.append(path)
    return seen


def library_path(name: str, source: Path, flags: tuple[str, ...] = NVCC_FLAGS) -> Path:
    """Where the library of ``source`` built with ``flags`` lives."""
    data = source.read_bytes() + b"".join(p.read_bytes() for p in local_includes(source))
    tag = hashlib.sha256(data + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{tag}.so"


def build(name: str, source: Path, flags: tuple[str, ...] = NVCC_FLAGS) -> KernelBuild:
    """Compile ``source`` (once per source and flags) and load it.

    The library is written under a temporary name and renamed into place,
    so a build running beside this one sees all of it or nothing. nvcc's
    output is kept beside the library, and a reused build reports it too.
    """
    path = library_path(name, source, flags)
    log_path = path.with_suffix(".log")
    command = None
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        command = (nvcc, *flags, "-o", str(tmp), str(source))
        res = subprocess.run(command, capture_output=True, text=True)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} with exit code "
                               f"{res.returncode}:\n{log}")
        log_path.write_text(log)
        os.replace(tmp, path)  # atomic: a concurrent build sees all or nothing
    log = log_path.read_text() if log_path.exists() else ""
    return KernelBuild(ctypes.CDLL(str(path)), path, command, log)
