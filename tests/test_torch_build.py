"""The shared kernel build (``repro_torch.kernels.build``): library
naming, the atomic rename, the kept log and reuse, with a stand-in for
``nvcc`` on the CPU; every kernel bound through it; and, on a card
(``-m cuda``), the kernels built from the sources and launched once."""

import hashlib
import os
import stat
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import _ctypes
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6 as wkv

# nvcc's flags as flash attention's own build code had them before that
# code was shared; its library name must not change.
FLASH_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """An ``nvcc`` on the PATH that copies a real shared library to its
    ``-o`` target and prints a ptxas line; builds go under ``tmp_path``."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import shutil, sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        f"shutil.copy({_ctypes.__file__!r}, out)\n"
        "print('ptxas info    : Used 40 registers, 0 bytes spill stores')\n"
    )
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "kernels")
    return nvcc


def test_build_names_renames_logs_and_reuses(fake_nvcc, tmp_path):
    header = fa.SOURCE.parent / "ptx.cuh"  # the one local header it includes
    assert kbuild.local_includes(fa.SOURCE) == [header]
    data = fa.SOURCE.read_bytes() + header.read_bytes()
    tag = hashlib.sha256(data + " ".join(FLASH_FLAGS).encode()).hexdigest()[:16]
    assert kbuild.NVCC_FLAGS == FLASH_FLAGS
    first = kbuild.build("flash_attention", fa.SOURCE)
    assert first.path == tmp_path / "kernels" / f"flash_attention-{tag}.so"
    assert first.command[0] == str(fake_nvcc) and first.command[-1] == str(fa.SOURCE)
    assert "arch=compute_90a,code=sm_90a" in first.command
    assert "Used 40 registers" in first.log
    assert sorted(p.name for p in first.path.parent.iterdir()) == [
        f"flash_attention-{tag}.log", f"flash_attention-{tag}.so"]  # no temporary left
    again = kbuild.build("flash_attention", fa.SOURCE)
    assert again.command is None and again.path == first.path and again.log == first.log
    other = kbuild.build("rwkv6", wkv.SOURCE)
    assert other.path.name.startswith("rwkv6-") and other.path != first.path


def test_editing_an_included_header_changes_the_library_path(tmp_path):
    """The library name hashes every local ``#include "..."``, transitively,
    so an edited header builds anew; system headers are not hashed."""
    (tmp_path / "inc").mkdir()
    source = tmp_path / "kernel.cu"
    source.write_text('#include <cuda_runtime.h>\n#include "inc/a.cuh"\nint f();\n')
    (tmp_path / "inc" / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "inc" / "b.cuh").write_text("// b\n")
    assert kbuild.local_includes(source) == [tmp_path / "inc" / "a.cuh", tmp_path / "inc" / "b.cuh"]
    first = kbuild.library_path("k", source)
    assert kbuild.library_path("k", source) == first
    (tmp_path / "inc" / "b.cuh").write_text("// b, edited\n")
    second = kbuild.library_path("k", source)
    assert second != first and second.name.startswith("k-")
    (tmp_path / "inc" / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n// a\n')
    assert kbuild.library_path("k", source) not in (first, second)


def test_build_reports_a_failed_compile(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\nprint('error: bad kernel')\nsys.exit(2)\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="exit code 2(.|\n)*bad kernel"):
        kbuild.build("rwkv6", wkv.SOURCE)
    assert not any((tmp_path / "kernels").glob("*.so"))


@pytest.mark.parametrize("module,name,symbol,nargs", [
    (fa, "flash_attention", "flash_attention_fwd", 13),
    (wkv, "rwkv6", "rwkv6_wkv_fwd", 13),
    (ms, "mamba_scan", "mamba_scan_fwd", 14),
])
def test_kernels_bind_through_the_shared_build(module, name, symbol, nargs, monkeypatch):
    calls = []

    class FakeLib:  # every C function the module declares, made on first use
        def __getattr__(self, attr):
            setattr(self, attr, types.SimpleNamespace())
            return getattr(self, attr)

    def fake_build(kernel_name, source):
        calls.append((kernel_name, source))
        return kbuild.KernelBuild(FakeLib(), Path("unused.so"), None, "")

    monkeypatch.setattr(module, "build_kernel", fake_build)
    monkeypatch.setattr(module, "_build", None)
    kb = module.build()
    assert module.build() is kb and calls == [(name, module.SOURCE)]  # built once
    fn = getattr(kb.lib, symbol)
    assert len(fn.argtypes) == nargs and fn.restype is not None


@pytest.mark.cuda
def test_both_kernels_build_and_launch_on_the_card():
    """B1's launch count and results with the shared build; B2 beside it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 128, 4, 32)).astype(np.float32)) for _ in range(3))
    before = fa.launches
    got = ops.flash_attention(q.cuda(), k.cuda(), v.cuda())
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), ops.flash_attention(q, k, v).numpy(),
                               atol=2e-5, rtol=1e-4)
    assert fa.build().path.parent == wkv.build().path.parent == kbuild.BUILD_DIR
    assert ms.build().path.parent == kbuild.BUILD_DIR
