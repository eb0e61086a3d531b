"""The port stands alone: neither ``repro_torch`` nor ``chip_smoke.py``
imports JAX or any module of the reference package ``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


# the training slice's modules, each held to the same rule
TRAINING_MODULES = {
    "repro_torch.data.pipeline", "repro_torch.train.optimizer", "repro_torch.train.train_step",
    "repro_torch.train.checkpoint", "repro_torch.runtime.train_loop", "repro_torch.launch.train",
    "repro_torch.runtime.store",
}
# the executors' slice: the copied client and broker sides of ColonyOS and
# the executors
EXECUTOR_MODULES = {
    "repro_torch.core", "repro_torch.runtime.torch_executor", "repro_torch.broker",
    *(f"repro_torch.core.{m}" for m in (
        "errors", "retry", "crypto", "security", "idempotency", "spec", "process", "client",
        "http_transport", "fs", "executor")),
    *(f"repro_torch.broker.{m}" for m in (
        "database", "server", "generator", "cfs", "http_server")),
}

# the launchers and the dry-run plane's cells and plan
LAUNCH_MODULES = {
    "repro_torch.launch.serve", "repro_torch.launch.mesh", "repro_torch.launch.sharding_plan",
    "repro_torch.configs.shapes", "repro_torch.models.sharding",
}


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_importing_every_module_loads_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(' '.join(sorted(n for n in sys.modules if n.startswith('repro_torch'))))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    imported = set(res.stdout.split())
    assert len(imported) >= 69  # every module really was imported
    assert TRAINING_MODULES <= imported, TRAINING_MODULES - imported
    assert EXECUTOR_MODULES <= imported, EXECUTOR_MODULES - imported
    assert LAUNCH_MODULES <= imported, LAUNCH_MODULES - imported


def test_no_source_file_imports_jax_or_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    offences = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offences += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert not offences, offences


def test_chip_smoke_names_reference_and_jax_modules():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    loaded = dict.fromkeys(["repro_torch", "repro_torch.core.client", "reprolib", "jaxtyping_x",
                            "numpy", "repro", "repro.core.server", "jax", "jax.numpy", "jaxlib"])
    assert chip_smoke.reference_modules(loaded) == [
        "jax", "jax.numpy", "jaxlib", "jaxtyping_x", "repro", "repro.core.server"]
    assert chip_smoke.reference_modules({"repro_torch": None, "torch": None}) == []
    # after the port's executors are imported, as chip_smoke.py imports them
    code = ("import sys, chip_smoke\n"
            "import repro_torch.runtime.torch_executor, repro_torch.serve.batcher\n"
            "print(chip_smoke.reference_modules(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=""), timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
