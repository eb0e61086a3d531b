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
    assert len(imported) >= 38  # every module really was imported
    assert TRAINING_MODULES <= imported, TRAINING_MODULES - imported


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
