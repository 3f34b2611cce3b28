"""The port stands alone: no JAX, flax, optax or fscl_tpu behind it, and
its entry points ask for CUDA unless told otherwise."""
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "fscl_tpu")
IMPORT_RE = re.compile(
    r"^\s*(?:import\s+(?:jax|flax|optax)\b|from\s+(?:jax|flax|optax)\b"
    r"|import\s+fscl_tpu(?!_torch)\b|from\s+fscl_tpu(?!_torch)\b)", re.M)


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "fscl_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith((".py", ".cu"))]
    return sorted(paths)


def test_importing_every_submodule_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import fscl_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(fscl_tpu_torch.__path__, 'fscl_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 15 else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax(path):
    with open(path, encoding="utf-8") as f:
        src = f.read()
    assert not IMPORT_RE.search(src), f"{path} imports JAX or fscl_tpu"


def test_baseline_system_asks_for_cuda_by_default():
    import torch
    from fscl_tpu_torch.systems.baseline import BaselineSystem
    if torch.cuda.is_available():
        assert BaselineSystem().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            BaselineSystem()


def test_serve_asks_for_cuda_by_default():
    import torch
    from fscl_tpu_torch.serve import serve
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve(["hello"], {})
