"""Build and load the port's CUDA kernels at first use.

Each `csrc/<name>.cu` file exposes a plain C entry point. It is compiled with
`nvcc` for `sm_90a` into a shared library and loaded with `ctypes`. The
library lands in `fscl_tpu_torch/_build/<name>-<hash>/`, keyed by a hash of
the source and the flags, so an edited source is rebuilt and an unchanged one
is built once per checkout. Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, NamedTuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float      # time spent in nvcc by this call (0.0 if it was built)
    log: str            # nvcc's output, with ptxas's registers and spills


_LOADED: Dict[str, Built] = {}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            path = Path(os.environ[var]) / "bin" / "nvcc"
            if path.exists():
                return str(path)
    path = Path("/usr/local/cuda/bin/nvcc")
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (put it on PATH or set CUDA_HOME)")


def build(name: str) -> Built:
    """Compile `csrc/<name>.cu` unless this source was already built, then
    load it. Raises if nvcc fails."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_DIR / f"{name}-{digest}"
    lib_path = out_dir / f"lib{name}.so"
    log_path = out_dir / "nvcc.log"
    seconds = 0.0
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        # build under a temporary name, then rename: concurrent builds of
        # the same source never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            proc = subprocess.run(
                [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        seconds = time.perf_counter() - t0
    log = log_path.read_text() if log_path.exists() else ""
    built = Built(ctypes.CDLL(str(lib_path)), lib_path, seconds, log)
    _LOADED[name] = built
    return built


def build_all() -> Dict[str, Built]:
    """Build every `csrc/*.cu` at once, one nvcc process per source."""
    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))
