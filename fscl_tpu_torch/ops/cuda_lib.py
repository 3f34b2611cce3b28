"""Build and load the port's CUDA kernels at first use.

Each `csrc/<name>.cu` file exposes a plain C entry point. It is compiled with
`nvcc` for `sm_90a` into a shared library and loaded with `ctypes`. The
library lands in `fscl_tpu_torch/_build/<name>-<hash>/`, keyed by a hash of
the source, every header of `csrc/` it includes (`#include "x.cuh"`, and
theirs) and the flags, so an edited source or header is rebuilt and an
unchanged one is built once per checkout. Importing this module builds
nothing.

A source whose kernel instances take long to compile says so with a line
`// build parts: N`: it is then compiled by N nvcc processes at once, the
i-th with `-DFSCL_PART=i` (the source compiles the instances of part i in
that unit, and part 0 also holds the entry points), and the N objects are
linked into the one library. Without the macro the source compiles whole.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_FLAGS = (*COMPILE_FLAGS, "-shared")
PARTS = re.compile(r"^// build parts: (\d+)$", re.MULTILINE)
LOCAL_INCLUDE = re.compile(r'^#include "([^"]+)"', re.MULTILINE)


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


def build_parts(source: str) -> int:
    """How many nvcc processes compile `source` (its `// build parts: N`)."""
    found = PARTS.search(source)
    return int(found.group(1)) if found else 1


def local_headers(src: Path) -> list:
    """The headers `src` includes by a quoted name from its own directory,
    and theirs, each once, in the order first met."""
    seen, todo = [], [src]
    while todo:
        for name in LOCAL_INCLUDE.findall(todo.pop(0).read_text()):
            header = src.parent / name
            if header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


def source_digest(src: Path) -> str:
    """The build key of `src`: a hash of it, of `local_headers(src)` and of
    the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in local_headers(src):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc(args) -> str:
    """Run nvcc; its output (ptxas's registers and spills), or raise."""
    proc = subprocess.run([find_nvcc(), *args], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(args)}):\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _compile(src: Path, out: str, out_dir: Path) -> str:
    """`src` into the shared library `out`: one nvcc, or one per part at
    once and a link. Returns nvcc's output."""
    parts = build_parts(src.read_text())
    if parts == 1:
        return _nvcc([*NVCC_FLAGS, "-o", out, str(src)])
    objs = []
    try:
        for _ in range(parts):
            fd, obj = tempfile.mkstemp(suffix=".o", dir=out_dir)
            os.close(fd)
            objs.append(obj)
        with ThreadPoolExecutor(max_workers=parts) as pool:
            logs = list(pool.map(
                lambda i: _nvcc([*COMPILE_FLAGS, f"-DFSCL_PART={i}", "-c", "-o", objs[i],
                                 str(src)]), range(parts)))
        return "".join(logs) + _nvcc([*GENCODE, "-shared", "-o", out, *objs])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.unlink(obj)


def build(name: str) -> Built:
    """Compile `csrc/<name>.cu` unless this source was already built, then
    load it. Raises if nvcc fails."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC_DIR / f"{name}.cu"
    out_dir = BUILD_DIR / f"{name}-{source_digest(src)}"
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
            log_path.write_text(_compile(src, tmp, out_dir))
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
    """Build every `csrc/*.cu` at once, one nvcc process per source (per
    part of a source built in parts)."""
    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))
