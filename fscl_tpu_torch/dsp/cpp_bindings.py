"""ctypes bindings for the host C++ pitch trackers of `cpp/` (the port's own
copy of the pitch half of `fscl_tpu/dsp/cpp_bindings.py`).

`cpp/pitch.cc` (YIN) and `cpp/world_pitch.cc` (DIO-style) are compiled at
first use with `g++` and the flags of `cpp/Makefile` into
`fscl_tpu_torch/_build/<name>-<hash>/` (git-ignored), keyed by a hash of
the source, the compiler and the flags; nothing is written under `cpp/`.
The same source and flags give fscl_tpu's libraries, so the F0 is the
same bit for bit. A failed build raises: there is no numpy fallback here
(`dsp/pitch.py:extract_pitch(use_cpp=False)` asks for numpy).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

import numpy as np

REPO_DIR = Path(__file__).resolve().parents[2]
CPP_DIR = REPO_DIR / "cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")   # cpp/Makefile

_LOADED: Dict[str, ctypes.CDLL] = {}


def build(name: str) -> ctypes.CDLL:
    """Compile `cpp/<name>.cc` unless this source was already built, then
    load it. Raises if the compiler is missing or fails."""
    if name in _LOADED:
        return _LOADED[name]
    src = CPP_DIR / f"{name}.cc"
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host pitch trackers are built from "
                           f"{src} (or pass use_cpp=False for the numpy versions)")
    key = src.read_bytes() + " ".join((cxx,) + CXX_FLAGS).encode()
    out_dir = BUILD_DIR / f"{name}-{hashlib.sha256(key).hexdigest()[:16]}"
    lib_path = out_dir / f"lib{name}.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        # build under a temporary name, then rename: another process
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed on {src}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    _LOADED[name] = ctypes.CDLL(str(lib_path))
    return _LOADED[name]


def _f32(wav) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(wav, dtype=np.float32))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def cpp_yin_f0(wav, sr: int = 22050, hop_length: int = 256,
               fmin: float = 71.0, fmax: float = 800.0,
               threshold: float = 0.15, frame_length: int = 1024) -> np.ndarray:
    """YIN F0 (cpp/pitch.cc), (1 + len(wav) // hop_length,) float32."""
    fn = build("pitch").yin_f0
    fn.restype = ctypes.c_int64
    wav = _f32(wav)
    out = np.zeros(1 + len(wav) // hop_length, dtype=np.float32)
    fn(_ptr(wav), ctypes.c_int64(len(wav)), ctypes.c_int32(sr), ctypes.c_int32(hop_length),
       ctypes.c_float(fmin), ctypes.c_float(fmax), ctypes.c_float(threshold),
       ctypes.c_int32(frame_length), _ptr(out))
    return out


def cpp_world_f0(wav, sr: int = 22050, hop_length: int = 256,
                 fmin: float = 71.0, fmax: float = 800.0) -> np.ndarray:
    """DIO-style multi-band F0 + autocorrelation refinement
    (cpp/world_pitch.cc), the WORLD (pyworld) role in the reference's
    preprocessing; (1 + len(wav) // hop_length,) float32."""
    fn = build("world_pitch").world_f0
    fn.restype = ctypes.c_int64
    wav = _f32(wav)
    out = np.zeros(1 + len(wav) // hop_length, dtype=np.float32)
    fn(_ptr(wav), ctypes.c_int64(len(wav)), ctypes.c_int32(sr), ctypes.c_int32(hop_length),
       ctypes.c_float(fmin), ctypes.c_float(fmax), _ptr(out))
    return out
