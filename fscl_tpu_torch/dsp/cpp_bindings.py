"""ctypes bindings for the host C++ of `cpp/` (the port's own copy of
`fscl_tpu/dsp/cpp_bindings.py`): the pitch trackers (`cpp/pitch.cc` YIN,
`cpp/world_pitch.cc` DIO-style), the CTC beam decoder (`cpp/ctc_beam.cc`)
and the batch readers of the native loader and the packed shards
(`cpp/npy_batch.cc`, `cpp/shard_batch.cc`).

Each source is compiled at first use with `g++` and the flags of
`cpp/Makefile` into `fscl_tpu_torch/_build/<name>-<hash>/` (git-ignored),
keyed by a hash of the source, the compiler and the flags; nothing is
written under `cpp/`. The same source and flags give fscl_tpu's libraries,
so the results are the same bit for bit. A failed build raises: there is no
numpy fallback here (the callers' numpy versions are asked for explicitly:
`dsp/pitch.py:extract_pitch(use_cpp=False)`, `PackedShard(native=False)`,
the datamodules' `native_io=False`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

REPO_DIR = Path(__file__).resolve().parents[2]
CPP_DIR = REPO_DIR / "cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")   # cpp/Makefile
LINK_FLAGS = {"npy_batch": ("-lpthread",)}                                 # cpp/Makefile

_LOADED: Dict[str, ctypes.CDLL] = {}


def build(name: str) -> ctypes.CDLL:
    """Compile `cpp/<name>.cc` unless this source was already built, then
    load it. Raises if the compiler is missing or fails."""
    if name in _LOADED:
        return _LOADED[name]
    src = CPP_DIR / f"{name}.cc"
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the host C++ is built from {src} (the callers "
                           "take an explicit argument for their numpy versions)")
    link = LINK_FLAGS.get(name, ())
    key = src.read_bytes() + " ".join((cxx,) + CXX_FLAGS + link).encode()
    out_dir = BUILD_DIR / f"{name}-{hashlib.sha256(key).hexdigest()[:16]}"
    lib_path = out_dir / f"lib{name}.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        # build under a temporary name, then rename: another process
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(src), *link],
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


def cpp_ctc_beam_decode(logprobs, blank: int = 0, beam_width: int = 50,
                        token_min_logp: float = -25.0) -> Tuple[List[int], float]:
    """Lexicon-free CTC beam search over (T, C) log-probabilities
    (cpp/ctc_beam.cc; torchaudio/Flashlight ctc_decoder equivalent,
    lightning/build.py:48-59): (tokens, score)."""
    fn = build("ctc_beam").ctc_beam_decode
    fn.restype = ctypes.c_int64
    lp = _f32(logprobs)
    T, C = lp.shape
    out = np.zeros(T, dtype=np.int32)
    score = ctypes.c_double(0.0)
    n = fn(_ptr(lp), ctypes.c_int64(T), ctypes.c_int64(C), ctypes.c_int32(blank),
           ctypes.c_int32(beam_width), ctypes.c_float(token_min_logp),
           out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ctypes.c_int64(T),
           ctypes.byref(score))
    return out[:n].tolist(), float(score.value)


def _paths_arg(paths: List[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode("utf-8") for p in paths])


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _check(rc: int, paths: List[str]) -> None:
    if rc != 0:
        raise IOError(f"npy batch read failed at {paths[rc - 1]}")


def cpp_npy_pad_1d_f32(paths: List[str], length: int, shift: float = 0.0,
                       scale: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Read B 1-D npy files, apply (x - shift) * scale in float64, zero-pad
    to (B, length) float32 (cpp/npy_batch.cc): (out, lens)."""
    fn = build("npy_batch").npy_pad_1d_f32
    fn.restype = ctypes.c_int64
    B = len(paths)
    out = np.zeros((B, length), np.float32)
    lens = np.zeros(B, np.int32)
    rc = fn(_paths_arg(paths), ctypes.c_int64(B), ctypes.c_int64(length),
            ctypes.c_double(shift), ctypes.c_double(scale), _ptr(out), _i32p(lens))
    _check(rc, paths)
    return out, lens


def cpp_npy_pad_1d_i32(paths: List[str], length: int,
                       offset: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Read B 1-D integer npy files plus `offset`, zero-pad to (B, length)
    int32: (out, lens)."""
    fn = build("npy_batch").npy_pad_1d_i32
    fn.restype = ctypes.c_int64
    B = len(paths)
    out = np.zeros((B, length), np.int32)
    lens = np.zeros(B, np.int32)
    rc = fn(_paths_arg(paths), ctypes.c_int64(B), ctypes.c_int64(length),
            ctypes.c_int32(offset), _i32p(out), _i32p(lens))
    _check(rc, paths)
    return out, lens


def cpp_npy_pad_2d_f32(paths: List[str], n_rows: int, n_cols: int,
                       trunc: Optional[np.ndarray] = None,
                       maybe_transposed_dim: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Read B 2-D npy files (T_i, D), or (D, T_i) when stored transposed with
    first dim == maybe_transposed_dim, cut to trunc[b] rows, zero-pad to
    (B, n_rows, n_cols) float32, reading on threads: (out, lens)."""
    fn = build("npy_batch").npy_pad_2d_f32
    fn.restype = ctypes.c_int64
    B = len(paths)
    out = np.zeros((B, n_rows, n_cols), np.float32)
    lens = np.zeros(B, np.int32)
    trunc_arr = (np.zeros(B, np.int32) if trunc is None
                 else np.ascontiguousarray(np.asarray(trunc, np.int32)))
    rc = fn(_paths_arg(paths), ctypes.c_int64(B), ctypes.c_int64(n_rows),
            ctypes.c_int64(n_cols), ctypes.c_int64(maybe_transposed_dim), _i32p(trunc_arr),
            _ptr(out), _i32p(lens))
    _check(rc, paths)
    return out, lens


SHARD_BATCH_FEATURES = ("phonemes", "mel", "pitch", "energy", "duration")


def cpp_shard_pad_batch(path: str, data_offset: int, recs, L: int, T: int,
                        var_lens: dict, n_mels: int = 80) -> dict:
    """A padded supervised batch from a packed shard (data/shards.py format)
    in one native call: B x 5 reads from one file descriptor. `recs` are the
    batch's index records; `var_lens` the pitch and energy widths."""
    fn = build("shard_batch").shard_pad_batch
    fn.restype = ctypes.c_int64
    B = len(recs)
    offs = np.zeros((B, 5), np.int64)
    rows = np.zeros((B, 5), np.int64)
    for b, rec in enumerate(recs):
        for j, name in enumerate(SHARD_BATCH_FEATURES):
            off, shape, _ = rec["offsets"][name]
            offs[b, j] = off
            rows[b, j] = shape[0] if shape else 1
    pl, el = var_lens["pitch"], var_lens["energy"]
    texts = np.zeros((B, L), np.int32)
    mel = np.zeros((B, T, n_mels), np.float32)
    pitch = np.zeros((B, pl), np.float32)
    energy = np.zeros((B, el), np.float32)
    dur = np.zeros((B, L), np.int32)
    rc = fn(path.encode(), ctypes.c_int64(data_offset), ctypes.c_int64(B), _i64p(offs),
            _i64p(rows), ctypes.c_int64(L), ctypes.c_int64(T), ctypes.c_int64(pl),
            ctypes.c_int64(el), ctypes.c_int64(n_mels), _i32p(texts), _ptr(mel), _ptr(pitch),
            _ptr(energy), _i32p(dur))
    if rc:
        raise IOError(f"packed-shard batch read failed at record {rc - 1} in {path}")
    return {"phonemes": texts, "mel": mel, "pitch": pitch, "energy": energy, "duration": dur}


def cpp_shard_pad_rows(path: str, data_offset: int, offs: np.ndarray, rows: np.ndarray,
                       maxlen: int, out: np.ndarray) -> None:
    """B 1-D arrays of 4-byte elements from a packed shard into the caller's
    zeroed out[B, maxlen]."""
    fn = build("shard_batch").shard_pad_rows
    fn.restype = ctypes.c_int64
    offs = np.ascontiguousarray(offs, np.int64)
    rows = np.ascontiguousarray(rows, np.int64)
    if not (out.flags["C_CONTIGUOUS"] and out.itemsize == 4):
        raise ValueError("out must be C-contiguous with 4-byte elements")
    rc = fn(path.encode(), ctypes.c_int64(data_offset), ctypes.c_int64(len(offs)), _i64p(offs),
            _i64p(rows), ctypes.c_int64(maxlen), out.ctypes.data_as(ctypes.c_void_p))
    if rc:
        raise IOError(f"packed-shard rows read failed at record {rc - 1} in {path}")
