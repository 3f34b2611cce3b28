"""Masked self-attention (port of `fscl_tpu/ops/attention.py`).

`attention_cuda` launches the Hopper kernel of `csrc/attention.cu`, which
replaces the TPU kernel `_attn_kernel` (`fscl_tpu/ops/attention.py:48-66`).
`attention_reference` is its plain PyTorch version, with the kernel's math:
scores in f32, invalid keys filled with the finite -1e9, softmax weights and
weights . V in f32, the result cast to the input dtype.

`attend` takes the plain version only for CPU tensors. For CUDA tensors it
launches the kernel or raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from fscl_tpu_torch.ops import cuda_lib

NEG_INF = -1e9
HEAD_DIMS = (64, 128)
MAX_LEN = 2048
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the CUDA kernel; chip_smoke.py reads it to show that the main
# path went through the kernel.
LAUNCHES = 0


def attention_reference(
    q: torch.Tensor,                       # (B, H, Lq, Dh)
    k: torch.Tensor,                       # (B, H, Lk, Dh)
    v: torch.Tensor,                       # (B, H, Lk, Dh)
    key_valid: Optional[torch.Tensor] = None,   # (B, Lk) bool, True = valid
    temperature: Optional[float] = None,
    return_weights: bool = False,
):
    """Plain attention with the kernel's math; key-only masking."""
    temp = temperature if temperature is not None else q.shape[-1] ** 0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / temp
    if key_valid is not None:
        scores = scores.masked_fill(~key_valid[:, None, None, :], NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.matmul(weights, v.float()).to(q.dtype)
    if return_weights:
        return out, weights.to(v.dtype)
    return out


def _load():
    built = cuda_lib.build("attention")
    fn = built.lib.fscl_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_valid: torch.Tensor,
    temperature: Optional[float] = None,
) -> torch.Tensor:
    """Launch the Hopper kernel. q, k, v: contiguous (B, H, L, Dh) CUDA
    tensors of one dtype (float32 or bfloat16), Dh in {64, 128},
    1 <= L <= 2048; key_valid: contiguous (B, L) bool on the same device."""
    global LAUNCHES
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, L, Dh), got {tuple(q.shape)}")
    B, H, L, Dh = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, q has "
                             f"{tuple(q.shape)}; the kernel takes Lq == Lk")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's dtype and device")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} not supported {HEAD_DIMS}")
    if not 1 <= L <= MAX_LEN:
        raise ValueError(f"length {L} outside 1..{MAX_LEN}")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the grid limit 65535")
    if key_valid.shape != (B, L) or key_valid.dtype != torch.bool \
            or key_valid.device != q.device:
        raise ValueError("key_valid must be a (B, L) bool tensor on q's device")
    for name, t in (("q", q), ("k", k), ("v", v), ("key_valid", key_valid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:   # the kernel loads 16 bytes at a time
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if q.device.type != "cuda":
        raise ValueError(f"attention_cuda takes CUDA tensors, got {q.device}")
    temp = float(temperature if temperature is not None else Dh ** 0.5)

    fn = _load()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
             out.data_ptr(), B, H, L, Dh, _DTYPE_CODES[q.dtype], temp, stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_valid: Optional[torch.Tensor] = None,
    temperature: Optional[float] = None,
    return_weights: bool = False,
):
    """Self-attention dispatch. Shapes (B, H, L, Dh)."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, key_valid, temperature, return_weights)
    if return_weights:
        raise NotImplementedError(
            "return_weights on CUDA: the kernel does not write the weights")
    if key_valid is None:
        key_valid = torch.ones(q.shape[0], k.shape[2], dtype=torch.bool, device=q.device)
    return attention_cuda(q, k, v, key_valid, temperature)
