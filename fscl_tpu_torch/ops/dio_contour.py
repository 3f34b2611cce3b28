"""DIO's contour fix (the second pass of
`fscl_tpu/dsp/world_device.py:world_f0_batched`, its `lax.scan` of
`fix_step` at `:199-213`).

Along each row, a voiced frame whose F0 jumps by more than 20 % from the
previous frame's FIXED value is set unvoiced, unless the next (original)
frame agrees with it within 20 %. The scan reads like a chain of F
dependent steps, but it is not one: the previous fixed value is either 0
(then nothing jumps) or the previous candidate itself. So with

  d[t] = c[t] > 0 & c[t-1] > 0 & |c[t] - c[t-1]| > 0.2 * max(c[t-1], 1e-9)
         & ~(c[t+1] > 0 & |c[t] - c[t+1]| < 0.2 * max(c[t], 1e-9))

(d[0] = False, c[F] = 0), frame t is dropped iff d[t] and frame t - 1 was
not dropped: iff the run of d ending at t has odd length. Every d[t] reads
the candidates alone, and the run length is t minus the last index before
it where d is False, a running maximum. The compares are `fix_step`'s in
float32 on the same operands, so both forms below equal the scan bit for
bit.

`dio_contour_cuda` launches `csrc/dio_contour.cu`: one block per row, each
thread a contiguous span of frames, the last False index carried across
spans by a block-wide max scan. It is a kernel of the port with no Pallas
counterpart: in fscl_tpu the scan is XLA's.

`dio_contour_reference` is the plain version, the same parity form in torch
ops (a cummax over indices). `dio_contour` takes it only for CPU tensors;
for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from fscl_tpu_torch.ops import cuda_lib

JUMP = 0.2
# frames per row: the kernel indexes a row with int, spans included
MAX_FRAMES = 2 ** 30

# Launches of the CUDA kernel (one per `dio_contour_cuda` call, a whole
# batch); chip_smoke.py reads it to show that the main path went through it.
LAUNCHES = 0


def dio_contour_reference(cand: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, F) float32 candidates -> (B, F) fixed F0."""
    B, n_frames = cand.shape
    if n_frames < 2:
        return cand.clone()
    f, prev = cand[:, 1:], cand[:, :-1]
    nx = torch.cat([cand[:, 2:], torch.zeros_like(cand[:, :1])], dim=1)
    keep = (nx > 0) & ((f - nx).abs() < JUMP * torch.clamp(f, min=1e-9))
    jump = (f > 0) & (prev > 0) & ((f - prev).abs() > JUMP * torch.clamp(prev, min=1e-9))
    d = torch.cat([torch.zeros_like(keep[:, :1]), jump & ~keep], dim=1)
    idx = torch.arange(n_frames, device=cand.device).expand(B, -1)
    last_clear = torch.cummax(torch.where(d, 0, idx), dim=1).values
    dropped = d & ((idx - last_clear) % 2 == 1)
    return torch.where(dropped, torch.zeros_like(cand), cand)


def _load():
    fn = cuda_lib.build("dio_contour").lib.fscl_dio_contour
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def dio_contour_cuda(cand: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a float32 (B, F) CUDA tensor, 1 <= F <= MAX_FRAMES."""
    global LAUNCHES
    if cand.dim() != 2 or cand.dtype != torch.float32:
        raise ValueError(f"cand must be float32 (B, F), got {cand.dtype} {tuple(cand.shape)}")
    if cand.device.type != "cuda":
        raise ValueError(f"dio_contour_cuda takes CUDA tensors, got {cand.device}")
    B, n_frames = cand.shape
    if not 1 <= n_frames <= MAX_FRAMES or not 1 <= B < 2 ** 31:
        raise ValueError(f"shape {tuple(cand.shape)} outside the kernel's range "
                         f"(1 <= B < 2**31, 1 <= F <= {MAX_FRAMES})")
    cand = cand.contiguous()
    out = torch.empty_like(cand)
    err = _load()(cand.data_ptr(), out.data_ptr(), B, n_frames,
                  torch.cuda.current_stream(cand.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dio_contour kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def dio_contour(cand: torch.Tensor) -> torch.Tensor:
    """(B, F) candidates -> fixed F0: the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    if cand.device.type == "cpu":
        return dio_contour_reference(cand)
    return dio_contour_cuda(cand)
