"""One HiFiGAN multi-receptive-field stage (port of
`fscl_tpu/ops/hifigan_fused.py:fused_mrf_stage`).

`mrf_stage_cuda` launches the Hopper kernels of `csrc/mrf_stage.cu`, which
replace the TPU kernel `_stage_kernel` (`fscl_tpu/ops/hifigan_fused.py:52`):
its convs run on the tensor cores, float32 by split TF32 and bfloat16
directly, on weights packed once per module in the kernel's fragment order
(`_pack_weight`).
`mrf_stage_reference` is its plain PyTorch version: the mean of the
ResBlock1 forwards on `F.conv1d`, then, with `post`, leaky -> conv_post ->
tanh. Leaky ReLU has slope 0.1. With a bfloat16 compute dtype both round the
conv operands (the activations after leaky, and the weights) to bfloat16 and
compute in float32, as the TPU kernel does.

Tensors are in torch's Conv1d layout, (B, C, T): the layout of the
generator around the stage. The JAX function takes (B, T, C).

`mrf_stage` takes the plain version only for CPU tensors. For CUDA tensors
it launches the kernel or raises: there is no fallback. The kernel's grid
takes at most 65535 samples, so `mrf_stage_cuda` splits the batch into
launches of at most that many (`batch_splits`), as fscl_tpu's XLA convs take
any batch. Its offsets are 64-bit: a sample or a launch of 2^31 elements or
more (over 8 GiB in float32) runs in one launch. T is an int up to
MAX_T.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fscl_tpu_torch.ops import cuda_lib

SLOPE = 0.1
KERNEL_SIZES = (3, 7, 11)
MAX_REACH = 32                 # largest (k - 1) // 2 * dilation the kernel takes
POST_KERNEL = 7                # conv_post's kernel, the only one the kernel takes

# Launches of the CUDA stage (one per `mrf_stage_cuda` call, which runs the
# whole chain of conv launches); chip_smoke.py reads it to show that the
# main path went through the kernel.
LAUNCHES = 0

MAX_BATCH = 65535              # the kernel's grid: one block row per sample
MAX_T = 2 ** 31 - 1 - 1024     # csrc/mrf_stage.cu MAX_T: T and a window's rows are ints


def batch_splits(B: int, C: int, T: int):
    """The (start, stop) sample ranges of one stage's launches: at most
    MAX_BATCH samples each. C and T do not enter: the kernel's offsets are
    64-bit."""
    return [(b, min(B, b + MAX_BATCH)) for b in range(0, B, MAX_BATCH)]


def _round(t: torch.Tensor, compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The value `t` has as an operand of the compute dtype."""
    if compute_dtype is None or compute_dtype == t.dtype:
        return t
    if compute_dtype == torch.bfloat16:
        return t.to(torch.bfloat16).to(t.dtype)
    raise ValueError(f"compute dtype {compute_dtype} not supported for {t.dtype} input "
                     "(None, the input's dtype, or bfloat16)")


def _conv(h: torch.Tensor, conv: nn.Conv1d, dilation: int,
          compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    k = conv.weight.shape[-1]
    return F.conv1d(_round(F.leaky_relu(h, SLOPE), compute_dtype),
                    _round(conv.weight, compute_dtype), conv.bias,
                    padding=(k - 1) // 2 * dilation, dilation=dilation)


def resblock_reference(x: torch.Tensor, rb, compute_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """One ResBlock1 (`fscl_tpu/models/hifigan.py:84-101`): for each
    dilation d, x <- x + conv2(leaky(conv1_d(leaky(x)))). `rb` carries
    `dilations`, `convs1` and `convs2` (the port's ResBlock1)."""
    for d, c1, c2 in zip(rb.dilations, rb.convs1, rb.convs2):
        x = x + _conv(_conv(x, c1, d, compute_dtype), c2, 1, compute_dtype)
    return x


def mrf_stage_reference(x: torch.Tensor, resblocks: Sequence, post: Optional[nn.Conv1d] = None,
                        compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain stage: the mean of the resblocks; with `post`, the wav
    tanh(conv_post(leaky(mean))) as (B, T)."""
    acc = None
    for rb in resblocks:
        h = resblock_reference(x, rb, compute_dtype)
        acc = h if acc is None else acc + h
    y = acc * (1.0 / len(resblocks))
    if post is None:
        return y
    k = post.weight.shape[-1]
    wav = F.conv1d(_round(F.leaky_relu(y, SLOPE), compute_dtype),
                   _round(post.weight, compute_dtype), post.bias, padding=(k - 1) // 2)
    return torch.tanh(wav)[:, 0]


def _load():
    built = cuda_lib.build("mrf_stage")
    fn = built.lib.fscl_mrf_stage
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_int)] * 3
                       + [ctypes.POINTER(ctypes.c_void_p)] * 2
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _pack_weight(w: torch.Tensor, round_bf16: bool) -> torch.Tensor:
    """A (C_out, C_in, k) conv weight in the kernel's fragment order: for each
    (16 output channels m, input-channel k-step c, tap i), the mma.sync A
    fragments of the 32 lanes (g, t) = (lane // 4, lane % 4), registers
    a0..a3 at rows g, g + 8, g, g + 8 and k offsets 0, 0, +half, +half.

    float32: (C_out/16, C_in/8, k, 32, 4), m16n8k8's
    a[r] = w[16m + g + 8(r % 2), 8c + t + 4(r // 2), i], as float32 (the
    kernel splits each into its TF32 big and small parts in registers).
    bfloat16: (C_out/16, C_in/16, k, 32, 4, 2), m16n8k16's register r as
    the pair w[16m + g + 8(r % 2), 16c + 2t + 8(r // 2) + (0, 1), i]."""
    c_out, c_in, k = w.shape
    w = w.detach().float()
    if round_bf16:
        # co = 16m + 8h + g, ci = 16c + 8q + 2t + e -> (m, c, i, g, t, q, h, e)
        a = w.to(torch.bfloat16).reshape(c_out // 16, 2, 8, c_in // 16, 2, 4, 2, k)
        return a.permute(0, 3, 7, 2, 5, 4, 1, 6).reshape(
            c_out // 16, c_in // 16, k, 32, 4, 2).contiguous()
    # co = 16m + 8h + g, ci = 8c + 4q + t -> (m, c, i, g, t, q, h)
    a = w.reshape(c_out // 16, 2, 8, c_in // 8, 2, 4, k).permute(0, 3, 6, 2, 5, 4, 1)
    return a.reshape(c_out // 16, c_in // 8, k, 32, 4).contiguous()


def _pack_post(w: torch.Tensor, round_bf16: bool) -> torch.Tensor:
    """conv_post's (1, C, 7) weight as (7, C, 1), the layout its kernel reads."""
    w = w.detach().float()
    if round_bf16:
        w = w.to(torch.bfloat16).float()
    return w.permute(2, 1, 0).contiguous()


def _packed(conv: nn.Conv1d, round_bf16: bool):
    """conv's weight in the layout its kernel reads (`_pack_weight`, or
    `_pack_post` for conv_post, C -> 1) and its bias as float32. Packed once
    and kept on the module until the weight or the bias is replaced or
    changed in place."""
    w, b = conv.weight.detach(), conv.bias.detach()      # share the version counters
    key = (w.data_ptr(), w._version, b.data_ptr(), b._version)
    cache = conv.__dict__.setdefault("_mrf_packed", {})
    hit = cache.get(round_bf16)
    if hit is None or hit[0] != key:
        pack = _pack_post if w.shape[0] == 1 else _pack_weight
        # holding w and b keeps their addresses from going to another tensor
        hit = (key, w, b, pack(w, round_bf16), b.float().contiguous())
        cache[round_bf16] = hit
    return hit[3], hit[4]


def _ints(values):
    return (ctypes.c_int * len(values))(*values)


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def mrf_stage_cuda(x: torch.Tensor, resblocks: Sequence, post: Optional[nn.Conv1d] = None,
                   compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch the Hopper stage, once per `batch_splits` range of samples.
    x: contiguous float32 (B, C, T) CUDA tensor, C a multiple of 32, B >= 1,
    1 <= T <= MAX_T; every resblock kernel size in (3, 7, 11) with
    (k - 1) // 2 * d <= 32; compute dtype float32 (or None) or bfloat16;
    `post` a Conv1d C -> 1 with kernel 7."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, C, T), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {compute_dtype} not supported (float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    B, C, T = x.shape
    if C < 32 or C % 32:
        raise ValueError(f"channels {C} not a multiple of 32")
    if B < 1 or T < 1 or T > MAX_T:
        raise ValueError(f"shape {tuple(x.shape)} outside the kernel's range (T up to {MAX_T})")
    splits = batch_splits(B, C, T)
    if not resblocks:
        raise ValueError("a stage needs at least one resblock")
    ks, n_dil, dils, convs = [], [], [], []
    for rb in resblocks:
        k = rb.kernel_size
        if k not in KERNEL_SIZES:
            raise ValueError(f"resblock kernel {k} not supported {KERNEL_SIZES}")
        ks.append(k)
        n_dil.append(len(rb.dilations))
        for d, c1, c2 in zip(rb.dilations, rb.convs1, rb.convs2):
            if d < 1 or (k - 1) // 2 * d > MAX_REACH:
                raise ValueError(f"dilation {d} at kernel {k} reaches past {MAX_REACH} rows")
            dils.append(d)
            for conv in (c1, c2):
                if tuple(conv.weight.shape) != (C, C, k) or conv.weight.device != x.device:
                    raise ValueError(f"conv weight {tuple(conv.weight.shape)} on "
                                     f"{conv.weight.device}, expected ({C}, {C}, {k}) on {x.device}")
                convs.append(conv)
    if post is not None and tuple(post.weight.shape) != (1, C, POST_KERNEL):
        raise ValueError(f"post conv weight {tuple(post.weight.shape)} not (1, {C}, {POST_KERNEL})")

    round_bf16 = compute_dtype == torch.bfloat16
    packed = [_packed(conv, round_bf16) for conv in convs]
    post_w = post_b = None
    if post is not None:
        post_w, post_b = _packed(post, round_bf16)                   # (7, C, 1)
    out = torch.empty(B, T, dtype=torch.float32, device=x.device) if post is not None \
        else torch.empty_like(x)
    for b0, b1 in splits:
        _launch_stage(x[b0:b1], out[b0:b1], ks, n_dil, dils, packed, post_w, post_b, round_bf16)
    return out


def _launch_stage(x, out, ks, n_dil, dils, packed, post_w, post_b, round_bf16: bool) -> None:
    """One launch of the stage on x (B, C, T) within the kernel's limits,
    into out: the stage output, or the wav (B, T) when post_w is given."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stage_cuda takes CUDA tensors, got {x.device}")
    B, C, T = x.shape
    h = torch.empty_like(x)
    r = torch.empty_like(x)
    stage_out, wav = (torch.empty_like(x), out) if post_w is not None else (out, None)

    # The launches run after this returns. The work buffers may be freed then:
    # PyTorch's caching allocator hands their memory only to work queued later
    # on the same stream.
    fn = _load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), stage_out.data_ptr(), h.data_ptr(), r.data_ptr(),
             wav.data_ptr() if wav is not None else None, B, C, T, len(ks),
             _ints(ks), _ints(n_dil), _ints(dils), _ptrs([w for w, _ in packed]),
             _ptrs([b for _, b in packed]),
             post_w.data_ptr() if post_w is not None else None,
             post_b.data_ptr() if post_b is not None else None, int(round_bf16), stream)
    if err != 0:
        raise RuntimeError(f"MRF stage kernel launch failed: cudaError {err}")
    LAUNCHES += 1


def _launch_post(y: torch.Tensor, post: nn.Conv1d,
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The stage's last kernel alone: tanh(conv_post(leaky(y))) as (B, T),
    for y (B, C, T) contiguous float32 on the card. chip_smoke.py times it
    apart from the convs; it is not a stage launch and is not counted."""
    B, C, T = y.shape
    if y.dtype != torch.float32 or not y.is_contiguous() or y.device.type != "cuda":
        raise ValueError("y must be a contiguous float32 CUDA tensor")
    if tuple(post.weight.shape) != (1, C, POST_KERNEL):
        raise ValueError(f"post conv weight {tuple(post.weight.shape)} not (1, {C}, {POST_KERNEL})")
    round_bf16 = compute_dtype == torch.bfloat16
    post_w, post_b = _packed(post, round_bf16)
    wav = torch.empty(B, T, dtype=torch.float32, device=y.device)
    fn = cuda_lib.build("mrf_stage").lib.fscl_mrf_post
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(y.data_ptr(), post_w.data_ptr(), post_b.data_ptr(), wav.data_ptr(), B, C, T,
             int(round_bf16), torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_post kernel launch failed: cudaError {err}")
    return wav


def mrf_stage(x: torch.Tensor, resblocks: Sequence, post: Optional[nn.Conv1d] = None,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """MRF stage dispatch. x (B, C, T) -> (B, C, T), or the wav (B, T) f32
    with `post`."""
    if x.device.type == "cpu":
        return mrf_stage_reference(x, resblocks, post, compute_dtype)
    return mrf_stage_cuda(x, resblocks, post, compute_dtype)
