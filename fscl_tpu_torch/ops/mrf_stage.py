"""One HiFiGAN multi-receptive-field stage (port of
`fscl_tpu/ops/hifigan_fused.py:fused_mrf_stage`).

`mrf_stage_cuda` launches the Hopper kernels of `csrc/mrf_stage.cu`, which
replace the TPU kernel `_stage_kernel` (`fscl_tpu/ops/hifigan_fused.py:52`):
each conv pair of a resblock is one launch on wgmma, float32 by split TF32
and bfloat16 directly, with the pair's intermediate in shared memory where it
fits (the library's route, `route_on_card`), on weights packed once per
module in the kernel's operand layout (`_pack_weight`).
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
MAX_T; the kernel's copies need rows a multiple of 4 floats apart, so a T
that is not is padded to one (`row_pitch`) in work buffers of the wrapper.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

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
# The kernel launches those stage launches queued, as the library counts
# them where it queues each: conv launches (pair_kernel: a fused pair, or one
# conv of a pair in two launches) and conv_post launches (post_kernel).
CONV_LAUNCHES = 0
POST_LAUNCHES = 0

MAX_BATCH = 65535              # samples a launch takes (csrc/mrf_stage.cu's check)
MAX_T = 2 ** 31 - 1 - 1024     # csrc/mrf_stage.cu MAX_T: T and a window's rows are ints


class Route(NamedTuple):
    """The library's route at C channels (csrc/mrf_stage.cu:route)."""
    np: int        # output channels a pass (wgmma's N)
    m: int         # time rows a tile computes
    fused: bool    # a conv pair is one launch, its intermediate in shared memory
    nw: int = 0    # the instance's weight stages (0: its type's default)


def pass_width(C: int) -> int:
    """NP, the output channels a pass of the kernel computes (wgmma's N):
    the largest of 128, 64 and 32 that divides C (csrc/mrf_stage.cu:route)."""
    if C < 32 or C % 32:
        raise ValueError(f"channels {C} not a multiple of 32")
    return 128 if C % 128 == 0 else 64 if C % 64 == 0 else 32


def row_pitch(T: int) -> int:
    """The rows' pitch in the kernel's buffers: T rounded up to a multiple of
    4 floats (TMA's 16-byte strides)."""
    return (T + 3) // 4 * 4


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
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_int)] * 3
                       + [ctypes.POINTER(ctypes.c_void_p)] * 2
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p]
                       + [ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
    return fn


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 (10 mantissa bits), to nearest with ties away from
    zero: cvt.rna.tf32.f32's rounding."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _pack_weight(w: torch.Tensor, round_bf16: bool) -> torch.Tensor:
    """A (C, C, k) conv weight in the kernel's B operand layout: for each
    (pass p, k-step s, tap i), one contiguous chunk that the kernel copies as
    it lies, K-major without swizzle: 16-byte rows of input channels, one per
    output channel n of the pass (wgmma's N = NP, `pass_width`), the k-step's two
    16-byte halves (kg) a plane of NP rows apart.

    float32: (C/NP, C/8, k, 2, 2, NP, 4): [p, s, i, part, kg, n, e] =
    part(w[p NP + n, 8 s + 4 kg + e, i]), part 0 the TF32 big part
    tf32(w) and 1 the small part tf32(w - big) (both rounded as
    cvt.rna.tf32.f32 rounds; big + small is w within 2^-22).
    bfloat16: (C/NP, C/16, k, 2, NP, 8): [p, s, i, kg, n, e] =
    bf16(w[p NP + n, 16 s + 8 kg + e, i])."""
    c_out, c_in, k = w.shape
    np_ = pass_width(c_out)
    w = w.detach().float()
    if round_bf16:
        a = w.to(torch.bfloat16).reshape(c_out // np_, np_, c_in // 16, 2, 8, k)
        return a.permute(0, 2, 5, 3, 1, 4).contiguous()
    big = _tf32(w)
    parts = torch.stack([big, _tf32(w - big)])
    a = parts.reshape(2, c_out // np_, np_, c_in // 8, 2, 4, k)
    return a.permute(1, 3, 6, 0, 4, 2, 5).contiguous()


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
    global LAUNCHES, CONV_LAUNCHES, POST_LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stage_cuda takes CUDA tensors, got {x.device}")
    B, C, T = x.shape
    ld = row_pitch(T)
    padded = ld != T
    if padded or x.data_ptr() % 16:
        # rows ld apart, 16-byte aligned; rows [T, ld) are never read
        xp = torch.empty(B, C, ld, dtype=x.dtype, device=x.device)
        xp[..., :T] = x
        x = xp
    h = torch.empty(B, C, ld, dtype=x.dtype, device=x.device)
    r = torch.empty_like(h)
    if post_w is not None:
        stage_out, wav = torch.empty_like(h), out
    else:
        stage_out, wav = (torch.empty_like(h) if padded or out.data_ptr() % 16 else out), None

    # The launches run after this returns. The work buffers may be freed then:
    # PyTorch's caching allocator hands their memory only to work queued later
    # on the same stream.
    fn = _load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    launched = (ctypes.c_int * 2)()
    err = fn(x.data_ptr(), stage_out.data_ptr(), h.data_ptr(), r.data_ptr(),
             wav.data_ptr() if wav is not None else None, B, C, T, ld, len(ks),
             _ints(ks), _ints(n_dil), _ints(dils), _ptrs([w for w, _ in packed]),
             _ptrs([b for _, b in packed]),
             post_w.data_ptr() if post_w is not None else None,
             post_b.data_ptr() if post_b is not None else None, int(round_bf16), stream,
             launched)
    CONV_LAUNCHES += launched[0]
    POST_LAUNCHES += launched[1]
    if err != 0:
        raise RuntimeError(f"MRF stage kernel launch failed: cudaError {err}")
    if wav is None and stage_out is not out:
        out.copy_(stage_out[..., :T])
    LAUNCHES += 1


def route_on_card(C: int, round_bf16: bool) -> Route:
    """The library's route at C channels (fscl_mrf_route): the kernel picks
    it at launch; read here to report it and to test it on the card."""
    fn = cuda_lib.build("mrf_stage").lib.fscl_mrf_route
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    got = (ctypes.c_int * 4)()
    err = fn(C, int(round_bf16), got)
    if err != 0:
        raise RuntimeError(f"fscl_mrf_route({C}) failed: cudaError {err}")
    return Route(got[0], got[1], bool(got[2]), got[3])


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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(y.data_ptr(), post_w.data_ptr(), post_b.data_ptr(), wav.data_ptr(), B, C, T, T,
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
