"""Masked attention (port of `fscl_tpu/ops/attention.py`).

`attention_cuda` launches the Hopper kernel of `csrc/attention.cu`, which
replaces the TPU kernel `_attn_kernel` (`fscl_tpu/ops/attention.py:48-66`).
It runs on the tensor cores: bf16 products directly, f32 products by split
TF32 (three TF32 products per f32 product, within 2e-5 of the plain version).
At head dims 64 and 128 (the narrow route) a block is a producer warpgroup
that streams K and V by TMA (and in f32 splits them into TF32 planes) and two
consumer warpgroups that take S = Q K^T and P V with wgmma; `narrow_split`
picks whether the two own 64 query rows each or split the key loop of one
64-row tile, from the query length, the head dim and whether row stats are
written, so no result depends on B * H.
`attention_reference` is its plain PyTorch version, with the JAX package's
math (`xla_attention`, `:24-43`): scores in f32, invalid keys filled with the
finite -1e9, softmax in f32, the weights rounded to v's dtype (a no-op in
f32; in bf16 as `xla_attention` rounds them, `:40`, and as the kernel rounds
its unnormalised weights), weights . V accumulated in f32, the result cast
to the input dtype. In bf16 the rounding matters: kept in f32, the weights
put the plain version 3.9e-3 from `xla_attention` at (4, 2, 64, 32); rounded,
2.4e-4.

The kernel has two routes. Head dims 64 and 128 take the narrow route's
instances; the wrapper zero-pads smaller head dims to the next of them
(`_launch`: the `mel` upstream's 40 to 64, 80 to 128). Head dims above 128
take the wide route, which holds no warp's whole Q or O in registers and
has no upper head dim: the wrapper zero-pads them to a multiple of 64 (a
384-wide FFT block's 192 stays 192, 200 goes to 256). The JAX package sends
every head dim its Pallas kernel does not take to `xla_attention` (`attend`,
`:145-165`); with the two routes the port computes them all on the card.
Any length and any B * H go too: the key flags travel with each key tile
through the kernel's ring, and the grid is one x index.
It takes Lq query rows against Lk keys: self-attention has Lq == Lk; the
sequence-parallel upstream (`parallel/sequence_parallel.py`) attends a
rank's T / S frames to all T gathered keys, a shape the JAX package sends
to XLA (`attend`, `:160`).

`attend` takes the plain version only for CPU tensors. For CUDA tensors it
launches the kernel or raises: there is no fallback. The one exception is
`return_weights=True`, which the JAX package too sends outside its kernel
(`attend`, `:151-164`, to `xla_attention`): the kernel never writes the
weights, so they come from the plain version on the tensors' own device. With grad mode on (where
autograd or a `torch.func` transform may be tracing) it launches the kernel
through `AttentionFunction`, the port of `_pallas_attention_ad` (`:106-130`), whose
backward `attention_bwd` recomputes the weights from q, k and v as
`_pallas_attention_bwd` (`:120-127`) does. The JAX package has no backward
kernel (its backward is `jax.vjp(xla_attention)`, which XLA fuses outside any
Pallas call). The port's backward on the narrow route (padded head dim <= 128,
CUDA tensors) is the Hopper kernel of `csrc/attention_bwd.cu`
(`attention_bwd_cuda`): the forward kernel also writes each query row's max
and sum (`stats`), and the backward kernel recomputes the forward's scores
bit for bit and takes the weights from them, in two launches. `attention_bwd`
stays its plain version: the tests and the CPU use it, and it is what the
backward is differentiated as.

Which path takes which backward (`AttentionFunction.backward`):
- CUDA tensors at a padded head dim <= 128, every first-order backward
  (training, FSCL episodes, tune adaptation, vmapped adaptation, remat's
  recompute, bf16): the kernel, through `AttentionGradFunction`.
- A backward that is itself differentiated (second-order MAML, iMAML's
  Hessian-vector products, the ADA systems): the kernel still gives the
  first-order gradients; their derivative is that of `attention_bwd`
  (`AttentionGradFunction.backward`, a `torch.func.vjp` of the plain
  recompute), so the second-order gradients are the plain version's.
- Head dims above 128 (the wide route) and CPU tensors: `attention_bwd`.
Like the JAX custom VJP, the Function can be differentiated twice and
transformed by `torch.func.grad` and `torch.func.vmap`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from fscl_tpu_torch.ops import cuda_lib

NEG_INF = -1e9
HEAD_DIMS = (64, 128)  # the narrow route's instances
WIDE_STEP = 64         # the wide route takes multiples of 64 above 128
WIDE_SLICE = 128       # O columns per block on the wide route (csrc/attention.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KEY_SPLITS = (1, 2, 4)  # the wide route's
QUERY_ROWS = {torch.float32: 128, torch.bfloat16: 64}   # per wide block at key_split 1
# The narrow route's key splits: 1, two consumer warpgroups of 64 query rows
# each (a block of 128); 2, one 64-row tile whose two warpgroups take
# alternate key tiles and merge at the end.
NARROW_SPLITS = (1, 2)
WG_ROWS = 64            # query rows of a consumer warpgroup: one wgmma M
# The longest query length `narrow_split` splits the key loop at, without
# and with row stats (training), by the caller's head dim: the smallest key
# at or above it, keys ascending.
NARROW_SPLIT_MAX_L = {48: (256, 256), 64: (64, 64), 128: (512, 128)}

# Launches of the CUDA kernel; chip_smoke.py reads it to show that the main
# path went through the kernel.
LAUNCHES = 0
# Launches of the backward kernels (`attention_bwd_cuda`: two a call, dQ then
# dK and dV).
BWD_LAUNCHES = 0


def attention_reference(
    q: torch.Tensor,                       # (B, H, Lq, Dh)
    k: torch.Tensor,                       # (B, H, Lk, Dh)
    v: torch.Tensor,                       # (B, H, Lk, Dh)
    key_valid: Optional[torch.Tensor] = None,   # (B, Lk) bool, True = valid
    temperature: Optional[float] = None,
    return_weights: bool = False,
):
    """Plain attention with `xla_attention`'s math; key-only masking."""
    temp = temperature if temperature is not None else q.shape[-1] ** 0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / temp
    if key_valid is not None:
        scores = scores.masked_fill(~key_valid[:, None, None, :], NEG_INF)
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(weights.float(), v.float()).to(q.dtype)
    if return_weights:
        return out, weights
    return out


def _load():
    built = cuda_lib.build("attention")
    fn = built.lib.fscl_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _load_bwd():
    built = cuda_lib.build("attention_bwd")
    fn = built.lib.fscl_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def padded_head_dim(dh: int) -> int:
    """The head dim the kernel computes `dh` at: 64 or 128 on the narrow
    route, the next multiple of 64 on the wide route above 128."""
    if dh <= HEAD_DIMS[-1]:
        return next(d for d in HEAD_DIMS if d >= dh)
    return -(-dh // WIDE_STEP) * WIDE_STEP


def wide_slices(head_dim: int) -> int:
    """Blocks per query tile along O's columns: 1 on the narrow route, one
    per 128 columns of the (padded) head dim on the wide route."""
    return 1 if head_dim <= HEAD_DIMS[-1] else -(-head_dim // WIDE_SLICE)


def key_splits(head_dim: int) -> tuple:
    """The key splits the kernel takes at `head_dim` (padded as `_launch`
    pads it): NARROW_SPLITS on the narrow route, KEY_SPLITS on the wide."""
    return NARROW_SPLITS if padded_head_dim(head_dim) <= HEAD_DIMS[-1] else KEY_SPLITS


def narrow_split(L: int, head_dim: int, stats: bool) -> int:
    """The narrow route's key split: 2 (the two consumer warpgroups of a
    block split the key loop of one 64-row tile, twice the work items) up to
    the query length NARROW_SPLIT_MAX_L gives the head dim (the caller's,
    before padding) without or with row stats (training), else 1 (a 128-row
    tile, each key tile read once for both warpgroups). Neither B nor H
    enters: a sample's output is the same bits alone and folded into a
    batch (the vmapped adaptation), at every B, and with its heads split
    over ranks (tensor parallel). The same in both dtypes.

    The limits come from chip_ab.py's sweep of both splits on an H100
    (PERF.md, §6). The head dim stands for the head count of the port's
    models, which sets how thin the grid is: up to 48 (the custom upstreams
    below 128 wide, 2 heads, padded to 64; chip_smoke.py drives 40 and 48
    at (8, 2, 199)), 64 (HuBERT, 16 heads), up to 128 (the FFT blocks, 2
    heads). Split 2 was the faster at B <= 16 up to 256 rows at head dims
    up to 48 (at B = 32 and 199 rows split 1 was, by 4-15 %); at HuBERT's
    up to 64 rows (at 128 rows it depends on B: 4 wants 2, 32 wants 1); at
    head dim 128 when serving (B = 8) up to 512 rows, and with row stats up
    to 128 (the vmapped adaptation's (32, 2, 256) wants 1, by 40 %; the
    train step's (16, 2, 199 | 256) would want 2, by 35 %). A 128-wide
    custom upstream (2 heads of 64) takes HuBERT's limits.

    Work items at B * H = 16: L = 64, 128, 256 get 16, 32, 64; (16, 2, 128)
    with stats 64; (4, 2, 128) with stats 16; (8, 2, 512) 128; (8, 2, 1000)
    128 (split 1); (8, 2, 199) at head dim 40 or 48, 64."""
    limits = NARROW_SPLIT_MAX_L[next(d for d in NARROW_SPLIT_MAX_L if d >= head_dim)]
    return 2 if L <= limits[1 if stats else 0] else 1


def narrow_items(batch_heads: int, L: int, split: int) -> int:
    """Work items (a 128- or 64-row query tile of one (batch, head)) of one
    narrow-route launch at key split `split`. The kernel runs them in one
    block each (f32 at head dim 128) or in a block per SM that runs several
    in turn."""
    return batch_heads * -(-L // (WG_ROWS * (3 - split)))


def wide_split(batch_heads: int, L: int, n_sm: int, dtype: torch.dtype, head_dim: int) -> int:
    """The wide route's key split: the warps of a block that share the key
    loop. A block owns QUERY_ROWS query rows in warps of 16 (8 warps in
    f32, 4 in bf16); with key_split s it owns 1/s of them, and each warp
    takes a slice of every key tile. The smallest s whose grid has a block
    for every two SMs, else 4. L is the query length, which sets the grid;
    the key length only sets how many key tiles each warp's slice runs
    through, so it does not enter. Each query tile is
    `wide_slices(head_dim)` blocks, which count toward the grid the same
    way."""
    rows = QUERY_ROWS[dtype]
    blocks = batch_heads * wide_slices(padded_head_dim(head_dim))
    for split in KEY_SPLITS:
        if 2 * -(-L // (rows // split)) * blocks >= n_sm:
            return split
    return KEY_SPLITS[-1]


def choose_key_split(shape, dtype: torch.dtype, n_sm: int, stats: bool) -> int:
    """The key split the wrapper launches q of `shape` (B, H, Lq, Dh, Dh the
    caller's head dim) at: `narrow_split` on the narrow route (padded head
    dim <= 128; `stats`: with row stats), `wide_split` above."""
    B, H, Lq, Dh = shape
    if padded_head_dim(Dh) <= HEAD_DIMS[-1]:
        return narrow_split(Lq, Dh, stats)
    return wide_split(B * H, Lq, n_sm, dtype, Dh)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_valid: torch.Tensor,
    temperature: Optional[float] = None,
    stats: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the Hopper kernel. q: contiguous (B, H, Lq, Dh), k and v:
    contiguous (B, H, Lk, Dh) CUDA tensors of one dtype (float32 or
    bfloat16), any Dh >= 1 (padded where the kernel does not take it, see
    `_launch`), Lq, Lk >= 1; key_valid: contiguous (B, Lk) bool on the same
    device. stats: None, or on the narrow route (padded head dim <= 128) a
    contiguous float32 (B, H, Lq, 2) tensor that receives each query row's
    score max (in log2 units: scores times log2(e) / temperature) and the
    sum of its unnormalised weights, for `attention_bwd_cuda`."""
    return _launch(q, k, v, key_valid, temperature, None, stats)


def _launch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_valid: torch.Tensor,
    temperature: Optional[float],
    key_split: Optional[int],
    stats: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`attention_cuda` at a given key split (`key_splits(Dh)`: 1 or 2 on
    the narrow route, 1, 2 or 4 on the wide), or at the one
    `choose_key_split` picks for CUDA tensors when None, from the shape
    before any padding. Tests and chip_smoke.py sweep every split through
    it.

    A head dim the kernel does not compute at (`padded_head_dim`: the
    `mel` upstream's 40, a custom upstream's 48 or 80, 200 on the wide
    route) is zero-padded along Dh to the one it does, with the temperature
    kept at sqrt(the true Dh): zero columns add nothing to q k^T, and v's
    zero columns only give output columns, which are sliced off. The JAX
    package sends such shapes to XLA. The padding leaves the scores, and
    so `stats`, unchanged."""
    Dh = q.shape[-1]
    if key_split is None and q.device.type == "cuda" and q.dim() == 4 and Dh >= 1:
        key_split = choose_key_split(q.shape, q.dtype, _sm_count(q.device.index),
                                     stats is not None)
    if q.dim() != 4 or Dh < 1 or padded_head_dim(Dh) == Dh:
        return _launch_kernel(q, k, v, key_valid, temperature, key_split, stats)
    pad = padded_head_dim(Dh) - Dh
    temp = temperature if temperature is not None else Dh ** 0.5
    q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    out = _launch_kernel(q, k, v, key_valid, temp, key_split, stats)
    return out[..., :Dh].contiguous()


def _launch_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_valid: torch.Tensor,
    temperature: Optional[float],
    key_split: Optional[int],
    stats: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One launch of the kernel at a head dim it computes at (64, 128 or a
    multiple of 64 above 128), at the key split `_launch` gave."""
    global LAUNCHES
    _check_launch(q, k, v, key_valid, key_split)
    if stats is not None:
        _check_stats(stats, q)
    if q.device.type != "cuda":
        raise ValueError(f"attention_cuda takes CUDA tensors, got {q.device}")
    if key_split is None:
        raise ValueError("the launch takes the key split `_launch` chose")
    B, H, Lq, Dh = q.shape
    temp = float(temperature if temperature is not None else Dh ** 0.5)

    fn = _load()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
             out.data_ptr(), B, H, Lq, k.shape[2], Dh, _DTYPE_CODES[q.dtype], temp, key_split,
             None if stats is None else stats.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def _check_stats(stats: torch.Tensor, q: torch.Tensor) -> None:
    """Raise unless `stats` is a contiguous float32 (B, H, Lq, 2) tensor on
    q's device and q's head dim is on the narrow route (64 or 128)."""
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"row stats come from the narrow route (head dims {HEAD_DIMS}), "
                         f"not head dim {q.shape[-1]}")
    if stats.shape != (*q.shape[:3], 2) or stats.dtype != torch.float32 \
            or stats.device != q.device or not stats.is_contiguous():
        raise ValueError(f"stats must be a contiguous float32 {(*q.shape[:3], 2)} tensor on "
                         f"{q.device}, got {stats.dtype} {tuple(stats.shape)} on {stats.device}")


def _check_launch(q, k, v, key_valid, key_split) -> None:
    """Raise on what the kernel does not take: shapes that disagree, a dtype
    other than float32 and bfloat16, a head dim `_launch` would have padded,
    an empty query or key axis, a key_valid that is not (B, Lk) bool on q's
    device, layouts that are not contiguous or start off a 16-byte boundary,
    a key split the head dim's route does not take. Any length and any
    B * H pass."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, Lq, Dh), got {tuple(q.shape)}")
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2] if k.dim() == 4 else -1
    for name, t in (("k", k), ("v", v)):
        if t.shape != k.shape or (t.shape[:2], t.shape[3:]) != (q.shape[:2], q.shape[3:]):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, q has {tuple(q.shape)}: "
                             f"k and v must be one (B, H, Lk, Dh), q and k must agree on "
                             f"(B, H, Dh)")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's dtype and device")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    if Dh < 1 or padded_head_dim(Dh) != Dh:
        raise ValueError(f"head dim {Dh} not one the kernel computes at: 64, 128 or a "
                         f"multiple of {WIDE_STEP} above 128 (`_launch` pads the others)")
    for L in (Lq, Lk):
        if L < 1:
            raise ValueError(f"length {L} outside 1.. (no query row or no key)")
    if key_valid.shape != (B, Lk) or key_valid.dtype != torch.bool \
            or key_valid.device != q.device:
        raise ValueError("key_valid must be a (B, Lk) bool tensor on q's device")
    for name, t in (("q", q), ("k", k), ("v", v), ("key_valid", key_valid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:   # the kernel loads 16 bytes at a time
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if key_split is not None and key_split not in key_splits(Dh):
        raise ValueError(f"key_split {key_split} not in {key_splits(Dh)} (head dim {Dh})")


def attention_bwd(
    q: torch.Tensor,                       # (B, H, Lq, Dh)
    k: torch.Tensor,                       # (B, H, Lk, Dh)
    v: torch.Tensor,
    key_valid: torch.Tensor,               # (B, Lk) bool, True = valid
    temperature: Optional[float],
    g: torch.Tensor,                       # (B, H, Lq, Dh), d loss / d out
):
    """(dq, dk, dv) of the kernel's attention at (q, k, v), by recomputing
    the weights with its math (scores in f32, finite -1e9 fill at invalid
    keys, softmax): dV = P^T g; dS = P * (g V^T - rowsum(g V^T * P)), zeroed
    at invalid keys as `jnp.where`'s VJP zeroes them (in a row with no valid
    key P is uniform, and dS would otherwise carry a gradient to those keys);
    dQ = dS K / temp, dK = dS^T Q / temp. Products in f32 as batched products
    over B * H, whose transposed operands cuBLAS reads in place. Each
    gradient is cast to its input's dtype.

    With grad mode off (a first-order backward) the (Lq, Lk) temporaries are
    updated in place. With it on (a double backward, `torch.func`) every step
    is out of place, so that autograd can differentiate the backward itself,
    as JAX differentiates `jax.vjp(xla_attention)` again."""
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    temp = temperature if temperature is not None else Dh ** 0.5
    qf, gf = (t.reshape(B * H, Lq, Dh).float() for t in (q, g))
    kf, vf = (t.reshape(B * H, Lk, Dh).float() for t in (k, v))
    invalid = (~key_valid).repeat_interleave(H, dim=0)[:, None, :]
    dw = torch.bmm(gf, vf.transpose(1, 2))
    if torch.is_grad_enabled():
        scores = (torch.bmm(qf, kf.transpose(1, 2)) / temp).masked_fill(invalid, NEG_INF)
        weights = torch.softmax(scores, dim=-1)
        ds = (dw - (dw * weights).sum(dim=-1, keepdim=True)) * weights
        ds = ds.masked_fill(invalid, 0.0) / temp
    else:
        scores = torch.bmm(qf, kf.transpose(1, 2)).div_(temp).masked_fill_(invalid, NEG_INF)
        weights = torch.softmax(scores, dim=-1)
        ds = dw.sub_((dw * weights).sum(dim=-1, keepdim=True)).mul_(weights)
        ds = ds.masked_fill_(invalid, 0.0).div_(temp)
    dv = torch.bmm(weights.transpose(1, 2), gf)
    dq = torch.bmm(ds, kf)
    dk = torch.bmm(ds.transpose(1, 2), qf)
    return tuple(d.view(t.shape).to(t.dtype) for d, t in ((dq, q), (dk, k), (dv, v)))


def attention_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_valid: torch.Tensor,
    temperature: Optional[float],
    g: torch.Tensor,
    stats: torch.Tensor,
):
    """(dq, dk, dv) by the Hopper backward kernels (`csrc/attention_bwd.cu`):
    `attention_bwd`'s gradients, with the weights exp2(scores - m) / l from
    each query row's max m and sum l (`stats`, written by `attention_cuda(q,
    k, v, key_valid, temperature, stats)`; the kernels recompute its scores
    bit for bit). q, g: contiguous (B, H, Lq, Dh); k, v: contiguous (B, H,
    Lk, Dh), all one dtype (float32 or bfloat16) on one CUDA device; a
    padded head dim of 64 or 128 (smaller ones are zero-padded as `_launch`
    pads them); key_valid (B, Lk) bool; stats contiguous float32 (B, H, Lq,
    2). Gradients in the input dtype."""
    Dh = q.shape[-1]
    if q.dim() != 4 or Dh < 1 or padded_head_dim(Dh) > HEAD_DIMS[-1]:
        raise ValueError(f"the backward kernel takes (B, H, L, Dh) at head dims up to "
                         f"{HEAD_DIMS[-1]}, got {tuple(q.shape)}")
    if padded_head_dim(Dh) == Dh:
        return _launch_bwd(q, k, v, key_valid, temperature, g, stats)
    pad = padded_head_dim(Dh) - Dh
    temp = temperature if temperature is not None else Dh ** 0.5
    q, k, v, g = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v, g))
    grads = _launch_bwd(q, k, v, key_valid, temp, g, stats)
    return tuple(d[..., :Dh].contiguous() for d in grads)


def _launch_bwd(q, k, v, key_valid, temperature, g, stats):
    """The backward kernels' two launches at a head dim of 64 or 128."""
    global BWD_LAUNCHES
    _check_launch(q, k, v, key_valid, None)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device \
            or not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError(f"g must be a contiguous {q.dtype} {tuple(q.shape)} tensor on "
                         f"{q.device} starting on a 16-byte boundary")
    _check_stats(stats, q)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd_cuda takes CUDA tensors, got {q.device}")
    B, H, Lq, Dh = q.shape
    temp = float(temperature if temperature is not None else Dh ** 0.5)
    fn = _load_bwd()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rowstats = torch.empty(B * H * Lq * 4, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(), g.data_ptr(),
             stats.data_ptr(), rowstats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             B, H, Lq, k.shape[2], Dh, _DTYPE_CODES[q.dtype], temp, stream)
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed: cudaError {err}")
    BWD_LAUNCHES += 2
    return dq, dk, dv


def kernel_backward(q: torch.Tensor) -> bool:
    """Whether `AttentionFunction` takes the backward kernel for q: CUDA
    tensors whose padded head dim is on the narrow route (<= 128)."""
    return q.device.type == "cuda" and padded_head_dim(q.shape[-1]) <= HEAD_DIMS[-1]


def _fold(t: torch.Tensor, dim: Optional[int], n: int) -> torch.Tensor:
    """A vmapped input with its vmapped dim folded into its first: (N, B, ...)
    -> (N * B, ...), contiguous; an input without the dim is expanded to it."""
    t = t.movedim(dim, 0) if dim is not None else t.expand(n, *t.shape)
    return t.reshape(n * t.shape[1], *t.shape[2:]).contiguous()


def _unfold(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.view(n, t.shape[0] // n, *t.shape[1:])


class AttentionFunction(torch.autograd.Function):
    """The kernel under autograd: forward `attention_cuda`, which returns
    (out, stats): on the narrow route each query row's max and sum, which
    the backward kernel reads (marked non-differentiable), else a (B, H,
    Lq, 0) placeholder. Backward: `AttentionGradFunction` (the backward
    kernel) where `kernel_backward` holds, else `attention_bwd` from the
    saved q, k, v and key_valid (the wide route, and CPU tensors in the
    tests). Written in the `setup_context` form with a `vmap` rule, so
    that `torch.func.grad`, `torch.func.vmap` and double backwards run
    through it."""

    @staticmethod
    def forward(q, k, v, key_valid, temperature):
        if not kernel_backward(q):
            return (attention_cuda(q, k, v, key_valid, temperature),
                    q.new_empty((*q.shape[:3], 0), dtype=torch.float32))
        stats = torch.empty((*q.shape[:3], 2), dtype=torch.float32, device=q.device)
        return attention_cuda(q, k, v, key_valid, temperature, stats), stats

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, key_valid, temperature = inputs
        stats = output[1]
        ctx.mark_non_differentiable(stats)
        ctx.save_for_backward(q, k, v, key_valid, stats)
        ctx.temperature = temperature

    @staticmethod
    def backward(ctx, g, _):
        q, k, v, key_valid, stats = ctx.saved_tensors
        if stats.shape[-1] == 0:
            dq, dk, dv = attention_bwd(q, k, v, key_valid, ctx.temperature, g)
        else:
            dq, dk, dv = AttentionGradFunction.apply(q, k, v, key_valid, ctx.temperature,
                                                     g.contiguous(), stats)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, key_valid, temperature):
        """Fold the vmapped dim into B: (N, B, H, L, Dh) -> (N * B, H, L, Dh)
        (Lq for q, Lk for k and v),
        one launch for all N. An input without the vmapped dim (key_valid
        when only q, k and v are vmapped) is expanded to it."""
        n = info.batch_size
        args = [_fold(t, d, n) for t, d in zip((q, k, v, key_valid), in_dims[:4])]
        out, stats = AttentionFunction.apply(*args, temperature)
        return (_unfold(out, n), _unfold(stats, n)), (0, 0)


class AttentionGradFunction(torch.autograd.Function):
    """The backward kernel under autograd: forward `attention_bwd_cuda`
    (q, k, v, key_valid, temperature, g, stats) -> (dq, dk, dv). Its own
    backward, which only a differentiated backward reaches (MAML, iMAML,
    the ADA systems), is the vector-Jacobian product of the plain
    `attention_bwd` recompute in q, k, v and g, so second-order gradients
    are those of the plain version; stats, a function of q and k, gets
    none. `setup_context` form with a `vmap` rule, as `AttentionFunction`."""

    @staticmethod
    def forward(q, k, v, key_valid, temperature, g, stats):
        return attention_bwd_cuda(q, k, v, key_valid, temperature, g, stats)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, key_valid, temperature, g, _ = inputs
        ctx.save_for_backward(q, k, v, key_valid, g)
        ctx.temperature = temperature

    @staticmethod
    def backward(ctx, gdq, gdk, gdv):
        q, k, v, key_valid, g = ctx.saved_tensors

        def recompute(q_, k_, v_, g_):
            return attention_bwd(q_, k_, v_, key_valid, ctx.temperature, g_)

        _, vjp = torch.func.vjp(recompute, q, k, v, g)
        dq, dk, dv, dg = vjp((gdq, gdk, gdv))
        return dq, dk, dv, None, None, dg, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, key_valid, temperature, g, stats):
        """Fold the vmapped dim into B as `AttentionFunction.vmap` does: one
        kernel call for all N."""
        n = info.batch_size
        tensors = (q, k, v, key_valid, g, stats)
        dims = (*in_dims[:4], *in_dims[5:])
        q, k, v, key_valid, g, stats = (_fold(t, d, n) for t, d in zip(tensors, dims))
        grads = AttentionGradFunction.apply(q, k, v, key_valid, temperature, g, stats)
        return tuple(_unfold(d, n) for d in grads), (0, 0, 0)


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_valid: Optional[torch.Tensor] = None,
    temperature: Optional[float] = None,
    return_weights: bool = False,
):
    """Attention dispatch. Shapes q (B, H, Lq, Dh), k and v (B, H, Lk, Dh),
    key_valid (B, Lk)."""
    if q.device.type == "cpu" or return_weights:
        return attention_reference(q, k, v, key_valid, temperature, return_weights)
    if key_valid is None:
        key_valid = torch.ones(q.shape[0], k.shape[2], dtype=torch.bool, device=q.device)
    if torch.is_grad_enabled():     # autograd or a torch.func transform may be tracing
        return AttentionFunction.apply(q, k, v, key_valid, temperature)[0]
    return attention_cuda(q, k, v, key_valid, temperature)
