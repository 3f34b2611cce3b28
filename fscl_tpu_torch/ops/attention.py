"""Masked self-attention (port of `fscl_tpu/ops/attention.py`).

`attention_cuda` launches the Hopper kernel of `csrc/attention.cu`, which
replaces the TPU kernel `_attn_kernel` (`fscl_tpu/ops/attention.py:48-66`).
It runs on the tensor cores: bf16 products directly, f32 products by split
TF32 (three TF32 products per f32 product, within 2e-5 of the plain version).
`attention_reference` is its plain PyTorch version, with the kernel's math:
scores in f32, invalid keys filled with the finite -1e9, softmax weights and
weights . V in f32, the result cast to the input dtype.

`attend` takes the plain version only for CPU tensors. For CUDA tensors it
launches the kernel or raises: there is no fallback. With grad mode on (where
autograd or a `torch.func` transform may be tracing) it launches the kernel
through `AttentionFunction`, the port of `_pallas_attention_ad` (`:106-130`), whose
backward `attention_bwd` recomputes the weights from q, k and v as
`_pallas_attention_bwd` (`:120-127`) does. The JAX package has no backward
kernel (its backward is XLA code outside any Pallas call), so the backward
here is plain PyTorch: two products recompute P, three give the gradients.
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
HEAD_DIMS = (64, 128)
MAX_LEN = 2048
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KEY_SPLITS = (1, 2, 4)
QUERY_ROWS = {torch.float32: 128, torch.bfloat16: 64}   # per block at key_split 1

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
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def choose_key_split(batch_heads: int, L: int, n_sm: int, dtype: torch.dtype) -> int:
    """Warps of a block that share the key loop. A block owns QUERY_ROWS
    query rows in warps of 16 (8 warps in f32, 4 in bf16); with key_split s
    it owns 1/s of them, and each warp takes a slice of every key tile. The
    smallest s whose grid has a block for every two SMs, else 4: on an H100
    that was the fastest split, or within 15 % of it, at B * H = 16 and
    L = 64 ... 1000 in both types (chip_smoke.py phase 3)."""
    rows = QUERY_ROWS[dtype]
    for split in KEY_SPLITS:
        if 2 * -(-L // (rows // split)) * batch_heads >= n_sm:
            return split
    return KEY_SPLITS[-1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    return _launch(q, k, v, key_valid, temperature, None)


def _launch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_valid: torch.Tensor,
    temperature: Optional[float],
    key_split: Optional[int],
) -> torch.Tensor:
    """`attention_cuda` at a given key split (1, 2 or 4), or at the one
    `choose_key_split` picks when None. Tests and chip_smoke.py sweep every
    split through it."""
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
    if key_split is not None and key_split not in KEY_SPLITS:
        raise ValueError(f"key_split {key_split} not in {KEY_SPLITS}")
    if q.device.type != "cuda":
        raise ValueError(f"attention_cuda takes CUDA tensors, got {q.device}")
    temp = float(temperature if temperature is not None else Dh ** 0.5)
    if key_split is None:
        key_split = choose_key_split(B * H, L, _sm_count(q.device.index), q.dtype)

    fn = _load()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
             out.data_ptr(), B, H, L, Dh, _DTYPE_CODES[q.dtype], temp, key_split, stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def attention_bwd(
    q: torch.Tensor,                       # (B, H, L, Dh)
    k: torch.Tensor,
    v: torch.Tensor,
    key_valid: torch.Tensor,               # (B, L) bool, True = valid
    temperature: Optional[float],
    g: torch.Tensor,                       # (B, H, L, Dh), d loss / d out
):
    """(dq, dk, dv) of the kernel's attention at (q, k, v), by recomputing
    the weights with its math (scores in f32, finite -1e9 fill at invalid
    keys, softmax): dV = P^T g; dS = P * (g V^T - rowsum(g V^T * P)), zeroed
    at invalid keys as `jnp.where`'s VJP zeroes them (in a row with no valid
    key P is uniform, and dS would otherwise carry a gradient to those keys);
    dQ = dS K / temp, dK = dS^T Q / temp. Products in f32 as batched products
    over B * H, whose transposed operands cuBLAS reads in place. Each
    gradient is cast to its input's dtype.

    With grad mode off (a first-order backward) the (L, L) temporaries are
    updated in place. With it on (a double backward, `torch.func`) every step
    is out of place, so that autograd can differentiate the backward itself,
    as JAX differentiates `jax.vjp(xla_attention)` again."""
    B, H, L, Dh = q.shape
    temp = temperature if temperature is not None else Dh ** 0.5
    qf, kf, vf, gf = (t.reshape(B * H, L, Dh).float() for t in (q, k, v, g))
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
    return tuple(d.view(B, H, L, Dh).to(t.dtype) for d, t in ((dq, q), (dk, k), (dv, v)))


class AttentionFunction(torch.autograd.Function):
    """The kernel under autograd: forward `attention_cuda`, backward
    `attention_bwd` from the saved q, k, v and key_valid. Written in the
    `setup_context` form with a `vmap` rule, so that `torch.func.grad`,
    `torch.func.vmap` and double backwards run through it."""

    @staticmethod
    def forward(q, k, v, key_valid, temperature):
        return attention_cuda(q, k, v, key_valid, temperature)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, key_valid, temperature = inputs
        ctx.save_for_backward(q, k, v, key_valid)
        ctx.temperature = temperature

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_valid = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, key_valid, ctx.temperature, g)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, key_valid, temperature):
        """Fold the vmapped dim into B: (N, B, H, L, Dh) -> (N * B, H, L, Dh),
        one launch for all N. An input without the vmapped dim (key_valid
        when only q, k and v are vmapped) is expanded to it."""
        n = info.batch_size

        def fold(t, dim):
            t = t.movedim(dim, 0) if dim is not None else t.expand(n, *t.shape)
            return t.reshape(n * t.shape[1], *t.shape[2:]).contiguous()

        args = [fold(t, d) for t, d in zip((q, k, v, key_valid), in_dims[:4])]
        out = AttentionFunction.apply(*args, temperature)
        return out.view(n, out.shape[0] // n, *out.shape[1:]), 0


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
    if torch.is_grad_enabled():     # autograd or a torch.func transform may be tracing
        return AttentionFunction.apply(q, k, v, key_valid, temperature)
    return attention_cuda(q, k, v, key_valid, temperature)
