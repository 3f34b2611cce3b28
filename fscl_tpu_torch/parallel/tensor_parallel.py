"""Tensor parallelism over the mesh's `model` axis (port of
`fscl_tpu/parallel/tensor_parallel.py`).

Megatron column / row sharding: the conv-FFN's inner dimension and the
attention's heads are split over the model ranks, so each rank holds a
1 / n_model slice of those weights (and of their Adam moments) and computes
its heads and its FFN channels. fscl_tpu states the split as
PartitionSpecs and XLA inserts the collectives; here the spec functions
name the sharded dimension of each `state_dict` key (None: replicated),
`shard_state` cuts the parameters and the optimizer's state in place and
swaps in the layers' tensor-parallel forwards, which carry the two
collectives of each column / row pair: the input enters the column-parallel
products through `copy_to_model` (identity; its backward sums the ranks'
partial input gradients) and the row-parallel product's partial sums leave
through `reduce_from_model` (a sum over the model ranks; identity backward),
after which the bias is added once.

    mesh = make_mesh(n_data=4, n_model=2)
    shard_state(system, state, mesh)
    step = make_tp_train_step(system, mesh)

The port has the per-layer upstream layout only: fscl_tpu's scanned layout
(`layers.*` with a leading layer axis) has no counterpart here. Nor has
`state_shardings`, whose NamedShardings no torch object stands for:
`shard_state` cuts the state directly.
"""
from __future__ import annotations

import re
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from fscl_tpu_torch.models.hubert import FeedForward, SelfAttention, gelu
from fscl_tpu_torch.nn.fft_block import ConvFFN, MultiHeadAttention, conv_nlc, dense
from fscl_tpu_torch.ops.attention import attend
from fscl_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, all_reduce_
from fscl_tpu_torch.train.optim import global_norm

SpecFn = Callable[[str, Optional[torch.Tensor]], Optional[int]]


def fastspeech2_param_spec(name: str, tensor=None) -> Optional[int]:
    """FastSpeech2 `state_dict` key -> its dimension sharded over the model
    axis. Column-parallel (fscl_tpu's spec in brackets):
    `pos_ffn.w_1.weight` (d_inner, d_model, k): 0 [`pos_ffn.w_1.kernel`
    (k, d_model, d_inner): P(None, None, model)]; `pos_ffn.w_1.bias`: 0 [P(model)];
    `slf_attn.w_{q,k,v}s.weight` (heads * dh, d_model): 0 [kernel (d_model,
    heads * dh): P(None, model)] and their biases: 0. Row-parallel:
    `pos_ffn.w_2.weight` (d_model, d_inner, k): 1 [kernel (k, d_inner,
    d_model): P(None, model, None)]; `slf_attn.fc.weight` (d_model,
    heads * dh): 1 [kernel: P(model, None)]. Everything else replicated."""
    if re.search(r"(pos_ffn\.w_1|slf_attn\.w_[qkv]s)\.(weight|bias)$", name):
        return 0
    if re.search(r"(pos_ffn\.w_2|slf_attn\.fc)\.weight$", name):
        return 1
    return None


def upstream_param_spec(name: str, tensor=None) -> Optional[int]:
    """SSL upstream (HF `HubertModel` keys) -> sharded dimension, fscl_tpu's
    per-layer rules: `attention.{q,k,v}_proj` [`layer_i.{q,k,v}_proj`] and
    `feed_forward.intermediate_dense` [`fc1`] column-parallel (weight and
    bias: 0), `attention.out_proj` and `feed_forward.output_dense` [`fc2`]
    row-parallel (weight: 1). The conv extractor, the norms and the
    positional conv stay replicated."""
    if re.search(r"(attention\.[qkv]_proj|feed_forward\.intermediate_dense)\.(weight|bias)$",
                 name):
        return 0
    if re.search(r"(attention\.out_proj|feed_forward\.output_dense)\.weight$", name):
        return 1
    return None


def frozen_spec(name: str, tensor=None) -> Optional[int]:
    """A system's frozen upstream (`upstream.*`) by `upstream_param_spec`;
    anything else replicated."""
    if name.startswith("upstream."):
        return upstream_param_spec(name[len("upstream."):], tensor)
    return None


def shard_tensor(t: torch.Tensor, dim: Optional[int], n: int, index: int) -> torch.Tensor:
    """Rank `index` of `n`'s slice of `t` along `dim` (all of it when None)."""
    if dim is None:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split over {n} ranks")
    size = t.shape[dim] // n
    return t.narrow(dim, index * size, size).clone()


# -- the two collectives of a column / row pair --------------------------------------

# each one's backward is the other, so that a second derivative crosses the
# model ranks as the first does

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ReduceFromModel.apply(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _CopyToModel.apply(g, ctx.group), None


def copy_to_model(x, group):
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    return _ReduceFromModel.apply(x, group)


def _row(layer, x, group, dtype=None):
    """A row-parallel Linear: the local partial product summed over the
    model ranks, then the (replicated) bias, in `dtype` when given."""
    w = layer.weight if dtype is None else layer.weight.to(dtype)
    y = reduce_from_model(F.linear(x if dtype is None else x.to(dtype), w), group)
    return y + (layer.bias if dtype is None else layer.bias.to(dtype))


# -- the layers' tensor-parallel forwards ----------------------------------------------

class TPMultiHeadAttention(MultiHeadAttention):
    """`MultiHeadAttention` over this rank's heads (`n_head` local)."""
    tp_group = None

    def forward(self, x, key_valid=None, return_weights: bool = False):
        if return_weights:
            raise ValueError("tensor-parallel attention does not return its weights")
        B, L, _ = x.shape
        h = copy_to_model(x, self.tp_group)

        def split(t):
            return t.view(B, L, self.n_head, self.d_k).transpose(1, 2).contiguous()

        dt = self.dtype
        out = attend(split(dense(self.w_qs, h, dt)), split(dense(self.w_ks, h, dt)),
                     split(dense(self.w_vs, h, dt)), key_valid=key_valid,
                     temperature=self.d_k ** 0.5)
        out = out.transpose(1, 2).reshape(B, L, self.n_head * self.d_k)
        out = self.dropout(_row(self.fc, out, self.tp_group, dt))
        return self.layer_norm(out + x), None


class TPConvFFN(ConvFFN):
    """`ConvFFN` over this rank's inner channels."""
    tp_group = None

    def forward(self, x):
        h = torch.relu(conv_nlc(self.w_1, copy_to_model(x, self.tp_group), self.dtype))
        w2, dt = self.w_2, self.dtype
        y = F.conv1d(h.transpose(1, 2) if dt is None else h.transpose(1, 2).to(dt),
                     w2.weight if dt is None else w2.weight.to(dt), None, w2.stride,
                     w2.padding, w2.dilation, w2.groups)
        y = reduce_from_model(y, self.tp_group)
        y = y + (w2.bias if dt is None else w2.bias.to(dt))[:, None]
        return self.layer_norm(self.dropout(y.transpose(1, 2)) + x)


class TPSelfAttention(SelfAttention):
    """HuBERT's `SelfAttention` over this rank's heads."""
    tp_group = None
    head_dim = 64

    def forward(self, x, valid):
        B, L, _ = x.shape
        h = copy_to_model(x, self.tp_group)

        def split(t):
            return t.view(B, L, self.n_heads, self.head_dim).transpose(1, 2).contiguous()

        o = attend(split(self.q_proj(h)), split(self.k_proj(h)), split(self.v_proj(h)),
                   key_valid=valid, temperature=self.head_dim ** 0.5)
        o = o.transpose(1, 2).reshape(B, L, self.n_heads * self.head_dim)
        return _row(self.out_proj, o, self.tp_group)


class TPFeedForward(FeedForward):
    tp_group = None

    def forward(self, x):
        h = gelu(self.intermediate_dense(copy_to_model(x, self.tp_group)))
        return _row(self.output_dense, h, self.tp_group)


_TP_CLASSES = {MultiHeadAttention: TPMultiHeadAttention, ConvFFN: TPConvFFN,
               SelfAttention: TPSelfAttention, FeedForward: TPFeedForward}


def _to_tp(module: torch.nn.Module, n: int, group) -> None:
    """Swap a layer's class for its tensor-parallel forward, its head count
    to this rank's."""
    if isinstance(module, MultiHeadAttention):
        if module.n_head % n:
            raise ValueError(f"{module.n_head} heads do not split over {n} model ranks")
        module.n_head //= n
    elif isinstance(module, SelfAttention):
        if module.n_heads % n:
            raise ValueError(f"{module.n_heads} heads do not split over {n} model ranks")
        module.head_dim = module.q_proj.out_features // module.n_heads
        module.n_heads //= n
    module.__class__ = _TP_CLASSES[type(module)]
    module.tp_group = group


@torch.no_grad()
def shard_state(system, state, mesh: Mesh, spec_fn: SpecFn = fastspeech2_param_spec,
                frozen_spec_fn: SpecFn = frozen_spec):
    """Cut `system`'s parameters (by `spec_fn`; the frozen upstream's by
    `frozen_spec_fn`) to this rank's model-axis shards, in place: the Adam
    moments (and accumulators) of a sharded parameter follow its shard,
    the layers that hold sharded weights take their tensor-parallel
    forwards, and the optimizer's global norm adds the other ranks' shards.
    Returns `state`."""
    n, index = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
    group = mesh.group(MODEL_AXIS)
    opt = system.optimizer
    slot = {id(p): i for i, p in enumerate(opt.params)}
    sharded = set()
    owners = set()
    for name, p in system.named_parameters():
        dim = frozen_spec_fn(name, p) if name.startswith("upstream.") else spec_fn(name, p)
        if dim is None:
            continue
        i = slot.get(id(p))
        p.data = shard_tensor(p.data, dim, n, index)
        if i is not None:
            sharded.add(i)
            st = state.opt_state
            for moments in (st.mu, st.nu, st.work, st.acc):
                if moments:
                    moments[i] = shard_tensor(moments[i], dim, n, index)
        owners.add(name.rsplit(".", 2)[0])
    for name, module in system.named_modules():
        if type(module) in _TP_CLASSES and name in owners:
            _to_tp(module, n, group)

    def tp_norm(grads):
        shard_sq = sum((grads[i].float() ** 2).sum() for i in sharded) if sharded \
            else grads[0].new_zeros(())
        rest = [g for i, g in enumerate(grads) if i not in sharded]
        rest_sq = global_norm(rest) ** 2 if rest else shard_sq * 0
        return torch.sqrt(rest_sq + all_reduce_(shard_sq, group))

    opt.grad_norm = tp_norm
    system.tp_mesh = mesh
    return state


def make_tp_train_step(system, mesh: Mesh) -> Callable:
    """The data-parallel step over a system `shard_state` has sharded: the
    model ranks of a data row compute one step together, the data rows'
    gradients are averaged."""
    from fscl_tpu_torch.train.trainer import make_parallel_train_step
    if getattr(system, "tp_mesh", None) is not mesh:
        raise ValueError("shard_state(system, state, mesh) first")
    return make_parallel_train_step(system, mesh)

