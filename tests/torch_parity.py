"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

One small configuration is built in both packages from the same arguments;
the JAX BaselineSystem is initialised by fscl_tpu's own init, and its
variables are carried to the port by `fscl_tpu_torch.convert`.
"""
from __future__ import annotations

import dataclasses
import math

import flax.linen

import jax
import jax.numpy as jnp
import numpy as np

import fscl_tpu.core.config as jax_config
import fscl_tpu_torch.core.config as torch_config
from fscl_tpu.core.config import OptimConfig
from fscl_tpu.data.batch import Batch
from fscl_tpu.systems.baseline import BaselineSystem as JaxBaseline
from fscl_tpu_torch.convert import baseline_state_dict
from fscl_tpu_torch.systems.baseline import BaselineSystem as TorchBaseline

N_SYMBOLS = 152            # the en table
ID2SYMBOLS = (("en", N_SYMBOLS),)
N_SPEAKERS = 4
FRAMES_PER_PHONEME = 4.0


def make_cfg(C, **variance):
    """The test configuration in config module C (either package's):
    2 + 2 layers, d_model 64 with 2 heads, filter 128, n_bins 16."""
    return C.ModelConfig(
        transformer=C.TransformerConfig(
            encoder_layer=2, decoder_layer=2, encoder_hidden=64,
            decoder_hidden=64, encoder_head=2, decoder_head=2,
            conv_filter_size=128),
        variance_predictor=C.VariancePredictorConfig(filter_size=64),
        variance_embedding=C.VarianceEmbeddingConfig(n_bins=16),
        variance=C.VarianceConfig(**variance),
        max_seq_len=64,
        speaker=C.SpeakerConfig(n_speakers=N_SPEAKERS))


def jax_cfg(**variance):
    return make_cfg(jax_config, **variance)


def torch_cfg(**variance):
    return make_cfg(torch_config, **variance)


def init_jax_variables(cfg, seed: int = 0):
    """fscl_tpu's own init, as numpy, with non-trivial BatchNorm statistics
    and the duration head pinned near log(FRAMES_PER_PHONEME) (bias set, the
    random kernel scaled down) so the decoder sees realistic lengths."""
    rng = np.random.default_rng(seed)
    B, L, T = 2, 8, 32
    batch = Batch(
        speaker_args=np.zeros(B, np.int32),
        texts=rng.integers(1, N_SYMBOLS, (B, L)).astype(np.int32),
        src_lens=np.full((B,), L, np.int32),
        mels=np.zeros((B, T, 80), np.float32),
        mel_lens=np.full((B,), T, np.int32),
        pitches=np.zeros((B, L), np.float32),
        energies=np.zeros((B, L), np.float32),
        durations=np.full((B, L), 4, np.int32),
        lang_ids=np.zeros(B, np.int32))
    system = JaxBaseline(cfg, OptimConfig(), ID2SYMBOLS)
    variables = jax.tree.map(np.asarray, system.init_variables(
        jax.random.PRNGKey(seed), batch))
    for bn in variables["batch_stats"]["model"]["postnet"].values():
        bn["mean"] = rng.normal(0.0, 0.2, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    for bn in variables["params"]["model"]["postnet"].values():
        if "scale" in bn:
            bn["scale"] = rng.uniform(0.5, 1.5, bn["scale"].shape).astype(np.float32)
            bn["bias"] = rng.normal(0.0, 0.2, bn["bias"].shape).astype(np.float32)
    lin = variables["params"]["model"]["variance_adaptor"]["duration_predictor"]["linear_layer"]
    lin["bias"] = (lin["bias"] + math.log(FRAMES_PER_PHONEME)).astype(np.float32)
    lin["kernel"] = (lin["kernel"] * 0.25).astype(np.float32)
    return system, variables


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def torch_system(cfg, variables):
    system = TorchBaseline(cfg, ID2SYMBOLS, device="cpu")
    system.load_state_dict(baseline_state_dict(variables), strict=True)
    return system


def make_texts(rng, lens, L):
    """(B, L) ids in [1, N_SYMBOLS) padded with 0 past each length."""
    texts = rng.integers(1, N_SYMBOLS, (len(lens), L))
    texts[np.arange(L)[None, :] >= np.asarray(lens)[:, None]] = 0
    return texts.astype(np.int32), np.asarray(lens, np.int32)


class Losses:
    """A trainer callback that keeps every logged total loss."""

    def __init__(self):
        self.losses = []

    def on_log(self, step, metrics, **kw):
        self.losses.append(float(metrics["Total Loss"]))

    def on_validation(self, step, metrics):
        pass

    def on_save(self, step, state):
        pass


class NoDropout(flax.linen.Module):
    """flax's Dropout as the identity: JAX's dropout draws cannot be
    reproduced, so parity runs patch `flax.linen.Dropout` with this."""
    rate: float = 0.0

    @flax.linen.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


def _fields(x):
    if hasattr(x, "_fields"):
        return {f: getattr(x, f) for f in x._fields}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    return None


def same(got, want, where="item"):
    """Exact equality of two nested structures: the port's NamedTuples
    against fscl_tpu's NamedTuples or flax structs (field by field), arrays
    by dtype, shape and every value."""
    if got is None or want is None:
        assert got is None and want is None, where
        return
    gf, wf = _fields(got), _fields(want)
    if gf is not None or wf is not None:
        assert gf is not None and wf is not None and list(gf) == list(wf), where
        for k in gf:
            same(gf[k], wf[k], f"{where}.{k}")
        return
    if isinstance(got, dict):
        assert isinstance(want, dict) and sorted(got) == sorted(want), where
        for k in got:
            same(got[k], want[k], f"{where}[{k!r}]")
        return
    if isinstance(got, (list, tuple)) and not isinstance(want, np.ndarray):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            same(a, b, f"{where}[{i}]")
        return
    if isinstance(got, np.ndarray) or isinstance(want, (np.ndarray, jax.Array)):
        a, b = np.asarray(got), np.asarray(want)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), where
        return
    assert type(got) is type(want) and got == want, (where, got, want)


# -- the T2U family: fscl_tpu's dropout masks, rebuilt for the port ------------

def t2u_scan_masks(cfg, r_scan, B: int, T: int, train: bool, infer: bool = False,
                   encoder=None):
    """The port's `T2UMasks` equal to the masks fscl_tpu's TacoT2U draws from
    `r_scan` over T steps: each step folds t into the key, splits it (three
    ways in the teacher-forced scan, two in `infer`), and the prenet and
    (in train mode) the cell split their key once per draw. `encoder`: the
    encoder's Dropout masks, captured with `capture_dropout`."""
    import torch
    from fscl_tpu_torch.models.tacotron2_t2u import T2UMasks

    pre, att, dec = [], [], []
    for t in range(T):
        step = jax.random.fold_in(r_scan, t)
        if infer:
            r_pre, r_cell = jax.random.split(step)
        else:
            _, r_pre, r_cell = jax.random.split(step, 3)
        keys = []
        for _ in range(2):
            r_pre, sub = jax.random.split(r_pre)
            keys.append(np.asarray(jax.random.bernoulli(sub, 0.5, (B, cfg.prenet_dim))))
        pre.append(np.stack(keys))
        if train:
            r_cell, sub = jax.random.split(r_cell)
            att.append(np.asarray(jax.random.bernoulli(
                sub, 1 - cfg.p_attention_dropout, (B, cfg.attention_rnn_dim))))
            r_cell, sub = jax.random.split(r_cell)
            dec.append(np.asarray(jax.random.bernoulli(
                sub, 1 - cfg.p_decoder_dropout, (B, cfg.decoder_rnn_dim))))
    as_t = lambda xs: torch.from_numpy(np.stack(xs)) if xs else None
    return T2UMasks(prenet=as_t(pre), attention=as_t(att), decoder=as_t(dec),
                    encoder=None if encoder is None else torch.from_numpy(encoder))


def capture_dropout(fn):
    """Run fn() eagerly and return (its result, the keep masks of every
    flax Dropout it called that was not deterministic, stacked). Each such
    call draws its mask once, on an input of ones (so the mask is where the
    output is not 0), and applies it to the real input."""
    captured = []

    def interceptor(next_fun, args, kwargs, context):
        module = context.module
        if not (isinstance(module, flax.linen.Dropout) and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        det = kwargs.get("deterministic", args[1] if len(args) > 1 else None)
        if det is None:
            det = module.deterministic
        if det or module.rate == 0:
            return next_fun(*args, **kwargs)
        x = args[0]
        keep = next_fun(jnp.ones_like(x), *args[1:], **kwargs) != 0
        captured.append(np.asarray(keep))
        return jnp.where(keep, x / (1.0 - module.rate), 0.0)

    with flax.linen.intercept_methods(interceptor):
        out = fn()
    return out, (np.stack(captured) if captured else None)
