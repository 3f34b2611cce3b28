"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

One small configuration is built in both packages from the same arguments;
the JAX BaselineSystem is initialised by fscl_tpu's own init, and its
variables are carried to the port by `fscl_tpu_torch.convert`.
"""
from __future__ import annotations

import math

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
