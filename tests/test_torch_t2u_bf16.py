"""The FSCL-T2U table with the upstream stored in bf16
(`upstream.compute_dtype: bfloat16`), port against fscl_tpu on the CPU.

At a tiny width (test_torch_t2u.py's T2U and support set) with a custom
upstream of dim 256 and 2 layers: 16 channels per group in the positional
conv, above the 8 where torch's CPU bf16 grouped conv goes wrong. Both
packages cast the frozen upstream's weights to bf16 once (`storage_cast`,
`FrozenUpstream._store_upstream`) and return f32 hidden states; Downstream1,
the segment means and the table are f32. The two round inside the upstream
at different places (XLA's fused bf16 ops against torch's op by op), so the
table is held to BF16_TABLE_REL of its largest |entry| (measured 1.1e-2):
one bf16 rounding (2^-8) grown over 2 layers, as tests/test_torch_hubert.py
holds the bf16 hidden states to 4e-2. The f32 tables of the same weights
are held to 1e-5, and each package's bf16 table to its own f32 one within
the 0.1 that chip_smoke.py holds the card's bf16 table to.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fscl_tpu.core.config as jax_config
import fscl_tpu_torch.core.config as torch_config
from fscl_tpu.models.hubert import storage_cast
from fscl_tpu.systems import t2u as J
from fscl_tpu_torch import convert
from fscl_tpu_torch.data.batch import to_device
from fscl_tpu_torch.systems import t2u as P

from test_torch_t2u import JCFG, N_SYM, PCFG, _jsup, _model_cfg, _np, _support

BF16_TABLE_REL = 4e-2
F32_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfg(C, dtype):
    cfg = _model_cfg(C)
    return dataclasses.replace(cfg, upstream=C.UpstreamConfig(
        name="custom", dim=256, n_layers=3, compute_dtype=dtype))


@pytest.fixture(scope="module")
def tables():
    """Each package's table of one support set, upstream in f32 and in bf16,
    from one set of weights (fscl_tpu's upstream init, the port's
    Downstream1)."""
    sup = _support(6)
    jup = J.make_upstream("custom", _cfg(jax_config, "float32").upstream)
    up_params = _np(jax.jit(jup.init)(jax.random.PRNGKey(2), jnp.zeros((1, 4000))))
    torch.manual_seed(3)
    out = {}
    params = None
    for dtype in ("float32", "bfloat16"):
        psys = P.TransEmbT2USystem(_cfg(torch_config, dtype), N_SYM, PCFG, device="cpu")
        if params is None:
            params = convert.t2u_variables(psys.state_dict())["params"]
            generator = {k: v for k, v in psys.state_dict().items()
                         if not k.startswith("upstream.")}
        psys.load_state_dict(generator, strict=False)
        psys.load_upstream(convert.hubert_state_dict(up_params))
        assert next(psys.upstream.parameters()).dtype == getattr(torch, dtype)
        s = to_device(sup, "cpu")
        with torch.no_grad():
            hidden, _ = psys.extract_ssl(s.wavs, s.wav_lens)
            port = psys.build_embedding_table(hidden, s).numpy()
        jsys = J.TransEmbT2USystem(_cfg(jax_config, dtype), jax_config.OptimConfig(), N_SYM,
                                   JCFG)
        jsys.upstream_params = storage_cast(jax.tree.map(jnp.asarray, up_params), dtype)
        jhidden, _ = jsys.extract_ssl(jnp.asarray(sup.wavs), jnp.asarray(sup.wav_lens))
        want = np.asarray(jsys.build_embedding_table(jax.tree.map(jnp.asarray, params),
                                                     jhidden, _jsup(sup)))
        out[dtype] = (port, want)
    return out


def test_f32_upstream_table_matches_fscl_tpu(tables):
    port, want = tables["float32"]
    np.testing.assert_allclose(port, want, atol=F32_ATOL, rtol=0)


def test_bf16_upstream_table_matches_fscl_tpu(tables):
    port, want = tables["bfloat16"]
    assert port.dtype == np.float32
    assert port.shape == want.shape == (N_SYM, PCFG.symbols_embedding_dim)
    rel = np.abs(port - want).max() / np.abs(want).max()
    assert rel <= BF16_TABLE_REL, rel
    # the bf16 upstream moves each package's table by less than the card's bar
    for side in (0, 1):
        f32 = tables["float32"][side]
        assert 0 < np.abs(tables["bfloat16"][side] - f32).max() / np.abs(f32).max() <= 0.1
