"""Seeding, the bf16 compute policy and remat of the port against fscl_tpu,
on the CPU.

- `core/prng.py` and `utils/tool.py`: the same values as fscl_tpu's on the
  same inputs (the host RNGs draw alike; `RngStream` hands out torch
  generators in a fixed order from one seed).
- `train/precision.py`: `cast_params_bf16` keeps the same leaves in f32 as
  fscl_tpu's, mapped through the converters (FastSpeech2, HuBERT in both
  extractor modes, the T2U model and Downstream1).
- `compute_dtype: bfloat16`: one forward of FastSpeech2 against fscl_tpu's
  bf16 forward, on the same weights. Bars: mean |d| over valid frames 2e-3
  and max 3e-2 on postnet_mel (measured 1.3e-3 and 1.4e-2 at a largest
  |value| of 3.6: one bf16 ulp, as XLA fuses elementwise ops without
  rounding between them where torch rounds each op); the f32 port sits
  4.3e-3 from fscl_tpu's bf16 (mean), so the mean bar tells bf16 from f32.
  The variance predictors stay f32 in both (1e-5).
- the trajectory: 25 train steps of the port in bf16 against fscl_tpu's in
  bf16 and against the port's f32, at `tests/test_precision_parity.py`'s
  configuration and bars (first loss 2 %, last 8 %, any step 15 %). The
  port's attention backward recomputes in f32 where fscl_tpu differentiates
  its bf16 `xla_attention`, a gradient difference of bf16 rounding (below
  1e-2 relative), which these bars allow. Every dropout is off: JAX's draws
  cannot be reproduced (`tests/test_torch_train.py`). The optimizer runs at
  lr 1e-4 and eps 1e-3, the repo's rate for trajectories held across two
  implementations (`tests/test_torch_train.py`'s docstring): at
  test_precision_parity.py's lr 2e-3 with every dropout off, one batch
  repeated makes the loss oscillate and fscl_tpu's own bf16 run ends 48 %
  from its f32 run (2.97 against 2.00 at step 25, measured on the CPU), so
  no two runs of it can be held to 8 % there; at 1e-4 the four runs (either
  package, either dtype) stay within 0.3 % of each other.
- remat: the loss and every gradient equal to the run without remat, at
  `tests/test_remat.py`'s bars (loss rtol 1e-6; gradients rtol 1e-5, atol
  1e-6), with dropout on (the masks replay) and with the attention routed
  through `AttentionFunction` (its forward launched again by the
  recompute); a second-order MAML step (`systems/maml.py:inner_adapt`
  through `functional_call`) equal to the one without remat; and a clear
  error under a `torch.func` transform, where torch's checkpoint cannot run.
"""
import dataclasses
import random

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call, grad, vmap

import fscl_tpu.core.config as jax_config
import fscl_tpu.core.prng as jprng
import fscl_tpu.utils as jutils
import fscl_tpu_torch.core.config as torch_config
import fscl_tpu_torch.core.prng as tprng
import fscl_tpu_torch.nn.fft_block as tfft
import fscl_tpu_torch.utils as tutils
from fscl_tpu.data.batch import Batch as JaxBatch
from fscl_tpu.models.hubert import SSLUpstream as JaxUpstream
from fscl_tpu.systems.baseline import BaselineSystem as JaxBaseline
from fscl_tpu.train.precision import cast_params_bf16 as jax_cast_params_bf16
from fscl_tpu_torch.core.stats import DEFAULT_STATS
from fscl_tpu_torch.convert import (
    baseline_state_dict, downstream_entries, hubert_state_dict, tacot2u_entries,
    variables_from,
)
from fscl_tpu_torch.data.batch import Batch
from fscl_tpu_torch.models.fastspeech2 import FastSpeech2
from fscl_tpu_torch.models.hubert import SSLUpstream
from fscl_tpu_torch.models.tacotron2_t2u import T2UConfig, TacoT2U
from fscl_tpu_torch.nn.downstreams import Downstream1
from fscl_tpu_torch.ops import attention as tattn
from fscl_tpu_torch.systems.baseline import BaselineSystem
from fscl_tpu_torch.systems.maml import inner_adapt
from fscl_tpu_torch.train.precision import cast_floating, cast_params_bf16, norm_parameter_names
from torch_parity import init_jax_variables, make_cfg, make_texts, to_jax, torch_system

FWD_MEAN, FWD_MAX, VAR_ATOL = 2e-3, 3e-2, 1e-5
REMAT_LOSS_RTOL, REMAT_GRAD_RTOL, REMAT_GRAD_ATOL = 1e-6, 1e-5, 1e-6
N_SYM = 40


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """torch on 2 threads: tier-1 runs six test processes on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# -- prng and tool -------------------------------------------------------------

def test_tool_matches_fscl_tpu():
    rng = np.random.default_rng(0)
    seq, dur = list("abcde"), [2, 0, 3, 1, 0]
    assert tutils.expand(seq, dur) == jutils.expand(seq, dur)
    reprs = rng.normal(size=(2, 7, 3)).astype(np.float32)
    for n in (4, 7, 10):
        got, want = tutils.ssl_match_length(reprs, n), jutils.ssl_match_length(reprs, n)
        assert got.shape == want.shape and np.array_equal(got, want)
    seqs = [np.arange(3, dtype=np.int32), np.arange(5, dtype=np.int32), np.arange(1, dtype=np.int32)]
    for value in (0, -1):
        got, want = tutils.pad_1d_list(seqs, value), jutils.pad_1d_list(seqs, value)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    draws = []
    for mod in (tutils, jutils):
        random.seed(5)
        np.random.seed(5)
        with mod.seed_all(11):
            inside = (random.random(), np.random.rand())
        draws.append((inside, random.random(), np.random.rand()))
    assert draws[0] == draws[1]          # same draws inside, state restored after


def test_prng_streams():
    """The host generators draw as fscl_tpu's; an RngStream's n-th generator
    is the same from the same seed, on the device asked for, and its
    generators draw apart."""
    assert tprng.py_rng(7).random() == jprng.py_rng(7).random()
    assert np.array_equal(tprng.np_rng(7).normal(size=5), jprng.np_rng(7).normal(size=5))
    a, b = tprng.RngStream(3), tprng.RngStream(3, device="cpu")
    ga, gb = a.next_n(3), b.next_n(3)
    for x, y in zip(ga, gb):
        assert x.device == torch.device("cpu")
        assert torch.equal(torch.rand(4, generator=x), torch.rand(4, generator=y))
    d = [torch.rand(4, generator=g) for g in tprng.RngStream(3).next_n(3)]
    assert not torch.equal(d[0], d[1]) and not torch.equal(d[1], d[2])
    assert not torch.equal(torch.rand(4, generator=tprng.RngStream(4).next()), d[0])


# -- cast_params_bf16: the same f32 set ---------------------------------------

def _indicators(tree):
    """1 where fscl_tpu's cast kept a leaf in f32, 0 where it cast it."""
    return jax.tree.map(lambda x: np.full(np.shape(x), float(x.dtype == jnp.float32),
                                          np.float32), tree)


def _kept_by_state_dict(sd, names):
    return {n for n in names if bool(torch.all(sd[n] == 1))}


def _kept_by_entries(entries, cast):
    kept = set()
    for key, path, layout in entries:
        if not path or path[0] != "params":
            continue
        sub = cast
        for k in path:
            sub = sub[k]
        if all(x.dtype == jnp.float32 for x in jax.tree.leaves(sub)):
            kept.add(key)
    return kept


def _port_keep(module):
    keep = norm_parameter_names(module)
    cast = cast_params_bf16(module)
    assert set(cast) == {n for n, _ in module.named_parameters()}
    for n, t in cast.items():       # the map's dtypes are the set's
        assert t.dtype == (torch.float32 if n in keep else torch.bfloat16), n
    return keep


@pytest.mark.parametrize("model", ["fastspeech2", "hubert-group_norm", "hubert-layer_norm",
                                   "tacot2u", "downstream1"])
def test_cast_params_bf16_keeps_the_same_leaves_in_f32(model):
    if model == "fastspeech2":
        _, variables = init_jax_variables(make_cfg(jax_config))
        ind = {"params": _indicators(jax_cast_params_bf16(to_jax(variables["params"]))),
               "batch_stats": variables["batch_stats"]}
        tsys = torch_system(make_cfg(torch_config), variables)
        names = [n for n, _ in tsys.named_parameters()]
        want = _kept_by_state_dict(baseline_state_dict(ind), names)
        got = _port_keep(tsys)
    elif model.startswith("hubert"):
        mode = model.split("-")[1]
        kw = dict(dim=16, n_layers=2, n_heads=2, ffn_dim=32, pos_conv_kernel=4,
                  pos_conv_groups=2, extractor_mode=mode)
        wav = jnp.zeros((1, 1600))
        shapes = jax.eval_shape(JaxUpstream(**kw).init, jax.random.PRNGKey(0), wav)["params"]
        params = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), shapes)
        port = SSLUpstream(**kw)
        names = [n for n, _ in port.named_parameters()]
        want = _kept_by_state_dict(hubert_state_dict(_indicators(jax_cast_params_bf16(params))),
                                   names)
        got = _port_keep(port)
        # the feature extractor's norms are cast in both (conv_ln_* / group_norm)
        assert not any(n.startswith("feature_extractor.") for n in got)
        assert any(".layer_norm." in n for n in names if n.startswith("feature_extractor."))
    else:
        if model == "tacot2u":
            port = TacoT2U(T2UConfig(n_units=16, d_unit=8, symbols_embedding_dim=8,
                                     encoder_embedding_dim=16, prenet_dim=8,
                                     attention_rnn_dim=16, decoder_rnn_dim=16, attention_dim=8,
                                     attention_location_n_filters=4,
                                     attention_location_kernel_size=5))
            entries = tacot2u_entries()
        else:
            port = Downstream1(3, 12, d_model=16, n_head=2, d_ff=(32, 32))
            entries = downstream_entries(2, False)
        variables = variables_from(entries, port.state_dict())
        cast = {"params": jax_cast_params_bf16(to_jax(variables["params"]))}
        names = {n for n, _ in port.named_parameters()}
        want = _kept_by_entries(entries, cast) & names
        got = _port_keep(port)
    assert got == want, (sorted(got ^ want))
    assert got, "some norm leaves are kept"


def test_cast_floating():
    tree = {"a": torch.ones(2), "b": [torch.ones(2, dtype=torch.int64), (torch.ones(1),)],
            "c": Batch(*(torch.ones(1) for _ in Batch._fields)), "d": 3}
    out = cast_floating(tree, torch.bfloat16)
    assert out["a"].dtype == torch.bfloat16 and out["b"][0].dtype == torch.int64
    assert out["b"][1][0].dtype == torch.bfloat16 and out["d"] == 3
    assert isinstance(out["c"], Batch) and out["c"].mels.dtype == torch.bfloat16


# -- the bf16 forward ----------------------------------------------------------

def _forward_batch(seed=1, B=3, L=16, T=64):
    rng = np.random.default_rng(seed)
    texts, lens = make_texts(rng, [16, 11, 6], L)
    dur = rng.integers(1, 5, (B, L)).astype(np.int32)
    dur[texts == 0] = 0
    return dict(speaker_args=rng.integers(0, 4, B).astype(np.int32), texts=texts, src_lens=lens,
                mels=rng.normal(size=(B, T, 80)).astype(np.float32),
                mel_lens=np.minimum(dur.sum(1), T).astype(np.int32),
                pitches=rng.normal(size=(B, L)).astype(np.float32),
                energies=rng.normal(size=(B, L)).astype(np.float32),
                durations=dur, lang_ids=np.zeros(B, np.int32))


def test_bf16_forward_matches_fscl_tpu_bf16():
    b = _forward_batch()
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in b.items()})
    tb = Batch(**{k: torch.from_numpy(v) for k, v in b.items()})
    jsys, variables = init_jax_variables(
        dataclasses.replace(make_cfg(jax_config), compute_dtype="bfloat16"))
    jout, _ = jsys.forward(to_jax(variables["params"]), to_jax(variables["batch_stats"]), jb)
    outs = {}
    for dtype in ("float32", "bfloat16"):
        tsys = torch_system(dataclasses.replace(make_cfg(torch_config), compute_dtype=dtype),
                            variables)
        with torch.no_grad():
            outs[dtype] = tsys(tb)
    tout = outs["bfloat16"]
    for f in ("mel", "postnet_mel", "pitch_prediction", "log_duration_prediction"):
        assert getattr(tout, f).dtype == torch.float32, f       # f32 outputs, f32 loss
        assert np.asarray(getattr(jout, f)).dtype == np.float32, f
    valid = np.asarray(jout.mel_valid)[..., None]

    def mean_abs(a, c):
        return float((np.abs(np.asarray(a, np.float32) - c) * valid).sum() / (valid.sum() * 80))

    got = tout.postnet_mel.numpy()
    assert mean_abs(jout.postnet_mel, got) < FWD_MEAN
    assert np.abs((np.asarray(jout.postnet_mel) - got) * valid).max() < FWD_MAX
    # the bar tells bf16 from f32: the port's f32 forward misses it
    assert mean_abs(jout.postnet_mel, outs["float32"].postnet_mel.numpy()) > 2 * FWD_MEAN
    for f in ("pitch_prediction", "energy_prediction", "log_duration_prediction"):
        np.testing.assert_allclose(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)),
                                   atol=VAR_ATOL, rtol=0, err_msg=f)


def test_bf16_policy_runs_the_blocks_in_bf16_and_the_norms_in_f32():
    """The attention sees bf16 q, k, v; the residual stream, the LayerNorms'
    inputs, mel_linear and the PostNet's BatchNorm outputs are f32."""
    cfg = dataclasses.replace(make_cfg(torch_config), compute_dtype="bfloat16")
    model = FastSpeech2(cfg, DEFAULT_STATS)
    seen = {}

    def hook(name):
        def f(mod, args, out):
            seen.setdefault(name, set()).add(args[0].dtype)
        return f

    for name, mod in model.named_modules():
        if isinstance(mod, (torch.nn.LayerNorm, tfft.BatchNorm)) or name == "mel_linear":
            mod.register_forward_hook(hook(type(mod).__name__ if name != "mel_linear" else name))
    dtypes = []
    orig = tfft.attend
    try:
        tfft.attend = lambda q, k, v, **kw: dtypes.append(q.dtype) or orig(q, k, v, **kw)
        b = _forward_batch()
        with torch.no_grad():
            out = model(torch.randn(3, 16, 64), torch.from_numpy(b["src_lens"]), 64,
                        speaker_args=torch.zeros(3, dtype=torch.long),
                        lang_args=torch.zeros(3, dtype=torch.long))
    finally:
        tfft.attend = orig
    assert set(dtypes) == {torch.bfloat16} and len(dtypes) == 4
    assert seen["LayerNorm"] == {torch.float32}        # residual + bf16 sublayer -> f32
    assert seen["mel_linear"] == {torch.float32}
    assert seen["BatchNorm"] == {torch.bfloat16}       # a bf16 conv's output, normalised in f32
    assert out.postnet_mel.dtype == torch.float32


# -- the bf16 trajectory -------------------------------------------------------

class _NoDropout(flax.linen.Module):
    rate: float = 0.0

    @flax.linen.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


def _parity_cfg(C, dtype):
    """tests/test_precision_parity.py's configuration, the variance
    predictors' dropout off too."""
    return C.ModelConfig(
        transformer=C.TransformerConfig(
            encoder_layer=2, decoder_layer=2, encoder_hidden=64, decoder_hidden=64,
            conv_filter_size=128, encoder_head=2, decoder_head=2, encoder_dropout=0.0,
            decoder_dropout=0.0),
        variance_predictor=C.VariancePredictorConfig(dropout=0.0),
        max_seq_len=64, speaker=C.SpeakerConfig(n_speakers=4), compute_dtype=dtype)


def _parity_batch(rng, B=4, L=12, T=48):
    dur = rng.integers(1, 4, (B, L)).astype(np.int32)
    return dict(
        speaker_args=np.zeros(B, np.int32), texts=rng.integers(1, N_SYM, (B, L)).astype(np.int32),
        src_lens=np.full((B,), L, np.int32), mels=rng.normal(size=(B, T, 80)).astype(np.float32),
        mel_lens=np.minimum(dur.sum(1), T).astype(np.int32),
        pitches=rng.normal(size=(B, L)).astype(np.float32),
        energies=rng.normal(size=(B, L)).astype(np.float32),
        durations=dur, lang_ids=np.zeros(B, np.int32))


def _trajectory_bars(got, want):
    assert np.isfinite(got).all()
    assert abs(got[0] - want[0]) / want[0] < 0.02, (got[0], want[0])
    assert got[-1] < got[0] and want[-1] < want[0]
    assert abs(got[-1] - want[-1]) / want[-1] < 0.08, (got[-1], want[-1])
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-3)
    assert rel.max() < 0.15, rel.max()


def test_bf16_trajectory_matches_fscl_tpu_and_f32(monkeypatch):
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    kw = dict(lr=1e-4, eps=1e-3, betas=(0.9, 0.98), warmup_step=10, anneal_steps=())
    b = _parity_batch(np.random.default_rng(0))
    jsys = JaxBaseline(_parity_cfg(jax_config, "bfloat16"), jax_config.OptimConfig(**kw),
                       (("en", N_SYM),))
    jstate = jsys.init_state(jax.random.PRNGKey(0), JaxBatch(**b))
    variables = jax.tree.map(np.asarray, {"params": jstate.params,
                                          "batch_stats": jstate.batch_stats})
    step = jax.jit(jsys.train_step)
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in b.items()})
    want = []
    for _ in range(25):
        jstate, metrics = step(jstate, jb, jax.random.PRNGKey(1))
        want.append(float(metrics["Total Loss"]))
    curves = {}
    for dtype in ("bfloat16", "float32"):
        tsys = BaselineSystem(_parity_cfg(torch_config, dtype), (("en", N_SYM),), device="cpu",
                              optim_cfg=torch_config.OptimConfig(**kw))
        tsys.load_state_dict(baseline_state_dict(variables), strict=True)
        tsys.model.postnet.dropout.p = 0.0
        state = tsys.init_state()
        tb = Batch(**{k: torch.from_numpy(v) for k, v in b.items()})
        losses = []
        for _ in range(25):
            state, m = tsys.train_step(state, tb)
            losses.append(float(m["Total Loss"]))
        curves[dtype] = np.asarray(losses)
    _trajectory_bars(curves["bfloat16"], np.asarray(want))
    _trajectory_bars(curves["bfloat16"], curves["float32"])


# -- remat -----------------------------------------------------------------------

def _remat_inputs(seed=0):
    rng = np.random.default_rng(seed)
    B, L, T = 2, 8, 16
    dur = rng.integers(1, 3, (B, L)).astype(np.int32)
    return dict(emb=torch.from_numpy(rng.normal(size=(B, L, 32)).astype(np.float32)),
                src_lens=torch.tensor([8, 6]), T=T,
                dur=torch.from_numpy(dur), mel_lens=torch.from_numpy(np.minimum(dur.sum(1), T)),
                pitch=torch.from_numpy(rng.normal(size=(B, L)).astype(np.float32)),
                energy=torch.from_numpy(rng.normal(size=(B, L)).astype(np.float32)),
                target=torch.from_numpy(rng.normal(size=(B, T, 80)).astype(np.float32)))


def _remat_model(remat, dtype="float32"):
    """tests/test_remat.py's configuration (dropout at its defaults)."""
    cfg = torch_config.ModelConfig(
        transformer=torch_config.TransformerConfig(
            encoder_layer=2, decoder_layer=2, encoder_hidden=32, decoder_hidden=32,
            conv_filter_size=64, encoder_head=2, decoder_head=2),
        max_seq_len=16, speaker=torch_config.SpeakerConfig(n_speakers=2), remat=remat,
        compute_dtype=dtype)
    torch.manual_seed(0)
    return FastSpeech2(cfg, DEFAULT_STATS)


def _remat_loss(model, x, params=None):
    args = (x["emb"], x["src_lens"], x["T"])
    kwargs = dict(speaker_args=torch.tensor([0, 1]), mel_lens=x["mel_lens"], p_targets=x["pitch"],
                  e_targets=x["energy"], d_targets=x["dur"], lang_args=torch.tensor([0, 0]))
    out = (model(*args, **kwargs) if params is None
           else functional_call(model, params, args, kwargs))
    return ((out.postnet_mel - x["target"]) ** 2).mean()


@pytest.fixture
def function_attention(monkeypatch):
    """The FFT blocks' attention through `AttentionFunction`, its forward
    the plain version (no card here), each forward counted."""
    calls = []

    def forward(q, k, v, key_valid, temperature=None):
        calls.append(q.shape)
        return tattn.attention_reference(q, k, v, key_valid, temperature)

    monkeypatch.setattr(tattn, "attention_cuda", forward)

    def attend(q, k, v, key_valid=None, temperature=None, return_weights=False):
        if key_valid is None:
            key_valid = torch.ones(q.shape[0], q.shape[2], dtype=torch.bool)
        return tattn.AttentionFunction.apply(q, k, v, key_valid, temperature)[0]

    monkeypatch.setattr(tfft, "attend", attend)
    return calls


@pytest.mark.parametrize("route", ["plain", "function"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_matches_plain(request, route, dtype):
    calls = request.getfixturevalue("function_attention") if route == "function" else None
    x = _remat_inputs()
    results = {}
    for remat in (False, True):
        model = _remat_model(remat, dtype)
        model.train()                    # dropout on: the recompute replays its masks
        params = list(model.parameters())
        n0 = len(calls) if calls is not None else 0
        torch.manual_seed(1)
        loss = _remat_loss(model, x)
        n_fwd = len(calls) - n0 if calls is not None else 0
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        n_bwd = len(calls) - n0 - n_fwd if calls is not None else 0
        results[remat] = (loss, grads, n_fwd, n_bwd)
    (l1, g1, f1, b1), (l2, g2, f2, b2) = results[False], results[True]
    np.testing.assert_allclose(float(l2.detach()), float(l1.detach()), rtol=REMAT_LOSS_RTOL)
    for a, b in zip(g1, g2):
        if a is None:
            assert b is None
            continue
        np.testing.assert_allclose(b.float().numpy(), a.float().numpy(),
                                   rtol=REMAT_GRAD_RTOL, atol=REMAT_GRAD_ATOL)
    if calls is not None:
        # 4 blocks: each launched once in the forward; with remat again by
        # the recompute in the backward, through AttentionFunction
        assert (f1, b1, f2, b2) == (4, 0, 4, 4)


def test_remat_second_order_maml_matches_plain():
    """Second-order MAML (`inner_adapt`, two SGD steps through
    `functional_call`, differentiated again): the outer gradient with remat
    equals the one without. The recompute runs after `functional_call` has
    put the module's own parameters back, so `FFTStack` passes each block
    its tensors (`_block_out`); recomputing with the module's own weights
    gave gradients 1.8e-3 off."""
    x = _remat_inputs()
    results = {}
    for remat in (False, True):
        model = _remat_model(remat)
        model.train()
        params = dict(model.named_parameters())
        torch.manual_seed(1)
        adapted = inner_adapt(lambda p: _remat_loss(model, x, p), params, 1e-2, 2)
        outer = _remat_loss(model, x, adapted)
        results[remat] = (outer, torch.autograd.grad(outer, list(params.values()),
                                                     allow_unused=True))
    np.testing.assert_allclose(float(results[True][0].detach()),
                               float(results[False][0].detach()),
                               rtol=REMAT_LOSS_RTOL)
    for a, b in zip(results[False][1], results[True][1]):
        if a is not None:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=REMAT_GRAD_RTOL,
                                       atol=REMAT_GRAD_ATOL)


def test_remat_under_torch_func_raises_a_clear_error():
    x = _remat_inputs()
    model = _remat_model(True)
    params = dict(model.named_parameters())
    with pytest.raises(RuntimeError, match="remat: torch.utils.checkpoint cannot run under a "
                                          "torch.func transform"):
        grad(lambda p: _remat_loss(model, x, p))(params)
    emb = x["emb"].expand(3, *x["emb"].shape)
    with pytest.raises(RuntimeError, match="torch.func transform"):
        vmap(lambda e: _remat_loss(model, dict(x, emb=e)))(emb)
    # without a graph there is nothing to recompute: no_grad runs plain
    with torch.no_grad():
        assert torch.isfinite(_remat_loss(model, x))
