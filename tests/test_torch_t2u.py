"""Parity of the port's T2U models and systems with fscl_tpu, on the CPU in
float32, at a tiny width (encoder 12, RNNs 10, 21 unit symbols).

fscl_tpu's TacoT2U draws its prenet dropout even at inference, so no test
can switch dropout off: `torch_parity.t2u_scan_masks` rebuilds fscl_tpu's
per-step masks from its key schedule with `jax.random`, and
`capture_dropout` reads the encoder's Dropout masks off fscl_tpu's run; the
port's loop takes them as a `T2UMasks`. Weights come from fscl_tpu's init
through `fscl_tpu_torch.convert` (whose tables are also read backwards).

Tolerances, each with its reason:
- modules (downstreams, discriminator): 1e-5 absolute, f32 products in
  another order;
- teacher-forced logits over <= 32 steps: 1e-4 absolute, the recurrence
  carrying those differences from step to step;
- losses and one train step's parameters: 1e-5 relative; gradients 1e-5
  absolute;
- `infer`: unit ids equal up to the first step where fscl_tpu's top-2
  logit margin falls below INFER_MARGIN (an argmax near-tie may go either
  way under another summation order); logits 1e-4 up to there.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fscl_tpu.core.config as jax_config
import fscl_tpu_torch.core.config as torch_config
from fscl_tpu.data.batch import Batch as JBatch
from fscl_tpu.data.batch import SupInfo as JSupInfo
from fscl_tpu.models.tacotron2_t2u import T2UConfig as JT2UConfig
from fscl_tpu.models.tacotron2_t2u import TacoT2U as JTacoT2U
from fscl_tpu.nn.downstreams import Downstream1 as JDownstream1
from fscl_tpu.nn.downstreams import Downstream2 as JDownstream2
from fscl_tpu.nn.losses import framewise_accuracy as jax_acc
from fscl_tpu.nn.losses import framewise_ce_loss as jax_ce
from fscl_tpu.systems import t2u as J
from fscl_tpu.systems import t2u_tune as JT
from fscl_tpu.systems.base import apply_grads, create_state
from fscl_tpu.systems.baseline import BaselineSystem as JBaseline
from fscl_tpu.train.optim import make_optimizer as jax_make_optimizer
from fscl_tpu_torch import convert
from fscl_tpu_torch.data.batch import SupInfo, collate_batch, to_device
from fscl_tpu_torch.models.tacotron2_t2u import T2UConfig, TacoT2U, draw_masks
from fscl_tpu_torch.nn.downstreams import Downstream1, Downstream2
from fscl_tpu_torch.nn.losses import framewise_accuracy, framewise_ce_loss
from fscl_tpu_torch.systems import t2u as P
from fscl_tpu_torch.systems import t2u_tune as PT
from fscl_tpu_torch.systems.baseline import BaselineSystem

from torch_parity import capture_dropout, make_cfg, t2u_scan_masks, to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOD_ATOL, LOGIT_ATOL, LOSS_RTOL, GRAD_ATOL, PARAM_RTOL = 1e-5, 1e-4, 1e-5, 1e-5, 1e-5
INFER_MARGIN = 1e-4
N_UNITS, N_SYM = 21, 24
TINY = dict(n_units=N_UNITS, d_unit=8, symbols_embedding_dim=8, encoder_embedding_dim=12,
            prenet_dim=8, attention_rnn_dim=10, decoder_rnn_dim=10, attention_dim=6,
            attention_location_n_filters=3, attention_location_kernel_size=5)
JCFG, PCFG = JT2UConfig(**TINY), T2UConfig(**TINY)
B, L, TU = 3, 7, 9
ID2SYMBOLS = (("xx", N_SYM),)
STEP = dict(lr=1e-4, eps=1e-3, warmup_step=2, anneal_steps=(), grad_clip_thresh=0.5)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t2u_batch(seed, lens=(7, 4, 2), unit_lens=(9, 6, 3)):
    rng = np.random.default_rng(seed)
    texts = rng.integers(1, N_SYM, (B, L)).astype(np.int32)
    units = rng.integers(1, N_UNITS, (B, TU)).astype(np.int32)
    texts[np.arange(L)[None] >= np.asarray(lens)[:, None]] = 0
    units[np.arange(TU)[None] >= np.asarray(unit_lens)[:, None]] = 0
    return P.T2UBatch(np.zeros(B, np.int32), texts, np.asarray(lens, np.int32), units,
                      np.asarray(unit_lens, np.int32), np.zeros(B, np.int32))


def _jbatch(b):
    return J.T2UBatch(*map(jnp.asarray, b))


def _emb(seed):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(B, L, PCFG.symbols_embedding_dim)).astype(np.float32)
    lens = np.array([7, 4, 2], np.int32)
    emb[np.arange(L)[None] >= lens[:, None]] = 0.0
    return emb, lens


@pytest.fixture(scope="module")
def tacot2u():
    """fscl_tpu's TacoT2U variables (with random BatchNorm statistics) and
    the port's model loaded from them."""
    emb, lens = _emb(0)
    units = _t2u_batch(0).units
    v = _np(jax.jit(JTacoT2U(JCFG).init)(jax.random.PRNGKey(0), jnp.asarray(emb),
                                         jnp.asarray(lens), jnp.asarray(units),
                                         jax.random.PRNGKey(1)))
    rng = np.random.default_rng(1)
    for bn in v["batch_stats"]["encoder"].values():
        bn["mean"] = rng.normal(0, 0.2, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    return v


def _port_model(v):
    m = TacoT2U(PCFG)
    m.load_state_dict(convert.state_dict_from(convert.tacot2u_entries(), v), strict=True)
    return m


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_tacot2u_teacher_forced_matches(tacot2u, train):
    """Logits and alignments in both modes; in train mode every dropout and
    the encoder's BatchNorm on batch statistics (running buffers updated
    as flax does). The converter's table read back gives fscl_tpu's
    variables exactly."""
    emb, lens = _emb(1)
    units = _t2u_batch(1).units
    r_scan, r_drop = jax.random.PRNGKey(5), jax.random.PRNGKey(6)
    out, enc = capture_dropout(lambda: JTacoT2U(JCFG).apply(
        tacot2u, jnp.asarray(emb), jnp.asarray(lens), jnp.asarray(units), r_scan,
        deterministic=not train, rngs={"dropout": r_drop} if train else None,
        mutable=["batch_stats"] if train else False))
    (logits, aligns), updates = out if train else (out, None)
    m = _port_model(tacot2u).train(train)
    back = convert.variables_from(convert.tacot2u_entries(), m.state_dict())
    assert jax.tree.all(jax.tree.map(np.array_equal, back, tacot2u))
    masks = t2u_scan_masks(JCFG, r_scan, B, TU, train, encoder=enc)
    if train:                       # the encoder alone reads the same masks
        sys_v = {"params": {"model": tacot2u["params"]},
                 "batch_stats": {"model": tacot2u["batch_stats"]}}
        t2u = P.T2UBatch(None, np.zeros((B, L), np.int32), lens, units, None, None)
        np.testing.assert_array_equal(
            _encoder_masks(sys_v, t2u, None, r_keys=(r_scan, r_drop)), enc)
    assert (masks.encoder is not None) == train
    got_l, got_a = m(torch.from_numpy(emb), torch.from_numpy(lens),
                     torch.from_numpy(units).long(), masks=masks)
    np.testing.assert_allclose(got_l.detach().numpy(), logits, atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(got_a.detach().numpy(), aligns, atol=LOGIT_ATOL, rtol=0)
    if train:
        for i, bn in enumerate(m.encoder.norms):
            want = updates["batch_stats"]["encoder"][f"bn_{i}"]
            np.testing.assert_allclose(bn.running_mean.numpy(), want["mean"], atol=MOD_ATOL)
            np.testing.assert_allclose(bn.running_var.numpy(), want["var"], atol=MOD_ATOL)


def test_tacot2u_infer_matches(tacot2u):
    """Batched argmax decoding over max_decoder_ratio * L steps on fscl_tpu's
    prenet masks: ids, lengths and logits up to the first near-tie."""
    emb, lens = _emb(2)
    rng = jax.random.PRNGKey(9)
    logits, preds, n_steps, _ = JTacoT2U(JCFG).apply(
        tacot2u, jnp.asarray(emb), jnp.asarray(lens), rng, method="infer")
    logits, preds = np.asarray(logits), np.asarray(preds)
    S = logits.shape[1]
    assert S == JCFG.max_decoder_ratio * L
    with torch.no_grad():
        got_l, got_p, got_n, got_a = _port_model(tacot2u).eval().infer(
            torch.from_numpy(emb), torch.from_numpy(lens),
            masks=t2u_scan_masks(JCFG, rng, B, S, False, infer=True))
    top2 = np.sort(logits, -1)[..., -2:]
    ties = np.nonzero((top2[..., 1] - top2[..., 0]).min(axis=0) < INFER_MARGIN)[0]
    upto = int(ties[0]) if len(ties) else S
    assert upto > 20, f"a near-tie at step {upto}: pick another seed"
    np.testing.assert_array_equal(got_p.numpy()[:, :upto], preds[:, :upto])
    np.testing.assert_allclose(got_l.numpy()[:, :upto], logits[:, :upto], atol=LOGIT_ATOL)
    if upto == S:
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(n_steps))
    assert got_a.shape == (B, S, L) and got_p.dtype == torch.int64


def test_infer_marks_eos_and_masks_after_it():
    """Positions from a sample's <eos> on are 0 and its length counts the
    steps before it; masks drawn from one generator seed repeat."""
    torch.manual_seed(0)
    m = TacoT2U(PCFG).eval()
    with torch.no_grad():
        m.decoder_cell.final_proj.bias[8] = 6.0        # <eos> wins once the logits are small
        emb, lens = _emb(3)
        runs = [m.infer(torch.from_numpy(emb), torch.from_numpy(lens), max_steps=12,
                        generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)
    _, preds, n, _ = runs[0]
    for row in range(B):
        assert (preds[row, n[row]:] == 0).all() and (preds[row, :n[row]] != 8).all()
    masks = draw_masks(PCFG, B, L, 5, True, torch.Generator().manual_seed(0), "cpu")
    assert masks.prenet.shape == (5, 2, B, PCFG.prenet_dim)
    assert masks.encoder.shape == (3, B, L, PCFG.encoder_embedding_dim)


def _downstreams(kind, specific_layer):
    kw = dict(n_in_layers=4, d_model=8, n_head=2, d_ff=(16, 12), specific_layer=specific_layer)
    if kind == "downstream2":
        return (JDownstream2(codebook_size=5, **kw), Downstream2(d_in=6, codebook_size=5, **kw),
                convert.downstream_entries(1, True))
    return JDownstream1(**kw), Downstream1(d_in=6, **kw), convert.downstream_entries(2, False)


@pytest.mark.parametrize("kind,specific_layer", [("downstream1", None), ("downstream1", 2),
                                                 ("downstream2", None)])
def test_downstream_matches_and_converts_both_ways(kind, specific_layer):
    """Weighted sum, projection, transformer blocks (attention over the
    valid frames) and the codeformer; the converter's table read back gives
    fscl_tpu's params exactly."""
    jm, pm, entries = _downstreams(kind, specific_layer)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 4, 6)).astype(np.float32)
    valid = np.arange(9)[None] < np.array([[9], [5]])
    v = _np(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    sd = convert.state_dict_from(entries, v)
    pm.load_state_dict(sd, strict=True)
    back = convert.variables_from(entries, pm.state_dict())
    assert jax.tree.all(jax.tree.map(np.array_equal, back, v))
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(valid))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x), torch.from_numpy(valid))
    if kind == "downstream2":
        want, got = want[0], got[0]
    np.testing.assert_allclose(got.numpy(), want, atol=MOD_ATOL, rtol=0)


def test_framewise_losses_match():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 11, N_UNITS)).astype(np.float32)
    targets = rng.integers(0, N_UNITS, (3, 11)).astype(np.int32)
    targets[2, 4:] = 0
    for pf, jf in ((framewise_ce_loss, jax_ce), (framewise_accuracy, jax_acc)):
        got = pf(torch.from_numpy(logits), torch.from_numpy(targets))
        np.testing.assert_allclose(float(got), float(jf(logits, targets)), rtol=LOSS_RTOL)
    assert float(framewise_ce_loss(torch.zeros(1, 2, 3), torch.zeros(1, 2, dtype=torch.int32))) == 0


# -- systems --------------------------------------------------------------------

def _model_cfg(C):
    cfg = make_cfg(C)
    return dataclasses.replace(
        cfg, codebook=C.CodebookConfig(size=6, num_heads=2, dim=64),
        upstream=C.UpstreamConfig(name="custom", dim=64, n_layers=3))


def _support(seed):
    rng = np.random.default_rng(seed)
    S, T_WAV = 2, 4000
    wav = 0.3 * rng.normal(size=(S, T_WAV))
    wav_lens = np.array([T_WAV, 3100], np.int32)
    wav = np.where(np.arange(T_WAV)[None] < wav_lens[:, None], wav, 0.0)
    avg_frames = np.array([[2, 0, 3, 1, 2, 3], [3, 3, 2, 4, 1, 2]], np.int32)
    phonemes = rng.integers(1, N_SYM, (S, 6)).astype(np.int32)
    return SupInfo(np.round(wav * 32767).astype(np.int16), wav_lens, avg_frames, phonemes,
                   N_SYM)


def _jsup(sup):
    return JSupInfo(*(jnp.asarray(x) for x in sup[:4]), n_symbols=sup.n_symbols)


def _u2s(seed, T_units=16):
    """u2s batch over the unit symbols: learnable targets from collate_batch."""
    rng = np.random.default_rng(seed)
    table = np.random.default_rng(98).normal(size=(N_UNITS, 82)).astype(np.float32)
    samples = []
    for i, n in enumerate((8, 5, 2)):
        ph = rng.integers(1, N_UNITS, n)
        dur = rng.integers(1, 4, n)
        frames = np.repeat(ph, dur)
        samples.append(dict(
            id=str(i), text="", phonemes=ph, duration=dur, speaker=i % 2, lang_id=0,
            mel=table[frames, :80] + 0.1 * rng.normal(size=(len(frames), 80)).astype(np.float32),
            pitch=table[ph, 80], energy=table[ph, 81]))
    return collate_batch(samples, (T_units,), (64,), pitch_feature="phoneme_level",
                         energy_feature="phoneme_level")[1]


def _jax_u2s():
    """fscl_tpu's u2s BaselineSystem over the unit symbols and its variables."""
    u2s = JBaseline(make_cfg(jax_config), jax_config.OptimConfig(), (("units", N_UNITS),))
    b = _u2s(0)
    v = _np(u2s.init_variables(jax.random.PRNGKey(7), JBatch(*map(jnp.asarray, b))))
    lin = v["params"]["model"]["variance_adaptor"]["duration_predictor"]["linear_layer"]
    lin["bias"] = (lin["bias"] + np.log(2.0)).astype(np.float32)
    return u2s, v


def _port_u2s(v):
    u2s = BaselineSystem(make_cfg(torch_config), (("units", N_UNITS),), device="cpu")
    u2s.load_state_dict(convert.baseline_state_dict(v), strict=True)
    return u2s


def _real(seed):
    rng = np.random.default_rng(seed)
    units = rng.integers(1, N_UNITS, (B, TU)).astype(np.int32)
    lens = np.array([9, 2, 5], np.int32)
    units[np.arange(TU)[None] >= lens[:, None]] = 0
    return units, lens


@functools.lru_cache(maxsize=1)
def _jax_upstream():
    """fscl_tpu's tiny custom upstream params, made once for every FSCL kind."""
    up = J.make_upstream("custom", _model_cfg(jax_config).upstream)
    wav = jnp.zeros((1, 4000))
    return jax.jit(up.init)(jax.random.PRNGKey(2), wav)


@functools.lru_cache(maxsize=None)
def _jax_upstream_variables():
    return _np({"upstream": _jax_upstream()})


def _build(kind):
    """(fscl_tpu system, its variables, port system, port batch, fscl_tpu
    batch) of one T2U system kind at the tiny width. The port system is
    made from torch's init under a seed and its weights carried to fscl_tpu
    by `convert.t2u_variables` (fscl_tpu's own init of the scan decoder
    costs seconds a system); the frozen upstream and u2s come from fscl_tpu's
    init."""
    jm, pm = _model_cfg(jax_config), _model_cfg(torch_config)
    jopt = jax_config.OptimConfig(**STEP)
    popt = torch_config.OptimConfig(**STEP)
    t2u = _t2u_batch(6)
    torch.manual_seed(3)
    frozen = None
    if kind in ("fscl-t2u", "fscl-t2u-c", "fscl-t2u-c2"):
        jcls = {"fscl-t2u": J.TransEmbT2USystem, "fscl-t2u-c": J.TransEmbCT2USystem,
                "fscl-t2u-c2": J.TransEmbC2T2USystem}[kind]
        jsys = jcls(jm, jopt, N_SYM, JCFG)
        frozen = _jax_upstream_variables()
        psys = P.SYSTEMS.get(kind)(pm, N_SYM, PCFG, device="cpu", optim_cfg=popt)
        psys.load_upstream(convert.hubert_state_dict(frozen["upstream"]))
        batch = P.T2UEpisode(sup=_support(6), qry=t2u)
        jbatch = J.T2UEpisode(sup=_jsup(batch.sup), qry=_jbatch(t2u))
    elif kind in ("tacot2u", "fscl-t2u-da-tune"):
        jsys = (J.TacoT2USystem(jm, jopt, ID2SYMBOLS, JCFG) if kind == "tacot2u"
                else JT.DATuneSystem(jm, jopt, ID2SYMBOLS, JCFG))
        psys = P.SYSTEMS.get(kind)(pm, ID2SYMBOLS, PCFG, device="cpu", optim_cfg=popt)
        batch, jbatch = t2u, _jbatch(t2u)
        if kind != "tacot2u":
            batch = PT.DABatch(t2u, *_real(7))
            jbatch = JT.DABatch(_jbatch(t2u), *map(jnp.asarray, _real(7)))
    else:                       # the E2E chain, with or without the discriminator
        ju2s, uv = _jax_u2s()
        da = kind == "fscl-t2u-da-e2e-tune"
        jcls, pcls = ((JT.DAE2ETuneSystem, PT.DAE2ETuneSystem) if da
                      else (JT.E2ETuneSystem, PT.E2ETuneSystem))
        jsys = jcls(jm, jopt, ID2SYMBOLS, JCFG, ju2s, uv["params"], uv["batch_stats"],
                    u2s_symbol_id="units")
        psys = pcls(pm, ID2SYMBOLS, PCFG, _port_u2s(uv), device="cpu", optim_cfg=popt,
                    u2s_symbol_id="units")
        u2s = _u2s(8)
        batch = PT.E2EBatch(t2u, u2s)
        jbatch = JT.E2EBatch(_jbatch(t2u), JBatch(*map(jnp.asarray, u2s)))
        if da:
            batch = PT.DAE2EBatch(t2u, u2s, *_real(7))
            jbatch = JT.DAE2EBatch(jbatch.t2u, jbatch.u2s, *map(jnp.asarray, _real(7)))
    v = convert.t2u_variables(psys.state_dict())
    if frozen is not None:
        v["frozen"] = frozen
    return jsys, v, psys, batch, jbatch


def _encoder_masks(v, t2u, key, r_keys=None):
    """The encoder's dropout masks of fscl_tpu's train-mode forward under
    `key`: they depend on the key, the module path and the shapes alone, so
    the encoder alone, called inside TacoT2U on zeros, reads them."""
    r_scan, r_drop = jax.random.split(key) if r_keys is None else r_keys
    emb = jnp.zeros(t2u.texts.shape + (JCFG.symbols_embedding_dim,))
    valid = jnp.arange(t2u.texts.shape[1])[None] < jnp.asarray(t2u.src_lens)[:, None]
    return capture_dropout(lambda: JTacoT2U(JCFG).apply(
        {"params": v["params"]["model"], "batch_stats": v["batch_stats"]["model"]}, emb, valid,
        method=lambda m, e, sv: m.encoder(e, sv, False), rngs={"dropout": r_drop},
        mutable=["batch_stats"]))[1]


KINDS = ["tacot2u", "fscl-t2u", "fscl-t2u-c", "fscl-t2u-c2", "fscl-t2u-da-tune",
         "fscl-t2u-e2e-tune", "fscl-t2u-da-e2e-tune"]


@pytest.mark.parametrize("kind", KINDS)
def test_system_train_step_matches(kind):
    """One train step of each T2U system on fscl_tpu's dropout masks: the
    metrics, every trainable gradient, and the parameters after fscl_tpu's
    optimizer step (1e-5 relative); the frozen upstream and u2s stay out of
    the optimizer and unchanged; the converters carry the weights both
    ways exactly."""
    jsys, v, psys, batch, jbatch = _build(kind)
    rng = jax.random.PRNGKey(11)
    key = jax.random.fold_in(rng, 0)            # the train step folds in the step
    r_scan, _ = jax.random.split(key)
    t2u = batch.qry if isinstance(batch, P.T2UEpisode) else getattr(batch, "t2u", batch)
    masks = t2u_scan_masks(JCFG, r_scan, B, TU, True, encoder=_encoder_masks(v, t2u, key))

    def loss(params, batch_stats, b, frozen):
        return jsys.loss_and_metrics(params, batch_stats, b, key, True, frozen)
    (_, (metrics, new_bs)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        to_jax(v["params"]), to_jax(v["batch_stats"]), jbatch, to_jax(v.get("frozen")))
    want_grads = {k: x.numpy() for k, x in convert.t2u_state_dict(
        _np({"params": grads, "batch_stats": v["batch_stats"]})).items()}
    tx = jax_make_optimizer(jsys.optim_cfg, jsys.trainable_mask(v["params"]))
    state, _ = create_state({"params": to_jax(v["params"]),
                             "batch_stats": to_jax(v["batch_stats"])}, tx)
    new_state = jax.jit(lambda s, g, bs: apply_grads(s, g, tx, bs))(state, grads, new_bs)
    want_params = {k: x.numpy() for k, x in convert.t2u_state_dict(
        _np({"params": new_state.params, "batch_stats": new_state.batch_stats})).items()}

    sd = psys.state_dict()          # fscl_tpu's variables convert back to the same weights
    assert all(torch.equal(x, sd[k]) for k, x in convert.t2u_state_dict(v).items())
    frozen_before = {k: x.clone() for k, x in psys.state_dict().items()
                     if k.startswith(("upstream.", "u2s_system."))}
    psys.loss_and_metrics = lambda b: type(psys).loss_and_metrics(psys, b, masks=masks)
    pstate = psys.init_state()
    names = [n for n, p in psys.named_parameters() if psys.trainable_mask()[n]]
    assert not any(n.startswith(("upstream.", "u2s_system.")) or "bias_ih" in n
                   for n in names)
    psys.train()
    got_loss, got_metrics = psys.loss_and_metrics(to_device(batch, "cpu"))
    params = dict(psys.named_parameters())
    got = torch.autograd.grad(got_loss, [params[n] for n in names], allow_unused=True)
    psys.eval()
    for k, x in got_metrics.items():
        np.testing.assert_allclose(float(x), float(metrics[k]), rtol=LOSS_RTOL, err_msg=k)
    assert set(got_metrics) == set(metrics)
    for name, g in zip(names, got):
        w = want_grads[name]
        np.testing.assert_allclose(np.zeros_like(w) if g is None else g.numpy(), w,
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)
    psys.train_step(pstate, to_device(batch, "cpu"))
    for name in names:
        got_p, w = params[name].detach().numpy(), want_params[name]
        assert np.abs(got_p - w).max() <= PARAM_RTOL * max(np.abs(w).max(), 1e-3), name
    for k, x in psys.state_dict().items():
        if k in frozen_before:
            assert torch.equal(x, frozen_before[k]), k
    assert not psys.training


def test_da_discriminator_matches_and_converts_both_ways():
    """The DA module's discriminator (SAME-padded k = 6 convs, tanh GELU, a
    masked mean) from fscl_tpu's init, on soft unit distributions."""
    rng = np.random.default_rng(10)
    probs = rng.dirichlet(np.ones(N_UNITS), size=(2, 11)).astype(np.float32)
    valid = np.arange(11)[None] < np.array([[11], [6]])
    jda = J.DA(N_UNITS)
    v = _np(jda.init(jax.random.PRNGKey(5), jnp.asarray(probs)))
    pda = P.DA(N_UNITS)
    pda.load_state_dict(convert.state_dict_from(convert.da_entries(), v), strict=True)
    back = convert.variables_from(convert.da_entries(), pda.state_dict())
    assert jax.tree.all(jax.tree.map(np.array_equal, back, v))
    for mask in (valid, None):
        want = jda.apply(v, jnp.asarray(probs), None if mask is None else jnp.asarray(mask))
        with torch.no_grad():
            got = pda(torch.from_numpy(probs), None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), want, atol=MOD_ATOL, rtol=0)


def test_gradient_reversal_matches():
    """Identity forward, -scale times the cotangent backward, as fscl_tpu's
    custom_vjp."""
    x = np.random.default_rng(8).normal(size=(2, 5)).astype(np.float32)
    w = np.random.default_rng(9).normal(size=(2, 5)).astype(np.float32)
    jgrl = J.GradientReversal(0.7)
    want = jax.grad(lambda a: jnp.sum(jgrl.apply({}, a) * w))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    out = P.GradientReversal(0.7)(t)
    assert torch.equal(out.detach(), torch.from_numpy(x))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["fscl-t2u", "fscl-t2u-c2"])
def test_t2u_tune_init_matches(kind):
    """The split's table streamed in two SupInfo batches through the
    meta-system, then transplanted into a TacoT2U system's table."""
    jsys, v, psys, _, _ = _build(kind)
    sups = [_support(20), _support(21)]
    jt2u = J.TacoT2USystem(_model_cfg(jax_config), jax_config.OptimConfig(), ID2SYMBOLS, JCFG)
    pt2u = P.TacoT2USystem(_model_cfg(torch_config), ID2SYMBOLS, PCFG, device="cpu")
    tv = convert.t2u_variables(pt2u.state_dict())
    jsys.upstream_params = to_jax(v["frozen"]["upstream"])
    want = JT.t2u_tune_init(jsys, to_jax(v["params"]), jt2u, tv["params"], map(_jsup, sups),
                            "xx")["embedding"]["table-xx"]
    got = PT.t2u_tune_init(psys, pt2u, sups, "xx")
    np.testing.assert_allclose(got.numpy(), want, atol=MOD_ATOL, rtol=0)
    assert torch.equal(pt2u.embedding_model.tables["table-xx"].detach(), got)




E2E_STEPS, E2E_REF_STEPS, E2E_LOSS_RTOL = 40, 1500, 1e-4


def test_e2e_tune_trajectory_matches_fscl_tpu():
    """40 E2E tune steps in both packages on the same batches (a new one
    each step) and the same dropout masks, at config/train/tune-t2s-1500.yaml's
    optimizer (Adam betas 0.9 / 0.98, eps 1e-9, clip 1.0, the sqrt schedule)
    with its 4000 warm-up steps cut in proportion to the run (107), as
    chip_smoke.py's phase 14 runs it: every step's loss within 1e-4
    relative. This classifies the card's reading (ROADMAP Queue 3, PERF.md
    §7): the tune's trajectory is fscl_tpu's."""
    jsys, v, psys, _, _ = _build("fscl-t2u-e2e-tune")
    path = os.path.join(REPO, "config", "train", "tune-t2s-1500.yaml")
    jref = jax_config.train_config_from_yaml(path)
    pref = torch_config.train_config_from_yaml(path)
    assert jref.total_step == pref.total_step == E2E_REF_STEPS
    warmup = round(jref.optim.warmup_step * E2E_STEPS / E2E_REF_STEPS)
    # YAML 1.1 reads `1e-09` as a string, which optax cannot add: a number here
    jopt = dataclasses.replace(jref.optim, warmup_step=warmup, eps=float(jref.optim.eps))
    popt = dataclasses.replace(pref.optim, warmup_step=warmup, eps=float(pref.optim.eps))
    assert dataclasses.asdict(jopt) == dataclasses.asdict(popt) and warmup == 107

    tx = jax_make_optimizer(jopt, jsys.trainable_mask(v["params"]))
    state, _ = create_state({"params": to_jax(v["params"]),
                             "batch_stats": to_jax(v["batch_stats"])}, tx)
    rng = jax.random.PRNGKey(3)

    def loss(params, batch_stats, b, key):
        return jsys.loss_and_metrics(params, batch_stats, b, key, True, None)
    grad_fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    apply = jax.jit(lambda s, g, bs: apply_grads(s, g, tx, bs))
    psys.optim_cfg = popt
    pstate = psys.init_state()
    want, got = [], []
    for step in range(E2E_STEPS):
        batch = PT.E2EBatch(_t2u_batch(100 + step), _u2s(200 + step))
        jbatch = JT.E2EBatch(_jbatch(batch.t2u), JBatch(*map(jnp.asarray, batch.u2s)))
        key = jax.random.fold_in(rng, step)
        r_scan, _ = jax.random.split(key)
        masks = t2u_scan_masks(JCFG, r_scan, B, TU, True,
                               encoder=_encoder_masks(v, batch.t2u, key))
        (value, (metrics, new_bs)), grads = grad_fn(state.params, state.batch_stats, jbatch,
                                                     key)
        state = apply(state, grads, new_bs)
        want.append(float(value))
        psys.loss_and_metrics = lambda b, m=masks: type(psys).loss_and_metrics(psys, b, masks=m)
        pstate, pm = psys.train_step(pstate, to_device(batch, "cpu"))
        got.append(float(pm["Total Loss"]))
    np.testing.assert_allclose(got, want, rtol=E2E_LOSS_RTOL)
