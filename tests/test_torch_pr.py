"""Parity of the port's phoneme-recognition (PR) family with fscl_tpu, on
the CPU in float32, at a tiny width: a 3-layer custom upstream of dim 64,
Downstream1 and the heads at d_model 32 with 2 heads, a 6-row codebook,
24 symbols.

Pieces first (the PR heads, `BiLSTMDownstream` on ragged lengths, the
codebooks, `asr_center`, `TransHeadGenerator`, `gather_frame_labels`), then
each of the five systems: logits, loss, accuracy, every trainable gradient
and the parameters after one Adam step, from the port's init carried to
fscl_tpu by `convert.pr_variables` (the frozen upstream from fscl_tpu's init,
carried the other way), on the same numpy batch or episode. Every dropout
rate is 0 (fscl_tpu's Dropout is patched to the identity: its draws cannot
be reproduced).

Tolerances, each with its reason:
- modules: 1e-5 absolute (f32 products in another order);
- logits 1e-5 relative to their largest magnitude (the protonet's
  -|x - c|^2 is summed as |x|^2 - 2 x.c + |c|^2 here, over a broadcast
  there); loss and accuracy 1e-5 relative;
- gradients 1e-4 relative to each tensor's largest magnitude (the forward's
  differences through the backward of an LSTM or transformer stack), and
  1e-7 absolute for a gradient that is 0 in exact arithmetic (the attention
  keys' bias: softmax ignores a constant shift);
- parameters after one Adam step (lr 1e-4, eps 1e-3): 1e-4 relative
  (1e-7 absolute for TransHead's bias, 0 and with a gradient 0 in exact
  arithmetic: a shift of every logit).
"""
import dataclasses
import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fscl_tpu.core.config as jax_config
import fscl_tpu_torch.core.config as torch_config
from fscl_tpu.models.hubert import make_upstream as jax_make_upstream
from fscl_tpu.nn import asr_center as jasr
from fscl_tpu.nn import downstreams as jds
from fscl_tpu.nn import phoneme_embedding as jpe
from fscl_tpu.ops.length_regulator import gather_frame_labels as jax_gather_frame_labels
from fscl_tpu.systems import pr as J
from fscl_tpu.systems.base import apply_grads, create_state
from fscl_tpu.train.optim import make_optimizer as jax_make_optimizer
from fscl_tpu_torch import convert
from fscl_tpu_torch.core.registry import DATAMODULES, SYSTEMS
from fscl_tpu_torch.data import datamodules  # noqa: F401 (registers the datamodules)
from fscl_tpu_torch.data.batch import to_device
from fscl_tpu_torch.nn import asr_center as pasr
from fscl_tpu_torch.nn import downstreams as pds
from fscl_tpu_torch.nn import phoneme_embedding as ppe
from fscl_tpu_torch.ops.length_regulator import gather_frame_labels
from fscl_tpu_torch.systems import pr as P

from torch_parity import NoDropout, make_cfg, to_jax

MOD_ATOL, LOGIT_RTOL, LOSS_RTOL, GRAD_RTOL, PARAM_RTOL = 1e-5, 1e-5, 1e-5, 1e-4, 1e-4
N_SYM, D, UP_DIM, N_LAYERS = 24, 32, 64, 3
ID2SYMBOLS = (("xx", N_SYM),)
STEP = dict(lr=1e-4, eps=1e-3, warmup_step=2, anneal_steps=(), grad_clip_thresh=1.0)
PR_KEYS = ("pr-ssl-linear", "pr-ssl-linear-tune", "pr-ssl-baseline", "pr-ssl-baseline-tune",
           "pr-ssl-cluster", "pr-ssl-cluster-tune", "pr-trans-head", "pr-trans-head-tune",
           "pr-fscl", "pr-fscl-tune", "pr-ssl-protonet")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(flax.linen, "Dropout", NoDropout)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, rtol, what, floor=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), floor)
    assert np.abs(got - want).max() <= rtol * scale, (what, np.abs(got - want).max(), scale)


# -- pieces ---------------------------------------------------------------------

def test_registry_resolves_every_pr_key():
    """All 11 keys of fscl_tpu's PR family resolve in SYSTEMS and DATAMODULES;
    the key config/algorithm/phoneme_recognition/ssl-codebook-cluster.yaml
    names, which fscl_tpu registers nowhere, is a KeyError in both."""
    from fscl_tpu.core.registry import SYSTEMS as JSYSTEMS
    for key in PR_KEYS:
        assert SYSTEMS.get(key).__name__ == JSYSTEMS.get(key).__name__
        assert DATAMODULES.get(key).__name__ in ("PRDataModule", "PREpisodicDataModule")
    for reg in (SYSTEMS, JSYSTEMS):
        with pytest.raises(KeyError):
            reg.get("pr-ssl-codebook-cluster")


def test_gather_frame_labels_matches():
    rng = np.random.default_rng(0)
    labels = rng.integers(1, N_SYM, (3, 6)).astype(np.int32)
    dur = rng.integers(0, 4, (3, 6)).astype(np.int32)
    dur[2] = 0
    for T in (5, 40):
        want = np.asarray(jax_gather_frame_labels(jnp.asarray(labels), jnp.asarray(dur), T))
        got = gather_frame_labels(_t(labels), _t(dur), T).numpy()
        np.testing.assert_array_equal(got, want)


def _reprs(seed, B=3, T=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, N_LAYERS, UP_DIM)).astype(np.float32)
    valid = np.arange(T)[None] < np.array([9, 5, 1])[:, None]
    return x, valid


@pytest.mark.parametrize("specific_layer", [None, 1])
def test_bilstm_downstream_on_ragged_lengths(specific_layer):
    """Rows of 9, 5 and 1 valid frames: the backward direction starts at each
    row's last valid frame (flax's seq_lengths + keep_order), padding stays
    out of it and is zeroed after each layer; the weights convert both ways."""
    x, valid = _reprs(1)
    jm = jds.BiLSTMDownstream(N_LAYERS, D, specific_layer)
    v = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(valid)))
    want = np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(valid)))
    pm = pds.BiLSTMDownstream(N_LAYERS, UP_DIM, D, specific_layer)
    entries = convert.bilstm_downstream_entries()
    pm.load_state_dict(convert.state_dict_from(entries, v), strict=True)
    got = pm(_t(x), _t(valid)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=MOD_ATOL)
    assert not got[~valid].any()
    # padding content does not reach the valid frames
    x2 = x.copy()
    x2[~valid] = 100.0
    np.testing.assert_allclose(pm(_t(x2), _t(valid)).detach().numpy(), got, atol=MOD_ATOL)
    back = convert.variables_from(entries, pm.state_dict())
    jax.tree.map(np.testing.assert_array_equal, back, v)


def test_linear_downstream_and_heads_match():
    x, _ = _reprs(2)
    jm = jds.LinearDownstream(N_LAYERS, D)
    v = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    pm = pds.LinearDownstream(N_LAYERS, UP_DIM, D)
    pm.load_state_dict(convert.state_dict_from(
        [("weighted_sum.weight_raw", ("params", "weighted_sum", "weight_raw"), "plain")]
        + convert._linear_entries("proj", ("params", "proj")), v), strict=True)
    h = np.asarray(jm.apply(v, jnp.asarray(x)))
    np.testing.assert_allclose(pm(_t(x)).detach().numpy(), h, atol=MOD_ATOL)
    id2 = (("en", 5), ("zh", 7))
    for sid in ("en", "zh"):
        jh = jds.MultilingualPRHead(id2, D)
        hv = _np(jh.init(jax.random.PRNGKey(1), jnp.asarray(h), sid))
        ph = pds.MultilingualPRHead(id2, D)
        lin = ph.heads[f"head-{sid}"]
        lin.weight.data = _t(hv["params"][f"head-{sid}"]["kernel"].T.copy())
        lin.bias.data = _t(hv["params"][f"head-{sid}"]["bias"])
        np.testing.assert_allclose(ph(_t(h), sid).detach().numpy(),
                                   np.asarray(jh.apply(hv, jnp.asarray(h), sid)), atol=MOD_ATOL)
        for mode in ("cos", "l2"):
            jc = jds.MultilingualClusterHead(id2, D, mode=mode)
            cv = _np(jc.init(jax.random.PRNGKey(2), jnp.asarray(h), sid))
            pc = pds.MultilingualClusterHead(id2, D, mode=mode)
            pc.centers[f"head-{sid}"].data = _t(cv["params"][f"head-{sid}"])
            np.testing.assert_allclose(pc(_t(h), sid).detach().numpy(),
                                       np.asarray(jc.apply(cv, jnp.asarray(h), sid)),
                                       atol=MOD_ATOL, err_msg=mode)
        with pytest.raises(KeyError):
            ph(_t(h), "ko")


def test_codebooks_asr_center_and_generator_match():
    rng = np.random.default_rng(3)
    queries = rng.normal(size=(7, UP_DIM)).astype(np.float32)
    queries[3] = 0.0                       # a symbol with no frames
    cents = rng.normal(size=(6, UP_DIM)).astype(np.float32)
    jh = jpe.HardAttCodebook(6, D, UP_DIM)
    hv = _np(jh.init(jax.random.PRNGKey(0), jnp.asarray(queries)))
    ph = ppe.HardAttCodebook(6, D, UP_DIM)
    ph.emb_banks.data, ph.att_banks.data = (_t(hv["params"][k]) for k in ("emb_banks", "att_banks"))
    for c in (None, cents):
        jt, jw = jh.apply(hv, jnp.asarray(queries), None if c is None else jnp.asarray(c), True)
        pt, pw = ph(_t(queries), None if c is None else _t(c), True)
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(jt), atol=MOD_ATOL)
        np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    js = jpe.SoftAttCodebook(6, D, UP_DIM)
    sv = _np(js.init(jax.random.PRNGKey(1), jnp.asarray(queries)))
    ps = ppe.SoftAttCodebook(6, D, UP_DIM)
    ps.emb_banks.data, ps.att_banks.data = (_t(sv["params"][k]) for k in ("emb_banks", "att_banks"))
    for a, b in zip(ps(_t(queries), True), js.apply(sv, jnp.asarray(queries), True)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=MOD_ATOL)
    for mode in ppe.PhonemeEmbeddingHub.MODES:
        built = ppe.PhonemeEmbeddingHub.build(mode, 6, D, UP_DIM, N_LAYERS)
        want = jpe.PhonemeEmbeddingHub.build(mode, 6, D, UP_DIM, N_LAYERS)
        assert (built is None) == (want is None) and (
            built is None or type(built).__name__ == type(want).__name__), mode

    ref, _ = _reprs(4, B=2, T=5)
    ref[0, 1, 0, 0] = np.nan
    jmc = jasr.MatchingCodebook(6, UP_DIM, D, 2, N_LAYERS)
    mv = _np(jmc.init(jax.random.PRNGKey(2), jnp.asarray(ref)))
    pmc = pasr.MatchingCodebook(6, UP_DIM, D, 2, N_LAYERS)
    pmc.weight_raw.data, pmc.banks.data = _t(mv["params"]["weight_raw"]), _t(mv["params"]["banks"])
    pmc.q_linear.weight.data = _t(mv["params"]["q_linear"]["kernel"].T.copy())
    pmc.q_linear.bias.data = _t(mv["params"]["q_linear"]["bias"])
    np.testing.assert_allclose(pmc(_t(ref)).detach().numpy(),
                               np.asarray(jmc.apply(mv, jnp.asarray(ref))), atol=MOD_ATOL)
    x = rng.normal(size=(2, 5, D)).astype(np.float32)
    tgt = rng.integers(0, 5, (2, 5))
    jc = jasr.ASRCenterHead((("en", 5),), D)
    cv = _np(jc.init(jax.random.PRNGKey(3), jnp.asarray(x), "en"))
    pc = pasr.ASRCenterHead((("en", 5),), D)
    pc.centers["centers-en"].data = _t(cv["params"]["centers-en"])
    for a, b in zip(pc(_t(x), "en", _t(tgt)), jc.apply(cv, jnp.asarray(x), "en", jnp.asarray(tgt))):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=MOD_ATOL)

    jg = J.TransHeadGenerator(N_LAYERS, 6, D, UP_DIM)
    qs = rng.normal(size=(1, 7, N_LAYERS, UP_DIM)).astype(np.float32)
    gv = _np(jg.init(jax.random.PRNGKey(4), jnp.asarray(qs)))
    pg = P.TransHeadGenerator(N_LAYERS, 6, D, UP_DIM)
    pg.weighted_sum.weight_raw.data = _t(gv["params"]["weighted_sum"]["weight_raw"])
    pg.codebook.emb_banks.data = _t(gv["params"]["codebook"]["emb_banks"])
    pg.codebook.att_banks.data = _t(gv["params"]["codebook"]["att_banks"])
    for a, b in zip(pg(_t(qs), True), jg.apply(gv, jnp.asarray(qs), True)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=MOD_ATOL)


# -- systems ------------------------------------------------------------------

def _model_cfg(C):
    cfg = make_cfg(C)
    tr = dataclasses.replace(cfg.transformer, encoder_hidden=D, encoder_head=2)
    return dataclasses.replace(cfg, transformer=tr,
                               codebook=C.CodebookConfig(size=6, num_heads=2, dim=D),
                               upstream=C.UpstreamConfig(name="custom", dim=UP_DIM,
                                                         n_layers=N_LAYERS))


@functools.lru_cache(maxsize=1)
def _jax_upstream():
    up = jax_make_upstream("custom", _model_cfg(jax_config).upstream)
    return _np(jax.jit(up.init)(jax.random.PRNGKey(2), jnp.zeros((1, 4000))))


def pr_batch(seed, wav_lens=(4000, 3100, 1500), n_phones=6):
    """A PRBatch of float32 wavs with ragged lengths and 20 ms frame counts
    that fit inside each wav (a zero-duration phoneme included)."""
    rng = np.random.default_rng(seed)
    B, W = len(wav_lens), max(wav_lens)
    wav_lens = np.asarray(wav_lens, np.int32)
    wavs = (0.3 * rng.normal(size=(B, W))).astype(np.float32)
    wavs[np.arange(W)[None] >= wav_lens[:, None]] = 0.0
    avg = np.zeros((B, n_phones), np.int32)
    ph = np.zeros((B, n_phones), np.int32)
    for b in range(B):
        frames = int(wav_lens[b]) // 320
        n = min(n_phones, max(frames // 2, 1))
        d = 1 + rng.multinomial(frames - n, np.ones(n) / n)
        d[0] = 0 if n > 2 else d[0]
        avg[b, :n], ph[b, :n] = d, rng.integers(1, N_SYM, n)
    return P.PRBatch(wavs, wav_lens, avg, ph, np.zeros(B, np.int32), N_SYM, "xx")


def _jbatch(b):
    return J.PRBatch(*(jnp.asarray(x) for x in b[:5]), n_symbols=b.n_symbols,
                     symbol_id=b.symbol_id)


KINDS = {"pr-ssl-linear": J.SSLLinearSystem, "pr-ssl-baseline": J.SSLBaselineSystem,
         "pr-ssl-cluster": J.SSLClusterSystem, "pr-trans-head": J.TransHeadPRSystem,
         "pr-ssl-protonet": J.SSLProtoNetSystem}
EPISODIC = ("pr-trans-head", "pr-ssl-protonet")


def build(kind, seed=3):
    """(fscl_tpu system, its variables, port system, port batch, fscl_tpu
    batch) of one PR system kind: the port's init under `seed` carried to
    fscl_tpu, fscl_tpu's upstream carried to the port."""
    jm, pm = _model_cfg(jax_config), _model_cfg(torch_config)
    jsys = KINDS[kind](jm, jax_config.OptimConfig(**STEP), ID2SYMBOLS)
    torch.manual_seed(seed)
    psys = SYSTEMS.get(kind)(pm, ID2SYMBOLS, device="cpu",
                             optim_cfg=torch_config.OptimConfig(**STEP))
    for m in psys.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    up = _jax_upstream()
    psys.load_upstream(convert.hubert_state_dict(up))
    v = convert.pr_variables(psys.state_dict())
    v["frozen"] = {"upstream": up}
    if kind in EPISODIC:
        batch = P.PREpisode(pr_batch(seed + 10), pr_batch(seed + 11, (3900, 2200)))
        jbatch = J.PREpisode(_jbatch(batch.sup), _jbatch(batch.qry))
    else:
        batch = pr_batch(seed + 10)
        jbatch = _jbatch(batch)
    return jsys, v, psys, batch, jbatch


def _jax_logits(kind, jsys, params, jbatch, up):
    if kind == "pr-ssl-protonet":
        protos = jsys.build_prototypes(params, jbatch.sup, upstream_params=up)
        return jsys.classify(params, protos, jbatch.qry, upstream_params=up)
    return jsys.logits(params, jbatch, upstream_params=up)


def _port_logits(kind, psys, batch):
    b = to_device(batch, "cpu")
    if kind == "pr-ssl-protonet":
        return psys.classify(psys.build_prototypes(b.sup), b.qry)
    return psys.logits(b)


@pytest.mark.parametrize("kind", list(KINDS))
def test_system_train_step_matches(kind, no_dropout):
    """One train step of each PR system: logits, metrics, every trainable
    gradient and the parameters after fscl_tpu's Adam step; the frozen
    upstream stays out of the optimizer and unchanged; the converters carry
    the weights both ways exactly."""
    jsys, v, psys, batch, jbatch = build(kind)
    params, up = to_jax(v["params"]), to_jax(v["frozen"]["upstream"])
    with torch.no_grad():
        _close(_port_logits(kind, psys, batch).numpy(),
               jax.jit(functools.partial(_jax_logits, kind, jsys))(params, jbatch, up),
               LOGIT_RTOL, "logits")

    def loss(p, b, u):
        return jsys.loss_and_metrics(p, {}, b, jax.random.PRNGKey(0), True, {"upstream": u})
    (_, (metrics, _)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, jbatch, up)
    want_grads = {k: x.numpy() for k, x in convert.pr_state_dict(
        _np({"params": grads})).items()}
    tx = jax_make_optimizer(jsys.optim_cfg, jsys.trainable_mask(params))
    state, _ = create_state({"params": params, "batch_stats": {}}, tx)
    new = jax.jit(lambda s, g: apply_grads(s, g, tx, {}))(state, grads)
    want_params = {k: x.numpy() for k, x in convert.pr_state_dict(
        _np({"params": new.params})).items()}

    sd = psys.state_dict()
    assert all(torch.equal(x, sd[k]) for k, x in convert.pr_state_dict(v).items())
    up_before = {k: x.clone() for k, x in sd.items() if k.startswith("upstream.")}
    pstate = psys.init_state()
    mask = psys.trainable_mask()
    names = [n for n, _ in psys.named_parameters() if mask[n]]
    assert names and not any(n.startswith("upstream.") or "bias_ih" in n for n in names)
    psys.train()
    got_loss, got_metrics = psys.loss_and_metrics(to_device(batch, "cpu"))
    pp = dict(psys.named_parameters())
    got = torch.autograd.grad(got_loss, [pp[n] for n in names], allow_unused=True)
    psys.eval()
    assert set(got_metrics) == set(metrics)
    for k, x in got_metrics.items():
        np.testing.assert_allclose(float(x), float(metrics[k]), rtol=LOSS_RTOL, err_msg=k)
    for name, g in zip(names, got):
        w = want_grads[name]
        _close(np.zeros_like(w) if g is None else g.numpy(), w, GRAD_RTOL, name, floor=1e-3)
    psys.train_step(pstate, to_device(batch, "cpu"))
    for name in names:
        _close(pp[name].detach().numpy(), want_params[name], PARAM_RTOL, name, floor=1e-3)
    for k, x in psys.state_dict().items():
        if k in up_before:
            assert torch.equal(x, up_before[k]), k
    assert not psys.training


def test_converters_work_both_ways():
    """fscl_tpu's own init of each PR system (the heads of the init batch's
    language) carried to the port and back, leaf for leaf."""
    for kind, jcls in KINDS.items():
        jsys, _, psys, batch, jbatch = build(kind, seed=5)
        jsys.upstream_params = to_jax(_jax_upstream())
        v = _np(jsys.init_variables(jax.random.PRNGKey(9), jbatch))
        v.pop("frozen")
        sd = convert.pr_state_dict(v)
        missing, unexpected = psys.load_state_dict(sd, strict=False)
        assert not unexpected and all(k.startswith("upstream.") for k in missing), kind
        back = convert.pr_variables(psys.state_dict())
        jax.tree.map(np.testing.assert_array_equal, back, v)


def test_port_heads_cover_every_language_where_fscl_tpu_inits_one():
    """A departure on purpose: fscl_tpu's PR heads create only the head of
    the language they are initialised with, so a batch of a second language
    fails on its parameters; the port holds a head for each language of
    id2symbols."""
    id2 = (("en", 5), ("zh", 7))
    h = np.ones((1, 3, D), np.float32)
    jh = jds.MultilingualPRHead(id2, D)
    v = jh.init(jax.random.PRNGKey(0), jnp.asarray(h), "en")
    with pytest.raises(Exception, match="head-zh"):
        jh.apply(v, jnp.asarray(h), "zh")
    assert pds.MultilingualPRHead(id2, D)(_t(h), "zh").shape == (1, 3, 7)
