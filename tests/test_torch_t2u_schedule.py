"""Scheduled sampling in the port's T2U decoder against fscl_tpu, on the CPU
in float32, at a narrow width (encoder 12, RNNs 10, 21 unit symbols).

fscl_tpu's `TacoT2U.__call__` decides at each step t from one batch-wide
draw, `uniform(split(fold_in(rng, t), 3)[0]) < teacher_forcing_ratio` (step 0
always the target), whether the step reads the previous target or the
embedding of its own previous argmax. The tests compute those choices with
fscl_tpu's recipe and hand them to the port as `T2UMasks.teacher`, beside the
prenet masks rebuilt from the same keys (`torch_parity.t2u_scan_masks`; the
prenet's dropout is on even in eval mode, in both packages). Eval mode: no
other dropout, the encoder's BatchNorm on its running statistics.

Tolerances: logits within 1e-4 of their largest |value| (the recurrence
carries f32 differences from step to step); gradients within 1e-4 of each
tensor's own largest entry. A sampled step follows fscl_tpu's argmax, so the
cases assert that fscl_tpu's top-2 logit margin stays above ARGMAX_MARGIN
there (a near-tie could go either way under another summation order).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fscl_tpu.core.config as jax_config
import fscl_tpu_torch.core.config as torch_config
from fscl_tpu.models.tacotron2_t2u import T2UConfig as JT2UConfig
from fscl_tpu.models.tacotron2_t2u import TacoT2U as JTacoT2U
from fscl_tpu.nn.losses import framewise_ce_loss as jax_ce
from fscl_tpu.systems import t2u as J
from fscl_tpu_torch import convert
from fscl_tpu_torch.models.tacotron2_t2u import T2UConfig, TacoT2U, draw_masks
from fscl_tpu_torch.nn.losses import framewise_ce_loss
from fscl_tpu_torch.systems import t2u as P

from torch_parity import make_cfg, t2u_scan_masks

LOGIT_REL, GRAD_REL, ARGMAX_MARGIN = 1e-4, 1e-4, 1e-4
N_UNITS, N_SYM = 21, 24
TINY = dict(n_units=N_UNITS, d_unit=8, symbols_embedding_dim=8, encoder_embedding_dim=12,
            prenet_dim=8, attention_rnn_dim=10, decoder_rnn_dim=10, attention_dim=6,
            attention_location_n_filters=3, attention_location_kernel_size=5)
JCFG, PCFG = JT2UConfig(**TINY), T2UConfig(**TINY)
B, L, TU = 3, 7, 12
ID2SYMBOLS = (("xx", N_SYM),)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(seed):
    """(text embeddings, text lengths, target units with <eos>-free padding)."""
    rng = np.random.default_rng(seed)
    lens = np.array([7, 4, 2], np.int32)
    emb = rng.normal(size=(B, L, TINY["symbols_embedding_dim"])).astype(np.float32)
    emb[np.arange(L)[None] >= lens[:, None]] = 0.0
    units = rng.integers(1, N_UNITS, (B, TU)).astype(np.int32)
    units[np.arange(TU)[None] >= np.array([12, 8, 5])[:, None]] = 0
    return emb, lens, units


@pytest.fixture(scope="module")
def model():
    """The port's TacoT2U (torch's init under a seed, BatchNorm statistics
    drawn with numpy) and fscl_tpu's variables converted from it."""
    torch.manual_seed(0)
    m = TacoT2U(PCFG).eval()
    rng = np.random.default_rng(1)
    for bn in m.encoder.norms:
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.2, bn.running_mean.shape)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, bn.running_var.shape)))
    v = convert.variables_from(convert.tacot2u_entries(), m.state_dict())
    return m, v


def jax_teacher(r_scan, T: int, ratio: float) -> np.ndarray:
    """fscl_tpu's per-step choices: step 0, or its draw below the ratio."""
    draws = np.array([float(jax.random.uniform(
        jax.random.split(jax.random.fold_in(r_scan, t), 3)[0], ())) for t in range(T)])
    return (np.arange(T) == 0) | (draws < ratio)


_APPLY = jax.jit(lambda v, e, lens, u, r, ratio: JTacoT2U(JCFG).apply(
    v, e, lens, u, r, teacher_forcing_ratio=ratio))


def _jax_loss(params, bs, e, lens, u, r, ratio):
    logits, _ = JTacoT2U(JCFG).apply({"params": params, "batch_stats": bs}, e, lens, u, r,
                                     teacher_forcing_ratio=ratio)
    return jax_ce(logits, u), logits


_GRAD = jax.jit(jax.value_and_grad(_jax_loss, has_aux=True))


def _margin_ok(logits, teacher):
    """fscl_tpu's top-2 margin at every step whose successor samples."""
    top2 = np.sort(logits, -1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    sampled_from = np.nonzero(~teacher[1:])[0]
    return len(sampled_from) == 0 or margin[:, sampled_from].min() > ARGMAX_MARGIN


def _close(got, want, rel, what):
    err = float(np.abs(got - want).max())
    bar = rel * float(np.abs(want).max())
    assert err <= bar, f"{what}: max |d| {err:.3g} > {bar:.3g}"


@pytest.mark.parametrize("ratio", [0.0, 0.5, 1.0])
def test_logits_match_at_ratio(model, ratio):
    """Ratios 0, 0.5 and 1 on fscl_tpu's prenet masks and teacher choices.
    At 0 the masks come without choices and the port completes them (every
    step but the first samples, whatever the draw)."""
    m, v = model
    emb, lens, units = _inputs(2)
    r_scan = jax.random.PRNGKey(5)
    want, _ = _APPLY(v, jnp.asarray(emb), jnp.asarray(lens), jnp.asarray(units), r_scan, ratio)
    want = np.asarray(want)
    teacher = jax_teacher(r_scan, TU, ratio)
    if ratio == 0.5:
        assert 1 < teacher.sum() < TU, teacher
    assert _margin_ok(want, teacher), "a near-tie where a step samples: pick another seed"
    masks = t2u_scan_masks(JCFG, r_scan, B, TU, False)
    if ratio == 0.5:
        masks = masks._replace(teacher=torch.from_numpy(teacher))
    with torch.no_grad():
        got, _ = m(torch.from_numpy(emb), torch.from_numpy(lens), torch.from_numpy(units).long(),
                   masks=masks, teacher_forcing_ratio=ratio)
    _close(got.numpy(), want, LOGIT_REL, f"logits at ratio {ratio}")


def test_gradients_match_at_half(model):
    """The loss and every trainable gradient at ratio 0.5: the sampled steps
    pass no gradient through the argmax, the unit embedding gets its rows'."""
    m, v = model
    emb, lens, units = _inputs(3)
    r_scan = jax.random.PRNGKey(8)
    teacher = jax_teacher(r_scan, TU, 0.5)
    assert 1 < teacher.sum() < TU, teacher
    (loss, logits), grads = _GRAD(v["params"], v["batch_stats"], jnp.asarray(emb),
                                  jnp.asarray(lens), jnp.asarray(units), r_scan, 0.5)
    assert _margin_ok(np.asarray(logits), teacher), "a near-tie: pick another seed"
    want = convert.state_dict_from(convert.tacot2u_entries(),
                                   {"params": jax.tree.map(np.asarray, grads),
                                    "batch_stats": v["batch_stats"]})
    masks = t2u_scan_masks(JCFG, r_scan, B, TU, False)._replace(
        teacher=torch.from_numpy(teacher))
    m.zero_grad()
    got_logits, _ = m(torch.from_numpy(emb), torch.from_numpy(lens),
                      torch.from_numpy(units).long(), masks=masks, teacher_forcing_ratio=0.5)
    got_loss = framewise_ce_loss(got_logits, torch.from_numpy(units))
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), rtol=1e-5)
    named = [(k, p) for k, p in m.named_parameters() if p.requires_grad]
    assert named and m.unit_embedding.weight.requires_grad
    for k, p in named:
        _close(p.grad.numpy(), want[k].numpy(), GRAD_REL, k)


def test_system_forward_takes_tf_ratio():
    """`TacoT2USystem.forward(..., tf_ratio)` against fscl_tpu's system at
    0.5, from the same weights (the system splits its key into the scan's
    and the dropout's, as fscl_tpu's)."""
    torch.manual_seed(2)
    psys = P.TacoT2USystem(make_cfg(torch_config), ID2SYMBOLS, PCFG, device="cpu")
    jsys = J.TacoT2USystem(make_cfg(jax_config), jax_config.OptimConfig(), ID2SYMBOLS, JCFG)
    v = convert.t2u_variables(psys.state_dict())
    emb, lens, units = _inputs(4)
    texts = np.random.default_rng(4).integers(1, N_SYM, (B, L)).astype(np.int32)
    texts[np.arange(L)[None] >= lens[:, None]] = 0
    batch = P.T2UBatch(np.zeros(B, np.int32), texts, lens, units, None, np.zeros(B, np.int32))
    rng = jax.random.PRNGKey(9)
    want, _, _ = jax.jit(lambda p, bs, t, sl, u, r: jsys.forward(
        p, bs, J.T2UBatch(None, t, sl, u, None, None), r, False, tf_ratio=0.5))(
        v["params"], v["batch_stats"], texts, lens, units, rng)
    want = np.asarray(want)
    r_scan, _ = jax.random.split(rng)
    teacher = jax_teacher(r_scan, TU, 0.5)
    assert 1 < teacher.sum() < TU and _margin_ok(want, teacher)
    masks = t2u_scan_masks(JCFG, r_scan, B, TU, False)._replace(
        teacher=torch.from_numpy(teacher))
    with torch.no_grad():
        got, _ = psys(batch._replace(texts=torch.from_numpy(texts),
                                     src_lens=torch.from_numpy(lens),
                                     units=torch.from_numpy(units)), masks, tf_ratio=0.5)
    _close(got.numpy(), want, LOGIT_REL, "system logits at 0.5")


def test_schedules_match():
    for step in (0, 1, 5000, 10000, 12345, 20000, 40000):
        assert P.schedule_f(step) == J.schedule_f(step) == 1.0
        np.testing.assert_allclose(P.linear_decay_schedule(step),
                                   float(J.linear_decay_schedule(step)), rtol=1e-6)
        np.testing.assert_allclose(P.linear_decay_schedule(step, floor=0.2, span=1e4),
                                   float(J.linear_decay_schedule(step, 0.2, 1e4)), rtol=1e-6)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_ratio_one_draws_what_it_drew_before(model, train):
    """At ratio 1 the forward draws only the dropout masks, in the order it
    drew them before scheduled sampling existed, so the generator ends where
    those draws leave it and the output is bit-equal to a forward without
    the argument; below 1 it draws T choices more."""
    m, _ = model
    emb, lens, units = (torch.from_numpy(x) for x in _inputs(5))
    m.train(train)
    try:
        runs = {}
        for ratio in (None, 1.0, 0.5):
            g = torch.Generator().manual_seed(11)
            kw = {} if ratio is None else {"teacher_forcing_ratio": ratio}
            with torch.no_grad():
                out, _ = m(emb, lens, units.long(), generator=g, **kw)
            runs[ratio] = out, g.get_state()
    finally:
        m.eval()
    g = torch.Generator().manual_seed(11)       # the draws of the forward before
    c = PCFG
    torch.rand((TU, 2, B, c.prenet_dim), generator=g)
    if train:
        torch.rand((c.encoder_n_convolutions, B, L, c.encoder_embedding_dim), generator=g)
        torch.rand((TU, B, c.attention_rnn_dim), generator=g)
        torch.rand((TU, B, c.decoder_rnn_dim), generator=g)
    assert torch.equal(runs[None][1], g.get_state())
    assert torch.equal(runs[1.0][1], g.get_state())
    assert torch.equal(runs[1.0][0], runs[None][0])
    assert not torch.equal(runs[0.5][1], g.get_state())
    masks = draw_masks(PCFG, B, L, TU, train, torch.Generator().manual_seed(11), "cpu")
    assert masks.teacher is None
    half = draw_masks(PCFG, B, L, TU, train, torch.Generator().manual_seed(11), "cpu", 0.5)
    assert half.teacher.shape == (TU,) and bool(half.teacher[0])
    for a, b in zip(masks[:4], half[:4]):
        assert (a is None and b is None) or torch.equal(a, b)


def test_fscl_t2u_step_reads_schedule_f(monkeypatch):
    """The FSCL-T2U forward decodes at `schedule_f(step)`, fscl_tpu's step
    (`systems/t2u.py:223`)."""
    cfg = dataclasses.replace(make_cfg(torch_config),
                              upstream=torch_config.UpstreamConfig(name="custom", dim=64,
                                                                   n_layers=3))
    psys = P.TransEmbT2USystem(cfg, N_SYM, PCFG, device="cpu")
    seen = []
    monkeypatch.setattr(P, "schedule_f", lambda step: seen.append(step) or 0.25)
    monkeypatch.setattr(psys, "decode", lambda *a: seen.append(a[-1]))
    monkeypatch.setattr(psys, "extract_ssl", lambda w, l: (torch.zeros(2, 12, 4, 64), None))
    monkeypatch.setattr(psys, "build_embedding_table",
                        lambda h, s: torch.zeros(N_SYM, PCFG.symbols_embedding_dim))
    qry = P.T2UBatch(None, torch.ones(B, L, dtype=torch.long), torch.tensor([7, 4, 2]),
                     torch.ones(B, TU, dtype=torch.long), None, None)
    psys(P.T2UEpisode(types.SimpleNamespace(wavs=None, wav_lens=None), qry), None, step=123)
    assert seen == [123, 0.25]
