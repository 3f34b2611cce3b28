"""Parity of the port's MAML and iMAML with fscl_tpu, on the CPU in float32.

`inner_adapt` and `cg_solve` on fscl_tpu's quadratics
(tests/test_maml_tune.py), then one episode of `MAMLTransEmbSystem`
(second order with `speaker_emb: dvec`, so GE2E's LSTM is differentiated
twice through `lstm_unrolled`; first order with a speaker table) and of
`IMAMLTransEmbSystem` (dvec), each from fscl_tpu's init carried over by
`fscl_tpu_torch.convert.transemb_state_dict`, on the same numpy episode: a
2-layer custom upstream of dim 64, a 16-row codebook in 2 heads and the
2 + 2 layer trunk of tests/torch_parity.py, every dropout rate 0 (see
tests/test_torch_train.py for why).

Tolerances: the episode's metrics 1e-5 relative; every trainable tensor's
gradient 1e-4 relative to that tensor's own largest |entry| (measured up
to 1.4e-5: the forward's differences of about 1e-6 relative through a
second derivative and two FFT stacks), plus 1e-6 absolute for a gradient
that is 0 in exact arithmetic (`zero_in_exact_arithmetic`: rounding alone,
measured up to 1.5e-7); the quadratics 1e-5 relative (f32 arithmetic on a
few numbers).

iMAML's meta-gradient is held to fscl_tpu's in float64 (`jax.enable_x64`,
the flax LSTM carry and fscl_tpu's float32 casts mapped to float64 by
`fscl_tpu_float64`): the port's float64 within 1e-5 of it per tensor
(measured 2.3e-6), the port's float32 within 1e-4 (measured about 1e-5).
fscl_tpu's own float32 meta-gradient is 1.2e-2 off its float64 one in
every tensor, while the port's float32 is within 8e-6 of its float64:
`test_fscl_tpu_float32_imaml_meta_gradient_is_off_its_float64` pins it.
"""
import contextlib
import dataclasses
import functools
import importlib
import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fscl_tpu.core.config as jax_config
import fscl_tpu_torch.core.config as torch_config
from fscl_tpu.data.batch import Batch as JBatch
from fscl_tpu.data.batch import DvecRefs as JDvecRefs
from fscl_tpu.data.batch import SupInfo as JSupInfo
from fscl_tpu.systems import maml as jmaml
from fscl_tpu.systems.fscl import Episode as JEpisode
from fscl_tpu_torch.convert import transemb_state_dict
from fscl_tpu_torch.data.batch import SupInfo, collate_batch, to_device
from fscl_tpu_torch.systems import maml as pmaml
from fscl_tpu_torch.systems.fscl import Episode

from torch_parity import NoDropout, make_cfg, to_jax

LOSS_RTOL, GRAD_REL, ZERO_ATOL, F64_REL = 1e-5, 1e-4, 1e-6, 1e-5
QUAD_RTOL = 1e-5
N_SYM = 24
S, T_WAV, L_SUP = 2, 4000, 6
N_SLICES, SLICE_T = 3, 20


@pytest.fixture(scope="module", autouse=True)
def _no_dropout_few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", NoDropout)
        yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# -- inner_adapt and cg_solve -------------------------------------------------------

@pytest.mark.parametrize("first_order", [False, True], ids=["second_order", "first_order"])
def test_inner_adapt_matches_on_a_quadratic(first_order):
    """fscl_tpu's quadratic (test_maml_tune.py:53), then the outer gradient
    of a loss at the adapted point: through the inner gradients (second
    order) or through the identity only (first order)."""
    target = np.array([1.0, 2.0, 3.0], np.float32)
    w0 = np.array([0.5, -1.0, 0.25], np.float32)

    def jloss(p):
        return jnp.sum(p["s"] * (p["w"] - target) ** 2)

    def jouter(w):
        adapted = jmaml.inner_adapt(jloss, {"w": w, "s": jnp.float32(1.5)}, 0.1, 3, first_order)
        return jnp.sum(adapted["w"] ** 3)

    want_val, want_grad = jax.value_and_grad(jouter)(jnp.asarray(w0))
    adapted_j = jmaml.inner_adapt(jloss, {"w": jnp.zeros(3), "s": jnp.float32(1.0)}, 0.1, 20)

    t_target = torch.from_numpy(target)
    w = torch.from_numpy(w0).requires_grad_()
    adapted = pmaml.inner_adapt(lambda p: (p["s"] * (p["w"] - t_target) ** 2).sum(),
                                {"w": w, "s": torch.tensor(1.5)}, 0.1, 3, first_order)
    val = (adapted["w"] ** 3).sum()
    grad, = torch.autograd.grad(val, w)
    np.testing.assert_allclose(float(val), float(want_val), rtol=QUAD_RTOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=QUAD_RTOL)
    got = pmaml.inner_adapt(lambda p: (p["s"] * (p["w"] - t_target) ** 2).sum(),
                            {"w": torch.zeros(3), "s": torch.tensor(1.0)}, 0.1, 20)
    np.testing.assert_allclose(got["w"].detach().numpy(), np.asarray(adapted_j["w"]),
                               rtol=QUAD_RTOL)
    assert pmaml.inner_adapt(None, {"w": w}, 0.1, 0)["w"] is w


def test_cg_solve_matches_on_quadratics():
    """fscl_tpu's two CG checks (test_maml_tune.py:130, :141): a diagonal
    SPD system solved in n steps, and iMAML's analytic implicit gradient
    (1 + a / lambda)^-1 g with the HVP taken reverse over reverse."""
    a = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    b = np.array([4.0, 6.0, 6.0, 4.0], np.float32)
    got = pmaml.cg_solve(lambda v: {"x": torch.from_numpy(a) * v["x"]},
                         {"x": torch.from_numpy(b)}, 4)["x"]
    want = jmaml.cg_solve(lambda v: {"x": jnp.asarray(a) * v["x"]}, {"x": jnp.asarray(b)}, 4)["x"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=QUAD_RTOL)
    np.testing.assert_allclose(got.numpy(), b / a, rtol=1e-4)

    curv, lam = 3.0, 2.0
    p = {"w": torch.tensor(1.0, requires_grad=True)}
    g_sup = pmaml._grads(0.5 * curv * p["w"] ** 2, p, create_graph=True)

    def matvec(v):
        hv = pmaml._grads(pmaml._tree_dot(g_sup, v), p, retain_graph=True)
        return {n: v[n] + hv[n] / lam for n in v}

    v = pmaml.cg_solve(matvec, {"w": torch.tensor(5.0)}, 5)
    np.testing.assert_allclose(float(v["w"]), 5.0 / (1 + curv / lam), rtol=QUAD_RTOL)


# -- one episode of each system -------------------------------------------------------

def _cfg(C, speaker):
    cfg = make_cfg(C)
    return dataclasses.replace(
        cfg,
        transformer=dataclasses.replace(cfg.transformer, encoder_dropout=0.0,
                                        decoder_dropout=0.0),
        variance_predictor=dataclasses.replace(cfg.variance_predictor, dropout=0.0),
        speaker=C.SpeakerConfig(emb_type=speaker, n_speakers=4, n_ref_slices=N_SLICES),
        codebook=C.CodebookConfig(size=16, num_heads=2, dim=64),
        upstream=C.UpstreamConfig(name="custom", dim=64, n_layers=3))


def tts_batch(seed, B, dvec, padded=True):
    """A TTS batch of learnable targets (d-vector references, with padded
    slices unless `padded` is False, or speaker ids), from `collate_batch`."""
    rng = np.random.default_rng(seed)
    table = np.random.default_rng(99).normal(size=(N_SYM, 82)).astype(np.float32)
    samples = []
    for i in range(B):
        n = int(rng.integers(6, 15))
        ph = rng.integers(1, N_SYM, n)
        dur = rng.integers(1, 5, n)
        frames = np.repeat(ph, dur)
        samples.append(dict(
            id=str(i), text="", phonemes=ph, duration=dur,
            mel=table[frames, :80] + 0.1 * rng.normal(size=(len(frames), 80)).astype(np.float32),
            pitch=table[ph, 80] + 0.1 * rng.normal(size=n),
            energy=table[ph, 81] + 0.1 * rng.normal(size=n), speaker=i % 4,
            lang_id=int(rng.integers(0, 2)),
            spk_ref_mel_slices=rng.normal(size=(N_SLICES - i % N_SLICES if padded else N_SLICES,
                                                SLICE_T, 40)).astype(np.float32)))
    return collate_batch(samples, (16,), (64,), dvec_slices=N_SLICES if dvec else None,
                         pitch_feature="phoneme_level", energy_feature="phoneme_level")[1]


def support(seed):
    rng = np.random.default_rng(seed)
    wav = 0.3 * rng.normal(size=(S, T_WAV))
    wav_lens = np.array([T_WAV, 3100], np.int32)
    wav = np.where(np.arange(T_WAV)[None] < wav_lens[:, None], wav, 0.0)
    avg_frames = np.array([[2, 0, 3, 1, 2, 3], [3, 3, 2, 4, 1, 2]], np.int32)
    phonemes = rng.integers(1, N_SYM, (S, L_SUP)).astype(np.int32)
    phonemes[1, :2] = phonemes[0, :2]
    return SupInfo(np.round(wav * 32767).astype(np.int16), wav_lens, avg_frames, phonemes, N_SYM)


def episode(seed, dvec=True, padded_support=False):
    """The support TTS batch has no padded d-vector slice unless asked (see
    `test_second_order_through_padded_dvec_slices_is_nan_in_fscl_tpu`)."""
    return Episode(sup=support(seed), qry=tts_batch(seed, 3, dvec),
                   sup_batch=tts_batch(seed + 100, 2, dvec, padded=padded_support))


def jax_batch(b):
    spk = (JDvecRefs(*map(jnp.asarray, b.speaker_args)) if isinstance(b.speaker_args, tuple)
           else jnp.asarray(b.speaker_args))
    return JBatch(spk, *(jnp.asarray(x) for x in b[1:]))


def jax_episode(ep):
    sup = ep.sup
    return JEpisode(sup=JSupInfo(*(jnp.asarray(x) for x in sup[:4]), n_symbols=sup.n_symbols),
                    qry=jax_batch(ep.qry),
                    sup_batch=None if ep.sup_batch is None else jax_batch(ep.sup_batch))


def jax_variables(jsys, ep):
    """fscl_tpu's init (float support wavs), the duration head pinned near
    log 4 so the decoder sees realistic lengths."""
    init_ep = ep._replace(sup=ep.sup._replace(wavs=ep.sup.wavs.astype(np.float32) / 32768.0))
    variables = _np(jsys.init_variables(jax.random.PRNGKey(0), jax_episode(init_ep)))
    lin = variables["params"]["model"]["variance_adaptor"]["duration_predictor"]["linear_layer"]
    lin["bias"] = (lin["bias"] + np.log(4.0)).astype(np.float32)
    return variables


@contextlib.contextmanager
def fscl_tpu_float64():
    """fscl_tpu in float64: `jax.enable_x64`, flax's LSTM carry cast to the
    input's type, and the float32 that fscl_tpu's codebook attention, HuBERT
    and duration loss name outright read as float64."""
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.float32 = jnp.float64
    cell = flax.linen.OptimizedLSTMCell
    carry = cell.initialize_carry
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for mod in ("fscl_tpu.nn.embeddings", "fscl_tpu.models.hubert", "fscl_tpu.nn.losses"):
            mp.setattr(importlib.import_module(mod), "jnp", proxy)
        mp.setattr(cell, "initialize_carry", lambda self, rng, shape: jax.tree.map(
            lambda c: c.astype(jnp.float64), carry(self, rng, shape)))
        yield


def _to_f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64)
                        if np.asarray(x).dtype == np.float32 else np.asarray(x), tree)


def jax_loss_and_grads(jsys, variables, ep, x64=False):
    def loss(params, batch_stats, episode, frozen):
        return jsys.loss_and_metrics(params, batch_stats, episode, None, True, frozen)

    jep = jax_episode(ep)
    with fscl_tpu_float64() if x64 else contextlib.nullcontext():
        if x64:
            variables, jep = _to_f64(variables), jax.tree.map(
                lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x, jep)
        (loss, (metrics, new_bs)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            to_jax(variables["params"]), to_jax(variables["batch_stats"]), jep,
            to_jax(variables["frozen"]))
        assert not x64 or {x.dtype for x in jax.tree.leaves(grads)} == {jnp.dtype("float64")}
        grads = transemb_state_dict(_np({"params": grads,
                                         "batch_stats": variables["batch_stats"]}))
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads, new_bs


def zero_in_exact_arithmetic(name):
    """A gradient that is 0 in exact arithmetic, so rounding alone in either
    package: an attention key's bias (softmax ignores a shift of every
    score) and a conv bias before a BatchNorm in train mode (the batch mean
    takes the shift away). Second order, such a bias also reaches the loss
    through the inner step's eval-mode BatchNorm, a part smaller than that
    rounding (2.5e-6 here)."""
    return name.endswith("attn.w_ks.bias") or (
        ".postnet.convolutions." in name and name.endswith(".conv.bias"))


def assert_grad_close(name, got, want, rel=GRAD_REL):
    """`got` within `rel` of `want`'s own largest |entry|, plus ZERO_ATOL
    where the gradient is 0 in exact arithmetic."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    bound = rel * scale + (ZERO_ATOL if zero_in_exact_arithmetic(name) else 0.0)
    assert err <= bound, (name, err, scale)


def port_system(cls, cfg, variables, **kw):
    tsys = cls(cfg, N_SYM, device="cpu", **kw)
    tsys.load_state_dict(transemb_state_dict(variables), strict=True)
    tsys.model.postnet.dropout.p = 0.0
    return tsys


def assert_grads_match(tsys, loss, want, rel=GRAD_REL):
    mask = tsys.trainable_mask()
    names = [n for n, _ in tsys.named_parameters() if mask[n]]
    params = dict(tsys.named_parameters())
    got = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    assert not any(n.startswith("upstream.") or "bias_ih" in n for n in names)
    reached = 0
    for name, g in zip(names, got):
        w = want[name].numpy()
        assert_grad_close(name, np.zeros_like(w) if g is None else g.numpy(), w, rel)
        reached += float(np.abs(w).max()) > 1e-7
    assert reached > 0.9 * len(names)
    return dict(zip(names, got))


def postnet_stats(tsys):
    return {k: v.clone() for k, v in tsys.model.postnet.state_dict().items() if "running" in k}


CASES = {"maml_dvec_second_order": (jmaml.MAMLTransEmbSystem, pmaml.MAMLTransEmbSystem, "dvec",
                                    dict(adaptation_lr=1e-2, adaptation_steps=2)),
         "maml_table_first_order": (jmaml.MAMLTransEmbSystem, pmaml.MAMLTransEmbSystem, "table",
                                    dict(adaptation_lr=1e-2, adaptation_steps=2,
                                         first_order=True)),
         "imaml_dvec": (jmaml.IMAMLTransEmbSystem, pmaml.IMAMLTransEmbSystem, "dvec",
                        dict(adaptation_lr=1e-2, adaptation_steps=3, cg_steps=2,
                             reg_param=1.0))}


@functools.lru_cache(maxsize=None)
def reference(case, x64=False):
    """fscl_tpu's system, init, episode and `jax.grad` of `loss_and_metrics`
    (in float64 with `x64`), computed once per case."""
    jcls, _, speaker, kw = CASES[case]
    jsys = jcls(_cfg(jax_config, speaker), jax_config.OptimConfig(), N_SYM, **kw)
    ep = episode(1, dvec=speaker == "dvec")
    variables = jax_variables(jsys, ep)
    return variables, ep, jax_loss_and_grads(jsys, variables, ep, x64)


@pytest.mark.parametrize("case", list(CASES))
def test_meta_episode_loss_gradients_and_batchnorm_match(case):
    """One episode in train mode: the metrics and every trainable gradient
    against `jax.grad` of fscl_tpu's `loss_and_metrics`, which returns no
    new BatchNorm statistics (iMAML's gradients against fscl_tpu's float64
    ones, see the module's docstring); one `train_step` of the port then
    leaves the PostNet's running statistics as they were, and moves the
    codebook and the trunk."""
    _, pcls, speaker, kw = CASES[case]
    variables, ep, (want_loss, want_metrics, want_grads, new_bs) = reference(case)
    assert new_bs is None
    if case.startswith("imaml"):
        want_grads = reference(case, x64=True)[2][2]

    tsys = port_system(pcls, _cfg(torch_config, speaker), variables, **kw)
    tsys.train()
    loss, metrics = tsys.loss_and_metrics(to_device(ep, "cpu"))
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    assert set(metrics) == set(want_metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), want_metrics[k], rtol=LOSS_RTOL, err_msg=k)
    grads = assert_grads_match(tsys, loss, want_grads)
    tsys.eval()
    if speaker == "dvec":
        assert any(n.startswith("model.speaker_emb.ge2e.lstm") and g.abs().max() > 0
                   for n, g in grads.items())
        assert not any(m.unrolled for m in tsys.modules() if hasattr(m, "unrolled"))

    stats = postnet_stats(tsys)
    before = {k: v.clone() for k, v in tsys.state_dict().items()}
    state = tsys.init_state()
    _, m = tsys.train_step(state, to_device(ep, "cpu"))
    assert np.isfinite(float(m["Total Loss"]))
    for k, v in postnet_stats(tsys).items():
        assert torch.equal(v, stats[k]), k
    after = tsys.state_dict()
    for key in ("codebook.emb_banks", "model.decoder.layer_stack.0.pos_ffn.w_1.weight"):
        assert not torch.equal(after[key], before[key]), key
    assert not tsys.training


def test_maml_needs_the_support_batch():
    tsys = pmaml.MAMLTransEmbSystem(_cfg(torch_config, "table"), N_SYM, device="cpu")
    with pytest.raises(ValueError, match="with_sup_batch"):
        tsys.loss_and_metrics(to_device(episode(2, dvec=False)._replace(sup_batch=None), "cpu"))


def test_eval_step_adapts_under_no_grad():
    """An eval step runs the inner loop too (fscl_tpu's loss_and_metrics at
    train=False), under `no_grad`: the metrics equal a train-mode-free
    forward of the adapted query loss and no parameter keeps a gradient."""
    tsys = pmaml.MAMLTransEmbSystem(_cfg(torch_config, "dvec"), N_SYM, device="cpu",
                                    adaptation_lr=1e-2, adaptation_steps=1)
    ep = to_device(episode(3), "cpu")
    state = tsys.init_state()
    metrics = tsys.eval_step(state, ep)
    with torch.enable_grad():
        loss, _ = tsys.loss_and_metrics(ep)
    np.testing.assert_allclose(float(metrics["Total Loss"]), float(loss), rtol=1e-6)
    assert all(p.grad is None for p in tsys.parameters())


def test_second_order_through_padded_dvec_slices_is_nan_in_fscl_tpu():
    """A reference fault the port does not share: at flax's init GE2E's LSTM
    biases are 0, so a padded (all-zero) reference slice of the support
    batch gives a zero partial embedding, and the second derivative of
    `jnp.linalg.norm` at 0 is NaN; the mask's 0 times it stays NaN, and
    fscl_tpu's second-order MAML meta-gradient is NaN in nearly every
    tensor (even at an inner rate of 0). torch's norm takes 0 there, and
    the port's gradient is finite; the loss agrees."""
    kw = dict(adaptation_lr=0.0, adaptation_steps=1)
    jsys = jmaml.MAMLTransEmbSystem(_cfg(jax_config, "dvec"), jax_config.OptimConfig(), N_SYM,
                                    **kw)
    ep = episode(4, padded_support=True)
    variables = jax_variables(jsys, ep)
    want_loss, _, want_grads, _ = jax_loss_and_grads(jsys, variables, ep)
    bad = [k for k, g in want_grads.items() if not torch.isfinite(g).all()]
    assert len(bad) > 100 and "codebook.emb_banks" in bad
    tsys = port_system(pmaml.MAMLTransEmbSystem, _cfg(torch_config, "dvec"), variables, **kw)
    tsys.train()
    loss, _ = tsys.loss_and_metrics(to_device(ep, "cpu"))
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    grads = torch.autograd.grad(loss, [p for n, p in tsys.named_parameters()
                                       if tsys.trainable_mask()[n]], allow_unused=True)
    assert all(torch.isfinite(g).all() for g in grads if g is not None)


def _f64(tree):
    return torch.utils._pytree.tree_map(
        lambda x: x.double() if torch.is_tensor(x) and x.is_floating_point() else x, tree)


def _meta_grads(tsys, ep):
    tsys.train()
    loss, metrics = tsys.loss_and_metrics(ep)
    mask = tsys.trainable_mask()
    named = [(n, p) for n, p in tsys.named_parameters() if mask[n]]
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    tsys.eval()
    return {k: float(v) for k, v in metrics.items()}, {
        n: (torch.zeros_like(p) if g is None else g).double() for (n, p), g in zip(named, grads)}


@functools.lru_cache(maxsize=None)
def port_imaml(dtype):
    """The port's iMAML episode of `reference("imaml_dvec")` on fscl_tpu's
    init, in `dtype`: (metrics, gradients in float64)."""
    _, pcls, _, kw = CASES["imaml_dvec"]
    variables, ep, _ = reference("imaml_dvec")
    tsys = port_system(pcls, _cfg(torch_config, "dvec"), variables, **kw).to(dtype)
    ep = to_device(ep, "cpu")
    return _meta_grads(tsys, _f64(ep) if dtype == torch.float64 else ep)


def test_imaml_meta_gradient_matches_itself_in_float64():
    """The port's iMAML meta-gradient in float32 against the same episode
    (d-vector speakers, fscl_tpu's init) in float64: within 1e-5 of the
    whole gradient's largest |entry| and 1e-4 of each tensor's own."""
    _, g32 = port_imaml(torch.float32)
    _, g64 = port_imaml(torch.float64)
    scale = max(float(g.abs().max()) for g in g64.values())
    for n in g64:
        assert float((g32[n] - g64[n]).abs().max()) <= F64_REL * scale, n
        assert_grad_close(n, g32[n].numpy(), g64[n].numpy())


def test_imaml_meta_gradient_matches_fscl_tpu_in_float64():
    """Both packages in float64 on the same episode and weights: the metrics
    1e-5 relative, every gradient 1e-5 of its own largest |entry|."""
    _, _, (_, want_metrics, want_grads, _) = reference("imaml_dvec", x64=True)
    metrics, grads = port_imaml(torch.float64)
    for k, v in metrics.items():
        np.testing.assert_allclose(v, want_metrics[k], rtol=LOSS_RTOL, err_msg=k)
    for n, g in grads.items():
        assert_grad_close(n, g.numpy(), want_grads[n].numpy(), rel=F64_REL)


def test_fscl_tpu_float32_imaml_meta_gradient_is_off_its_float64():
    """A precision fault of fscl_tpu that the port does not share: its
    float32 iMAML meta-gradient is more than 1e-3 (1.2e-2 measured) off its
    own float64 one in nearly every tensor, while the port's float32 keeps
    within 1e-4 of float64 (the two tests above)."""
    want64 = reference("imaml_dvec", x64=True)[2][2]
    want32 = reference("imaml_dvec")[2][2]
    names = [n for n in port_imaml(torch.float32)[1] if not zero_in_exact_arithmetic(n)]
    off = [n for n in names if float((want32[n] - want64[n]).abs().max())
           > 1e-3 * float(want64[n].abs().max())]
    assert len(off) > 0.9 * len(names), (len(off), len(names))
