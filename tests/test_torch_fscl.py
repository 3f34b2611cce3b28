"""Parity of the port's FSCL slice with fscl_tpu, on the CPU in float32.

Pieces first (segment ops, both codebooks, the GE2E d-vector encoder and its
converters both ways), then the whole meta-episode: fscl_tpu's
`TransEmbSystem` and the port's, at a small size (a 2-layer custom upstream
of dim 64, a 16-row codebook in 2 heads, the 2 + 2 layer trunk of
tests/torch_parity.py with `speaker_emb: dvec`), from fscl_tpu's init
carried over by `fscl_tpu_torch.convert.transemb_state_dict`, on the same
numpy episode (int16 support wavs, ragged wav_lens, zero durations and a
support row whose durations run past its frames, padded d-vector slices).
Every dropout rate is 0 (see tests/test_torch_train.py for why).

Tolerances, each with its reason:
- segment ops: 1e-6 absolute (the same f32 sums of O(1) features);
- codebooks and GE2E: 1e-5 absolute (f32 products in another order; GE2E
  outputs are unit vectors);
- the episode's metrics: 1e-5 relative, and every trainable gradient
  1e-5 absolute (the forward's differences, about 1e-6 relative, through
  the backward of two FFT stacks, the codebook and GE2E);
- trajectories at lr 1e-4, eps 1e-3 (the reason tests/test_torch_train.py
  gives: at eps 1e-9 Adam amplifies rounding): losses 1e-4 relative,
  parameters 2e-6 absolute.
"""
import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fscl_tpu.core.config as jax_config
import fscl_tpu.ops.segment_ops as jseg
import fscl_tpu_torch.core.config as torch_config
import fscl_tpu_torch.ops.segment_ops as tseg
from fscl_tpu.data.batch import Batch as JBatch
from fscl_tpu.data.batch import DvecRefs as JDvecRefs
from fscl_tpu.data.batch import SupInfo as JSupInfo
from fscl_tpu.nn.embeddings import SoftMultiAttCodebook as JCodebook
from fscl_tpu.nn.embeddings import SoftMultiAttCodebook2 as JCodebook2
from fscl_tpu.nn.speaker_encoder import SpeakerEncoder as JSpeakerEncoder
from fscl_tpu.nn.speaker_encoder import convert_resemblyzer_checkpoint
from fscl_tpu.systems.base import apply_grads, create_state
from fscl_tpu.systems.baseline import BaselineSystem as JBaseline
from fscl_tpu.systems.fscl import Episode as JEpisode
from fscl_tpu.systems.fscl import TransEmbSystem as JTransEmb
from fscl_tpu.systems.fscl import transplant_embedding as jax_transplant
from fscl_tpu.train.optim import make_optimizer as jax_make_optimizer
from fscl_tpu_torch.convert import (baseline_state_dict, codebook_state_dict, ge2e_state_dict,
                                    transemb_state_dict)
from fscl_tpu_torch.data.batch import DvecRefs, SupInfo, collate_batch, to_device
from fscl_tpu_torch.nn.embeddings import SoftMultiAttCodebook, SoftMultiAttCodebook2
from fscl_tpu_torch.nn.speaker_encoder import SpeakerEncoder
from fscl_tpu_torch.systems.baseline import BaselineSystem
from fscl_tpu_torch.systems.fscl import Episode, TransEmbSystem, transplant_embedding

from torch_parity import make_cfg, to_jax

SEG_ATOL = 1e-6
MOD_ATOL = 1e-5
LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-5
TRAJ_LOSS_RTOL, TRAJ_PARAM_ATOL = 1e-4, 2e-6
N_SYM = 24
S, T_WAV, L_SUP = 2, 4000, 6           # support: 2 wavs of 12 SSL frames
B, N_SLICES, SLICE_T = 3, 3, 20        # query batch, d-vector slices
TRAJ = dict(lr=1e-4, eps=1e-3, warmup_step=2, anneal_steps=(), grad_clip_thresh=0.5)


class _NoDropout(flax.linen.Module):
    rate: float = 0.0

    @flax.linen.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture(scope="module", autouse=True)
def _no_dropout_few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# -- segment ops ----------------------------------------------------------------

def _segment_inputs(seed=0):
    """Zero durations, a row whose durations run past T (its last segments
    fall wholly or partly past T), NaN frames, phoneme ids repeated across
    rows and one id >= n_symbols (dropped, as segment_sum drops it)."""
    rng = np.random.default_rng(seed)
    Bs, T, L, n_layers, D = 3, 14, 5, 3, 4
    reprs = rng.normal(size=(Bs, T, n_layers, D)).astype(np.float32)
    reprs[0, 2, 1, :] = np.nan
    reprs[2, 5] = np.nan
    durations = np.array([[2, 0, 3, 1, 4], [4, 4, 4, 3, 2], [0, 1, 0, 5, 0]], np.int32)
    phonemes = np.array([[3, 5, 3, 7, 1], [5, 2, 9, 3, 6], [4, 4, 11, 2, N_SYM - 1]], np.int32)
    phonemes[1, 4] = 12                  # >= n_symbols below: dropped
    return reprs, durations, phonemes


@pytest.mark.parametrize("fn", ["segment_mean", "phoneme_query_sums", "phoneme_query_extract",
                                "frame_phoneme_query_extract"])
def test_segment_ops_match(fn):
    reprs, durations, phonemes = _segment_inputs()
    args = (reprs, durations) if fn == "segment_mean" else (reprs, durations, phonemes)
    n_symbols = () if fn == "segment_mean" else (12,)
    want = getattr(jseg, fn)(*map(jnp.asarray, args), *n_symbols)
    got = getattr(tseg, fn)(*map(torch.from_numpy, args), *n_symbols)
    want, got = (want, got) if isinstance(got, tuple) else ((want,), (got,))
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=SEG_ATOL, rtol=0)


def test_queries_from_sums_and_past_t_segments():
    """A segment wholly past T still counts at its full duration (a zero
    mean in its symbol's average); an unseen symbol gives zeros."""
    reprs = torch.ones(1, 4, 1, 2)
    durations = torch.tensor([[2, 2, 3]])          # the third segment lies past T = 4
    phonemes = torch.tensor([[1, 2, 2]])
    sums, counts = tseg.phoneme_query_sums(reprs, durations, phonemes, 4)
    assert counts.tolist() == [0.0, 1.0, 2.0, 0.0]
    q = tseg.queries_from_sums(sums, counts)
    assert q.shape == (1, 4, 1, 2)
    assert q[0, :, 0, 0].tolist() == [0.0, 1.0, 0.5, 0.0]
    want = jseg.queries_from_sums(jnp.asarray(sums.numpy()), jnp.asarray(counts.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want))


# -- codebooks --------------------------------------------------------------------

@pytest.mark.parametrize("layer_idx,use_layer_weights", [(None, True), (2, True), (None, False)],
                         ids=["learned", "layer_idx", "no_layer_weights"])
def test_codebook2_matches(layer_idx, use_layer_weights):
    rng = np.random.default_rng(1)
    kw = dict(codebook_size=16, dim=32, num_heads=4, upstream_dim=12, n_layers=3,
              layer_idx=layer_idx, use_layer_weights=use_layer_weights)
    ref = rng.normal(size=(2, 7, 3, 12)).astype(np.float32)
    ref[1, 3, 0, 5] = np.nan
    jmod = JCodebook2(**kw)
    params = _np(jmod.init(jax.random.PRNGKey(1), jnp.asarray(ref)))
    params["params"]["q_linear"]["bias"] = rng.normal(size=32).astype(np.float32)
    if use_layer_weights:
        params["params"]["weight_raw"] = rng.normal(size=(1, 3, 1)).astype(np.float32)
    want, want_attn = jmod.apply(to_jax(params), jnp.asarray(ref), True)
    tmod = SoftMultiAttCodebook2(**kw)
    tmod.load_state_dict(codebook_state_dict(params["params"]), strict=True)
    got, attn = tmod(torch.from_numpy(ref), need_weights=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=MOD_ATOL, rtol=0)
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(want_attn), atol=MOD_ATOL, rtol=0)
    assert tmod(torch.from_numpy(ref))[1] is None
    lw = tmod.layer_weights()
    if use_layer_weights:
        np.testing.assert_allclose(lw.numpy(), np.asarray(jmod.layer_weights(to_jax(params))),
                                   atol=1e-7)
    else:
        assert lw is None
    if layer_idx is not None:   # the pinned layer alone, no gradient to weight_raw
        got.sum().backward()
        assert tmod.weight_raw.grad is None
        alone = SoftMultiAttCodebook2(**{**kw, "layer_idx": None})
        alone.load_state_dict(tmod.state_dict())
        one = np.repeat(ref[:, :, layer_idx:layer_idx + 1], 3, axis=2)
        torch.testing.assert_close(got, alone(torch.from_numpy(np.nan_to_num(one)))[0])


def test_codebook_matches():
    rng = np.random.default_rng(2)
    query = rng.normal(size=(2, 5, 32)).astype(np.float32)
    jmod = JCodebook(codebook_size=16, dim=32, num_heads=4)
    params = _np(jmod.init(jax.random.PRNGKey(2), jnp.asarray(query)))
    want, want_attn = jmod.apply(to_jax(params), jnp.asarray(query), True)
    tmod = SoftMultiAttCodebook(codebook_size=16, dim=32, num_heads=4)
    tmod.load_state_dict(codebook_state_dict(params["params"]), strict=True)
    got, attn = tmod(torch.from_numpy(query), need_weights=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=MOD_ATOL, rtol=0)
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(want_attn), atol=MOD_ATOL, rtol=0)


# -- GE2E d-vectors -----------------------------------------------------------------

def _dvec_refs(seed, n_real=(3, 1, 2)):
    rng = np.random.default_rng(seed)
    slices = rng.normal(size=(len(n_real), N_SLICES, SLICE_T, 40)).astype(np.float32)
    mask = (np.arange(N_SLICES)[None, :] < np.array(n_real)[:, None]).astype(np.float32)
    return slices, mask


@pytest.mark.parametrize("masked", [True, False], ids=["dvec_refs", "bare_slices"])
def test_ge2e_matches_and_converts_both_ways(masked):
    """The port's own init -> `convert_resemblyzer_checkpoint` -> fscl_tpu;
    and flax-layout params (new random values in every leaf, each gate's
    bias on the hidden side) -> `ge2e_state_dict` -> the port: the same
    d-vectors both ways, padded slices left out of the mean."""
    slices, mask = _dvec_refs(3)
    args = (JDvecRefs(jnp.asarray(slices), jnp.asarray(mask)) if masked
            else jnp.asarray(slices))
    targs = to_device(DvecRefs(slices, mask), "cpu") if masked else torch.from_numpy(slices)
    apply = jax.jit(JSpeakerEncoder("dvec", d_model=32).apply)

    torch.manual_seed(4)
    mine = SpeakerEncoder("dvec", d_model=32)
    back = {"params": {"ge2e": convert_resemblyzer_checkpoint(mine.ge2e.state_dict())["params"]}}
    np.testing.assert_allclose(mine(targs).detach().numpy(), np.asarray(apply(to_jax(back), args)),
                               atol=MOD_ATOL, rtol=0)

    rng = np.random.default_rng(5)
    params = jax.tree.map(lambda x: (0.2 * rng.normal(size=np.shape(x))).astype(np.float32), back)
    tmod = SpeakerEncoder("dvec", d_model=32)
    tmod.ge2e.load_state_dict(ge2e_state_dict(params["params"]["ge2e"]), strict=True)
    got = tmod(targs).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(apply(to_jax(params), args)), atol=MOD_ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-4)
    if masked:                  # a padded slice does not move the d-vector
        slices2 = slices.copy()
        slices2[1, 2] += 5.0
        torch.testing.assert_close(tmod(to_device(DvecRefs(slices2, mask), "cpu")), tmod(targs))


# -- the episode -------------------------------------------------------------------

def _cfg(C, speaker="dvec"):
    cfg = make_cfg(C)
    return dataclasses.replace(
        cfg,
        transformer=dataclasses.replace(cfg.transformer, encoder_dropout=0.0,
                                        decoder_dropout=0.0),
        variance_predictor=dataclasses.replace(cfg.variance_predictor, dropout=0.0),
        speaker=C.SpeakerConfig(emb_type=speaker, n_speakers=4, n_ref_slices=N_SLICES),
        codebook=C.CodebookConfig(size=16, num_heads=2, dim=64),
        upstream=C.UpstreamConfig(name="custom", dim=64, n_layers=3))


def _query(seed):
    """A query batch of learnable targets with d-vector references (two of
    three samples padded), from `collate_batch`."""
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
            energy=table[ph, 81] + 0.1 * rng.normal(size=n), speaker=0,
            lang_id=int(rng.integers(0, 2)),
            spk_ref_mel_slices=rng.normal(size=(3 - i % 3, SLICE_T, 40)).astype(np.float32)))
    return collate_batch(samples, (16,), (64,), dvec_slices=N_SLICES,
                         pitch_feature="phoneme_level", energy_feature="phoneme_level")[1]


def _support(seed, pcm=True):
    rng = np.random.default_rng(seed)
    wav = 0.3 * rng.normal(size=(S, T_WAV))
    wav_lens = np.array([T_WAV, 3100], np.int32)           # 12 and 9 valid frames
    wav = np.where(np.arange(T_WAV)[None] < wav_lens[:, None], wav, 0.0)
    wavs = np.round(wav * 32767).astype(np.int16) if pcm else wav.astype(np.float32)
    avg_frames = np.array([[2, 0, 3, 1, 2, 3], [3, 3, 2, 4, 1, 2]], np.int32)  # row 1: 15 > 12
    phonemes = rng.integers(1, N_SYM, (S, L_SUP)).astype(np.int32)
    phonemes[1, :2] = phonemes[0, :2]                       # shared symbols across rows
    return SupInfo(wavs, wav_lens, avg_frames, phonemes, N_SYM)


def _episode(seed):
    return Episode(sup=_support(seed), qry=_query(seed))


def _jax_episode(ep):
    qry = ep.qry
    spk = JDvecRefs(*map(jnp.asarray, qry.speaker_args))
    jqry = JBatch(spk, *(jnp.asarray(x) for x in qry[1:]))
    sup = ep.sup
    return JEpisode(sup=JSupInfo(*(jnp.asarray(x) for x in sup[:4]), n_symbols=sup.n_symbols),
                    qry=jqry)


@pytest.fixture(scope="module")
def jax_side():
    """fscl_tpu's TransEmbSystem at the test config, its variables (with the
    frozen upstream) and its train-mode loss under one jitted
    value_and_grad."""
    jsys = JTransEmb(_cfg(jax_config), jax_config.OptimConfig(), N_SYM)
    ep = _episode(0)
    init_ep = ep._replace(sup=_support(0, pcm=False))
    variables = _np(jsys.init_variables(jax.random.PRNGKey(0), _jax_episode(init_ep)))
    lin = variables["params"]["model"]["variance_adaptor"]["duration_predictor"]["linear_layer"]
    lin["bias"] = (lin["bias"] + np.log(4.0)).astype(np.float32)

    def loss(params, batch_stats, episode, frozen):
        return jsys.loss_and_metrics(params, batch_stats, episode, None, True, frozen)

    return jsys, variables, jax.jit(jax.value_and_grad(loss, has_aux=True))


def _torch_transemb(variables, optim_cfg=None):
    tsys = TransEmbSystem(_cfg(torch_config), N_SYM, device="cpu", optim_cfg=optim_cfg)
    tsys.load_state_dict(transemb_state_dict(variables), strict=True)
    tsys.model.postnet.dropout.p = 0.0
    return tsys


def _port_space(params, batch_stats):
    return {k: v.numpy() for k, v in
            transemb_state_dict(_np({"params": params, "batch_stats": batch_stats})).items()}


def test_episode_loss_and_gradients_match(jax_side):
    jsys, variables, grad_fn = jax_side
    ep = _episode(1)
    (loss, (metrics, new_bs)), grads = grad_fn(
        to_jax(variables["params"]), to_jax(variables["batch_stats"]), _jax_episode(ep),
        to_jax(variables["frozen"]))
    want = _port_space(grads, new_bs)

    tsys = _torch_transemb(variables)
    tsys.train()
    assert not tsys.upstream.training
    got_loss, got_metrics = tsys.loss_and_metrics(to_device(ep, "cpu"))
    mask = tsys.trainable_mask()
    names = [n for n, _ in tsys.named_parameters() if mask[n]]
    params = dict(tsys.named_parameters())
    got = torch.autograd.grad(got_loss, [params[n] for n in names], allow_unused=True)
    for k, v in got_metrics.items():
        np.testing.assert_allclose(float(v), float(metrics[k]), rtol=LOSS_RTOL, err_msg=k)
    assert not any(n.startswith("upstream.") for n in names)
    assert not any("bias_ih" in n for n in names)
    reached = 0
    for name, g in zip(names, got):
        w = want[name]
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=0, err_msg=name)
        reached += bool(np.abs(w).max() > 1e-6)
    for prefix in ("codebook.q_linear", "codebook.weight_raw", "codebook.emb_banks",
                   "codebook.att_banks", "model.speaker_emb.ge2e.lstm", "model.encoder"):
        assert any(n.startswith(prefix) and np.abs(want[n]).max() > 0 for n in names), prefix
    assert reached > 0.9 * len(names)


def test_build_embedding_table_matches(jax_side):
    """The (n_symbols, d) table: PAD row 0, unseen symbols through the
    codebook's zero query, the codebook's attention weights."""
    jsys, variables, _ = jax_side
    ep = _episode(2)
    jep = _jax_episode(ep)

    def table(params, frozen, sup):
        hidden, _ = jsys.extract_ssl(sup.wavs, sup.wav_lens, frozen["upstream"])
        return (hidden,) + jsys.build_embedding_table(params, hidden, sup, need_weights=True)

    hidden, want, want_attn = jax.jit(table)(to_jax(variables["params"]),
                                             to_jax(variables["frozen"]), jep.sup)
    tsys = _torch_transemb(variables)
    tep = to_device(ep, "cpu")
    got_hidden, valid = tsys.extract_ssl(tep.sup.wavs, tep.sup.wav_lens)
    np.testing.assert_allclose(got_hidden.numpy(), np.asarray(hidden), atol=MOD_ATOL, rtol=0)
    assert valid.sum(1).tolist() == [12, 9]
    got, attn = tsys.build_embedding_table(got_hidden, tep.sup, need_weights=True)
    assert got.shape == (N_SYM, 64) and float(got[0].abs().max()) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=MOD_ATOL, rtol=0)
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(want_attn), atol=MOD_ATOL, rtol=0)


def _jax_trajectory(jsys, grad_fn, variables, episodes, steps):
    tx = jax_make_optimizer(jax_config.OptimConfig(**TRAJ),
                            jsys.trainable_mask(variables["params"]))
    state, _ = create_state(to_jax(variables), tx)
    step_fn = jax.jit(lambda s, g, bs: apply_grads(s, g, tx, bs))
    losses = []
    for i in range(steps):
        (loss, (_, new_bs)), grads = grad_fn(state.params, state.batch_stats,
                                             episodes[i % len(episodes)], state.frozen)
        state = step_fn(state, grads, new_bs)
        losses.append(float(loss))
    return losses, state


def test_episode_trajectory_matches(jax_side):
    """5 train steps on alternating episodes: the losses and the trained
    weights of fscl_tpu and the port agree; the frozen upstream is outside
    the optimizer and unchanged; the codebook and the GE2E encoder train in
    both (the JAX FSCL system trains GE2E under "dvec")."""
    jsys, variables, grad_fn = jax_side
    episodes = [_episode(3), _episode(4)]
    want_losses, state = _jax_trajectory(jsys, grad_fn, variables,
                                         [_jax_episode(e) for e in episodes], 5)
    tsys = _torch_transemb(variables, torch_config.OptimConfig(**TRAJ))
    before = {k: v.clone() for k, v in tsys.state_dict().items()}
    tstate = tsys.init_state()
    upstream = {id(p) for p in tsys.upstream.parameters()}
    assert not any(id(p) in upstream for p in tsys.optimizer.params)
    got_losses = [float(tsys.train_step(tstate, to_device(episodes[i % 2], "cpu"))[1]["Total Loss"])
                  for i in range(5)]
    np.testing.assert_allclose(got_losses, want_losses, rtol=TRAJ_LOSS_RTOL)
    want = _port_space(state.params, state.batch_stats)
    after = tsys.state_dict()
    for k, v in after.items():
        if k.startswith("upstream."):
            assert torch.equal(v, before[k]), k
        elif "running" not in k and "num_batches" not in k:
            np.testing.assert_allclose(v.numpy(), want[k], atol=TRAJ_PARAM_ATOL, rtol=0, err_msg=k)
    for key in ("codebook.emb_banks", "codebook.q_linear.weight",
                "model.speaker_emb.ge2e.lstm.weight_hh_l2", "model.speaker_emb.ge2e.linear.weight"):
        assert not torch.equal(after[key], before[key]), key
    assert not tsys.training and not tsys.upstream.training


def test_dvec_baseline_freezes_ge2e_as_jax_does(jax_side):
    """BaselineSystem under "dvec": GE2E stays out of the optimizer and its
    clip (the clip fires at 0.5) and unchanged, in fscl_tpu and the port,
    whose 3-step trajectories agree; the episode test above shows the FSCL
    system training the same encoder."""
    id2symbols = (("en", N_SYM),)
    jsys = JBaseline(_cfg(jax_config), jax_config.OptimConfig(), id2symbols)
    batches = [_query(5), _query(6)]
    jbatches = [_jax_episode(Episode(_support(0), b)).qry for b in batches]
    # the FSCL system's trunk is this system's model (same config): its
    # variables, and an embedding table, with no second init to compile
    _, fscl_variables, _ = jax_side
    table = np.random.default_rng(10).normal(0.0, 0.3, (N_SYM, 64)).astype(np.float32)
    variables = {"params": {"embedding": {"table-en": table},
                            "model": fscl_variables["params"]["model"]},
                 "batch_stats": fscl_variables["batch_stats"]}
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, bs, b: jsys.loss_and_metrics(p, bs, b, None, True), has_aux=True))
    tx = jax_make_optimizer(jax_config.OptimConfig(**TRAJ),
                            jsys.trainable_mask(variables["params"]))
    state, _ = create_state(to_jax(variables), tx)
    step_fn = jax.jit(lambda s, g, bs: apply_grads(s, g, tx, bs))
    want_losses = []
    for i in range(3):
        (loss, (_, new_bs)), grads = grad_fn(state.params, state.batch_stats, jbatches[i % 2])
        state = step_fn(state, grads, new_bs)
        want_losses.append(float(loss))

    tsys = BaselineSystem(_cfg(torch_config), id2symbols, device="cpu",
                          optim_cfg=torch_config.OptimConfig(**TRAJ))
    tsys.load_state_dict(baseline_state_dict(variables), strict=True)
    tsys.model.postnet.dropout.p = 0.0
    before = {k: v.clone() for k, v in tsys.state_dict().items()}
    tstate = tsys.init_state()
    ge2e = {id(p) for p in tsys.model.speaker_emb.ge2e.parameters()}
    assert ge2e and not any(id(p) in ge2e for p in tsys.optimizer.params)
    got_losses = [float(tsys.train_step(tstate, to_device(batches[i % 2], "cpu"))[1]["Total Loss"])
                  for i in range(3)]
    np.testing.assert_allclose(got_losses, want_losses, rtol=TRAJ_LOSS_RTOL)
    want = {k: v.numpy() for k, v in baseline_state_dict(_np(
        {"params": state.params, "batch_stats": state.batch_stats})).items()}
    for k, v in tsys.state_dict().items():
        if "ge2e" in k:
            assert torch.equal(v, before[k]), k
            np.testing.assert_array_equal(want[k], before[k].numpy(), err_msg=k)
        elif "running" not in k and "num_batches" not in k:
            np.testing.assert_allclose(v.numpy(), want[k], atol=TRAJ_PARAM_ATOL, rtol=0, err_msg=k)
    assert not torch.equal(tsys.state_dict()["model.encoder.layer_stack.0.slf_attn.w_qs.weight"],
                           before["model.encoder.layer_stack.0.slf_attn.w_qs.weight"])


def test_transplant_embedding_matches():
    """A generated table written into a BaselineSystem's table, as the tune
    flow does: the same tables as fscl_tpu's pure update of its params."""
    id2symbols = (("en", 30), ("xx", N_SYM))
    torch.manual_seed(0)
    tsys = BaselineSystem(_cfg(torch_config, speaker="table"), id2symbols, device="cpu")
    tables = {k: v.detach().numpy().copy() for k, v in tsys.embedding_model.tables.items()}
    table = np.random.default_rng(8).normal(size=(N_SYM, 64)).astype(np.float32)
    want = jax_transplant({"embedding": tables, "model": {}}, jnp.asarray(table), "xx")
    before = {k: v.clone() for k, v in tsys.model.state_dict().items()}
    transplant_embedding(tsys, torch.from_numpy(table), "xx")
    for k, v in tsys.embedding_model.tables.items():
        np.testing.assert_array_equal(v.detach().numpy(), np.asarray(want["embedding"][k]), k)
    for k, v in tsys.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(KeyError):
        transplant_embedding(tsys, torch.from_numpy(table), "yy")
    with pytest.raises(ValueError):
        transplant_embedding(tsys, torch.from_numpy(table[:5]), "xx")


def test_to_device_carries_an_episode():
    ep = _episode(9)
    got = to_device(ep, "cpu")
    assert isinstance(got, Episode) and isinstance(got.sup, SupInfo)
    assert got.sup.n_symbols == N_SYM and got.sup_batch is None
    assert got.sup.wavs.dtype == torch.int16
    assert got.qry.speaker_args.slices.shape == (B, N_SLICES, SLICE_T, 40)
    assert got.qry.speaker_args.mask.tolist() == [[1, 1, 1], [1, 1, 0], [1, 0, 0]]


def test_transemb_system_asks_for_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="cuda"):
        TransEmbSystem(_cfg(torch_config), N_SYM)
