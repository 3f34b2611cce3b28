"""Parity of the port's training half with fscl_tpu, on the CPU in float32.

Same weights (fscl_tpu's init carried over by fscl_tpu_torch.convert, in port
space: the JAX gradients and trained params go through the same
`baseline_state_dict`), same numpy batches. Every dropout rate is 0: JAX
draws dropout from `fold_in(rng, step)`, which torch cannot reproduce, and
the PostNet's fixed 0.5 is switched off in both packages for these tests
(flax's `nn.Dropout` replaced by the identity while this module runs, the
port's `postnet.dropout.p` set to 0).

Tolerances, each with its reason:
- the losses: 1e-6 relative (the same f32 sums in another order);
- one step's gradients: 2e-5 of each tensor's max |grad|, plus 1e-7 (ten
  stacked layers' backward, f32 products and reductions in another order;
  the floor is for gradients that are zero but for rounding, such as the
  attention key projection's bias: adding a constant to a row of scores
  leaves the softmax unchanged);
- the optimizer fed fscl_tpu's gradients for 25 steps: parameters 1e-7
  absolute plus 3e-7 relative (the same f32 update, a few roundings in
  another order: two ulps of a weight near 1);
- the 25-step train-step trajectories: losses 1e-5 relative, parameters
  2e-6 absolute, PostNet running statistics 2e-4 of each tensor's largest
  value (measured on the CPU: at most 7e-7, 2e-7 and 2e-5).
- attention's backward, the length regulator's and masked_mean's: 1e-5
  absolute at unit-scale inputs.

Why the trajectories run at lr 1e-4 and eps 1e-3: at the repo's eps 1e-9,
Adam turns a gradient that is zero but for rounding into a full step of
either sign, and the training itself amplifies the difference. Measured on
the CPU with the port alone, weights perturbed by 1e-7 relative gave losses
1e-3 apart after 6 steps and 1e-2 after 18 (lr 2e-3; 2e-3 after 18 at lr
5e-4, eps 1e-6), so no two implementations can be held together there. At
lr 1e-4 and eps 1e-3 JAX and the port stay within the bars above, and the
optimizer at eps 1e-9 is held on its own, on shared gradients.

JAX's `train_step` is `value_and_grad(loss_and_metrics)` then `apply_grads`
with the step's rng folded in; with dropout off the rng is unused, so the
trajectory runs fscl_tpu's `loss_and_metrics` under one jitted
`value_and_grad` and fscl_tpu's `apply_grads` under one jit per optimizer
configuration, which compiles the model once for the whole file.
"""
import dataclasses
import glob
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fscl_tpu.core.config as jax_config
import fscl_tpu_torch.core.config as torch_config
from fscl_tpu.data.batch import Batch as JaxBatch
from fscl_tpu.data.batch import collate_batch as jax_collate_batch
from fscl_tpu.nn import fft_block as jfft
from fscl_tpu.nn.losses import fastspeech2_ada_loss as jax_ada_loss
from fscl_tpu.nn.losses import fastspeech2_loss as jax_loss
from fscl_tpu.ops.attention import xla_attention
from fscl_tpu.ops.length_regulator import regulate_lengths as jax_regulate
from fscl_tpu.ops.masking import masked_mean as jax_masked_mean
from fscl_tpu.systems.base import apply_grads, create_state
from fscl_tpu.train.optim import lr_schedule as jax_lr_schedule
from fscl_tpu.train.optim import make_optimizer as jax_make_optimizer
from fscl_tpu_torch.convert import baseline_state_dict
from fscl_tpu_torch.data.batch import collate_batch, to_device
from fscl_tpu_torch.models.fastspeech2 import FastSpeech2
from fscl_tpu_torch.nn.losses import fastspeech2_ada_loss, fastspeech2_loss
from fscl_tpu_torch.obs.profiling import PhaseTimer
from fscl_tpu_torch.ops import attention as tattn
from fscl_tpu_torch.ops.length_regulator import regulate_lengths
from fscl_tpu_torch.ops.masking import masked_mean
from fscl_tpu_torch.systems.baseline import BaselineSystem
from fscl_tpu_torch.train.optim import lr_schedule
from fscl_tpu_torch.train.trainer import Trainer, prefetch_batches

from torch_parity import ID2SYMBOLS, N_SYMBOLS, init_jax_variables, make_cfg, to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-6
GRAD_REL, GRAD_FLOOR = 2e-5, 1e-7
OPT_PARAM_ATOL, OPT_PARAM_RTOL = 1e-7, 3e-7
TRAJ_LOSS_RTOL, TRAJ_PARAM_ATOL, TRAJ_STATS_REL = 1e-5, 2e-6, 2e-4
STATS_RTOL = 1e-5
OP_ATOL = 1e-5
STEPS = 25
TEXT_BUCKETS, MEL_BUCKETS = (16,), (64,)


class _NoDropout(flax.linen.Module):
    rate: float = 0.0

    @flax.linen.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture(scope="module", autouse=True)
def _no_dropout_few_threads():
    """flax's Dropout is the identity while this module runs (see the
    docstring); torch runs on 2 threads, as tier-1 runs six test processes
    on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        yield
    torch.set_num_threads(before)


def _cfg(C, **variance):
    """The parity config of tests/torch_parity.py with every dropout at 0."""
    cfg = make_cfg(C, **variance)
    return dataclasses.replace(
        cfg,
        transformer=dataclasses.replace(cfg.transformer, encoder_dropout=0.0,
                                        decoder_dropout=0.0),
        variance_predictor=dataclasses.replace(cfg.variance_predictor, dropout=0.0))


def _samples(seed, B=3):
    """Utterances whose targets follow a per-phoneme table plus noise, so
    that training lowers the loss."""
    rng = np.random.default_rng(seed)
    table = np.random.default_rng(99).normal(size=(N_SYMBOLS, 82)).astype(np.float32)
    out = []
    for i in range(B):
        n = int(rng.integers(6, 17))
        ph = rng.integers(1, N_SYMBOLS, n)
        dur = rng.integers(1, 5, n)
        frames = np.repeat(ph, dur)
        out.append(dict(
            id=f"{seed}-{i}", text="", phonemes=ph, duration=dur,
            mel=table[frames, :80] + 0.1 * rng.normal(size=(len(frames), 80)).astype(np.float32),
            pitch=table[ph, 80] + 0.1 * rng.normal(size=n),
            energy=table[ph, 81] + 0.1 * rng.normal(size=n),
            speaker=int(rng.integers(0, 4)), lang_id=int(rng.integers(0, 2))))
    return out


def _batch(seed):
    return collate_batch(_samples(seed), TEXT_BUCKETS, MEL_BUCKETS,
                         pitch_feature="phoneme_level", energy_feature="phoneme_level")[1]


def _jax_batch(batch):
    return JaxBatch(*(jnp.asarray(x) for x in batch))


def _torch_system(variables, optim_cfg=None, **variance):
    system = BaselineSystem(_cfg(torch_config, **variance), ID2SYMBOLS, device="cpu",
                            optim_cfg=optim_cfg)
    system.load_state_dict(baseline_state_dict(variables), strict=True)
    system.model.postnet.dropout.p = 0.0
    return system


def _port_space(params, batch_stats):
    """JAX params (or gradients) and batch stats under the port's keys."""
    tree = jax.tree.map(np.asarray, {"params": params, "batch_stats": batch_stats})
    return {k: v.numpy() for k, v in baseline_state_dict(tree).items()}


@pytest.fixture(scope="module")
def jax_side():
    """fscl_tpu's system at the parity config, its variables and its
    `loss_and_metrics` in train mode under one jitted value_and_grad."""
    jsys, variables = init_jax_variables(_cfg(jax_config))

    def loss(params, batch_stats, batch):
        return jsys.loss_and_metrics(params, batch_stats, batch, None, True)

    grad_fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    return jsys, variables, grad_fn


# -- losses ------------------------------------------------------------------

def _loss_inputs(seed, level):
    rng = np.random.default_rng(seed)
    B, L, T = 3, 12, 40
    src_valid = np.arange(L)[None, :] < np.array([12, 7, 3])[:, None]
    mel_valid = np.arange(T)[None, :] < np.array([40, 22, 9])[:, None]
    V = L if level == "phoneme_level" else T
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return (f(B, T, 80), f(B, T, 80), f(B, V), f(B, V), f(B, L), f(B, T, 80), f(B, V), f(B, V),
            rng.integers(0, 6, (B, L)).astype(np.int32), src_valid, mel_valid)


@pytest.mark.parametrize("pitch_level,energy_level", [
    ("phoneme_level", "phoneme_level"), ("frame_level", "frame_level"),
    ("phoneme_level", "frame_level")])
def test_fastspeech2_loss_matches(pitch_level, energy_level):
    args = list(_loss_inputs(0, pitch_level))
    if energy_level != pitch_level:   # energy at the frame level
        args[3] = np.resize(args[3], (3, 40)).astype(np.float32)
        args[7] = np.resize(args[7], (3, 40)).astype(np.float32)
    want = jax_loss(*map(jnp.asarray, args), pitch_level, energy_level)
    got = fastspeech2_loss(*map(torch.from_numpy, args), pitch_level, energy_level)
    assert list(got.as_dict()) == list(want.as_dict())
    for k, v in got.as_dict().items():
        np.testing.assert_allclose(float(v), float(want.as_dict()[k]), rtol=LOSS_RTOL, err_msg=k)


def test_fastspeech2_ada_loss_matches():
    args = _loss_inputs(1, "phoneme_level")
    picks = [args[0], args[1], args[5], args[10]]
    want = jax_ada_loss(*map(jnp.asarray, picks))
    got = fastspeech2_ada_loss(*map(torch.from_numpy, picks))
    np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want], rtol=LOSS_RTOL)


# -- ops' gradients ----------------------------------------------------------

def test_attention_bwd_matches_jax_vjp():
    """Ragged keys, a sample with no valid key (uniform P: dS must be zeroed
    at the invalid keys) and one with a single valid key."""
    rng = np.random.default_rng(2)
    B, H, L, Dh = 4, 2, 24, 32
    q, k, v, g = (rng.normal(size=(B, H, L, Dh)).astype(np.float32) for _ in range(4))
    valid = np.arange(L)[None, :] < np.array([L, 13, 0, 1])[:, None]
    _, vjp = jax.vjp(lambda q_, k_, v_: xla_attention(q_, k_, v_, jnp.asarray(valid)),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = tattn.attention_bwd(*map(torch.from_numpy, (q, k, v, valid)), None, torch.from_numpy(g))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=OP_ATOL, err_msg=f"d{name}")
    assert np.abs(np.asarray(want[1])[2]).max() == 0.0   # no gradient to invalid keys


def test_attention_bwd_matches_autograd_of_plain_version():
    """On CPU tensors `attend` differentiates `attention_reference`; the
    recompute backward the CUDA path uses must give the same gradients."""
    rng = np.random.default_rng(3)
    B, H, L, Dh = 3, 2, 17, 64
    q, k, v, g = (torch.from_numpy(rng.normal(size=(B, H, L, Dh)).astype(np.float32))
                  for _ in range(4))
    valid = torch.from_numpy(np.arange(L)[None, :] < np.array([17, 5, 0])[:, None])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tattn.attend(*leaves, valid).backward(g)
    got = tattn.attention_bwd(q, k, v, valid, None, g)
    for name, leaf, a in zip("qkv", leaves, got):
        torch.testing.assert_close(a, leaf.grad, atol=OP_ATOL, rtol=0, msg=f"d{name}")


def test_length_regulator_grad_matches_one_hot_vjp():
    rng = np.random.default_rng(4)
    B, L, D, T = 3, 9, 8, 30
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    dur = rng.integers(0, 5, (B, L)).astype(np.int32)
    dur[2] = 6                          # total 54 > T: frames past T dropped
    g = rng.normal(size=(B, T, D)).astype(np.float32)
    (want_out, _), vjp = jax.vjp(lambda x_: jax_regulate(x_, jnp.asarray(dur), T),
                                 jnp.asarray(x))
    want = vjp((jnp.asarray(g), np.zeros(B, jax.dtypes.float0)))[0]
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = regulate_lengths(xt, torch.from_numpy(dur), T)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=OP_ATOL)


@pytest.mark.parametrize("lens", [[5, 2, 0], [0, 0, 0]], ids=["ragged", "all_invalid"])
def test_masked_mean_grad_matches(lens):
    """An all-invalid mask counts one position (the clamp): value and
    gradient 0 in both."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 5, 4)).astype(np.float32)
    valid = np.arange(5)[None, :] < np.array(lens)[:, None]
    want_v, want_g = jax.value_and_grad(jax_masked_mean)(jnp.asarray(x), jnp.asarray(valid))
    xt = torch.from_numpy(x).requires_grad_()
    got = masked_mean(xt, torch.from_numpy(valid))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want_v), rtol=LOSS_RTOL, atol=1e-7)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), atol=1e-7)


# -- configs, schedule, batches ------------------------------------------------

@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "config", "train", "*.yaml"))),
                         ids=os.path.basename)
def test_train_config_from_yaml_matches(path):
    assert dataclasses.asdict(torch_config.train_config_from_yaml(path)) == \
        dataclasses.asdict(jax_config.train_config_from_yaml(path))


@pytest.mark.parametrize("kw", [
    dict(scheduler="sqrt", warmup_step=10, anneal_steps=(20, 30), anneal_rate=0.3),
    dict(scheduler="const", warmup_step=10, anneal_steps=(20, 30), anneal_rate=0.5),
    dict(scheduler="sqrt", warmup_step=0, anneal_steps=(), anneal_rate=0.3),
], ids=["sqrt", "const", "no_warmup"])
def test_lr_schedule_matches(kw):
    """Steps around the warmup's end and each anneal step (the +1 is
    inside: step 9 is the last warmup rate, step 19 the last before the
    first anneal)."""
    jcfg = jax_config.OptimConfig(lr=2e-3, **kw)
    tcfg = torch_config.OptimConfig(lr=2e-3, **kw)
    steps = [0, 1, 8, 9, 10, 11, 18, 19, 20, 21, 28, 29, 30, 31, 1000]
    want = [float(jax_lr_schedule(jcfg)(jnp.asarray(s))) for s in steps]
    got = [lr_schedule(tcfg)(s) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-7)


@pytest.mark.parametrize("level", ["phoneme_level", "frame_level"])
def test_collate_batch_matches(level):
    samples = _samples(6)
    if level == "frame_level":
        for s in samples:
            s["pitch"] = np.repeat(s["pitch"], s["duration"])
            s["energy"] = np.repeat(s["energy"], s["duration"])
    got = collate_batch(samples, pitch_feature=level, energy_feature=level)
    want = jax_collate_batch(samples, pitch_feature=level, energy_feature=level)
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
    for name, a, b in zip(got[1]._fields, got[1], want[1]):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    t = to_device(got[1], "cpu")
    assert all(torch.equal(x, torch.from_numpy(y)) for x, y in zip(t, got[1]))


# -- the model in train mode ----------------------------------------------------

def test_postnet_train_mode_matches_flax(jax_side):
    """BatchNorm on the batch's biased statistics, running buffers updated
    as flax does (momentum 0.9, biased variance) -- a few dozen frames, where
    torch's unbiased update would differ by 3 %."""
    _, variables, _ = jax_side
    tsys = _torch_system(variables)
    x = np.random.default_rng(7).normal(size=(2, 17, 80)).astype(np.float32)
    want, upd = jfft.PostNet(80).apply(
        {"params": to_jax(variables["params"]["model"]["postnet"]),
         "batch_stats": to_jax(variables["batch_stats"]["model"]["postnet"])},
        jnp.asarray(x), deterministic=False, mutable=["batch_stats"])
    tsys.train()
    got = tsys.model.postnet(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    for i, conv in enumerate(tsys.model.postnet.convolutions):
        stats = upd["batch_stats"][f"bn_{i}"]
        np.testing.assert_allclose(conv[1].running_mean.numpy(), np.asarray(stats["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(conv[1].running_var.numpy(), np.asarray(stats["var"]),
                                   rtol=1e-5, atol=1e-6)


def test_loss_and_metrics_gradients_match(jax_side):
    """One train-mode loss_and_metrics: the metrics, every parameter's
    gradient (pitch/energy predictors and embeddings included) and the
    PostNet's updated statistics against jax.value_and_grad."""
    jsys, variables, grad_fn = jax_side
    batch = _batch(8)
    (loss, (metrics, new_bs)), grads = grad_fn(
        to_jax(variables["params"]), to_jax(variables["batch_stats"]), _jax_batch(batch))
    want = _port_space(grads, new_bs)

    tsys = _torch_system(variables)
    tsys.train()
    got_loss, got_metrics = tsys.loss_and_metrics(to_device(batch, "cpu"))
    names = [n for n, _ in tsys.named_parameters()]
    got = torch.autograd.grad(got_loss, list(tsys.parameters()), allow_unused=True)
    for k, v in got_metrics.items():
        np.testing.assert_allclose(float(v), float(metrics[k]), rtol=LOSS_RTOL, err_msg=k)
    reached = 0
    for name, g in zip(names, got):
        w = want[name]
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, atol=GRAD_REL * np.abs(w).max() + GRAD_FLOOR, rtol=0,
                                   err_msg=name)
        reached += bool(np.abs(w).max() > GRAD_FLOOR)
    for key in ("variance_adaptor.pitch_predictor.linear_layer.weight",
                "variance_adaptor.energy_predictor.conv_layer.conv1d_1.conv.weight",
                "variance_adaptor.pitch_embedding.weight",
                "variance_adaptor.energy_embedding.weight"):
        assert np.abs(want[f"model.{key}"]).max() > 0, key
    assert reached > 0.9 * len(names)
    sd = tsys.state_dict()
    for k, v in want.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), v, rtol=STATS_RTOL, atol=1e-7,
                                       err_msg=k)


def _jax_trajectory(jsys, grad_fn, variables, kw, batches):
    """STEPS steps of fscl_tpu's train step (dropout off) from `variables`;
    yields (loss, gradients, state after the step) for each."""
    tx = jax_make_optimizer(jax_config.OptimConfig(**kw), jsys.trainable_mask(variables["params"]))
    state, _ = create_state(to_jax(variables), tx)
    step_fn = jax.jit(lambda s, g, bs: apply_grads(s, g, tx, bs))
    for i in range(STEPS):
        batch = batches[i % len(batches)]
        (loss, (_, new_bs)), grads = grad_fn(state.params, state.batch_stats, _jax_batch(batch))
        state = step_fn(state, grads, new_bs)
        yield float(loss), grads, state


@pytest.fixture(scope="module")
def shared_grads(jax_side):
    """fscl_tpu's gradients of STEPS train steps along its own trajectory
    (lr 2e-3, the repo's eps 1e-9, clip 20)."""
    jsys, variables, grad_fn = jax_side
    kw = dict(lr=2e-3, warmup_step=5, anneal_steps=(12,), anneal_rate=0.5, grad_clip_thresh=20.0)
    return [grads for _, grads, _ in _jax_trajectory(jsys, grad_fn, variables, kw,
                                                      [_batch(10 + i) for i in range(3)])]


def _flat(tree):
    return {k: jnp.concatenate([jnp.ravel(x) for x in jax.tree.leaves(v)]) for k, v in tree.items()}


def _unflat(vectors, like):
    out = {}
    for k, v in like.items():
        leaves, treedef = jax.tree.flatten(v)
        parts = np.split(np.asarray(vectors[k]), np.cumsum([x.size for x in leaves])[:-1])
        out[k] = jax.tree.unflatten(treedef, [p.reshape(x.shape) for p, x in zip(parts, leaves)])
    return out


def _apply_updates(tx, params, opt_state, grads):
    updates, opt_state = tx.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state


@pytest.mark.parametrize("grad_acc_step,weight_decay,frozen", [
    (1, 0.0, False), (2, 0.0, False), (1, 1e-2, False), (1, 0.0, True)],
    ids=["adam", "grad_acc_2", "weight_decay", "frozen_embedding"])
def test_optimizer_matches_optax_on_shared_gradients(jax_side, shared_grads, grad_acc_step,
                                                     weight_decay, frozen):
    """The optimizer alone at the repo's eps 1e-9: the same STEPS gradients
    through fscl_tpu's optax chain and the port's `Adam`, from the same
    weights. Warmup, one anneal, the clip both firing and not (global norms
    on both sides of 20), and, with the embedding frozen, a global norm over
    the trainable parameters only."""
    _, variables, _ = jax_side
    kw = dict(lr=2e-3, warmup_step=5, anneal_steps=(12,), anneal_rate=0.5,
              grad_clip_thresh=20.0, grad_acc_step=grad_acc_step, weight_decay=weight_decay)
    # optax's chain is elementwise but for the global norm, so it runs on
    # each top-level subtree flattened to one vector: the same update, and a
    # compile of seconds instead of one per leaf
    tx = jax_make_optimizer(jax_config.OptimConfig(**kw),
                            {"embedding": not frozen, "model": True})
    jax_step = jax.jit(lambda p, s, g: _apply_updates(tx, p, s, g))
    params = _flat(to_jax(variables["params"]))
    opt_state = tx.init(params)
    tsys = _torch_system(variables, torch_config.OptimConfig(**kw))
    if frozen:
        tsys.trainable_mask = lambda: {n: not n.startswith("embedding_model.")
                                       for n, _ in tsys.named_parameters()}
    tstate = tsys.init_state()
    names = [n for n, p in tsys.named_parameters()
             if any(p is q for q in tsys.optimizer.params)]
    norms = []
    for grads in shared_grads:
        params, opt_state = jax_step(params, opt_state, _flat(grads))
        g = _port_space(grads, variables["batch_stats"])
        norms.append(np.sqrt(sum(float(np.sum(g[n].astype(np.float64) ** 2)) for n in names)))
        tsys.optimizer.update(tstate.opt_state, [torch.from_numpy(g[n]) for n in names])
    assert min(norms) < 20.0 < max(norms)
    assert tstate.opt_state.count == STEPS // grad_acc_step
    want = _port_space(_unflat(params, variables["params"]), variables["batch_stats"])
    for name, p in tsys.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=OPT_PARAM_ATOL,
                                   rtol=OPT_PARAM_RTOL, err_msg=name)
    if frozen:
        emb = "embedding_model.tables.table-en"
        np.testing.assert_array_equal(want[emb], baseline_state_dict(variables)[emb].numpy())


@pytest.mark.parametrize("grad_acc_step,weight_decay", [(1, 0.0), (2, 1e-2)])
def test_train_step_trajectory_matches(jax_side, grad_acc_step, weight_decay):
    """STEPS train steps in each package from the same weights on three
    alternating batches, through the port's `train_step`: warmup, one anneal
    and the clip inside the run (global norms 14-48 against 1). At lr 1e-4 and
    eps 1e-3, where rounding differences stay at rounding level; at the repo's
    eps 1e-9 they do not (see the module docstring)."""
    jsys, variables, grad_fn = jax_side
    kw = dict(lr=1e-4, eps=1e-3, warmup_step=5, anneal_steps=(12,), anneal_rate=0.5,
              grad_clip_thresh=1.0, grad_acc_step=grad_acc_step, weight_decay=weight_decay)
    batches = [_batch(10 + i) for i in range(3)]
    tsys = _torch_system(variables, torch_config.OptimConfig(**kw))
    tstate = tsys.init_state()
    want_losses, got_losses = [], []
    for i, (loss, _, state) in enumerate(_jax_trajectory(jsys, grad_fn, variables, kw, batches)):
        want_losses.append(loss)
        tstate, metrics = tsys.train_step(tstate, to_device(batches[i % len(batches)], "cpu"))
        got_losses.append(float(metrics["Total Loss"]))
    assert tstate.step == int(state.step) == STEPS
    assert tstate.opt_state.count == STEPS // grad_acc_step
    assert not tsys.training
    np.testing.assert_allclose(got_losses, want_losses, rtol=TRAJ_LOSS_RTOL)
    assert np.mean(want_losses[-3:]) < 0.8 * np.mean(want_losses[:3])
    want = _port_space(state.params, state.batch_stats)
    for k, v in tsys.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want[k], rtol=0, err_msg=k,
                                       atol=TRAJ_STATS_REL * np.abs(want[k]).max())
        elif k in want:
            np.testing.assert_allclose(v.numpy(), want[k], atol=TRAJ_PARAM_ATOL, rtol=0,
                                       err_msg=k)


# -- the trainer ---------------------------------------------------------------

class _Recorder:
    def __init__(self):
        self.logs, self.vals, self.saves, self.samples = [], [], [], []

    def on_log(self, step, metrics, steps_per_sec):
        self.logs.append((step, metrics))

    def on_validation(self, step, metrics):
        self.vals.append((step, metrics))

    def on_validation_sample(self, step, state, batch):
        self.samples.append(step)

    def on_save(self, step, state):
        self.saves.append(step)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_trainer_fit_matches_train_steps(jax_side, prefetch):
    """Trainer.fit over 7 steps (log every 3, validate every 4, save every
    6, a last log at step 7) gives the losses and weights of 7 train_step
    calls, with or without the prefetch thread."""
    _, variables, _ = jax_side
    optim = torch_config.OptimConfig(lr=2e-3, warmup_step=3, anneal_steps=())
    batches = [_batch(20 + i) for i in range(7)]
    ref = _torch_system(variables, optim)
    rstate = ref.init_state()
    ref_losses = [float(ref.train_step(rstate, to_device(b, "cpu"))[1]["Total Loss"])
                  for b in batches]

    tsys = _torch_system(variables, optim)
    cfg = torch_config.TrainConfig(optim=optim, total_step=7, log_step=3, val_step=4,
                                   save_step=6, prefetch=prefetch)
    rec = _Recorder()
    trainer = Trainer(tsys, cfg, [rec], profile=True)
    state = trainer.fit(tsys.init_state(), iter(batches + batches),
                        val_loader=lambda: batches[:2])
    assert state.step == 7
    assert [s for s, _ in rec.logs] == [3, 6, 7]
    assert [s for s, _ in rec.vals] == [4] and rec.samples == [4] and rec.saves == [6]
    for s, m in rec.logs:
        np.testing.assert_allclose(m["Total Loss"], ref_losses[s - 1], rtol=1e-6)
        assert m["lr"] == lr_schedule(optim)(s)
    assert set(rec.vals[0][1]) == set(rec.logs[0][1]) - {"lr"}
    for (k, a), b in zip(tsys.state_dict().items(), ref.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=k)
    assert trainer.timer.counts["train_step"] == 7 and "place_batch" in trainer.timer.counts


def test_trainer_checks_cadence_against_steps_per_dispatch(jax_side):
    _, variables, _ = jax_side
    tsys = _torch_system(variables)
    cfg = torch_config.TrainConfig(steps_per_dispatch=4, log_step=6, val_step=8, save_step=8)
    with pytest.raises(ValueError, match="log_step=6"):
        Trainer(tsys, cfg).fit(tsys.init_state(), iter([]))


def test_prefetch_batches_reraises_and_stops():
    def source():
        yield 1
        yield 2
        raise KeyError("boom")

    got = prefetch_batches(source(), size=1, place=lambda b: b * 10)
    assert next(got) == 10 and next(got) == 20
    with pytest.raises(KeyError, match="boom"):
        next(got)
    source = iter(range(10 ** 9))
    endless = prefetch_batches(source, size=2)
    assert next(endless) == 0
    endless.close()                     # stops the producer thread and waits for it
    assert next(source) > 0             # let go of: another consumer can pull


def test_phase_timer_counts_phases():
    timer = PhaseTimer()
    for _ in range(3):
        with timer.phase("step", block_on=torch.zeros(1)):
            pass
    assert timer.counts["step"] == 3 and "step" in timer.report()


def test_remat_is_refused():
    """remat is ported (tests/test_torch_precision.py holds it to the run
    without it): the model builds with it and runs it under autograd; it is
    refused where torch's checkpoint cannot run, under a torch.func
    transform, with an error that names it."""
    cfg = dataclasses.replace(_cfg(torch_config), remat=True)
    from fscl_tpu_torch.core.stats import DEFAULT_STATS
    model = FastSpeech2(cfg, DEFAULT_STATS)
    assert model.encoder.remat and model.decoder.remat
    x = torch.randn(2, 8, 64, requires_grad=True)
    valid = torch.ones(2, 8, dtype=torch.bool)
    assert torch.autograd.grad(model.encoder(x, valid).sum(), x)[0].shape == x.shape
    with pytest.raises(RuntimeError, match="remat"):
        torch.func.grad(lambda t: model.encoder(t, valid).sum())(x.detach())


def test_trainable_mask_trains_everything_without_dvec(jax_side):
    _, variables, _ = jax_side
    tsys = _torch_system(variables)
    mask = tsys.trainable_mask()
    assert list(mask) == [n for n, _ in tsys.named_parameters()] and all(mask.values())
    assert len(tsys.init_state().opt_state.mu) == len(mask)
