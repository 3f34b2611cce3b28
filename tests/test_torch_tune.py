"""Parity of the port's few-shot tune slice with fscl_tpu, on the CPU in float32.

`fscl_tpu_torch.systems.tune` and `systems.maml` against `fscl_tpu.systems.
tune` and `systems.maml` at a small size: the 2 + 2 layer trunk of
tests/torch_parity.py (d_model 64) with two phoneme tables ("en" and the
adapted "xx") and table or GE2E d-vector speakers, and the FSCL system of
tests/test_torch_fscl.py (a 3-layer custom upstream of dim 64, a 16-row
codebook) for the reference table. Weights come from one fscl_tpu init and
are carried by `fscl_tpu_torch.convert`; batches are made with numpy from a
seed. The adaptation runs the JAX package's `train=False` forward (eval
mode: BatchNorm on its running statistics, which are set away from their
init, and no dropout). Results are compared in the port's key space
(`baseline_state_dict` of the JAX params).

Trajectories run at lr 1e-4, as the other parity trajectories do: a ReLU
input that lands within rounding of 0 makes the two packages' gradients
differ by that unit's whole contribution (at lr 1e-3 the d-vector run put an
energy-predictor input at exactly 0.0 in the port on its third step, and the
gradients at the same parameters then differed by 0.058), a property of the
function, not of either package.

Bars, each with its reason:
- SGD (losses 1e-5 relative, parameters 1e-5 absolute): the forward and
  backward differ by f32 summation order (about 1e-6 relative), and SGD
  moves a parameter by lr times its gradient, which carries that difference
  on without amplifying it.
- Adam at eps 1e-3 (losses 1e-5 relative, parameters 1e-5 absolute): eps
  bounds the step's sensitivity to a gradient difference by lr / eps.
- Adam at the tune flows' eps 1e-9 (losses 1e-4 relative, parameters 2e-4
  absolute): a gradient entry near 0 is divided by its own root mean square,
  so a rounding difference in it can move that entry by up to lr per step
  in either direction (tests/test_torch_train.py, PERF.md); 2e-4 allows two
  such steps at lr 1e-4 (measured: 7.5e-5 over 5 steps, losses 3.7e-7).
- Within the port, runs that must be the same computation (chunked and one
  run, resident and the gathered batches) agree to 1e-6; task-parallel and
  sequential runs (vmap's batched products; GE2E's written-out LSTM gates
  against torch's LSTM) to the SGD / Adam bars above.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fscl_tpu.core.config as jax_config
import fscl_tpu.systems.tune as jtune
import fscl_tpu_torch.core.config as torch_config
from fscl_tpu.data.batch import Batch as JBatch
from fscl_tpu.data.batch import DvecRefs as JDvecRefs
from fscl_tpu.data.batch import SupInfo as JSupInfo
from fscl_tpu.systems.baseline import BaselineSystem as JBaseline
from fscl_tpu.systems.fscl import Episode as JEpisode
from fscl_tpu.systems.fscl import TransEmbSystem as JTransEmb
from fscl_tpu.systems.maml import fast_adaptation_scan_adam as jax_scan_adam
from fscl_tpu_torch.convert import baseline_state_dict, transemb_state_dict
from fscl_tpu_torch.data.batch import DvecRefs, SupInfo, collate_batch
from fscl_tpu_torch.systems import maml, tune
from fscl_tpu_torch.systems.fscl import TransEmbSystem

from torch_parity import make_cfg, to_jax

N_SYM = 24
ID2SYMBOLS = (("en", 30), ("xx", N_SYM))
B, N_SLICES, SLICE_T = 3, 3, 20
LR = 1e-4
SGD_LOSS_RTOL, SGD_PARAM_ATOL = 1e-5, 1e-5
ADAM_LOSS_RTOL, ADAM_PARAM_ATOL = 1e-5, 1e-5            # eps 1e-3
ADAM9_LR, ADAM9_LOSS_RTOL, ADAM9_PARAM_ATOL = 1e-4, 1e-4, 2e-4   # eps 1e-9
SAME_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg(C, speaker):
    cfg = make_cfg(C)
    return dataclasses.replace(
        cfg,
        speaker=C.SpeakerConfig(emb_type=speaker, n_speakers=4, n_ref_slices=N_SLICES),
        codebook=C.CodebookConfig(size=16, num_heads=2, dim=64),
        upstream=C.UpstreamConfig(name="custom", dim=64, n_layers=3))


def _batch(seed, dvec, n=B):
    """n lines of learnable targets (a fixed random table per phoneme plus
    noise), L bucket 16, T bucket 64; d-vector references of 3 slices, two
    samples padded, when `dvec`."""
    rng = np.random.default_rng(seed)
    table = np.random.default_rng(99).normal(size=(N_SYM, 82)).astype(np.float32)
    samples = []
    for i in range(n):
        k = int(rng.integers(6, 15))
        ph = rng.integers(1, N_SYM, k)
        dur = rng.integers(1, 5, k)
        frames = np.repeat(ph, dur)
        samples.append(dict(
            id=str(i), text="", phonemes=ph, duration=dur,
            mel=table[frames, :80] + 0.1 * rng.normal(size=(len(frames), 80)).astype(np.float32),
            pitch=table[ph, 80] + 0.1 * rng.normal(size=k),
            energy=table[ph, 81] + 0.1 * rng.normal(size=k), speaker=i % 4,
            lang_id=int(rng.integers(0, 2)),
            spk_ref_mel_slices=rng.normal(size=(3 - i % 3, SLICE_T, 40)).astype(np.float32)))
    return collate_batch(samples, (16,), (64,), dvec_slices=N_SLICES if dvec else None,
                         pitch_feature="phoneme_level", energy_feature="phoneme_level")[1]


def _batches(seed, n, speaker):
    return [_batch(seed + i, speaker == "dvec") for i in range(n)]


def _jb(b):
    spk = (JDvecRefs(*map(jnp.asarray, b.speaker_args)) if isinstance(b.speaker_args, DvecRefs)
           else jnp.asarray(b.speaker_args))
    return JBatch(spk, *(jnp.asarray(x) for x in b[1:]))


def _support(seed, S=2, T_wav=4000, L=6):
    """int16 support wavs (one cut short), phonemes of 0-4 SSL frames (one
    row running past its frames), symbols shared across rows."""
    rng = np.random.default_rng(seed)
    wav_lens = np.array([T_wav, 3100][:S], np.int32)
    wav = 0.3 * rng.normal(size=(S, T_wav))
    wav = np.where(np.arange(T_wav)[None] < wav_lens[:, None], wav, 0.0)
    avg_frames = rng.integers(0, 5, (S, L)).astype(np.int32)
    phonemes = rng.integers(1, N_SYM, (S, L)).astype(np.int32)
    phonemes[1, :2] = phonemes[0, :2]
    return SupInfo(np.round(wav * 32767).astype(np.int16), wav_lens, avg_frames, phonemes, N_SYM)


def _jsup(sup):
    return JSupInfo(*(jnp.asarray(x) for x in sup[:4]), n_symbols=sup.n_symbols)


@pytest.fixture(scope="module")
def world():
    """One fscl_tpu init of the FSCL system (upstream, codebook and a dvec
    trunk); the baselines reuse its trunk, with a speaker table in place of
    GE2E for table speakers, random phoneme tables and PostNet statistics
    away from their init; the JAX baselines by speaker type."""
    jfscl = JTransEmb(_cfg(jax_config, "dvec"), jax_config.OptimConfig(), N_SYM)
    sup = _support(0)
    init_sup = JSupInfo(jnp.asarray(sup.wavs.astype(np.float32) / 32768.0),
                        *(jnp.asarray(x) for x in sup[1:4]), n_symbols=N_SYM)
    fscl_vars = _np(jfscl.init_variables(jax.random.PRNGKey(0),
                                         JEpisode(sup=init_sup, qry=_jb(_batch(0, True)))))
    lin = fscl_vars["params"]["model"]["variance_adaptor"]["duration_predictor"]["linear_layer"]
    lin["bias"] = (lin["bias"] + np.log(4.0)).astype(np.float32)
    rng = np.random.default_rng(7)
    variables = {}
    for speaker in ("table", "dvec"):
        model = copy.deepcopy(fscl_vars["params"]["model"])
        if speaker == "table":
            model["speaker_emb"] = {"table": {"embedding": rng.normal(
                0.0, 0.3, (4, 64)).astype(np.float32)}}
        batch_stats = copy.deepcopy(fscl_vars["batch_stats"])
        for bn in batch_stats["model"]["postnet"].values():
            bn["mean"] = rng.normal(0.0, 0.2, bn["mean"].shape).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
        tables = {f"table-{s}": rng.normal(0.0, 0.3, (n, 64)).astype(np.float32)
                  for s, n in ID2SYMBOLS}
        variables[speaker] = {"params": {"embedding": tables, "model": model},
                              "batch_stats": batch_stats}
    jax_systems = {s: JBaseline(_cfg(jax_config, s), jax_config.OptimConfig(), ID2SYMBOLS)
                   for s in ("table", "dvec")}
    return jfscl, fscl_vars, variables, jax_systems


def _port(variables, speaker):
    system = tune.TransEmbTuneSystem(_cfg(torch_config, speaker), ID2SYMBOLS, device="cpu")
    system.load_state_dict(baseline_state_dict(variables), strict=True)
    return system


def _jax_params(variables):
    return to_jax(variables["params"]), to_jax(variables["batch_stats"])


def _port_space(jparams, variables):
    return {k: v.numpy() for k, v in baseline_state_dict(
        _np({"params": jparams, "batch_stats": variables["batch_stats"]})).items()}


def _assert_params(got, want, atol, stacked_task=None):
    for name, value in got.items():
        value = value if stacked_task is None else value[stacked_task]
        np.testing.assert_allclose(value.numpy(), want[name], atol=atol, rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def sgd_runs(world):
    """5 SGD steps on table "xx" per speaker type: fscl_tpu's
    `adapt_on_chip` and the port's `fast_adaptation_scan` on its task loss."""
    _, _, variables, jax_systems = world
    runs = {}
    for speaker in ("table", "dvec"):
        batches = _batches(10, 5, speaker)
        params, bs = _jax_params(variables[speaker])
        jp, jl = jtune.adapt_on_chip(jax_systems[speaker], params, bs,
                                     [_jb(b) for b in batches], lr=LR, symbol_id="xx")
        system = _port(variables[speaker], speaker)
        before = tune.adaptable_params(system)
        with tune.adaptation_mode(system):
            got, losses = maml.fast_adaptation_scan(
                tune._make_task_loss_fn(system, "xx"), before,
                tune.stack_batches(batches, "cpu"), LR)
        runs[speaker] = dict(system=system, batches=batches, before=before, got=got,
                             losses=losses, want=_port_space(jp, variables[speaker]),
                             want_losses=np.asarray(jl), jax_params=jp)
    return runs


@pytest.mark.parametrize("speaker", ["table", "dvec"])
def test_fast_adaptation_scan_sgd_matches(sgd_runs, speaker):
    r = sgd_runs[speaker]
    assert r["losses"].shape == (5,) and r["losses"][-1] < r["losses"][0]
    np.testing.assert_allclose(r["losses"].numpy(), r["want_losses"], rtol=SGD_LOSS_RTOL)
    _assert_params(r["got"], r["want"], SGD_PARAM_ATOL)
    # table "en" is not looked up: no step moves it, in either package
    assert torch.equal(r["got"]["embedding_model.tables.table-en"],
                       r["before"]["embedding_model.tables.table-en"])


@pytest.mark.parametrize("speaker", ["table", "dvec"])
def test_adapt_on_chip_sgd_matches(sgd_runs, speaker):
    """The entry point gives the scan's result, and leaves the system in
    its mode with its own weights untouched."""
    r = sgd_runs[speaker]
    system = r["system"]
    system.train()
    got, losses = tune.adapt_on_chip(system, r["before"], r["batches"], lr=LR, symbol_id="xx")
    assert system.training and system.model.postnet.training
    system.eval()
    np.testing.assert_allclose(losses.numpy(), r["want_losses"], rtol=SGD_LOSS_RTOL)
    _assert_params(got, r["want"], SGD_PARAM_ATOL)
    for name, value in tune.adaptable_params(system).items():
        assert torch.equal(value, r["before"][name]), name


def test_adaptation_trains_ge2e_under_dvec_as_jax_does(sgd_runs):
    """The JAX loops differentiate the whole param tree: under "dvec" every
    step moves the GE2E encoder (ROADMAP Queue 3), in both packages; the
    port moves GE2E's trained bias (`bias_hh`) and keeps `bias_ih`, its
    constant half, at 0."""
    r = sgd_runs["dvec"]
    ge2e = [n for n in r["got"] if ".ge2e." in n]
    assert ge2e and not any("bias_ih" in n for n in ge2e)
    jge2e = r["jax_params"]["model"]["speaker_emb"]["ge2e"]
    jbefore = _np(r["system"].state_dict())       # the port's weights, unadapted
    for name in ge2e:
        assert not torch.equal(r["got"][name], r["before"][name]), name
        assert not np.array_equal(r["want"][name], jbefore[name]), name
    assert "lstm_0" in jge2e
    for i in range(3):
        assert float(r["system"].state_dict()[f"model.speaker_emb.ge2e.lstm.bias_ih_l{i}"]
                     .abs().max()) == 0.0


def test_fast_adaptation_scan_adam_matches_at_eps_1e_3(world):
    """10 Adam steps at eps 1e-3 (the clip at 1.0 fires: the first
    gradients' norm is above it)."""
    _, _, variables, jax_systems = world
    batches = _batches(20, 10, "table")
    params, bs = _jax_params(variables["table"])
    jsys = jax_systems["table"]
    jp, jl = jax.jit(lambda p, s, b: jax_scan_adam(
        jtune._make_task_loss_fn(jsys, s, "xx"), p, b, LR, eps=1e-3))(
        params, bs, jtune.stack_batches([_jb(b) for b in batches]))
    system = _port(variables["table"], "table")
    loss_fn = tune._make_task_loss_fn(system, "xx")
    params = tune.adaptable_params(system)
    stacked = tune.stack_batches(batches, "cpu")
    with tune.adaptation_mode(system):
        got, losses = maml.fast_adaptation_scan_adam(loss_fn, params, stacked, LR, eps=1e-3)
        layout = maml._layout(params)
        _, g = maml._value_and_flat_grad(loss_fn, maml._flatten(params, layout), layout,
                                         next(maml._steps(stacked)))
    assert float(torch.linalg.vector_norm(g)) > 1.0
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=ADAM_LOSS_RTOL)
    _assert_params(got, _port_space(jp, variables["table"]), ADAM_PARAM_ATOL)


@pytest.fixture(scope="module")
def adam_run(world):
    """5 steps of the tune Adam at its own eps 1e-9 through fscl_tpu's
    `adapt_on_chip` (table speakers)."""
    _, _, variables, jax_systems = world
    batches = _batches(30, 5, "table")
    params, bs = _jax_params(variables["table"])
    jp, jl = jtune.adapt_on_chip(jax_systems["table"], params, bs, [_jb(b) for b in batches],
                                 lr=ADAM9_LR, symbol_id="xx", optimizer="adam")
    return batches, _port_space(jp, variables["table"]), np.asarray(jl)


def test_adapt_on_chip_adam_matches_at_eps_1e_9(world, adam_run):
    _, _, variables, _ = world
    batches, want, want_losses = adam_run
    system = _port(variables["table"], "table")
    got, losses = tune.adapt_on_chip(system, tune.adaptable_params(system), batches,
                                     lr=ADAM9_LR, symbol_id="xx", optimizer="adam")
    np.testing.assert_allclose(losses.numpy(), want_losses, rtol=ADAM9_LOSS_RTOL)
    _assert_params(got, want, ADAM9_PARAM_ATOL)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_adapt_on_chip_chunked_matches(world, sgd_runs, adam_run, optimizer):
    """Chunks of 2 over 5 steps (a ragged last chunk), batches drawn from an
    iterator: one run's result in the port, and fscl_tpu's."""
    _, _, variables, _ = world
    if optimizer == "sgd":
        r = sgd_runs["table"]
        batches, want, want_losses, lr = r["batches"], r["want"], r["want_losses"], LR
        atol, rtol = SGD_PARAM_ATOL, SGD_LOSS_RTOL
    else:
        batches, want, want_losses = adam_run
        lr, atol, rtol = ADAM9_LR, ADAM9_PARAM_ATOL, ADAM9_LOSS_RTOL
    system = _port(variables["table"], "table")
    params = tune.adaptable_params(system)
    got, losses = tune.adapt_on_chip_chunked(system, params, iter(batches), 5, chunk=2, lr=lr,
                                             symbol_id="xx", optimizer=optimizer)
    one, one_losses = tune.adapt_on_chip(system, params, batches, lr=lr, symbol_id="xx",
                                         optimizer=optimizer)
    torch.testing.assert_close(losses, one_losses, atol=SAME_ATOL, rtol=0)
    for name, value in one.items():
        torch.testing.assert_close(got[name], value, atol=SAME_ATOL, rtol=0, msg=name)
    np.testing.assert_allclose(losses.numpy(), want_losses, rtol=rtol)
    _assert_params(got, want, atol)


def test_adapt_on_chip_resident_matches(world):
    """A 5-row support set resident on the device, 4 steps of 3 rows drawn
    without replacement from seed 3: fscl_tpu's result (so the same rows),
    and the port's `adapt_on_chip` over the gathered batches."""
    _, _, variables, jax_systems = world
    support = _batch(40, False, n=5)
    params, bs = _jax_params(variables["table"])
    jp, jl = jtune.adapt_on_chip_resident(jax_systems["table"], params, bs, _jb(support), 4,
                                          batch_size=3, lr=LR, symbol_id="xx", seed=3)
    system = _port(variables["table"], "table")
    before = tune.adaptable_params(system)
    got, losses = tune.adapt_on_chip_resident(system, before, support, 4, batch_size=3, lr=LR,
                                              symbol_id="xx", seed=3)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=SGD_LOSS_RTOL)
    _assert_params(got, _port_space(jp, variables["table"]), SGD_PARAM_ATOL)
    idx = tune.resident_indices(5, 4, 3, seed=3)
    assert idx.shape == (4, 3) and all(len(set(row)) == 3 for row in idx)
    gathered = [type(support)(*(
        type(x)(*(f[row] for f in x)) if isinstance(x, tuple) else x[row] for x in support))
        for row in idx]
    one, one_losses = tune.adapt_on_chip(system, before, gathered, lr=LR, symbol_id="xx")
    torch.testing.assert_close(losses, one_losses, atol=SAME_ATOL, rtol=0)
    for name, value in one.items():
        torch.testing.assert_close(got[name], value, atol=SAME_ATOL, rtol=0, msg=name)


@pytest.mark.parametrize("speaker,optimizer", [("table", "sgd"), ("dvec", "adam")])
def test_adapt_many_on_chip_matches(world, speaker, optimizer):
    """Two tasks of 3 steps under vmap against each task adapted alone in
    the port; with table speakers also against fscl_tpu's
    `adapt_many_on_chip`. Under "dvec" GE2E runs on its written-out LSTM
    gates under vmap and on torch's LSTM alone (whose runs the SGD test
    above holds to fscl_tpu: a vmapped d-vector trunk takes XLA 13 s to
    compile here)."""
    _, _, variables, jax_systems = world
    lr = LR if optimizer == "sgd" else ADAM9_LR
    loss_rtol, atol = ((SGD_LOSS_RTOL, SGD_PARAM_ATOL) if optimizer == "sgd"
                       else (ADAM9_LOSS_RTOL, ADAM9_PARAM_ATOL))
    tasks = [_batches(50 + 10 * t, 3, speaker) for t in range(2)]
    system = _port(variables[speaker], speaker)
    before = tune.adaptable_params(system)
    got, losses = tune.adapt_many_on_chip(system, before, tasks, lr=lr, symbol_id="xx",
                                          optimizer=optimizer)
    assert losses.shape == (2, 3)
    if speaker == "table":
        params, bs = _jax_params(variables[speaker])
        jp, jl = jtune.adapt_many_on_chip(jax_systems[speaker], params, bs,
                                          [[_jb(b) for b in task] for task in tasks], lr=lr,
                                          symbol_id="xx", optimizer=optimizer)
        np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=loss_rtol)
        for t in range(len(tasks)):
            want = _port_space(jax.tree.map(lambda x: x[t], jp), variables[speaker])
            _assert_params(got, want, atol, stacked_task=t)
    for t, task in enumerate(tasks):
        one, one_losses = tune.adapt_on_chip(system, before, task, lr=lr, symbol_id="xx",
                                             optimizer=optimizer)
        torch.testing.assert_close(losses[t], one_losses, rtol=loss_rtol, atol=0)
        for name, value in one.items():
            torch.testing.assert_close(got[name][t], value, atol=atol, rtol=0, msg=name)
    # task 1's parameters into the system: its own weights become them
    tune.load_adapted(system, got, task=1)
    for name, value in tune.adaptable_params(system).items():
        assert torch.equal(value, got[name][1]), name


def test_synthesis_with_adapted_params_matches(world, sgd_runs):
    """The last step of the flow: the d-vector system's adapted parameters
    copied in (`load_adapted`), then `synthesize_bucketed` through table
    "xx" with d-vector references, as fscl_tpu synthesizes with its adapted
    params: the same mel bucket and lengths, mels within 1e-4 (the
    forward's f32 differences through predicted durations)."""
    _, _, variables, jax_systems = world
    r = sgd_runs["dvec"]
    system = r["system"]
    b = _batch(80, True)
    jout = jax_systems["dvec"].synthesize_bucketed(
        r["jax_params"], to_jax(variables["dvec"]["batch_stats"]), jnp.asarray(b.texts),
        jnp.asarray(b.src_lens), JDvecRefs(*map(jnp.asarray, b.speaker_args)),
        jnp.asarray(b.lang_ids), symbol_id="xx")
    tune.load_adapted(system, r["got"])
    out = system.synthesize_bucketed(b.texts, b.src_lens, b.speaker_args, b.lang_ids,
                                     symbol_id="xx")
    system.load_state_dict(baseline_state_dict(variables["dvec"]), strict=True)
    assert out.postnet_mel.shape == jout.postnet_mel.shape
    np.testing.assert_array_equal(out.mel_len.numpy(), np.asarray(jout.mel_len))
    np.testing.assert_allclose(out.postnet_mel.numpy(), np.asarray(jout.postnet_mel),
                               atol=1e-4, rtol=0)


def test_build_reference_table_and_tune_init_match(world):
    """The table streamed over 3 SupInfo batches (int16 wavs, ragged
    lengths, zero durations, a row running past its frames) through the
    frozen upstream, and its transplant into table "xx": fscl_tpu's
    `tune_init` values (1e-5, the codebook's f32 products in another
    order); the "en" table and the trunk untouched."""
    jfscl, fscl_vars, variables, jax_systems = world
    sups = [_support(60 + i) for i in range(3)]
    params, _ = _jax_params(variables["table"])
    jnew = jtune.tune_init(jfscl, to_jax(fscl_vars["params"]), jax_systems["table"], params,
                           [_jsup(s) for s in sups], "xx")
    want = np.asarray(jnew["embedding"]["table-xx"])
    fscl = TransEmbSystem(_cfg(torch_config, "dvec"), N_SYM, device="cpu")
    fscl.load_state_dict(transemb_state_dict(fscl_vars), strict=True)
    got = tune.build_reference_table(fscl, sups)
    assert got.shape == (N_SYM, 64) and float(got[0].abs().max()) == 0.0
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)

    system = _port(variables["table"], "table")
    before = {k: v.clone() for k, v in system.state_dict().items()}
    table = tune.tune_init(fscl, system, sups, "xx")
    torch.testing.assert_close(table, got, atol=0, rtol=0)
    np.testing.assert_allclose(system.embedding_model.tables["table-xx"].detach().numpy(), want,
                               atol=1e-5, rtol=0)
    for k, v in system.state_dict().items():
        if k != "embedding_model.tables.table-xx":
            assert torch.equal(v, before[k]), k


def test_tune_entry_points_run_on_the_systems_device(world):
    """The adapted parameters and losses come back on the system's device
    (numpy batches are moved there); the systems ask for CUDA by default."""
    _, _, variables, _ = world
    system = _port(variables["table"], "table")
    got, losses = tune.adapt_on_chip(system, tune.adaptable_params(system),
                                     _batches(70, 1, "table"), symbol_id="xx")
    assert losses.device.type == "cpu" and all(v.device.type == "cpu" for v in got.values())
    with pytest.raises(ValueError, match="optimizer"):
        tune.adapt_on_chip(system, got, _batches(70, 1, "table"), optimizer="sgdm")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="cuda"):
        tune.TransEmbTuneSystem(_cfg(torch_config, "table"), ID2SYMBOLS)
