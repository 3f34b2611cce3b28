"""The port's parallel layer against the single-process port, on the CPU
over gloo (no JAX: this module also holds the functions the spawned ranks
run, and a rank must not import JAX).

Two launches, one of 2 ranks and one of 4 (each rank on 1 thread, joined
through a FileStore), each running a suite of checks; the tests read their
results against the same computation in this process. Shapes are small
(1 + 1 FFT layers of width 32 in 2 heads, a 2-layer upstream of width 16),
lengths ragged so that the global counts matter, every dropout off (each
rank draws its own masks, where fscl_tpu's sharded step draws the
single-device ones).

Tolerances, each with its reason:
- the first step's loss: 1e-5 relative (the global sums in another order);
- parameters after a few Adam steps: 2e-6 absolute, BatchNorm running
  statistics 1e-5 (the bars of tests/test_torch_train.py at lr 1e-4, eps
  1e-3, where Adam does not amplify rounding);
- upstream hidden states on valid frames: 2e-5 absolute (f32 through two
  layers, gathered keys in another order);
- synthesis: mels 1e-5, lengths equal; adapted parameters 1e-6;
- a meta step's gradients (second-order MAML, iMAML): each tensor within
  1e-4 of its own largest entry, plus 1e-6 where it is 0 in exact
  arithmetic (tests/test_torch_meta.py's bars), the loss 1e-5 relative.
"""
import numpy as np
import pytest
import torch

import fscl_tpu_torch.core.config as C
from fscl_tpu_torch.data.batch import Batch, SupInfo, to_device
from fscl_tpu_torch.data.samplers import DistributedBatchSampler, GroupBatchSampler, \
    maybe_distribute
from fscl_tpu_torch.models.hubert import SSLUpstream, frozen_upstream_features
from fscl_tpu_torch.nn.fft_block import BatchNorm
from fscl_tpu_torch.ops.masking import length_mask
from fscl_tpu_torch.parallel import multihost
from fscl_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, data_parallel, make_mesh,
                                          shard_batch)
from fscl_tpu_torch.parallel.pipeline import attach_parallel_upstream, \
    pipeline_upstream_features
from fscl_tpu_torch.parallel.sequence_parallel import sequence_parallel_upstream_features
from fscl_tpu_torch.parallel.serving import make_parallel_synth
from fscl_tpu_torch.convert import tp_shard_state_dict
from fscl_tpu_torch.parallel.tensor_parallel import (fastspeech2_param_spec, make_tp_train_step,
                                                     shard_state)
from fscl_tpu_torch.systems.baseline import BaselineSystem
from fscl_tpu_torch.systems.fscl import Episode, TransEmbSystem
from fscl_tpu_torch.systems.maml import IMAMLTransEmbSystem, MAMLTransEmbSystem
from fscl_tpu_torch.systems.tune import adapt_many_on_chip, adapt_many_sharded, \
    adaptable_params
from fscl_tpu_torch.train.trainer import (make_multi_train_step, make_parallel_eval_step,
                                          make_parallel_train_step, reduce_gradients)

N_SYM = 20
ID2SYMBOLS = (("en", N_SYM),)
L, T, STEPS = 8, 16, 3
LOSS_RTOL, PARAM_ATOL, STATS_ATOL = 1e-5, 2e-6, 1e-5
HIDDEN_ATOL = 2e-5
GRAD_REL, ZERO_ATOL = 1e-4, 1e-6
OPTIM = C.OptimConfig(lr=1e-4, eps=1e-3, warmup_step=2, anneal_steps=(), grad_clip_thresh=0.5)


def cfg(M=C, **kw):
    """The test's model config in config module M (either package's)."""
    return M.ModelConfig(
        transformer=M.TransformerConfig(
            encoder_layer=1, decoder_layer=1, encoder_hidden=32, decoder_hidden=32,
            conv_filter_size=64, encoder_head=2, decoder_head=2, encoder_dropout=0.0,
            decoder_dropout=0.0),
        variance_predictor=M.VariancePredictorConfig(filter_size=32, dropout=0.0),
        variance_embedding=M.VarianceEmbeddingConfig(n_bins=8),
        max_seq_len=32, speaker=M.SpeakerConfig(n_speakers=4), **kw)


def fscl_cfg(M=C):
    return cfg(M, codebook=M.CodebookConfig(size=4, num_heads=2),
               upstream=M.UpstreamConfig(name="tiny", dim=16, n_layers=3))


UPSTREAM = dict(dim=16, n_heads=2, ffn_dim=32, pos_conv_kernel=8, pos_conv_groups=2)


def baseline(sd=None, optim=OPTIM, device="cpu"):
    torch.manual_seed(0)
    system = BaselineSystem(cfg(), ID2SYMBOLS, device=device, optim_cfg=optim)
    system.model.postnet.dropout.p = 0.0
    if sd is not None:
        system.load_state_dict(sd)
    return system


def batch(seed, B):
    """Ragged texts and mels: the global count of valid frames differs from
    the sum of the shards' means."""
    rng = np.random.default_rng(seed)
    src = rng.integers(3, L + 1, B).astype(np.int32)
    dur = rng.integers(1, 3, (B, L)).astype(np.int32) * (np.arange(L) < src[:, None])
    return Batch(
        speaker_args=rng.integers(0, 4, B).astype(np.int32),
        texts=(rng.integers(1, N_SYM, (B, L)) * (np.arange(L) < src[:, None])).astype(np.int32),
        src_lens=src, mels=rng.normal(size=(B, T, 80)).astype(np.float32),
        mel_lens=np.minimum(dur.sum(1), T).astype(np.int32),
        pitches=rng.normal(size=(B, L)).astype(np.float32),
        energies=rng.normal(size=(B, L)).astype(np.float32),
        durations=dur, lang_ids=np.zeros(B, np.int32))


def upstream(layer_norm_first=True, n_layers=2, seed=0):
    torch.manual_seed(seed)
    up = SSLUpstream(n_layers=n_layers, layer_norm_first=layer_norm_first, **UPSTREAM)
    return up.eval()


def wavs(B=4, W=8000, seed=1):
    """T' = 24 frames at W = 8000: divisible by 2, not by 4 (the padding)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(B, W)) * 0.3).clip(-1, 1).astype(np.float32)
    lens = np.resize(np.array([W, W // 2, W - 700, 3000], np.int32), B)
    return torch.from_numpy(w), torch.from_numpy(lens)


def params_of(system):
    return {k: v.detach().clone() for k, v in system.state_dict().items()}


def train_steps(system, batches, step=None):
    state = system.init_state()
    step = step or system.train_step
    losses = []
    for b in batches:
        state, m = step(state, to_device(b, "cpu"))
        losses.append(float(m["Total Loss"]))
    return state, losses


# -- the ranks' suites ------------------------------------------------------------------

def _dp(mesh, sd, batches):
    system = baseline(sd)
    step = make_parallel_train_step(system, mesh)
    _, losses = train_steps(system, [shard_batch(b, mesh) for b in batches], step)
    return {"losses": losses, "params": params_of(system)}


def _tp(mesh, sd, batches):
    system = baseline(sd)
    state = shard_state(system, system.init_state(), mesh)
    step = make_tp_train_step(system, mesh)
    losses = []
    for b in batches:
        state, m = step(state, to_device(shard_batch(b, mesh), "cpu"))
        losses.append(float(m["Total Loss"]))
    names = [n for n, p in system.named_parameters()]
    i = names.index("model.encoder.layer_stack.0.pos_ffn.w_1.weight")
    return {"losses": losses, "params": params_of(system),
            "w1_mu_shape": tuple(state.opt_state.mu[i].shape)}


def _fscl_tp(mesh, sd, ep):
    """The FSCL episode step with the trunk and the frozen upstream both
    tensor-parallel (fscl_tpu's test_fscl_upstream_tp_matches_single_device)."""
    system = fscl_system(sd)
    state = shard_state(system, system.init_state(), mesh)
    losses = []
    step = make_tp_train_step(system, mesh)
    for _ in range(2):
        state, m = step(state, to_device(shard_batch(ep, mesh), "cpu"))
        losses.append(float(m["Total Loss"]))
    up = system.upstream.encoder.layers[0]
    return {"losses": losses, "params": params_of(system),
            "fc1_rows": up.feed_forward.intermediate_dense.weight.shape[0],
            "heads": up.attention.n_heads}


def _bn(mesh):
    """PostNet BatchNorm in train mode over the global batch's statistics."""
    torch.manual_seed(3)
    bn = BatchNorm(6).train()
    x = torch.randn(4, 6, 5) * 2 + 1
    w = torch.randn(4, 6, 5)
    xl, wl = (shard_batch(t, mesh).clone() for t in (x, w))
    xl.requires_grad_()
    with data_parallel(mesh):
        y = bn(xl)
    # the ranks' losses add up to the global one: the statistics' sums carry
    # the other ranks' gradients back to this rank's rows
    gx, = torch.autograd.grad((y * wl).sum(), xl)
    return {"y": y.detach(), "gx": gx, "mean": bn.running_mean.clone(),
            "var": bn.running_var.clone()}


META = {"maml": (MAMLTransEmbSystem, {"adaptation_steps": 2}),
        "imaml": (IMAMLTransEmbSystem, {"adaptation_steps": 2, "cg_steps": 2})}


def meta_system(kind, sd):
    cls, kw = META[kind]
    torch.manual_seed(0)
    system = cls(fscl_cfg(), N_SYM, device="cpu", optim_cfg=OPTIM, upstream=upstream(), **kw)
    system.model.postnet.dropout.p = 0.0
    system.load_state_dict(sd)
    system.init_state()
    return system


def meta_grads(system, ep, mesh=None):
    """One meta step's loss and gradients by parameter name (with a mesh,
    the data-parallel step's, averaged over the data axis)."""
    params = system.optimizer.params
    if mesh is None:
        grads, m = system.grads_and_metrics(to_device(ep, "cpu"))
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    else:
        with data_parallel(mesh):
            grads, m = system.grads_and_metrics(to_device(shard_batch(ep, mesh), "cpu"))
        grads = reduce_gradients(grads, params, mesh)
    names = {id(p): n for n, p in system.named_parameters()}
    return float(m["Total Loss"]), {names[id(p)]: g.detach() for p, g in zip(params, grads)}


def _serve(mesh, sd, b):
    system = baseline(sd)
    synth = make_parallel_synth(system, mesh, max_mel_len=32)
    mel, mel_len = synth(b.texts, b.src_lens, b.speaker_args, b.lang_ids)
    return {"mel": mel, "mel_len": mel_len}


def _pp(mesh, sd, w, lens, n_micro, stage_only):
    up = upstream()
    up.load_state_dict(sd)
    if stage_only:      # this rank keeps its stage's layers only: the others zeroed
        from fscl_tpu_torch.convert import stage_state_dict
        keep = stage_state_dict(sd, up.n_layers, mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS))
        with torch.no_grad():
            for k, v in up.state_dict().items():
                if k not in keep:
                    v.zero_()
    return pipeline_upstream_features(up, w, length_mask(lens, w.shape[-1]), mesh,
                                      n_micro=n_micro)[0]


def _pp_errors(mesh, w, lens):
    out = []
    for up, M in ((upstream(n_layers=3), None), (upstream(), 3)):
        try:
            pipeline_upstream_features(up, w, length_mask(lens, w.shape[-1]), mesh, n_micro=M)
        except ValueError as e:
            out.append(str(e))
    return out


def _sp(mesh, sd, lnf, w, lens):
    up = upstream(layer_norm_first=lnf)
    up.load_state_dict(sd)
    return sequence_parallel_upstream_features(up, w, length_mask(lens, w.shape[-1]), mesh)[0]


def _adapt(mesh, sd, tasks):
    system = baseline(sd)
    adapted, losses = adapt_many_sharded(system, adaptable_params(system), tasks, mesh, lr=1e-3)
    try:
        adapt_many_sharded(system, adaptable_params(system), tasks[:3], mesh)
        err = None
    except ValueError as e:
        err = str(e)
    return {"adapted": adapted, "losses": losses, "error": err}


def suite2(rank, device, inp):
    out = {}
    dp = make_mesh(2, 1, device)
    out["dp"] = _dp(dp, inp["sd"], inp["batches"])
    multi = baseline(inp["sd"])
    _, m = make_multi_train_step(multi, STEPS, dp)(
        multi.init_state(), [to_device(shard_batch(b, dp), "cpu") for b in inp["batches"]])
    out["multi"] = {"loss": float(m["Total Loss"]), "params": params_of(multi)}
    ev = baseline(inp["sd"])
    ev.init_state()
    out["eval"] = {k: float(v) for k, v in make_parallel_eval_step(ev, dp)(
        None, to_device(shard_batch(inp["batches"][0], dp), "cpu")).items()}
    try:
        shard_batch(batch(0, 3), dp)
        out["odd_batch"] = None
    except ValueError as e:
        out["odd_batch"] = str(e)
    out["bn"] = _bn(dp)
    out["serve"] = _serve(dp, inp["sd"], inp["batches"][0])
    out["adapt"] = _adapt(dp, inp["sd"], inp["tasks"])
    out["meta"] = {k: meta_grads(meta_system(k, inp["fscl_sd"]), inp["meta_episode"], dp)
                   for k in META}
    tp = make_mesh(1, 2, device)
    out["tp"] = _tp(tp, inp["sd"], inp["batches"])
    out["fscl_tp"] = _fscl_tp(tp, inp["fscl_sd"], inp["episode"])
    w, lens = inp["wavs"]
    out["pp"] = {(M, only): _pp(tp, inp["up"][True], w, lens, M, only)
                 for M, only in ((2, False), (4, False), (2, True))}
    out["pp_errors"] = _pp_errors(tp, w, lens)
    out["sp"] = {lnf: _sp(tp, inp["up"][lnf], lnf, w, lens) for lnf in (True, False)}
    out["sp_int16"] = _sp(tp, inp["up"][True], True, inp["wavs16"], lens)
    return out


def suite4(rank, device, inp):
    out = {}
    out["dp"] = _dp(make_mesh(4, 1, device), inp["sd"], inp["batches"])
    m22 = make_mesh(2, 2, device)
    out["tp_dp"] = _tp(m22, inp["sd"], inp["batches"])
    w, lens = inp["wavs"]
    sp4 = make_mesh(1, 4, device)
    out["sp"] = {lnf: _sp(sp4, inp["up"][lnf], lnf, w, lens) for lnf in (True, False)}
    out["dp_pp"] = _fscl_episode(m22, inp["fscl_sd"], inp["episode"])
    return out


def suite_parity(rank, device, inp):
    """The trunk's parallel entry points (the data- and the tensor-parallel
    step among them) at fscl_tpu's weights and inputs
    (tests/test_torch_parallel_parity.py holds them to fscl_tpu)."""
    m21, m12 = make_mesh(2, 1, device), make_mesh(1, 2, device)
    return {"dp": _dp(m21, inp["sd"], inp["batches"]),
            "serve": _serve(m21, inp["sd"], inp["batches"][0]),
            "adapt": _adapt(m21, inp["sd"], inp["tasks"]),
            "tp": _tp(m12, inp["sd"], inp["batches"])}


def suite_parity_upstream(rank, device, inp):
    """The upstream's schedules and the FSCL episode step (with the hook, and
    with the trunk and the upstream tensor-parallel) at fscl_tpu's weights
    (tests/test_torch_parallel_parity_upstream.py)."""
    m21, m12 = make_mesh(2, 1, device), make_mesh(1, 2, device)
    w, lens = inp["wavs"]
    valid = length_mask(lens, w.shape[-1])
    up = upstream()
    up.load_state_dict(inp["up"])
    return {"pp": pipeline_upstream_features(up, w, valid, m12)[0],
            "sp": sequence_parallel_upstream_features(up, w, valid, m12)[0],
            "fscl": {mode: _fscl_episode(mesh, inp["fscl_sd"], inp["episode"], mode)
                     for mode, mesh in (("none", m21), ("pp", m12), ("sp", m12))},
            "fscl_tp": _fscl_tp(m12, inp["fscl_sd"], inp["episode"])}


def fscl_system(sd=None):
    torch.manual_seed(0)
    system = TransEmbSystem(fscl_cfg(), N_SYM, device="cpu", optim_cfg=OPTIM, upstream=upstream())
    system.model.postnet.dropout.p = 0.0
    if sd is not None:
        system.load_state_dict(sd)
    return system


def episode(seed=7, S=4, B=4):
    rng = np.random.default_rng(seed)
    W = 8000
    sup = SupInfo(wavs=(rng.normal(size=(S, W)) * 0.2).astype(np.float32),
                  wav_lens=np.array([W, W // 2, W - 900, 5000][:S], np.int32),
                  avg_frames=rng.integers(0, 4, (S, L)).astype(np.int32),
                  phonemes=rng.integers(1, N_SYM, (S, L)).astype(np.int32), n_symbols=N_SYM)
    return Episode(sup=sup, qry=batch(seed + 1, B))


def _fscl_episode(mesh, sd, ep, mode="pp"):
    """DP over the data axis x the pipelined upstream over the model axis in
    one FSCL train step (fscl_tpu's test_dp_x_pp_composition)."""
    system = fscl_system(sd)
    attach_parallel_upstream(system, mode, mesh)
    state, losses = train_steps(system, [shard_batch(ep, mesh)] * 2,
                                make_parallel_train_step(system, mesh))
    return {"losses": losses, "params": params_of(system)}


# -- launches ---------------------------------------------------------------------------

def inputs():
    sd = params_of(baseline())
    ups = {lnf: params_of(upstream(lnf)) for lnf in (True, False)}
    w, lens = wavs()
    w16 = (w * 32767).round().to(torch.int16)
    rng = np.random.default_rng(5)
    tasks = [[batch(int(rng.integers(1 << 30)), 2) for _ in range(2)] for _ in range(4)]
    return {"sd": sd, "batches": [batch(10 + i, 8) for i in range(STEPS)], "up": ups,
            "wavs": (w, lens), "wavs16": w16, "tasks": tasks,
            "fscl_sd": params_of(fscl_system()), "episode": episode(),
            "meta_episode": episode()._replace(sup_batch=batch(9, 4))}


@pytest.fixture(scope="module")
def inp():
    torch.set_num_threads(2)
    return inputs()


@pytest.fixture(scope="module")
def launches(inp, tmp_path_factory):
    """Both launches at once (6 processes of 1 thread)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(multihost.launch, fn, n, inp,
                            workdir=str(tmp_path_factory.mktemp(f"ranks{n}")))
                for fn, n in ((suite2, 2), (suite4, 4))]
        return [r.result() for r in runs]


@pytest.fixture(scope="module")
def two(launches):
    return launches[0]


@pytest.fixture(scope="module")
def four(launches):
    return launches[1]


@pytest.fixture(scope="module")
def single(inp):
    system = baseline(inp["sd"])
    _, losses = train_steps(system, inp["batches"])
    return {"losses": losses, "params": params_of(system)}


def _same_params(got, want, atol=PARAM_ATOL):
    for k, v in want.items():
        tol = STATS_ATOL if "running" in k else atol
        torch.testing.assert_close(got[k], v, atol=tol, rtol=0, msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_dp_step_matches_single_process(n, two, four, single):
    res = {2: two, 4: four}[n]
    for r in res:
        got = r["dp"]
        np.testing.assert_allclose(got["losses"][0], single["losses"][0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["losses"], single["losses"], rtol=1e-4)
        _same_params(got["params"], single["params"])


def test_multi_train_step_over_the_mesh_is_the_single_steps(two, single):
    """k data-parallel steps per call (`make_multi_train_step(mesh=...)`)
    end where k single-process steps do."""
    for r in two:
        np.testing.assert_allclose(r["multi"]["loss"], single["losses"][-1], rtol=1e-4)
        _same_params(r["multi"]["params"], single["params"])


def test_dp_step_global_count_differs_from_mean_of_shards(inp, single):
    """The ragged batch is a real test: averaging the shards' own means
    gives another loss than the global mean."""
    system = baseline(inp["sd"])
    system.init_state()
    b = inp["batches"][0]
    halves = [to_device(Batch(*(x[i * 4:(i + 1) * 4] for x in b)), "cpu") for i in range(2)]
    with torch.no_grad():
        mean_of_means = np.mean([float(system.loss_and_metrics(h)[0]) for h in halves])
    assert abs(mean_of_means - single["losses"][0]) > 1e-4 * abs(single["losses"][0])


def test_eval_step_matches_single_process(inp, two):
    system = baseline(inp["sd"])
    system.init_state()
    want = system.eval_step(None, to_device(inp["batches"][0], "cpu"))
    for r in two:
        for k, v in want.items():
            np.testing.assert_allclose(r["eval"][k], float(v), rtol=LOSS_RTOL, err_msg=k)


def test_batchnorm_uses_the_global_batch(two):
    torch.manual_seed(3)
    bn = BatchNorm(6).train()
    x = (torch.randn(4, 6, 5) * 2 + 1).requires_grad_()
    w = torch.randn(4, 6, 5)
    y = bn(x)
    gx, = torch.autograd.grad((y * w).sum(), x)
    for r, got in enumerate(two):
        rows = slice(2 * r, 2 * r + 2)
        torch.testing.assert_close(got["bn"]["y"], y.detach()[rows], atol=1e-6, rtol=0)
        torch.testing.assert_close(got["bn"]["gx"], gx[rows], atol=1e-6, rtol=0)
        torch.testing.assert_close(got["bn"]["mean"], bn.running_mean, atol=STATS_ATOL, rtol=0)
        torch.testing.assert_close(got["bn"]["var"], bn.running_var, atol=STATS_ATOL, rtol=0)


def test_shard_batch_refuses_an_indivisible_batch(two):
    for r in two:
        assert "not divisible" in r["odd_batch"]


def test_parallel_synth_matches_single_process(inp, two):
    system = baseline(inp["sd"])
    b = inp["batches"][0]
    with torch.inference_mode():
        out = system.synthesize(b.texts, b.src_lens, 32, b.speaker_args, b.lang_ids)
    for r in two:
        torch.testing.assert_close(r["serve"]["mel"], out.postnet_mel, atol=1e-5, rtol=0)
        assert torch.equal(r["serve"]["mel_len"], out.mel_len)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_tp_step_matches_single_process(mesh, inp, two, four, single):
    res = two if mesh == "1x2" else four
    n_model = 2
    key = "tp" if mesh == "1x2" else "tp_dp"
    for r in res:
        np.testing.assert_allclose(r[key]["losses"][0], single["losses"][0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r[key]["losses"], single["losses"], rtol=1e-4)
        # the FFN's w_1 and its Adam moments are half on each model rank
        assert r[key]["w1_mu_shape"] == (32, 32, 9)
    # each rank holds its shard of the single process's parameters
    for rank, r in enumerate(res):
        _same_params(r[key]["params"],
                     tp_shard_state_dict(single["params"], n_model, rank % n_model))


def _upstream_ref(inp, lnf=True, wav=None):
    up = upstream(lnf)
    up.load_state_dict(inp["up"][lnf])
    w, lens = inp["wavs"]
    hidden, fv = frozen_upstream_features(up, w if wav is None else wav,
                                          length_mask(lens, w.shape[-1]))
    return hidden, fv[:, :, None, None]


@pytest.mark.parametrize("n_micro,stage_only", [(2, False), (4, False), (2, True)],
                         ids=["S2M2", "S2M4", "S2M2_stage_weights_only"])
def test_pipeline_matches_single_process(inp, two, n_micro, stage_only):
    want, m = _upstream_ref(inp)
    for r in two:
        got = r["pp"][(n_micro, stage_only)]
        assert got.shape == want.shape
        torch.testing.assert_close(got * m, want * m, atol=HIDDEN_ATOL, rtol=0)


def test_pipeline_raises_on_indivisible_layers_and_batch(two):
    for r in two:
        a, b = r["pp_errors"]
        assert "not divisible by 2 pipeline stages" in a
        assert "not divisible by 3 microbatches" in b


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("lnf", [True, False], ids=["pre_ln", "post_ln"])
def test_sequence_parallel_matches_single_process(inp, two, four, n, lnf):
    want, m = _upstream_ref(inp, lnf)
    for r in {2: two, 4: four}[n]:
        got = r["sp"][lnf]
        assert got.shape == want.shape
        torch.testing.assert_close(got * m, want * m, atol=HIDDEN_ATOL, rtol=0)


def test_sequence_parallel_takes_int16_wavs(inp, two):
    want, m = _upstream_ref(inp, wav=inp["wavs16"])
    for r in two:
        torch.testing.assert_close(r["sp_int16"] * m, want * m, atol=HIDDEN_ATOL, rtol=0)


def test_dp_x_pp_fscl_step_matches_single_process(inp, four):
    system = fscl_system(inp["fscl_sd"])
    _, losses = train_steps(system, [inp["episode"]] * 2)
    want = params_of(system)
    for r in four:
        got = r["dp_pp"]
        np.testing.assert_allclose(got["losses"][0], losses[0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
        _same_params(got["params"], want)


def test_fscl_step_with_a_tensor_parallel_upstream_matches_single_process(inp, two):
    """The upstream's q/k/v and fc1 column-parallel, out_proj and fc2
    row-parallel over 2 model ranks (1 head of 8 and 16 FFN channels a
    rank), the trunk's too, in one FSCL train step."""
    from fscl_tpu_torch.parallel.tensor_parallel import frozen_spec
    system = fscl_system(inp["fscl_sd"])
    _, losses = train_steps(system, [inp["episode"]] * 2)
    want = params_of(system)
    for rank, r in enumerate(two):
        got = r["fscl_tp"]
        assert got["fc1_rows"] == 16 and got["heads"] == 1
        np.testing.assert_allclose(got["losses"][0], losses[0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
        _same_params(got["params"], tp_shard_state_dict(
            want, 2, rank, lambda k, v: frozen_spec(k) if k.startswith("upstream.")
            else fastspeech2_param_spec(k)))


def test_adapt_many_sharded_matches_unsharded(inp, two):
    system = baseline(inp["sd"])
    adapted, losses = adapt_many_on_chip(system, adaptable_params(system), inp["tasks"],
                                         lr=1e-3)
    for r in two:
        got = r["adapt"]
        torch.testing.assert_close(got["losses"], losses, atol=0, rtol=1e-6)
        for k, v in adapted.items():
            torch.testing.assert_close(got["adapted"][k], v, atol=1e-6, rtol=0, msg=k)
        assert "must be divisible by the data axis (2)" in got["error"]


def zero_in_exact_arithmetic(name):
    """tests/test_torch_meta.py's: an attention key's bias and a conv bias
    before a train-mode BatchNorm, whose gradients are rounding alone."""
    return name.endswith("attn.w_ks.bias") or (
        ".postnet.convolutions." in name and name.endswith(".conv.bias"))


@pytest.mark.parametrize("kind", list(META))
def test_meta_step_matches_single_process(inp, two, kind):
    """A second-order MAML step and an iMAML step (Hessian-vector products)
    with the episode's support set, support batch and queries split over 2
    data ranks: the inner loop adapts with the global support loss's
    gradient, whose own gradient crosses the ranks."""
    loss, want = meta_grads(meta_system(kind, inp["fscl_sd"]), inp["meta_episode"])
    for r in two:
        got_loss, got = r["meta"][kind]
        np.testing.assert_allclose(got_loss, loss, rtol=LOSS_RTOL)
        for k, w in want.items():
            bound = GRAD_REL * float(w.abs().max()) + (ZERO_ATOL if zero_in_exact_arithmetic(k)
                                                       else 0.0)
            assert float((got[k] - w).abs().max()) <= bound, k


def test_maybe_distribute_streams():
    """--n_devices: every rank reads the one stream (identity) and keeps its
    rows; --distributed: process p of P takes every P-th batch."""
    sampler = GroupBatchSampler(list(range(40)), 4, seed=1)
    assert maybe_distribute(sampler) is sampler
    before = multihost.stream_shard()
    try:
        parts = []
        for p in range(2):
            multihost.set_stream_shard(2, p)
            parts.append(list(maybe_distribute(GroupBatchSampler(list(range(40)), 4, seed=1))))
        whole = list(GroupBatchSampler(list(range(40)), 4, seed=1))
        assert parts[0] == whole[0::2] and parts[1] == whole[1::2]
        assert len(DistributedBatchSampler(sampler, 2, 1)) == len(whole) // 2
    finally:
        multihost._STREAM = before


def test_maybe_initialize_is_a_noop_for_one_process(monkeypatch):
    for k in ("FSCL_COORDINATOR", "FSCL_NUM_PROCESSES", "FSCL_PROCESS_ID", "WORLD_SIZE",
              "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.maybe_initialize() is False
    monkeypatch.setenv("FSCL_NUM_PROCESSES", "1")
    assert multihost.maybe_initialize() is False
    assert not torch.distributed.is_initialized()
    assert multihost.process_info() == (0, 1)
    assert multihost.stream_shard() is None


def test_mesh_without_a_process_group_is_one_rank():
    mesh = make_mesh(1, 1, torch.device("cpu"))
    assert mesh.shape == {DATA_AXIS: 1, MODEL_AXIS: 1} and mesh.group(DATA_AXIS) is None
    b = batch(0, 3)
    assert shard_batch(b, mesh).texts.shape == (3, L)
    assert list(multihost.shard_stream(iter([b]), mesh)) == [b]
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh(2, 2, torch.device("cpu"))
