"""Parity of the port's ADA, SSL-ADA, ContiAE and semi-FSCL systems with
fscl_tpu, on the CPU in float32.

Each system is built in both packages at the small configuration of
tests/test_torch_meta.py (2 + 2 layer trunk at d_model 64, a 2-layer custom
upstream of dim 64, d-vector speakers), from fscl_tpu's init carried over
by `fscl_tpu_torch.convert` (`transemb_state_dict` with the ADA encoder or
semi-FSCL's `unsup_embed`; `conti_ae_state_dict`), on the same numpy
inputs, every dropout rate 0. Also `interpolate_frames` index for index
(lengths where k T / target lands on .5 included), the trainable sets of
both ADA stages and `norm_only_mask` through the converter, and
`collate_conti_ae` field by field.

Tolerances: metrics 1e-5 relative; every gradient 1e-4 relative to its own
largest |entry|, plus 1e-6 absolute where it is 0 in exact arithmetic
(`test_torch_meta.assert_grad_close`, whose module says why); the
BatchNorm statistics semi-FSCL's step writes 1e-5 absolute; indices and
collates exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fscl_tpu.core.config as jax_config
import fscl_tpu_torch.core.config as torch_config
from fscl_tpu.systems import ada as jada
from fscl_tpu.systems import conti_ae as jconti
from fscl_tpu_torch.convert import conti_ae_state_dict, transemb_state_dict
from fscl_tpu_torch.data.batch import to_device
from fscl_tpu_torch.systems import ada as pada
from fscl_tpu_torch.systems import conti_ae as pconti

import test_torch_meta as M
from torch_parity import to_jax

LOSS_RTOL, GRAD_REL, BN_ATOL = 1e-5, 1e-4, 1e-5
B_WAV, T_WAV = 3, 6000


@pytest.fixture(scope="module", autouse=True)
def _no_dropout_few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        import flax.linen
        mp.setattr(flax.linen, "Dropout", M.NoDropout)
        yield
    torch.set_num_threads(before)


def query_wavs(seed, B=B_WAV):
    rng = np.random.default_rng(seed)
    lens = np.array([T_WAV, 4100, 5300][:B], np.int32)
    wavs = (0.3 * rng.normal(size=(B, T_WAV))).astype(np.float32)
    return np.where(np.arange(T_WAV)[None] < lens[:, None], wavs, 0.0).astype(np.float32), lens


def _mask_names(variables, mask_tree, convert):
    """The port names a fscl_tpu mask selects: the mask as arrays of 0 / 1,
    through the converter (a Dense kernel transposes, gates concatenate)."""
    ones = jax.tree.map(lambda m, x: np.full(np.shape(x), float(m), np.float32),
                        mask_tree, variables["params"])
    sd = convert({**variables, "params": ones, "frozen": None})
    return {n for n, t in sd.items() if t.numel() and float(t.min()) == 1.0}


def _grads(tsys, loss):
    mask = tsys.trainable_mask()
    named = [(n, p) for n, p in tsys.named_parameters() if mask[n]]
    got = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named, got)}


def _jax_run(jsys, variables, batch):
    def loss(params, batch_stats, b, frozen):
        return jsys.loss_and_metrics(params, batch_stats, b, None, True, frozen)

    (loss, (metrics, new_bs)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        to_jax(variables["params"]), to_jax(variables.get("batch_stats")), batch,
        to_jax(variables["frozen"]))
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads, new_bs


def _check(tsys, batch, want_loss, want_metrics, want_grads):
    tsys.train()
    loss, metrics = tsys.loss_and_metrics(batch)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    assert set(metrics) == set(want_metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), want_metrics[k], rtol=LOSS_RTOL, err_msg=k)
    got = _grads(tsys, loss)
    tsys.eval()
    for n, g in got.items():
        M.assert_grad_close(n, g.numpy(), want_grads[n].numpy(), GRAD_REL)
    assert sum(float(g.abs().max()) > 0 for g in got.values()) > 0.9 * len(got)
    return got


# -- ADA and SSL-ADA ------------------------------------------------------------------

def _ada_case(ssl: bool, stage: str):
    ep = M.episode(1)
    jep = M.jax_episode(ep)
    if ssl:
        wavs, lens = query_wavs(2)
        ep = pada.SSLEpisode(sup=ep.sup, qry=ep.qry, qry_wavs=wavs, qry_wav_lens=lens)
        jep = jada.SSLEpisode(sup=jep.sup, qry=jep.qry, qry_wavs=jnp.asarray(wavs),
                              qry_wav_lens=jnp.asarray(lens))
    jcls = jada.TransEmbSSLADASystem if ssl else jada.TransEmbADASystem
    pcls = pada.TransEmbSSLADASystem if ssl else pada.TransEmbADASystem
    jsys = jcls(M._cfg(jax_config, "dvec"), jax_config.OptimConfig(), M.N_SYM, ada_stage=stage)
    init = M.jax_episode(M.episode(1)._replace(
        sup=ep.sup._replace(wavs=ep.sup.wavs.astype(np.float32) / 32768)))
    if ssl:
        init = jep._replace(sup=init.sup)
    variables = M._np(jsys.init_variables(jax.random.PRNGKey(0), init))
    lin = variables["params"]["model"]["variance_adaptor"]["duration_predictor"]["linear_layer"]
    lin["bias"] = (lin["bias"] + np.log(4.0)).astype(np.float32)
    # non-trivial BatchNorm statistics: the reconstruction decodes on them
    rng = np.random.default_rng(3)
    for bn in variables["batch_stats"]["model"]["postnet"].values():
        bn["mean"] = rng.normal(0.0, 0.2, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    tsys = pcls(M._cfg(torch_config, "dvec"), M.N_SYM, device="cpu", ada_stage=stage)
    tsys.load_state_dict(transemb_state_dict(variables), strict=True)
    tsys.model.postnet.dropout.p = 0.0
    return jsys, variables, jep, tsys, to_device(ep, "cpu")


@pytest.mark.parametrize("ssl,stage", [(False, "matching"), (False, "unsup_tuning"),
                                       (True, "matching")],
                         ids=["ada1", "ada2", "ssl_ada1"])
def test_ada_step_and_trainable_sets_match(ssl, stage):
    """One train-mode step's metrics and gradients, the stage's trainable
    set equal to fscl_tpu's `trainable_mask` through the converter, and no
    BatchNorm statistic written (fscl_tpu returns none)."""
    jsys, variables, jep, tsys, ep = _ada_case(ssl, stage)
    want_loss, want_metrics, grads, new_bs = _jax_run(jsys, variables, jep)
    assert new_bs is None
    want_grads = transemb_state_dict(M._np({"params": grads,
                                            "batch_stats": variables["batch_stats"]}))
    mask = tsys.trainable_mask()
    trainable = {n for n, m in mask.items() if m}
    assert trainable == _mask_names(variables, jsys.trainable_mask(variables["params"]),
                                    transemb_state_dict)
    stats = {k: v.clone() for k, v in tsys.state_dict().items() if "running" in k}
    _check(tsys, ep, want_loss, want_metrics, want_grads)
    if stage == "matching":
        assert trainable and all(n.startswith("ada.") for n in trainable)
    else:
        assert len(trainable) == 4 * 2 + 5 * 2    # decoder LayerNorms, PostNet BatchNorms
    for k, v in tsys.state_dict().items():
        if "running" in k:
            assert torch.equal(v, stats[k]), k


def test_norm_only_mask_matches():
    jsys, variables, _, tsys, _ = _ada_case(False, "unsup_tuning")
    want = _mask_names(variables, jada.norm_only_mask(variables["params"]), transemb_state_dict)
    got = {n for n, m in pada.norm_only_mask(tsys).items() if m}
    assert got == want and len(got) == 18
    with pytest.raises(ValueError, match="ada_stage"):
        pada.TransEmbADASystem(M._cfg(torch_config, "dvec"), M.N_SYM, device="cpu",
                               ada_stage="nope")


# -- interpolate_frames ------------------------------------------------------------------

def test_interpolate_frames_matches_index_for_index():
    """Every (T, target) up to 10 x 20: the same frames as fscl_tpu's
    float32 `jnp.round` (halves to even); 68 of the pairs put some k T /
    target exactly on .5."""
    halves = 0
    for T in range(1, 11):
        x = np.arange(T, dtype=np.float32)[None, :, None]
        for target in range(1, 21):
            want = np.asarray(jconti.interpolate_frames(jnp.asarray(x), target))
            got = pconti.interpolate_frames(torch.from_numpy(x), target).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"T={T} target={target}")
            k = np.arange(target)
            halves += bool(np.any((2 * k * T) % (2 * target) == target))
    assert halves == 68


# -- ContiAE and semi-FSCL ----------------------------------------------------------------

def _conti_batch(seed):
    rng = np.random.default_rng(seed)
    wavs, lens = query_wavs(seed)
    mel_lens = np.array([37, 26, 33], np.int32)
    mels = rng.normal(size=(B_WAV, 64, 80)).astype(np.float32)
    mels[np.arange(64)[None, :] >= mel_lens[:, None]] = 0.0
    return pconti.ContiAEBatch(wavs, lens, mels, mel_lens)


def test_conti_ae_step_matches():
    batch = _conti_batch(4)
    jbatch = jconti.ContiAEBatch(*map(jnp.asarray, batch))
    jsys = jconti.ContiAESystem(M._cfg(jax_config, "dvec"), jax_config.OptimConfig())
    variables = M._np(jsys.init_variables(jax.random.PRNGKey(0), jbatch))
    assert set(variables["params"]["model"]) == {"decoder", "mel_linear", "postnet"}
    want_loss, want_metrics, grads, new_bs = _jax_run(jsys, variables, jbatch)
    want_grads = conti_ae_state_dict(M._np({"params": grads,
                                            "batch_stats": variables["batch_stats"]}))
    tsys = pconti.ContiAESystem(M._cfg(torch_config, "dvec"), device="cpu")
    tsys.load_state_dict(conti_ae_state_dict(variables), strict=True)
    tsys.model.postnet.dropout.p = 0.0
    assert {n for n, m in tsys.trainable_mask().items() if m} == set(want_grads) - {
        n for n in want_grads if "running" in n or "num_batches" in n or n.startswith("upstream.")}
    _check(tsys, to_device(batch, "cpu"), want_loss, want_metrics, want_grads)


def test_semi_fscl_step_matches():
    """The episode loss with its BatchNorm update (fscl_tpu's new
    statistics, 1e-5) plus the unlabelled reconstruction, which reads the
    statistics from before the step."""
    ep = M.episode(6)
    unsup = _conti_batch(7)
    jep = jconti.SemiEpisode(M.jax_episode(ep), jconti.ContiAEBatch(*map(jnp.asarray, unsup)))
    jsys = jconti.SemiTransEmbSystem(M._cfg(jax_config, "dvec"), jax_config.OptimConfig(),
                                     M.N_SYM, unsup_weight=0.5)
    init = jep._replace(sup_episode=M.jax_episode(ep._replace(
        sup=ep.sup._replace(wavs=ep.sup.wavs.astype(np.float32) / 32768))))
    variables = M._np(jsys.init_variables(jax.random.PRNGKey(0), init))
    want_loss, want_metrics, grads, new_bs = _jax_run(jsys, variables, jep)
    want_grads = transemb_state_dict(M._np({"params": grads,
                                            "batch_stats": variables["batch_stats"]}))
    want_stats = transemb_state_dict(M._np({"params": variables["params"],
                                            "batch_stats": new_bs}))
    tsys = pconti.SemiTransEmbSystem(M._cfg(torch_config, "dvec"), M.N_SYM, device="cpu",
                                     unsup_weight=0.5)
    tsys.load_state_dict(transemb_state_dict(variables), strict=True)
    tsys.model.postnet.dropout.p = 0.0
    _check(tsys, to_device(pconti.SemiEpisode(ep, unsup), "cpu"), want_loss, want_metrics,
           want_grads)
    for k, v in tsys.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want_stats[k].numpy(), atol=BN_ATOL, err_msg=k)


def test_collate_conti_ae_matches(tmp_path):
    from fscl_tpu.data import datasets as jds
    from fscl_tpu.data.feature_store import FeatureStore as JStore
    from fscl_tpu_torch.core.config import read_data_config
    from fscl_tpu_torch.data import datasets as pds
    from fscl_tpu_torch.data.feature_store import FeatureStore
    from torch_corpus import write_corpus
    from torch_parity import same

    cfg = write_corpus(str(tmp_path), "en1", "en", 0, seed=3, n_train=6, frames=(24, 300))
    dc = read_data_config(cfg)
    jdc = jax_config.read_data_config(cfg)
    port = pds.ContiAEDataset(dc.subset_path("train"), FeatureStore(dc.data_dir), dc)
    ref = jds.ContiAEDataset(jdc.subset_path("train"), JStore(jdc.data_dir), jdc)
    assert len(port) == len(ref) == 6
    for i in range(6):
        same(port[i], ref[i], f"item {i}")
    for idxs in ([0, 1, 2], [5, 3], [4]):
        same(pds.collate_conti_ae([port[i] for i in idxs]),
             jds.collate_conti_ae([ref[i] for i in idxs]), f"batch {idxs}")
