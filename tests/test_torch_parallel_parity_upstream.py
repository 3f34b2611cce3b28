"""The port's pipeline- and sequence-parallel upstream and the FSCL episode
step with and without the upstream hook, against fscl_tpu's monolithic
functions on the CPU: `frozen_upstream_features` (and fscl_tpu's own
sequence-parallel version on 2 virtual devices of tests/conftest.py) and the
jitted `TransEmbSystem.train_step`, computed in this process, held to the
port's pipelined, sequence-parallel and tensor-parallel versions; 2 spawned ranks
over gloo run the port's versions (`test_torch_parallel.
suite_parity_upstream`, JAX-free) at fscl_tpu's weights, carried by
`fscl_tpu_torch.convert`, on the same numpy inputs. Every dropout is off.

Tolerances (fscl_tpu's own tests: 2e-4 on hidden states,
tests/test_sequence_parallel.py:47-54, 1e-4 on the loss,
tests/test_pipeline_parallel.py:140-147):
- upstream hidden states on valid frames: 2e-5 absolute;
- the episode's losses: the first step 1e-5 relative, the next 1e-4;
  parameters 2e-5 absolute (the codebook over the upstream's features in
  another order; a tensor-parallel rank's against its shard of fscl_tpu's,
  `convert.tp_shard_state_dict`), BatchNorm running statistics as in
  tests/test_torch_parallel_parity.py.
"""
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import fscl_tpu.core.config as jax_config
import test_torch_parallel as tp
from fscl_tpu.data.batch import SupInfo as JSupInfo
from fscl_tpu.models.hubert import SSLUpstream as JUpstream
from fscl_tpu.models.hubert import frozen_upstream_features
from fscl_tpu.ops.masking import length_mask
from fscl_tpu.parallel.sequence_parallel import sequence_parallel_upstream_features
from fscl_tpu.systems.fscl import Episode as JEpisode
from fscl_tpu.systems.fscl import TransEmbSystem as JTransEmb
from fscl_tpu_torch.convert import hubert_state_dict, tp_shard_state_dict, transemb_state_dict
from fscl_tpu_torch.parallel.tensor_parallel import fastspeech2_param_spec, frozen_spec
from fscl_tpu_torch.parallel import multihost

from test_torch_parallel_parity import (FIRST_RTOL, JOPTIM, LATER_RTOL, _jbatch, _np,
                                        _trajectory, params_close)
from torch_parity import NoDropout

HIDDEN_ATOL, FSCL_PARAM_ATOL = 2e-5, 2e-5


def _jepisode(ep):
    sup = ep.sup
    return JEpisode(sup=JSupInfo(*(jnp.asarray(x) for x in sup[:4]), n_symbols=sup.n_symbols),
                    qry=_jbatch(ep.qry))


@pytest.fixture(scope="module")
def ref():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", NoDropout)
        up = JUpstream(n_layers=2, layer_norm_first=True, **tp.UPSTREAM)
        w, lens = tp.wavs()
        jw, jvalid = jnp.asarray(w.numpy()), length_mask(jnp.asarray(lens.numpy()), w.shape[-1])
        up_params = up.init(jax.random.PRNGKey(0), jw)
        hidden, valid = jax.jit(lambda p, x, v: frozen_upstream_features(up, p, x, v))(
            up_params, jw, jvalid)
        sp_hidden, _ = jax.jit(lambda p, x, v: sequence_parallel_upstream_features(
            up, p, x, v, Mesh(np.array(jax.devices()[:2]), ("model",))))(up_params, jw, jvalid)

        ep = tp.episode()
        fsys = JTransEmb(tp.fscl_cfg(jax_config), JOPTIM, tp.N_SYM,
                         upstream=JUpstream(n_layers=2, **tp.UPSTREAM))
        fstate = fsys.init_state(jax.random.PRNGKey(0), _jepisode(ep))
        fsd = transemb_state_dict(_np({"params": fstate.params,
                                       "batch_stats": fstate.batch_stats,
                                       "frozen": fstate.frozen}))
        fs1, f_losses = _trajectory(jax.jit(fsys.train_step), fstate, [_jepisode(ep)] * 2)
    return {
        "inp": {"wavs": (w, lens), "up": hubert_state_dict(_np(up_params)), "fscl_sd": fsd,
                "episode": ep},
        "hidden": np.asarray(hidden), "sp_hidden": np.asarray(sp_hidden),
        "valid": np.asarray(valid), "f_losses": f_losses,
        "fparams": transemb_state_dict(_np({"params": fs1.params,
                                            "batch_stats": fs1.batch_stats,
                                            "frozen": fs1.frozen})),
    }


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    torch.set_num_threads(2)
    return multihost.launch(tp.suite_parity_upstream, 2, ref["inp"],
                            workdir=str(tmp_path_factory.mktemp("parity_up")))


@pytest.mark.parametrize("mode", ["pp", "sp"])
def test_parallel_upstream_matches_frozen_upstream_features(ref, ranks, mode):
    m = ref["valid"][:, :, None, None]
    for r in ranks:
        got = r[mode].numpy()
        assert got.shape == ref["hidden"].shape
        np.testing.assert_allclose(got * m, ref["hidden"] * m, atol=HIDDEN_ATOL)
        if mode == "sp":       # and fscl_tpu's own sequence-parallel version
            np.testing.assert_allclose(got * m, ref["sp_hidden"] * m, atol=HIDDEN_ATOL)


@pytest.mark.parametrize("mode", ["none", "pp", "sp"])
def test_fscl_episode_step_with_and_without_the_hook_matches(ref, ranks, mode):
    """The FSCL episode's train_step: data-parallel without the hook (the
    support set and the queries split over 2 data ranks), the upstream
    pipelined or sequence-parallel over 2 model ranks with it, against
    fscl_tpu's jitted single-device step."""
    for r in ranks:
        got = r["fscl"][mode]
        np.testing.assert_allclose(got["losses"][0], ref["f_losses"][0], rtol=FIRST_RTOL)
        np.testing.assert_allclose(got["losses"], ref["f_losses"], rtol=LATER_RTOL)
        params_close(got["params"], ref["fparams"], FSCL_PARAM_ATOL)


def test_fscl_episode_step_with_the_trunk_and_upstream_tensor_parallel_matches(ref, ranks):
    """The FSCL episode's train_step with the trunk and the frozen upstream
    both tensor-parallel over 2 model ranks (the upstream's q/k/v and fc1
    column-, out_proj and fc2 row-parallel) against fscl_tpu's jitted
    single-device step; each rank against its shard of fscl_tpu's
    parameters, the frozen upstream's included."""
    def spec(k, v):
        return frozen_spec(k) if k.startswith("upstream.") else fastspeech2_param_spec(k)

    for rank, r in enumerate(ranks):
        got = r["fscl_tp"]
        np.testing.assert_allclose(got["losses"][0], ref["f_losses"][0], rtol=FIRST_RTOL)
        np.testing.assert_allclose(got["losses"], ref["f_losses"], rtol=LATER_RTOL)
        want = tp_shard_state_dict(ref["fparams"], 2, rank, spec)
        assert any(k.startswith("upstream.") for k in want)
        params_close(got["params"], want, FSCL_PARAM_ATOL)
