"""The port's parallel trunk entry points against fscl_tpu's monolithic
functions, on the CPU: fscl_tpu computes each reference in this process (its
jitted single-device train step, `synthesize` and `adapt_many_on_chip`, and
its own tensor-parallel step on 2 virtual devices of tests/conftest.py); its
weights go to the port through `fscl_tpu_torch.convert`, and 2 spawned ranks
over gloo run the port's data-parallel step, `make_parallel_synth`,
`adapt_many_sharded` and the tensor-parallel step on 2 model ranks
(`test_torch_parallel.suite_parity`, JAX-free) on the same numpy inputs. tests/test_torch_parallel_parity_upstream.py does the
same for the upstream's schedules and the FSCL episode. Every dropout is off
(flax's Dropout replaced by the identity, the port's rates 0).

Tolerances (fscl_tpu's own tests hold its sharded step to 1e-4 on the loss,
tests/test_parallel.py:56-63; the port holds tighter ones where the
single-process parity tests do):
- losses: the first step 1e-5 relative, later 1e-4 (tests/test_torch_train.py
  at lr 1e-4, eps 1e-3);
- parameters after a few steps: 1e-5 absolute (a tensor-parallel rank's
  against its shard of fscl_tpu's, `convert.tp_shard_state_dict`); the
  BatchNorm running
  statistics the larger of 1e-5 (the data-parallel step's bar against the
  port's single step) and 2e-4 of their largest |value| (the port's own bar
  against fscl_tpu, tests/test_torch_train.py's TRAJ_STATS_REL);
- mels: 1e-4 (tests/test_torch_fastspeech2.py's system bar), equal lengths;
- adaptation: losses 1e-5 relative, parameters 1e-5 (tests/test_torch_tune.py).
"""
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fscl_tpu.core.config as jax_config
import test_torch_parallel as tp
from fscl_tpu.data.batch import Batch as JBatch
from fscl_tpu.parallel import mesh as jmesh
from fscl_tpu.parallel import tensor_parallel as jtp
from fscl_tpu.systems import tune as jtune
from fscl_tpu.systems.baseline import BaselineSystem as JBaseline
from fscl_tpu.train.trainer import place_batch as jplace_batch
from fscl_tpu_torch.convert import baseline_state_dict, tp_shard_state_dict
from fscl_tpu_torch.parallel import multihost

from torch_parity import NoDropout

FIRST_RTOL, LATER_RTOL, PARAM_ATOL, MEL_ATOL = 1e-5, 1e-4, 1e-5, 1e-4
STATS_ATOL, STATS_REL = 1e-5, 2e-4
JOPTIM = jax_config.OptimConfig(lr=1e-4, eps=1e-3, warmup_step=2, anneal_steps=(),
                                grad_clip_thresh=0.5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jbatch(b):
    return JBatch(*(jnp.asarray(x) for x in b))


def _trajectory(step, state, batches):
    losses = []
    for b in batches:
        state, m = step(state, b, jax.random.PRNGKey(1))
        losses.append(float(m["Total Loss"]))
    return state, losses


@pytest.fixture(scope="module")
def ref():
    """fscl_tpu's side, and the port's inputs made from its weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", NoDropout)
        batches = [tp.batch(10 + i, 8) for i in range(tp.STEPS)]
        jsys = JBaseline(tp.cfg(jax_config), JOPTIM, tp.ID2SYMBOLS)
        state0 = jsys.init_state(jax.random.PRNGKey(0), _jbatch(batches[0]))
        sd = baseline_state_dict(_np({"params": state0.params,
                                      "batch_stats": state0.batch_stats}))
        s1, losses = _trajectory(jax.jit(jsys.train_step), state0,
                                 [_jbatch(b) for b in batches])
        # fscl_tpu's own tensor-parallel step, 1 data x 2 model devices
        mesh = jmesh.make_mesh(n_data=1, n_model=2)
        tstate = jtp.shard_state(jsys.init_state(jax.random.PRNGKey(0), _jbatch(batches[0])),
                                 mesh)
        _, tp_losses = _trajectory(jtp.make_tp_train_step(jsys, mesh, example_state=tstate),
                                   tstate, [jplace_batch(b, mesh) for b in batches])
        b0 = batches[0]
        out = jsys.synthesize(state0.params, state0.batch_stats, jnp.asarray(b0.texts),
                              jnp.asarray(b0.src_lens), 32, jnp.asarray(b0.speaker_args),
                              jnp.asarray(b0.lang_ids))
        tasks = tp.inputs()["tasks"]
        adapted, adapt_losses = jtune.adapt_many_on_chip(
            jsys, state0.params, state0.batch_stats,
            [[_jbatch(b) for b in t] for t in tasks], lr=1e-3)
    return {
        "inp": {"sd": sd, "batches": batches, "tasks": tasks}, "losses": losses,
        "tp_losses": tp_losses,
        "params": baseline_state_dict(_np({"params": s1.params, "batch_stats": s1.batch_stats})),
        "mel": np.asarray(out.postnet_mel), "mel_len": np.asarray(out.mel_len),
        "adapted": [baseline_state_dict(_np({"params": jax.tree.map(lambda x: x[i], adapted),
                                             "batch_stats": state0.batch_stats}))
                    for i in range(len(tasks))],
        "adapt_losses": np.asarray(adapt_losses),
    }


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    torch.set_num_threads(2)
    return multihost.launch(tp.suite_parity, 2, ref["inp"],
                            workdir=str(tmp_path_factory.mktemp("parity")))


def params_close(got, want, atol):
    for k, v in want.items():
        if k not in got:
            continue
        # the port's own gap to fscl_tpu (test_torch_train.py) or the data-
        # parallel step's to the port's single step (test_torch_parallel.py)
        tol = max(STATS_ATOL, STATS_REL * np.abs(v.numpy()).max()) if "running" in k else atol
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=tol, rtol=0, err_msg=k)


def test_dp_step_matches_fscl_tpu_step(ref, ranks):
    for r in ranks:
        np.testing.assert_allclose(r["dp"]["losses"][0], ref["losses"][0], rtol=FIRST_RTOL)
        np.testing.assert_allclose(r["dp"]["losses"], ref["losses"], rtol=LATER_RTOL)
        params_close(r["dp"]["params"], ref["params"], PARAM_ATOL)


def test_tp_step_matches_fscl_tpu_step(ref, ranks):
    """The tensor-parallel step on 2 model ranks (w_1 and q/k/v column-,
    w_2 and fc row-parallel, the Adam moments cut with their parameters)
    against fscl_tpu's jitted single-device step, and its losses against
    fscl_tpu's own tensor-parallel step."""
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["tp"]["losses"][0], ref["losses"][0], rtol=FIRST_RTOL)
        np.testing.assert_allclose(r["tp"]["losses"], ref["losses"], rtol=LATER_RTOL)
        np.testing.assert_allclose(r["tp"]["losses"], ref["tp_losses"], rtol=LATER_RTOL)
        params_close(r["tp"]["params"], tp_shard_state_dict(ref["params"], 2, rank), PARAM_ATOL)


def test_parallel_synth_matches_fscl_tpu_synthesize(ref, ranks):
    for r in ranks:
        np.testing.assert_allclose(r["serve"]["mel"].numpy(), ref["mel"], atol=MEL_ATOL)
        np.testing.assert_array_equal(r["serve"]["mel_len"].numpy(), ref["mel_len"])


def test_adapt_many_sharded_matches_fscl_tpu_adapt_many(ref, ranks):
    for r in ranks:
        got = r["adapt"]
        np.testing.assert_allclose(got["losses"].numpy(), ref["adapt_losses"], rtol=1e-5)
        for i, want in enumerate(ref["adapted"]):
            params_close({k: v[i] for k, v in got["adapted"].items()}, want, PARAM_ATOL)
