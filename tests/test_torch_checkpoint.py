"""The port's checkpoints (`core/checkpoint.py`) against fscl_tpu's semantics.

Mirrors tests/test_checkpoint.py (strip, remap, the shape-tolerant merge,
the manager's round trip with strip and max_to_keep) and
tests/test_trainer_resume.py (resume continues the trajectory and the
learning-rate schedule exactly; warm start keeps step 0 and fresh moments; a
model of another shape keeps its fresh moments). The surgery functions are
held to fscl_tpu's on the same tree (fscl_tpu's nested, the port's flat with
dotted names). Resume is bit-identical on the CPU with every dropout rate at
0: the port's dropout draws from the device's generator, which a checkpoint
does not hold, where fscl_tpu folds the step into its dropout key.
"""
import dataclasses

import numpy as np
import pytest
import torch

from fscl_tpu.core import checkpoint as jckpt
from fscl_tpu_torch.core import config as C
from fscl_tpu_torch.core.checkpoint import (
    CheckpointManager, merge_shape_tolerant, remap_keys, strip_submodules,
)
from fscl_tpu_torch.data.batch import Batch, to_device
from fscl_tpu_torch.systems.baseline import BaselineSystem
from fscl_tpu_torch.systems.fscl import TransEmbSystem
from fscl_tpu_torch.train.optim import lr_schedule


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _params():
    return {
        "model": {"encoder": {"w": np.ones((2, 2))}, "decoder": {"w": np.zeros((3,))}},
        "upstream": {"layer_0": {"k": np.ones(4)}},
        "upstream_proj": {"w": np.ones(2)},
        "codebook": {"emb_banks": np.ones((8, 4))},
    }


def _equal_trees(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_surgery_matches_fscl_tpu():
    rules = {r"^model\.encoder": "model.enc", r"\.w$": ".weight"}
    _equal_trees(strip_submodules(_flat(_params()), ["upstream"]),
                 _flat(jckpt.strip_submodules(_params(), ["upstream"])))
    assert "upstream_proj.w" not in strip_submodules(_flat(_params()), ["upstream"])
    _equal_trees(remap_keys(_flat(_params()), rules),
                 _flat(jckpt.remap_keys(_params(), rules)))
    restored = {"model": {"encoder": {"w": np.full((2, 2), 7.0)},
                          "decoder": {"w": np.ones((5,))}},     # mismatched shape
                "extra": {"junk": np.ones(1)}}                  # unknown key
    merged = merge_shape_tolerant(_flat(_params()), _flat(restored), verbose=False)
    _equal_trees(merged, _flat(jckpt.merge_shape_tolerant(_params(), restored, verbose=False)))
    np.testing.assert_array_equal(merged["model.encoder.w"], 7.0)
    np.testing.assert_array_equal(merged["model.decoder.w"], 0.0)


def _cfg(n_speakers=4, n_symbols=40):
    cfg = C.ModelConfig(
        transformer=C.TransformerConfig(
            encoder_layer=1, decoder_layer=1, encoder_hidden=32, decoder_hidden=32,
            conv_filter_size=64, encoder_dropout=0.0, decoder_dropout=0.0),
        variance_predictor=C.VariancePredictorConfig(dropout=0.0),
        speaker=C.SpeakerConfig(n_speakers=n_speakers), max_seq_len=64)
    return cfg, (("en", n_symbols),)


OPTIM = C.OptimConfig(lr=1e-3, warmup_step=4, anneal_steps=(5,), anneal_rate=0.3)


def _system(seed, n_speakers=4, n_symbols=40, optim=OPTIM):
    torch.manual_seed(seed)
    cfg, id2symbols = _cfg(n_speakers, n_symbols)
    system = BaselineSystem(cfg, id2symbols, device="cpu", optim_cfg=optim)
    system.model.postnet.dropout.p = 0.0
    return system


def _batch(seed, B=2, L=8, T=32):
    r = np.random.default_rng(seed)
    dur = np.full((B, L), T // L, np.int32)
    return to_device(Batch(
        speaker_args=np.zeros(B, np.int32), texts=r.integers(1, 40, (B, L)).astype(np.int32),
        src_lens=np.full((B,), L, np.int32), mels=r.normal(size=(B, T, 80)).astype(np.float32),
        mel_lens=dur.sum(1).astype(np.int32), pitches=r.normal(size=(B, L)).astype(np.float32),
        energies=r.normal(size=(B, L)).astype(np.float32), durations=dur,
        lang_ids=np.zeros(B, np.int32)), "cpu")


def _steps(system, state, seeds):
    for s in seeds:
        state, _ = system.train_step(state, _batch(s))
    return state


def _snapshot(system, state):
    return ({k: v.clone() for k, v in system.state_dict().items()},
            [t.clone() for t in state.opt_state.mu + state.opt_state.nu],
            state.step, state.opt_state.count)


def test_resume_continues_the_trajectory_exactly(tmp_path):
    """3 steps, save, a fresh system from another seed, full restore, 3 more:
    parameters, buffers, moments, step and learning rate equal 6
    uninterrupted steps bit for bit."""
    system = _system(0)
    state = _steps(system, system.init_state(), range(3))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state.step, system, state)
    want = _snapshot(system, _steps(system, state, range(3, 6)))

    fresh = _system(99)
    resumed = mgr.restore_into(fresh, fresh.init_state(), full=True)
    assert resumed.step == 3 and resumed.opt_state.count == 3
    assert any(float(m.abs().max()) > 0 for m in resumed.opt_state.mu)
    got = _snapshot(fresh, _steps(fresh, resumed, range(3, 6)))
    assert got[2:] == want[2:] == (6, 6)
    assert list(got[0]) == list(want[0])
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert fresh.optimizer.schedule(resumed.opt_state.count) == \
        system.optimizer.schedule(state.opt_state.count)


def test_resume_continues_the_lr_schedule(tmp_path):
    system = _system(0)
    state = _steps(system, system.init_state(), range(6))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state.step, system, state)
    fresh = _system(1)
    resumed = mgr.restore_into(fresh, fresh.init_state(), full=True)
    sched = lr_schedule(OPTIM)
    # step 6 is past warmup(4) and the anneal at 5
    assert sched(resumed.opt_state.count) == sched(6) != sched(0)


def test_warm_start_keeps_fresh_step_and_moments(tmp_path):
    system = _system(0)
    trained = _steps(system, system.init_state(), range(4))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(trained.step, system, trained)
    fresh = _system(1)
    fresh_state = fresh.init_state()
    buffers = {k: v.clone() for k, v in fresh.named_buffers()}
    warm = mgr.restore_into(fresh, fresh_state)
    assert warm is fresh_state and warm.step == 0 and warm.opt_state.count == 0
    for k, v in system.named_parameters():
        assert torch.equal(dict(fresh.named_parameters())[k], v), k
    assert all(float(m.abs().max()) == 0 for m in warm.opt_state.mu + warm.opt_state.nu)
    for k, v in fresh.named_buffers():      # BatchNorm statistics keep their init
        assert torch.equal(v, buffers[k]), k
    assert mgr.restore_into(_system(2)) is None   # a system without an optimizer


def test_restore_tolerates_another_shape(tmp_path):
    """A bigger speaker table and a phoneme table of another size keep their
    fresh init, the rest restores; the moments no longer line up with the
    parameters, so they stay fresh while the step resumes."""
    system = _system(0)
    trained = _steps(system, system.init_state(), range(2))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(trained.step, system, trained)
    other = _system(1, n_speakers=6, n_symbols=44)
    init = {k: v.clone() for k, v in other.named_parameters()}
    resumed = mgr.restore_into(other, other.init_state(), full=True)
    assert resumed.step == 2 and resumed.opt_state.count == 0
    changed = {"model.speaker_emb.model.weight", "embedding_model.tables.table-en"}
    for k, v in other.named_parameters():
        want = init[k] if k in changed else dict(system.named_parameters())[k]
        assert torch.equal(v, want), k
    assert all(float(m.abs().max()) == 0 for m in resumed.opt_state.mu)


def test_remap_on_restore(tmp_path):
    system = _system(0)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(0, system, system.init_state())
    raw = mgr.restore()
    assert raw["params"]["model.mel_linear.weight"].shape == (80, 32)
    fresh = _system(1)
    # a legacy name in the checkpoint comes back under its current one
    raw["params"] = remap_keys(raw["params"], {r"^model\.mel_linear": "model.old_linear"})
    torch.save(raw, str(tmp_path / "ckpt" / "step_00000000" / "state.pt"))
    mgr.restore_into(fresh, remap={r"^model\.old_linear": "model.mel_linear"})
    assert torch.equal(fresh.model.mel_linear.weight, system.model.mel_linear.weight)


def test_manager_files_max_to_keep_and_weights_only(tmp_path):
    system = _system(0)
    state = system.init_state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), strip_prefixes=["model.decoder"],
                            max_to_keep=2)
    for step in (100, 200, 300):
        path = mgr.save(step, system, state)
    assert mgr.all_steps() == [200, 300] and path.endswith("step_00000300")
    raw = torch.load(f"{path}/state.pt", map_location="cpu", weights_only=True)
    assert sorted(raw) == ["buffers", "opt_state", "params", "step"]
    assert not any(k.startswith("model.decoder") for part in
                   (raw["params"], raw["buffers"]) for k in part)
    # the optimizer's state is saved whole, as fscl_tpu saves its opt_state
    assert any(k.startswith("model.decoder") for k in raw["opt_state"]["mu"])
    assert all(t.device.type == "cpu" for t in raw["params"].values())
    assert "model.postnet.convolutions.0.1.running_mean" in raw["buffers"]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_fscl_checkpoint_without_upstream_restores_into_a_live_upstream(tmp_path):
    cfg, _ = _cfg()
    cfg = dataclasses.replace(cfg, upstream=C.UpstreamConfig(name="tiny", dim=32, n_layers=3),
                              codebook=C.CodebookConfig(size=8, num_heads=2, dim=32))
    optim = C.OptimConfig(lr=1e-3, warmup_step=2)
    torch.manual_seed(0)
    system = TransEmbSystem(cfg, 20, device="cpu", optim_cfg=optim, upstream_seed=0)
    state = system.init_state()
    with torch.no_grad():
        for p in system.codebook.parameters():
            p.add_(1.0)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), strip_prefixes=("upstream",))
    state.step = 7
    path = mgr.save(state.step, system, state)
    raw = torch.load(f"{path}/state.pt", weights_only=True)
    assert raw["params"] and not any(k.startswith("upstream.") for k in raw["params"])
    assert not any(k.startswith("upstream.") for k in raw["buffers"])

    torch.manual_seed(1)
    live = TransEmbSystem(cfg, 20, device="cpu", optim_cfg=optim, upstream_seed=5)
    upstream = {k: v.clone() for k, v in live.upstream.state_dict().items()}
    resumed = mgr.restore_into(live, live.init_state(), full=True)
    assert resumed.step == 7
    for k, v in live.upstream.state_dict().items():
        assert torch.equal(v, upstream[k]), k
    for k, v in system.state_dict().items():
        if not k.startswith("upstream."):
            assert torch.equal(live.state_dict()[k], v), k


def test_converted_fscl_tpu_weights_round_trip(tmp_path):
    """fscl_tpu's init, carried over by `convert.py`, through a port
    checkpoint into a fresh system: every tensor back bit for bit."""
    from torch_parity import init_jax_variables, jax_cfg, torch_cfg
    from fscl_tpu_torch.convert import baseline_state_dict
    from torch_parity import ID2SYMBOLS

    _, variables = init_jax_variables(jax_cfg())
    sd = baseline_state_dict(variables)
    system = BaselineSystem(torch_cfg(), ID2SYMBOLS, device="cpu")
    system.load_state_dict(sd, strict=True)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(0, system, system.init_state())
    fresh = BaselineSystem(torch_cfg(), ID2SYMBOLS, device="cpu")
    mgr.restore_into(fresh, fresh.init_state(), full=True)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k
