"""The port's command line (`fscl_tpu_torch.cli`), in process on the CPU.

On a small numpy-written store (tests/torch_corpus.py: `en` and `zh`, two
speakers each) and a small model YAML: `train` for the baseline, then
`--resume`; `synth --text` (Griffin-Lim) and `--text_file` with a HiFi-GAN
V1 checkpoint in the official layout; `train --system fscl` with a tiny
upstream; `tune` through the Trainer and through `--scan_adapt`; the
parallel flags: `--n_devices 2 --upstream_parallel sp` (4 spawned ranks over
gloo) and `--distributed` from the FSCL_* environment (2 processes). `main`
without `--device` asks for the card.

One repair against fscl_tpu is pinned here: its chunked adaptation stacks a
chunk's batches only when they share one bucket (it raises otherwise, which
a split of several lengths under d-vector speakers always reaches); the
port's `stack_batches` pads them to the chunk's largest bucket, the same
arrays `collate_batch` gives for that bucket.

Against fscl_tpu's own command line (`fscl_tpu.cli.main`, in process on the
same stores): `train` (baseline and fscl) and `tune` (through the Trainer and
through `--scan_adapt`) in both packages, with each package's
`System.init_state`, `Trainer.fit`, `tune_init` and adaptation loops tapped.
What the two command lines hand their trainers (batches, episodes), the
SupInfo batches of the tune flow's reference table and the support set of
its adaptation must be equal exactly. The port's systems start from
fscl_tpu's initial weights (through `convert.py`), every dropout off (flax's
Dropout replaced by the identity, the PostNet's at 0), trained at lr 1e-4
and eps 1e-3 (tests/test_torch_train.py's reasons); the losses are held to
that file's bars: 1e-5 relative at step 1, 1e-3 after.

`synth --text_file` vocodes each line cut to its length, as fscl_tpu does:
every sample of a line's wav, its last frames included, equals that line
vocoded alone within 1e-5.
"""
import contextlib
import dataclasses
import csv
import glob
import json
import os
from unittest import mock

import flax.linen
import jax
import numpy as np
import pytest
import torch

from fscl_tpu_torch.cli import main
from fscl_tpu_torch.core.checkpoint import CheckpointManager

from torch_corpus import FSCL_MODEL_YAML, MODEL_YAML, write_corpus, write_hifigan_checkpoint
from torch_parity import Losses, NoDropout, same

TRAIN_YAML = ("optimizer:\n  batch_size: 4\n  lr: 0.002\n  warm_up_step: 2\n  anneal_steps: []\n"
              "step:\n  total_step: 4\n  log_step: 2\n  val_step: 10\n  save_step: 2\n")
ALGO_YAML = "type: fscl\nadapt:\n  shots: 4\n  queries: 2\n"
PARITY_TRAIN_YAML = ("optimizer:\n  batch_size: 4\n  lr: 0.0001\n  eps: 0.001\n"
                     "  warm_up_step: 2\n  anneal_steps: []\n"
                     "step:\n  total_step: 3\n  log_step: 1\n  val_step: 10\n  save_step: 10\n")
CPU = ["--device", "cpu"]
FIRST_RTOL, LATER_RTOL = 1e-5, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    paths = {"en": write_corpus(str(root), "en-mini", "en", 0, 21),
             "zh": write_corpus(str(root), "zh-mini", "zh", 1, 22)}
    for name, text in (("model", MODEL_YAML), ("fscl_model", FSCL_MODEL_YAML),
                       ("train", TRAIN_YAML), ("algo", ALGO_YAML),
                       ("parity_train", PARITY_TRAIN_YAML)):
        paths[name] = str(root / f"{name}.yaml")
        with open(paths[name], "w") as f:
            f.write(text)
    paths["root"] = root
    return paths


@pytest.fixture(scope="module")
def baseline_run(world):
    """`train` for 4 steps (saves at 2 and 4), then `--resume` to 6."""
    exp = str(world["root"] / "exp")
    args = ["train", "--data_config", world["en"], "--model_config", world["model"],
            "--train_config", world["train"], "--exp_dir", exp] + CPU
    first = main(args)
    resumed = main(args + ["--resume", "--total_step", "6"])
    return exp, first, resumed


def test_train_baseline_then_resume(baseline_run):
    exp, (system, state), (resumed_system, resumed) = baseline_run
    assert state.step == 4 and resumed.step == 6
    assert resumed.opt_state.count == 6          # the moments continued from step 4
    assert CheckpointManager(f"{exp}/ckpt").all_steps() == [2, 4, 6]
    with open(f"{exp}/log/log.txt") as f:
        lines = f.read().splitlines()
    assert [l.split(" | ")[0] for l in lines] == [
        "[Train] step 2", "[Train] step 4", "[Train] step 6"]
    assert glob.glob(f"{exp}/tb/events.*") or os.path.isfile(f"{exp}/tb/metrics.jsonl")
    losses = [float(l.split("Total Loss: ")[1].split(" ")[0]) for l in lines]
    assert all(np.isfinite(losses))
    # the step-4 checkpoint is what --resume restored: its step and moments
    raw = CheckpointManager(f"{exp}/ckpt").restore(4)
    assert raw["step"] == 4 and raw["opt_state"]["count"] == 4


def test_synth_text_and_text_file(world, baseline_run, tmp_path):
    exp = baseline_run[0]
    common = ["synth", "--ckpt_dir", f"{exp}/ckpt", "--data_config", world["en"],
              "--model_config", world["model"]] + CPU
    (mel,) = main(common + ["--text", "{HH AY1 W ER1 L D}", "--output", str(tmp_path / "a.wav")])
    assert mel.shape[1] == 80 and np.isfinite(mel).all()
    assert os.path.getsize(tmp_path / "a.wav") > 44
    # the same checkpoint restored by hand gives the same mel
    from fscl_tpu_torch.core.config import model_config_from_yaml
    from fscl_tpu_torch.systems.baseline import BaselineSystem
    system = BaselineSystem(model_config_from_yaml(world["model"]), (("en", 152),), device="cpu")
    CheckpointManager(f"{exp}/ckpt").restore_into(system)
    from fscl_tpu_torch.frontend import text_to_sequence
    seq = text_to_sequence("{HH AY1 W ER1 L D}", ["basic_cleaners"], "en")
    assert len(seq) == 6
    out = system.synthesize(np.array([seq]), np.array([6]), 72, np.array([0]), np.array([0]),
                            symbol_id="en")
    n = int(out.mel_len[0])
    np.testing.assert_array_equal(mel, out.postnet_mel[0, :max(n, 1)].numpy())

    voc = str(tmp_path / "g_v1.pt")
    write_hifigan_checkpoint(voc, 0)
    (streamed,) = main(common + ["--text", "{HH AY1 W ER1 L D}", "--vocoder_ckpt", voc,
                                 "--stream", "--chunk", "16", "--output", str(tmp_path / "s.wav")])
    np.testing.assert_array_equal(streamed, mel)
    from fscl_tpu_torch.dsp.audio_io import load_wav
    assert load_wav(str(tmp_path / "s.wav"), 22050).shape == (mel.shape[0] * 256,)
    lines = tmp_path / "lines.txt"
    lines.write_text("{HH AY1}\n\n{W ER1 L D HH AY1 W ER1 L D}\n")
    from fscl_tpu_torch.audio_out.streaming import generator_halo
    from fscl_tpu_torch.audio_out.vocoder import Vocoder
    vocoded = []

    def infer(orig):
        def call(self, mel):
            wav = orig(self, mel)
            vocoded.append(wav)
            return wav
        return call

    with mock.patch.object(Vocoder, "infer", infer(Vocoder.infer)):
        mels = main(common + ["--text_file", str(lines), "--batch_size", "2",
                              "--vocoder_ckpt", voc, "--output", str(tmp_path / "wavs")])
    assert len(mels) == 2
    for i, m in enumerate(mels):
        wav = load_wav(str(tmp_path / "wavs" / f"{i:04d}.wav"), 22050)
        assert wav.shape == (m.shape[0] * 256,) and np.isfinite(wav).all()
        assert np.abs(wav).max() <= 1.0
    # one generator call per line, cut to its length (fscl_tpu's
    # _run_batch): every sample, the last halo's included, equals the line
    # vocoded alone
    alone = Vocoder.from_checkpoint(voc, kind="HifiGAN", device="cpu")
    assert len(vocoded) == len(mels)
    assert max(m.shape[0] for m in mels) > generator_halo(alone.model) + 8
    for got, m in zip(vocoded, mels):
        assert got.shape == (m.shape[0] * 256,)
        np.testing.assert_allclose(got, alone.infer(m), atol=1e-5, rtol=0)


def test_synth_text_keeps_one_frame_of_a_line_predicted_at_zero_frames(world, baseline_run,
                                                                      tmp_path):
    """A departure on purpose (ROADMAP Queue 3): with every predicted
    duration 0 (the duration head's bias pinned at -100), `synth --text`
    writes one frame's wav, as `--text_file` does; fscl_tpu's `synth --text`
    vocodes `mel[:0]`, on which its Griffin-Lim raises."""
    from fscl_tpu.audio_out.vocoder import griffin_lim as jax_griffin_lim
    from fscl_tpu_torch.core.config import model_config_from_yaml
    from fscl_tpu_torch.dsp.audio_io import load_wav
    from fscl_tpu_torch.systems.baseline import BaselineSystem
    system = BaselineSystem(model_config_from_yaml(world["model"]), (("en", 152),), device="cpu")
    CheckpointManager(f"{baseline_run[0]}/ckpt").restore_into(system)
    with torch.no_grad():
        system.model.variance_adaptor.duration_predictor.linear_layer.bias.fill_(-100.0)
    CheckpointManager(str(tmp_path / "ckpt")).save(1, system, system.init_state())
    out = tmp_path / "zero.wav"
    (mel,) = main(["synth", "--ckpt_dir", str(tmp_path / "ckpt"), "--data_config", world["en"],
                   "--model_config", world["model"], "--text", "{HH AY1 W ER1 L D}",
                   "--output", str(out)] + CPU)
    assert mel.shape == (1, 80) and np.isfinite(mel).all()
    assert load_wav(str(out), 22050).shape == (256,)
    with pytest.raises(Exception):
        jax_griffin_lim(np.zeros((0, 80), np.float32))


def test_train_fscl_with_a_tiny_upstream(world):
    exp = str(world["root"] / "fexp")
    system, state = main(["train", "--system", "fscl", "--data_config", world["en"],
                          "--data_config", world["zh"], "--model_config", world["fscl_model"],
                          "--algorithm_config", world["algo"], "--train_config", world["train"],
                          "--exp_dir", exp, "--total_step", "2"] + CPU)
    assert state.step == 2 and system.n_symbols == 225
    raw = CheckpointManager(f"{exp}/ckpt").restore()
    assert not any(k.startswith("upstream.") for k in raw["params"])
    assert any(k.startswith("codebook.") for k in raw["params"])
    with open(f"{exp}/log/log.txt") as f:
        assert "step 2" in f.read()


@pytest.mark.parametrize("scan", [False, True], ids=["trainer", "scan_adapt"])
def test_tune(world, scan, tmp_path):
    fexp = str(world["root"] / "tune_src")
    main(["train", "--system", "fscl", "--data_config", world["en"], "--data_config",
          world["zh"], "--model_config", world["fscl_model"], "--algorithm_config", world["algo"],
          "--train_config", world["train"], "--exp_dir", fexp, "--total_step", "1"] + CPU)
    exp = str(tmp_path / "tune")
    args = ["tune", "--data_config", world["zh"], "--fscl_ckpt", f"{fexp}/ckpt",
            "--model_config", world["fscl_model"], "--exp_dir", exp,
            "--adaptation_steps", "3"] + CPU
    if scan:
        args += ["--scan_adapt", "--scan_optimizer", "adam", "--scan_lr", "1e-3"]
    system, losses = main(args)
    assert CheckpointManager(f"{exp}/ckpt").all_steps() == [3 if not scan else 0]
    if scan:
        with open(f"{exp}/csv/zh/adaptation.csv") as f:
            rows = list(csv.reader(f))
        assert rows[0] == ["ft_step", "Total Loss"] and len(rows) == 4
        got = np.array([float(r[1]) for r in rows[1:]])
        np.testing.assert_array_equal(got, losses)
        assert np.isfinite(got).all() and got[-1] < got[0]
    else:
        assert losses is None
        with open(f"{exp}/log/log.txt") as f:
            assert "step 3" in f.read()


@pytest.mark.parametrize("extra,ranks", [
    (["--n_devices", "2"], 2), (["--upstream_parallel", "pp"], 2),
    (["--distributed"], None), (["--n_model", "2"], 2),
    (["--use_tracker", "--exp_key", "k", "--distributed"], None),
])
def test_unported_train_flags_and_systems_name_their_item(world, extra, ranks, monkeypatch):
    """The parallel flags are ported: none raises "not ported yet" any more.
    `--n_devices` / `--n_model` / `--upstream_parallel` spawn n_data x
    n_model ranks (n_model 2 by default once the upstream is parallel);
    `--distributed` without the FSCL_* or torchrun environment is one
    process, a no-op."""
    from fscl_tpu_torch.cli import train_cmd
    for k in ("FSCL_COORDINATOR", "FSCL_NUM_PROCESSES", "FSCL_PROCESS_ID", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    calls = []
    monkeypatch.setattr(train_cmd, "launch", lambda fn, n, *a, **kw: calls.append(("launch", n)))
    monkeypatch.setattr(train_cmd, "_train", lambda *a: calls.append(("train", a[2:])))
    main(["train", "--data_config", world["en"], "--exp_dir", "unused"] + extra + CPU)
    assert calls == ([("launch", ranks)] if ranks else [("train", (None, 1))])
    assert not torch.distributed.is_initialized()


def test_train_n_devices_with_sequence_parallel_upstream(world, tmp_path, capfd):
    """`train --system fscl --n_devices 2 --upstream_parallel sp`: 2 data x
    2 model ranks spawned on the CPU over gloo, two episodes; rank 0 alone
    writes the log and the checkpoint, without the upstream."""
    exp = str(tmp_path / "sp")
    out = main(["train", "--system", "fscl", "--data_config", world["en"], "--data_config",
                world["zh"], "--model_config", world["fscl_model"], "--algorithm_config",
                world["algo"], "--train_config", world["train"], "--exp_dir", exp,
                "--total_step", "2", "--n_devices", "2", "--upstream_parallel", "sp"] + CPU)
    assert out is None
    printed = capfd.readouterr().out
    assert "[parallel] 4 ranks (2 data x 2 model) on this host, backend gloo" in printed
    assert printed.count("[parallel] frozen upstream sp over 2 model-axis ranks") == 1
    assert CheckpointManager(f"{exp}/ckpt").all_steps() == [2]
    raw = CheckpointManager(f"{exp}/ckpt").restore()
    assert raw["step"] == 2 and not any(k.startswith("upstream.") for k in raw["params"])
    with open(f"{exp}/log/log.txt") as f:
        lines = f.read().splitlines()
    assert [l.split(" | ")[0] for l in lines] == ["[Train] step 2"]
    assert np.isfinite(float(lines[0].split("Total Loss: ")[1].split(" ")[0]))


def test_train_distributed_from_the_fscl_environment(world, tmp_path):
    """Two processes started with FSCL_COORDINATOR / FSCL_NUM_PROCESSES /
    FSCL_PROCESS_ID join one run (`--distributed`); process 0 saves."""
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    exp = str(tmp_path / "dist")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for i in range(2):
        env = dict(os.environ, FSCL_COORDINATOR=f"localhost:{port}", FSCL_NUM_PROCESSES="2",
                   FSCL_PROCESS_ID=str(i), OMP_NUM_THREADS="1", PYTHONPATH=repo)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fscl_tpu_torch.cli", "train", "--data_config", world["en"],
             "--model_config", world["model"], "--train_config", world["train"],
             "--exp_dir", exp, "--total_step", "2", "--distributed"] + CPU,
            cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "[distributed] process 0/2, backend gloo" in outs[0]
    assert "[distributed] process 1/2, backend gloo" in outs[1]
    assert "[train] done at step 2" in outs[0] and "[train] done" not in outs[1]
    assert CheckpointManager(f"{exp}/ckpt").all_steps() == [2]


def test_unported_synth_and_subcommands_name_their_item(world, baseline_run):
    """`rehearse`, `evaluate`, `clean` and `pack` are ported and parse
    fscl_tpu's flags (an unknown one is an argparse error)."""
    for cmd in ("rehearse", "evaluate", "clean", "pack"):
        with pytest.raises(SystemExit):
            main([cmd, "--anything", "x"])
    with pytest.raises(SystemExit):
        main(["train"])                        # --data_config is required


def test_main_without_device_asks_for_the_card(world):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["train", "--data_config", world["en"], "--exp_dir", "unused"])
    with pytest.raises(RuntimeError, match="cuda"):
        main(["tune", "--data_config", world["en"]])
    with pytest.raises(RuntimeError, match="cuda"):
        main(["synth", "--ckpt_dir", "x", "--data_config", world["en"], "--text", "hi"])


def test_speaker_table_too_small_for_the_corpus_raises(world, tmp_path):
    small = tmp_path / "model.yaml"
    small.write_text(MODEL_YAML.replace("n_speakers: 2", "n_speakers: 1"))
    with pytest.raises(ValueError, match="2 speakers"):
        main(["train", "--data_config", world["en"], "--model_config", str(small),
              "--exp_dir", str(tmp_path)] + CPU)


def test_chunked_adaptation_stacks_batches_of_several_buckets(world):
    """fscl_tpu's stack_batches raises on batches of two buckets; the port's
    pads them to the larger one, exactly as collate_batch pads for it."""
    from fscl_tpu.data.batch import Batch as JaxBatch
    from fscl_tpu.systems import tune as jtune
    from fscl_tpu_torch.core.config import read_data_config
    from fscl_tpu_torch.data.batch import collate_batch
    from fscl_tpu_torch.data.datasets import FastSpeech2Dataset
    from fscl_tpu_torch.data.feature_store import FeatureStore
    from fscl_tpu_torch.core.config import model_config_from_yaml
    from fscl_tpu_torch.systems.tune import stack_batches

    dc = read_data_config(world["zh"])
    cfg = model_config_from_yaml(world["model"])
    ds = FastSpeech2Dataset(dc.subset_path("train"), FeatureStore(dc.data_dir), dc, cfg,
                            spk_refer_wav=True)
    kw = dict(dvec_slices=10, pitch_feature="phoneme_level", energy_feature="phoneme_level")
    order = sorted(range(len(ds)), key=lambda i: len(ds[i]["mel"]))
    groups = [[ds[i] for i in order[:2]], [ds[i] for i in order[-2:]]]
    batches = [collate_batch(g, (8, 16), (32, 64, 128), **kw)[1] for g in groups]
    assert batches[0].mels.shape[1] < batches[1].mels.shape[1]
    with pytest.raises((ValueError, TypeError)):
        jtune.stack_batches([JaxBatch(*b) for b in batches])
    L, T = batches[1].texts.shape[1], batches[1].mels.shape[1]
    want = stack_batches([collate_batch(g, (L,), (T,), **kw)[1] for g in groups], "cpu")
    got = stack_batches(batches, "cpu")
    for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="different sizes"):
        stack_batches([batches[0], collate_batch(groups[1][:1], **kw)[1]], "cpu")


# -- against fscl_tpu's command line ---------------------------------------------------

def _tap(stack, owner, name, make):
    stack.enter_context(mock.patch.object(owner, name, make(getattr(owner, name))))


def _tap_fit(stack, trainer_cls, rec):
    """Every item the trainer draws and every step's loss (log_step 1)."""
    def make(orig):
        def fit(trainer, state, train_iter, *args, **kwargs):
            items, losses = rec.setdefault("items", []), Losses()
            rec["losses"] = losses.losses
            trainer.cfg = dataclasses.replace(trainer.cfg, log_step=1)
            trainer.callbacks.append(losses)

            def drawn():
                for x in train_iter:
                    items.append(x)
                    yield x
            return orig(trainer, state, drawn(), *args, **kwargs)
        return fit
    _tap(stack, trainer_cls, "fit", make)


def _tap_adapt(stack, module, rec, data_arg):
    """Which adaptation loop runs, and its support set or batch stream
    (positional argument `data_arg`: fscl_tpu's loops also take the
    BatchNorm statistics)."""
    for route in ("resident", "chunked"):
        def make(orig, route=route):
            def call(*args, **kwargs):
                rec["route"], rec["adapt_input"] = route, args[data_arg]
                return orig(*args, **kwargs)
            return call
        _tap(stack, module, f"adapt_on_chip_{route}", make)


def _run_jax(argv):
    """fscl_tpu's command line in process, tapped; returns the record. Its
    compilation-cache setting (a directory outside the test) is skipped. Its
    datamodules read as the port's do by default: a single corpus through
    the native C++ loader (which normalises pitch and energy in float64
    before the f32 store, one ulp from the Python path on this corpus)."""
    import fscl_tpu.systems.tune as jtune
    from fscl_tpu.cli.__main__ import main as jmain
    from fscl_tpu.systems.base import System as JSystem
    from fscl_tpu.train.trainer import Trainer as JTrainer

    rec = {"states": []}
    update = jax.config.update

    def init_state(orig):
        def call(system, *args, **kwargs):
            state = orig(system, *args, **kwargs)
            frozen = state.frozen or ({"upstream": system.upstream_params}
                                      if getattr(system, "upstream_params", None) else None)
            # copied now: the train step donates the state's buffers
            rec["states"].append((type(system).__name__, jax.tree.map(np.array, {
                "params": state.params, "batch_stats": state.batch_stats, "frozen": frozen})))
            return state
        return call

    def tune_init(orig):
        def call(fscl, fscl_params, baseline, baseline_params, sup_batches, symbol_id):
            rec["sup_batches"] = list(sup_batches)
            return orig(fscl, fscl_params, baseline, baseline_params, rec["sup_batches"],
                        symbol_id)
        return call

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            jax.config, "update",
            lambda k, v: None if k == "jax_compilation_cache_dir" else update(k, v)))
        _tap(stack, JSystem, "init_state", init_state)
        _tap_fit(stack, JTrainer, rec)
        _tap(stack, jtune, "tune_init", tune_init)
        _tap_adapt(stack, jtune, rec, data_arg=3)
        jmain(argv)
    return rec


def _port_weights(kind, variables):
    """fscl_tpu's initial variables as the port's state_dict."""
    from fscl_tpu_torch.convert import baseline_state_dict, transemb_state_dict
    return (baseline_state_dict if kind == "BaselineSystem" else transemb_state_dict)(variables)


def _run_port(argv, jax_rec):
    """The port's command line, tapped, each system loaded with the weights
    fscl_tpu's system of the same kind started from."""
    from fscl_tpu_torch.cli import tune_cmd
    from fscl_tpu_torch.systems.base import System
    from fscl_tpu_torch.train.trainer import Trainer as PTrainer

    rec = {}
    pending = list(jax_rec["states"])

    def load(system):
        i = next(i for i, (kind, _) in enumerate(pending) if kind == type(system).__name__)
        system.load_state_dict(_port_weights(*pending.pop(i)), strict=True)
        system.model.postnet.dropout.p = 0.0

    def init_state(orig):
        def call(system):
            load(system)
            return orig(system)
        return call

    def tune_init(orig):
        def call(fscl, baseline, sup_batches, symbol_id):
            load(fscl)
            rec["sup_batches"] = list(sup_batches)
            return orig(fscl, baseline, rec["sup_batches"], symbol_id)
        return call

    with contextlib.ExitStack() as stack:
        _tap(stack, System, "init_state", init_state)
        _tap_fit(stack, PTrainer, rec)
        _tap(stack, tune_cmd, "tune_init", tune_init)
        _tap_adapt(stack, tune_cmd, rec, data_arg=2)
        rec["out"] = main(argv + CPU)
    assert not pending, "a system of fscl_tpu's run has no counterpart in the port's"
    return rec


@pytest.fixture(scope="module")
def no_flax_dropout():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", NoDropout)
        yield


def _held(got, want):
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got[0], want[0], rtol=FIRST_RTOL)
    np.testing.assert_allclose(got[1:], want[1:], rtol=LATER_RTOL)


@pytest.mark.parametrize("system", ["baseline", "fscl"])
def test_train_matches_fscl_tpu_cli(world, tmp_path, no_flax_dropout, system):
    """The batches (baseline: `train_cmd.baseline_batches`; fscl: episodes,
    the port drawing fscl_tpu's init episode from its sampler) and the
    losses of 3 steps."""
    args = ["train", "--system", system, "--data_config", world["en"],
            "--train_config", world["parity_train"]]
    if system == "baseline":
        args += ["--model_config", world["model"]]
    else:
        args += ["--data_config", world["zh"], "--model_config", world["fscl_model"],
                 "--algorithm_config", world["algo"]]
    jrec = _run_jax(args + ["--exp_dir", str(tmp_path / "jax")])
    prec = _run_port(args + ["--exp_dir", str(tmp_path / "port")], jrec)
    assert prec["out"][1].step == 3
    n = 3
    assert len(prec["items"]) >= n and len(jrec["items"]) >= n
    same(prec["items"][:n], jrec["items"][:n], f"{system} batches")
    _held(prec["losses"], jrec["losses"])


def _experiment(exp_dir):
    """(key, meta.json without its timestamp, metrics rows) of the one
    tracked experiment under exp_dir."""
    root = os.path.join(exp_dir, "experiments")
    (key,) = os.listdir(root)
    with open(os.path.join(root, key, "meta.json")) as f:
        meta = json.load(f)
    assert meta.pop("created") and meta.pop("exp_key") == key
    with open(os.path.join(root, key, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return key, meta, rows


def test_train_use_tracker_and_exp_key_match_fscl_tpu_cli(world, tmp_path, no_flax_dropout):
    """`train --use_tracker` for 3 steps, then `--resume --exp_key <key>` to 5,
    in both packages from the same weights: the same experiment layout,
    meta.json (params, `resumed` 1) and metric names at the same steps; the
    losses held as above, the learning rates within 1e-6."""
    args = ["train", "--data_config", world["en"], "--model_config", world["model"],
            "--train_config", world["parity_train"], "--use_tracker"]
    exps = {side: str(tmp_path / side) for side in ("jax", "port")}
    prec = _run_port(args + ["--exp_dir", exps["port"]],
                     _run_jax(args + ["--exp_dir", exps["jax"]]))
    assert prec["out"][1].step == 3
    keys = {side: _experiment(exp)[0] for side, exp in exps.items()}
    resume = ["--resume", "--total_step", "5"]
    prec = _run_port(args + resume + ["--exp_key", keys["port"], "--exp_dir", exps["port"]],
                     _run_jax(args + resume + ["--exp_key", keys["jax"],
                                               "--exp_dir", exps["jax"]]))
    assert prec["out"][1].step == 5
    (pkey, pmeta, prows), (jkey, jmeta, jrows) = (_experiment(exps[s]) for s in ("port", "jax"))
    assert (pkey, jkey) == (keys["port"], keys["jax"])
    assert pmeta == jmeta and pmeta["resumed"] == 1 and pmeta["name"] == "baseline"
    assert pmeta["params"]["total_step"] == 5
    # the same names at the same steps (each package orders a step's metrics its own way)
    assert sorted((r["step"], r["name"]) for r in prows) == \
        sorted((r["step"], r["name"]) for r in jrows)
    assert sorted({r["step"] for r in prows}) == [1, 2, 3, 4, 5]
    for name in {r["name"] for r in prows}:
        got = [r["value"] for r in prows if r["name"] == name]
        want = [r["value"] for r in jrows if r["name"] == name]
        if name == "Train/lr":
            np.testing.assert_allclose(got, want, rtol=1e-6)
        elif name == "Train/Total Loss":
            _held(got, want)


@pytest.mark.parametrize("scan", [False, True], ids=["trainer", "scan_adapt"])
def test_tune_matches_fscl_tpu_cli(world, tmp_path, no_flax_dropout, scan):
    """The tune flow from the same FSCL and baseline weights: the SupInfo
    batches of 4 that build the reference table, then either the Trainer's
    batches and losses, or the adaptation route (resident), its support set
    and the loss curve of adaptation.csv."""
    args = ["tune", "--data_config", world["zh"], "--model_config", world["fscl_model"],
            "--adaptation_steps", "3"]
    if scan:
        args += ["--scan_adapt"]
    jrec = _run_jax(args + ["--exp_dir", str(tmp_path / "jax")])
    prec = _run_port(args + ["--exp_dir", str(tmp_path / "port")], jrec)
    assert len(jrec["sup_batches"]) == 2          # 8 utterances in batches of 4
    same(prec["sup_batches"], jrec["sup_batches"], "sup batches")
    if scan:
        assert prec["route"] == jrec["route"] == "resident"
        same(prec["adapt_input"], jrec["adapt_input"], "support")
        curves = []
        for side in ("jax", "port"):
            with open(tmp_path / side / "csv" / "zh" / "adaptation.csv") as f:
                curves.append([float(r[1]) for r in list(csv.reader(f))[1:]])
        np.testing.assert_array_equal(curves[1], prec["out"][1])
        _held(curves[1], curves[0])
    else:
        assert "route" not in prec and "route" not in jrec
        same(prec["items"][:3], jrec["items"][:3], "tune batches")
        _held(prec["losses"], jrec["losses"])
