"""`synth --vocoder_ckpt` with the MelGAN vocoder through the port's command
line (`fscl_tpu_torch.cli`), in process on the CPU.

The model YAML's `vocoder.model: MelGAN` picks the generator, and the
checkpoint is a melgan-neurips generator in its released weight-norm layout
(`tests/torch_corpus.py:write_melgan_checkpoint`, written from a seed). The
wav `synth` vocodes must equal `Vocoder.from_checkpoint(kind="MelGAN")
.infer` of the same mel exactly (one generator, one device), and stay within
tests/test_torch_vocoder.py's bars (mean |d| < 1e-4, max < 2e-2: f32 convs
summed in another order) of fscl_tpu's `Vocoder` on the same file. MelGAN
runs no MRF stage. `--stream` with MelGAN is refused, as fscl_tpu refuses it
(`fscl_tpu/cli/synth_cmd.py:77-80`).
"""
from unittest import mock

import numpy as np
import pytest
import torch

from fscl_tpu.audio_out import vocoder as jvocoder
from fscl_tpu_torch.audio_out.vocoder import Vocoder
from fscl_tpu_torch.cli import main
from fscl_tpu_torch.core.checkpoint import CheckpointManager
from fscl_tpu_torch.core.config import OptimConfig, model_config_from_yaml
from fscl_tpu_torch.dsp.audio_io import load_wav
from fscl_tpu_torch.ops import mrf_stage
from fscl_tpu_torch.systems.baseline import BaselineSystem

from torch_corpus import MODEL_YAML, write_corpus, write_melgan_checkpoint

GEN_MEAN, GEN_MAX = 1e-4, 2e-2
LINE = "{HH AY1 W ER1 L D HH AY1}"


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def melgan_synth(tmp_path_factory):
    """A seeded base model's checkpoint, a MelGAN model YAML and a MelGAN
    checkpoint; `synth`'s arguments for them on the CPU."""
    root = tmp_path_factory.mktemp("melgan")
    en = write_corpus(str(root), "en-mini", "en", 0, 21)
    model = root / "melgan.yaml"
    model.write_text(MODEL_YAML + 'vocoder:\n  model: "MelGAN"\n  speaker: "universal"\n')
    cfg = model_config_from_yaml(str(model))
    assert cfg.vocoder.model == "MelGAN"
    torch.manual_seed(0)
    system = BaselineSystem(cfg, (("en", 152),), device="cpu", optim_cfg=OptimConfig())
    with torch.no_grad():     # a few frames a phoneme, as chip_smoke.py pins it
        system.model.variance_adaptor.duration_predictor.linear_layer.bias.add_(np.log(4.0))
    CheckpointManager(str(root / "ckpt")).save(0, system, system.init_state())
    voc = str(root / "melgan.pt")
    write_melgan_checkpoint(voc, 1)
    args = ["synth", "--ckpt_dir", str(root / "ckpt"), "--data_config", en, "--model_config",
            str(model), "--device", "cpu", "--text", LINE, "--vocoder_ckpt", voc]
    return root, voc, args


def test_synth_with_a_melgan_checkpoint_matches_vocoder_and_fscl_tpu(melgan_synth):
    root, voc, args = melgan_synth
    vocoded = []

    def infer(orig):
        def call(self, mel):
            wav = orig(self, mel)
            vocoded.append((self.kind, mel, wav))
            return wav
        return call

    before = mrf_stage.LAUNCHES
    with mock.patch.object(Vocoder, "infer", infer(Vocoder.infer)):
        (mel,) = main(args + ["--output", str(root / "a.wav")])
    assert mrf_stage.LAUNCHES == before
    (kind, mel_in, wav), = vocoded
    assert kind == "MelGAN" and mel.shape[0] > 1
    np.testing.assert_array_equal(mel_in, mel)
    assert wav.shape == (mel.shape[0] * 256,) and wav.dtype == np.float32
    alone = Vocoder.from_checkpoint(voc, kind="MelGAN", device="cpu")
    np.testing.assert_array_equal(wav, alone.infer(mel))
    want = jvocoder.Vocoder.from_checkpoint(voc, kind="MelGAN", fused=False).infer(mel)
    err = np.abs(wav - np.asarray(want))
    assert err.mean() < GEN_MEAN and err.max() < GEN_MAX, (err.mean(), err.max())
    written = load_wav(str(root / "a.wav"), 22050)
    assert written.shape == wav.shape and np.isfinite(written).all()


def test_synth_stream_with_melgan_is_refused(melgan_synth):
    root, _, args = melgan_synth
    with pytest.raises(ValueError, match="--stream needs --vocoder_ckpt of a HiFiGAN"):
        main(args + ["--stream", "--output", str(root / "s.wav")])
