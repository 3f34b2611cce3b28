"""The port's CUDA kernels on the card (marked `cuda`; they skip without one).

This file imports neither JAX nor fscl_tpu, so it also runs where only the
port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(`--noconftest` because tests/conftest.py configures JAX.) The kernel is
held to its plain version at f32 atol 2e-5 and bf16 atol/rtol 1e-2; a small
system on the card is held to the same system on the CPU as chip_smoke.py
holds the full-width one: durations exact, mels at atol 1e-3.
"""
import numpy as np
import pytest
import torch

from fscl_tpu_torch.core import config as C
from fscl_tpu_torch.ops import attention as tattn
from fscl_tpu_torch.systems.baseline import BaselineSystem

F32_ATOL = 2e-5
BF16_TOL = 1e-2
CARD_VS_CPU_ATOL = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _inputs(seed, B, H, L, Dh, dtype, device):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(a).to(device, dtype)
               for a in rng.normal(size=(3, B, H, L, Dh)).astype(np.float32))
    lens = np.array([max(1, L - L // 3), L, 0])[:B]   # ragged, full, no valid key
    valid = torch.from_numpy(np.arange(L)[None, :] < lens[:, None]).to(device)
    return q, k, v, valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh,L", [(128, 16), (128, 1000), (64, 2048), (128, 77)])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, Dh, L):
    q, k, v, valid = _inputs(5, 3, 2, L, Dh, dtype, cuda_device)
    before = tattn.LAUNCHES
    got = tattn.attend(q, k, v, valid)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES == before + 1
    want = tattn.attention_reference(q, k, v, valid)
    atol, rtol = (F32_ATOL, 0) if dtype == torch.float32 else (BF16_TOL, BF16_TOL)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_cuda_system_matches_cpu(cuda_device):
    """2 + 2 layers at d_model 128 with 2 heads (head dim 64, which the
    kernel takes), synthesized on the card and on the CPU."""
    cfg = C.ModelConfig(
        transformer=C.TransformerConfig(
            encoder_layer=2, decoder_layer=2, encoder_hidden=128, decoder_hidden=128,
            encoder_head=2, decoder_head=2, conv_filter_size=256),
        max_seq_len=256)
    torch.manual_seed(0)
    card = BaselineSystem(cfg, (("en", 152),), device=cuda_device)
    with torch.no_grad():
        card.model.variance_adaptor.duration_predictor.linear_layer.bias.add_(np.log(4.0))
    cpu = BaselineSystem(cfg, (("en", 152),), device="cpu")
    cpu.load_state_dict(card.state_dict(), strict=True)
    rng = np.random.default_rng(0)
    lens = np.array([30, 17, 5])
    texts = rng.integers(1, 152, (3, 32)) * (np.arange(32)[None, :] < lens[:, None])
    args = (texts, lens, np.zeros(3, np.int64), np.zeros(3, np.int64))
    before = tattn.LAUNCHES
    got = card.synthesize_bucketed(*args)
    assert tattn.LAUNCHES == before + 2 * 2 + 2      # pass 1 encoder, pass 2 both stacks
    want = cpu.synthesize_bucketed(*args)
    assert got.postnet_mel.shape == want.postnet_mel.shape
    torch.testing.assert_close(got.duration_rounded.cpu(), want.duration_rounded, rtol=0, atol=0)
    torch.testing.assert_close(got.mel_len.cpu(), want.mel_len, rtol=0, atol=0)
    torch.testing.assert_close(got.postnet_mel.cpu(), want.postnet_mel,
                               atol=CARD_VS_CPU_ATOL, rtol=0)
