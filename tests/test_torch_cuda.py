"""The port's CUDA kernels on the card (marked `cuda`; they skip without one).

This file imports neither JAX nor fscl_tpu, so it also runs where only the
port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(`--noconftest` because tests/conftest.py configures JAX.) The attention
kernel is held to its plain version at f32 atol 2e-5 and bf16 atol/rtol
1e-2, at each key split and at the edges of its tiles; a small system on the card is held to the same system on the CPU as
chip_smoke.py holds the full-width one: durations exact, mels at atol 1e-3.
Under autograd `attend` runs the kernel through a `torch.autograd.Function`
whose backward recomputes the weights; its gradients are held to autograd
through the plain version at atol 1e-5 (the same f32 products, TF32 off, in
another order), and a small system's train steps on the card to the same
steps on the CPU (losses 1e-5 relative at the first step, 1e-3 after it:
Adam at eps 1e-9 amplifies rounding differences).
The MRF stage kernel is held to its plain version at the four HiFiGAN V1
stage widths, at a ragged T and at the edges of its time tile (f32: mean
|d| < 1e-5, max < 5e-3, the bars of
tests/test_hifigan_fused.py; bf16 compute: see STAGE_BF16_*), and a V1
generator on the card to the same one on the CPU at the f32 generator bars.
"""
import numpy as np
import pytest
import torch

from fscl_tpu_torch.core import config as C
from fscl_tpu_torch.data.batch import collate_batch, to_device
from fscl_tpu_torch.models.hifigan import HiFiGANGenerator, ResBlock1
from fscl_tpu_torch.ops import attention as tattn
from fscl_tpu_torch.ops import mrf_stage as tmrf
from fscl_tpu_torch.systems.baseline import BaselineSystem

F32_ATOL = 2e-5
BF16_TOL = 1e-2
CARD_VS_CPU_ATOL = 1e-3
STAGE_F32_MEAN, STAGE_F32_MAX = 1e-5, 5e-3
# bf16 compute: both versions round the same operands, but an f32 sum taken
# in another order can round an intermediate to the neighbouring bf16 value
# (2^-8 relative), which the next convs carry; bars relative to max |plain|,
# as tests/test_torch_hifigan.py holds the plain version to the TPU kernel.
STAGE_BF16_MEAN, STAGE_BF16_MAX = 1e-4, 1e-2
GEN_MEAN, GEN_MAX = 1e-4, 2e-2
GRAD_ATOL = 1e-5
TRAIN_FIRST_RTOL, TRAIN_LATER_RTOL = 1e-5, 1e-3


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
    # ragged, full, no valid key, a single valid key
    lens = np.resize(np.array([max(1, L - L // 3), L, 0, 1]), B)
    valid = torch.from_numpy(np.arange(L)[None, :] < lens[:, None]).to(device)
    return q, k, v, valid


# The kernel's tiling edges: 16-row warp tiles and 32- (f32) or 64-key (bf16)
# ring stages, each split across 1, 2 or 4 warps; B * H = 32 at L = 256; and
# the served L bucket 32 (one full f32 ring stage) at the served B = 8.
@pytest.mark.cuda
@pytest.mark.parametrize("key_split", [None, 1, 2, 4], ids=["auto", "ks1", "ks2", "ks4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh,L,B,H", [
    (128, 16, 3, 2), (128, 1000, 3, 2), (64, 2048, 3, 2), (128, 77, 3, 2), (128, 1, 3, 2),
    (128, 63, 3, 2), (128, 65, 3, 2), (128, 129, 3, 2), (64, 2047, 3, 2), (128, 256, 4, 8),
    (128, 32, 8, 2)])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, Dh, L, B, H, key_split):
    q, k, v, valid = _inputs(5, B, H, L, Dh, dtype, cuda_device)
    before = tattn.LAUNCHES
    if key_split is None:
        got = tattn.attend(q, k, v, valid)
    else:
        got = tattn._launch(q, k, v, valid, None, key_split)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES == before + 1
    want = tattn.attention_reference(q, k, v, valid)
    atol, rtol = (F32_ATOL, 0) if dtype == torch.float32 else (BF16_TOL, BF16_TOL)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    # the sample with no valid key gets the mean of V
    mean_v = v[2].float().mean(dim=1, keepdim=True).expand(v.shape[1:])
    torch.testing.assert_close(got[2].float(), mean_v, atol=atol, rtol=rtol)


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


@pytest.mark.cuda
@pytest.mark.parametrize("Dh,L", [(128, 77), (64, 129), (128, 512)])
def test_attention_function_grads_match_plain_autograd(cuda_device, Dh, L):
    q, k, v, valid = _inputs(7, 4, 2, L, Dh, torch.float32, cuda_device)
    g = torch.from_numpy(np.random.default_rng(8).normal(size=q.shape).astype(np.float32))
    g = g.to(cuda_device)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = tattn.LAUNCHES
    out = tattn.attend(*leaves, valid)
    got = torch.autograd.grad(out, leaves, g)
    assert tattn.LAUNCHES == before + 1          # the backward launches nothing
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = tattn.attention_reference(*ref_leaves, valid)
    want = torch.autograd.grad(ref, ref_leaves, g)
    torch.testing.assert_close(out, ref, atol=F32_ATOL, rtol=0)
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0, msg=f"d{name}")
    assert float(got[1][2].abs().max()) == 0.0   # sample 2 has no valid key


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attend_at_hubert_large_episode_shape(cuda_device, dtype):
    """HuBERT-large over an FSCL episode's support set: 32 wavs of 4 s,
    16 heads of 64 at 199 frames, under no_grad as the frozen upstream runs."""
    q, k, v, valid = _inputs(11, 32, 16, 199, 64, dtype, cuda_device)
    before = tattn.LAUNCHES
    with torch.no_grad():
        got = tattn.attend(q, k, v, valid)
    assert tattn.LAUNCHES == before + 1
    want = tattn.attention_reference(q, k, v, valid)
    tol = F32_ATOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=0 if dtype == torch.float32 else BF16_TOL)


@pytest.mark.cuda
def test_attention_function_twice_differentiable_on_card(cuda_device):
    """A double backward, torch.func.grad and vmap(grad) over a task axis
    through `attend` on the card (the kernel forward, the recompute backward
    differentiated again), against the same through the plain version."""
    from torch.func import grad, vmap
    q, k, v, valid = _inputs(12, 4, 2, 77, 64, torch.float32, cuda_device)
    rng = np.random.default_rng(13)
    w, u = (torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)).to(cuda_device)
            for _ in range(2))

    def second(attn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        first = torch.autograd.grad((attn(*leaves, valid) * w).sum(), leaves, create_graph=True)
        return torch.autograd.grad(sum((d * u).sum() for d in first), leaves)

    before = tattn.LAUNCHES
    got = second(lambda *a: tattn.attend(*a))
    assert tattn.LAUNCHES == before + 1
    for a, b in zip(got, second(tattn.attention_reference)):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0)

    def loss(attn):
        return lambda q_, k_, v_: (attn(q_, k_, v_, valid) * w).sum()

    got = grad(loss(tattn.attend), argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(got, grad(loss(tattn.attention_reference), argnums=(0, 1, 2))(q, k, v)):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0)

    tasks = [t.expand(3, *t.shape).contiguous() for t in (q, k, v)]
    before = tattn.LAUNCHES
    got = vmap(grad(loss(tattn.attend), argnums=(0, 1, 2)))(*tasks)
    assert tattn.LAUNCHES == before + 1          # the tasks folded into one launch
    want = vmap(grad(loss(tattn.attention_reference), argnums=(0, 1, 2)))(*tasks)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0)


@pytest.mark.cuda
def test_hubert_forward_card_matches_cpu(cuda_device):
    """A 2-layer HuBERT of 128 dims in 2 heads of 64 (the kernel's head dim),
    layer_norm extractor, ragged wavs, on the card against the CPU: the same
    f32 math (TF32 off; the kernel's split TF32) through the conv stack and
    two layers, hidden states of O(1) after the LayerNorms."""
    from fscl_tpu_torch.models.hubert import SSLUpstream, frozen_upstream_features
    from fscl_tpu_torch.ops.masking import length_mask
    torch.manual_seed(0)
    cpu = SSLUpstream(dim=128, n_layers=2, n_heads=2, ffn_dim=256, pos_conv_kernel=16,
                      extractor_mode="layer_norm").eval()
    card = SSLUpstream(dim=128, n_layers=2, n_heads=2, ffn_dim=256, pos_conv_kernel=16,
                       extractor_mode="layer_norm").to(cuda_device).eval()
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(14)
    pcm = torch.from_numpy((0.1 * 32767 * rng.normal(size=(3, 8000))).astype(np.int16))
    lens = torch.tensor([8000, 5000, 900])
    want, want_v = frozen_upstream_features(cpu, pcm, length_mask(lens, 8000))
    before = tattn.LAUNCHES
    got, got_v = frozen_upstream_features(card, pcm.to(cuda_device),
                                          length_mask(lens.to(cuda_device), 8000))
    assert tattn.LAUNCHES == before + 2
    assert torch.equal(got_v.cpu(), want_v)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_attend_under_autograd_gives_qkv_gradients(cuda_device):
    """The kernel's output is no autograd leaf: q, k and v get gradients."""
    q, k, v, valid = _inputs(9, 3, 2, 64, 128, torch.float32, cuda_device)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tattn.attend(*leaves, valid)
    assert out.grad_fn is not None
    out.square().sum().backward()
    assert all(t.grad is not None and float(t.grad.abs().max()) > 0 for t in leaves)
    with torch.no_grad():
        assert tattn.attend(*leaves, valid).grad_fn is None


def _train_batch(rng, B, table):
    samples = []
    for i in range(B):
        n = int(rng.integers(12, 31))
        ph = rng.integers(1, len(table), n)
        dur = rng.integers(1, 5, n)
        frames = np.repeat(ph, dur)
        samples.append(dict(
            id=str(i), text="", phonemes=ph, duration=dur,
            mel=table[frames, :80] + 0.1 * rng.normal(size=(len(frames), 80)),
            pitch=table[ph, 80] + 0.1 * rng.normal(size=n),
            energy=table[ph, 81] + 0.1 * rng.normal(size=n), speaker=0, lang_id=0))
    return collate_batch(samples, (32,), (128,), pitch_feature="phoneme_level",
                         energy_feature="phoneme_level")[1]


@pytest.mark.cuda
def test_cuda_train_steps_match_cpu(cuda_device):
    """Three train steps of a 2 + 2 layer system at d_model 128 (head dim
    64) without dropout, from the same weights, on the card and on the CPU."""
    cfg = C.ModelConfig(
        transformer=C.TransformerConfig(
            encoder_layer=2, decoder_layer=2, encoder_hidden=128, decoder_hidden=128,
            encoder_head=2, decoder_head=2, conv_filter_size=256, encoder_dropout=0.0,
            decoder_dropout=0.0),
        variance_predictor=C.VariancePredictorConfig(dropout=0.0), max_seq_len=256)
    optim = C.OptimConfig(lr=2e-3, warmup_step=10, anneal_steps=())
    torch.manual_seed(0)
    card = BaselineSystem(cfg, (("en", 152),), device=cuda_device, optim_cfg=optim)
    cpu = BaselineSystem(cfg, (("en", 152),), device="cpu", optim_cfg=optim)
    cpu.load_state_dict(card.state_dict(), strict=True)
    rng = np.random.default_rng(3)
    table = rng.normal(size=(152, 82)).astype(np.float32)
    batches = [_train_batch(rng, 4, table) for _ in range(3)]
    losses = {}
    for system in (card, cpu):
        system.model.postnet.dropout.p = 0.0
        state = system.init_state()
        before = tattn.LAUNCHES
        losses[system.device.type] = [
            float(system.train_step(state, to_device(b, system.device))[1]["Total Loss"])
            for b in batches]
        assert tattn.LAUNCHES - before == (4 * 3 if system is card else 0)
    rel = np.abs(np.subtract(losses["cuda"], losses["cpu"])) / np.abs(losses["cpu"])
    assert rel[0] <= TRAIN_FIRST_RTOL and rel[1:].max() <= TRAIN_LATER_RTOL, rel


def _stage(C, post, seed=0):
    torch.manual_seed(seed)
    rbs = [ResBlock1(C, k, (1, 3, 5)) for k in (3, 7, 11)]
    conv_post = torch.nn.Conv1d(C, 1, 7, padding=3) if post else None
    return rbs, conv_post


# The stage kernel's time tile (csrc/mrf_stage.cu, Cfg::BT): 512 rows. Per V1
# stage width: a ragged T, T = 1, one short of the tile and one past it (odd
# T: 4-byte window copies), and a ragged T that is a multiple of 4 (bulk
# copies with zero-filled edge rows, as every served T).
TIME_TILE = 512
STAGE_SHAPES = [(256, 517, False), (128, 1031, False), (64, 2053, False), (32, 4099, True)] + [
    (C, T, C == 32) for C in (256, 128, 64, 32)
    for T in (1, TIME_TILE - 1, TIME_TILE + 1, TIME_TILE + 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("C,T,post", STAGE_SHAPES)
def test_mrf_stage_kernel_matches_plain_version(cuda_device, compute_dtype, C, T, post):
    rbs, conv_post = _stage(C, post)
    for m in rbs + ([conv_post] if post else []):
        m.to(cuda_device)
    rng = np.random.default_rng(C)
    x = torch.from_numpy(rng.normal(size=(2, C, T)).astype(np.float32)).to(cuda_device)
    want = tmrf.mrf_stage_reference(x, rbs, conv_post, compute_dtype)
    before = tmrf.LAUNCHES
    got = tmrf.mrf_stage(x, rbs, conv_post, compute_dtype)
    torch.cuda.synchronize()
    assert tmrf.LAUNCHES == before + 1
    assert got.shape == want.shape == ((2, T) if post else (2, C, T))
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    if compute_dtype == torch.float32:
        assert err.mean() < STAGE_F32_MEAN and err.max() < STAGE_F32_MAX
    else:
        scale = want.abs().max()
        assert err.mean() < STAGE_BF16_MEAN * scale and err.max() < STAGE_BF16_MAX * scale


@pytest.mark.cuda
def test_mrf_stage_kernel_refuses_what_it_cannot_run(cuda_device):
    rbs, _ = _stage(32, False)
    for m in rbs:
        m.to(cuda_device)
    with pytest.raises(ValueError, match="multiple of 32"):
        tmrf.mrf_stage(torch.zeros(1, 48, 10, device=cuda_device), rbs)
    with pytest.raises(ValueError, match="float32"):
        tmrf.mrf_stage(torch.zeros(1, 32, 10, device=cuda_device, dtype=torch.float64), rbs)
    with pytest.raises(ValueError, match="post conv"):
        tmrf.mrf_stage(torch.zeros(1, 32, 10, device=cuda_device), rbs,
                       torch.nn.Conv1d(32, 1, 5).to(cuda_device))


@pytest.mark.cuda
def test_hifigan_card_matches_cpu(cuda_device):
    """HiFiGAN V1 (stages at C = 256, 128, 64, 32) on 6 mel frames."""
    torch.manual_seed(1)
    cpu = HiFiGANGenerator().eval()
    card = HiFiGANGenerator().to(cuda_device).eval()
    card.load_state_dict(cpu.state_dict())
    mel = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 6, 80)).astype(np.float32))
    before = tmrf.LAUNCHES
    with torch.inference_mode():
        got = card(mel.to(cuda_device)).cpu()
        want = cpu(mel)
    assert tmrf.LAUNCHES == before + 4
    assert got.shape == want.shape == (2, 6 * 256)
    err = (got - want).abs()
    assert err.mean() < GEN_MEAN and err.max() < GEN_MAX
