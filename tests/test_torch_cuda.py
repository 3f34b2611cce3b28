"""The port's CUDA kernels on the card (marked `cuda`; they skip without one).

This file imports neither JAX nor fscl_tpu, so it also runs where only the
port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(`--noconftest` because tests/conftest.py configures JAX.) The attention
kernel is held to its plain version at f32 atol 2e-5 and bf16 atol/rtol
1e-2, at each key split and at the edges of its tiles; a small system on the card is held to the same system on the CPU as
chip_smoke.py holds the full-width one: durations exact, mels at atol 1e-3.
Under autograd `attend` runs the kernel through a `torch.autograd.Function`
whose backward is the backward kernel (csrc/attention_bwd.cu) at head dims up
to 128 and the recompute `attention_bwd` above; its gradients are held to
autograd through the plain version at atol 1e-5 (f32 products, TF32 off, in
another order), and a small system's train steps on the card to the same
steps on the CPU (losses 1e-5 relative at the first step, 1e-3 after it:
Adam at eps 1e-9 amplifies rounding differences). The backward kernel is
held to `attention_bwd` at the training, FSCL, tune and vmapped shapes in
f32 (atol 1e-5) and bf16 (1e-2 of each gradient's max).
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
from fscl_tpu_torch.data.batch import DvecRefs, collate_batch, to_device
from fscl_tpu_torch.models.hifigan import HiFiGANGenerator, ResBlock1
from fscl_tpu_torch.ops import attention as tattn
from fscl_tpu_torch.ops import mrf_stage as tmrf
from fscl_tpu_torch.systems.baseline import BaselineSystem

from attention_grads_f64 import distance_from_float64

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


# The kernel's tiling edges: 64-row warpgroup tiles, 128-row blocks (key
# split 1) or 64-row ones whose warpgroups split the key loop (2), 32-key
# ring stages; B * H = 32 at L = 256; and the served L bucket 32 (one full
# ring stage) at the served B = 8; the 10 L = 2560 unit positions chained
# serving decodes for the L bucket 256; L = 20000, past the 16384 keys an
# earlier design's shared memory held (the key flags travel with each ring
# stage). "stats": the wrapper's split with row stats, the instance whose
# f32 scores the backward kernel recomputes.
@pytest.mark.cuda
@pytest.mark.parametrize("key_split", [None, 1, 2, "stats"], ids=["auto", "ks1", "ks2", "stats"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh,L,B,H", [
    (128, 16, 3, 2), (128, 1000, 3, 2), (64, 2048, 3, 2), (128, 77, 3, 2), (128, 1, 3, 2),
    (128, 63, 3, 2), (128, 65, 3, 2), (128, 129, 3, 2), (64, 2047, 3, 2), (128, 256, 4, 8),
    (128, 32, 8, 2), (128, 2560, 3, 2), (128, 20000, 3, 1)])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, Dh, L, B, H, key_split):
    q, k, v, valid = _inputs(5, B, H, L, Dh, dtype, cuda_device)
    before = tattn.LAUNCHES
    stats = None
    if key_split is None:
        got = tattn.attend(q, k, v, valid)
    elif key_split == "stats":
        stats = torch.full((B, H, L, 2), float("nan"), device=cuda_device)
        got = tattn.attention_cuda(q, k, v, valid, None, stats)
    else:
        got = tattn._launch(q, k, v, valid, None, key_split)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES == before + 1
    if stats is not None:
        # every row's max is finite and its sum of weights at least 1 (the
        # weight of its max); the one-valid-key sample's sum is exactly 1
        assert torch.isfinite(stats).all() and bool((stats[..., 1] >= 1).all())
        if B > 3:
            assert bool((stats[3, ..., 1] == 1).all())
    want = tattn.attention_reference(q, k, v, valid)
    atol, rtol = (F32_ATOL, 0) if dtype == torch.float32 else (BF16_TOL, BF16_TOL)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    # the sample with no valid key gets the mean of V
    mean_v = v[2].float().mean(dim=1, keepdim=True).expand(v.shape[1:])
    torch.testing.assert_close(got[2].float(), mean_v, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [40, 48, 80])
def test_cuda_kernel_pads_other_head_dims(cuda_device, dtype, Dh):
    """Head dims without a kernel instance (the `mel` upstream's 40, custom
    upstreams' 48 and 80) run zero-padded to 64 or 128: at every key split
    and through `attend`, held to the plain version at the true head dim."""
    q, k, v, valid = _inputs(14, 8, 2, 199, Dh, dtype, cuda_device)
    want = tattn.attention_reference(q, k, v, valid)
    atol, rtol = (F32_ATOL, 0) if dtype == torch.float32 else (BF16_TOL, BF16_TOL)
    for key_split in (None, *tattn.key_splits(Dh)):
        before = tattn.LAUNCHES
        with torch.no_grad():
            got = (tattn.attend(q, k, v, valid) if key_split is None
                   else tattn._launch(q, k, v, valid, None, key_split))
        torch.cuda.synchronize()
        assert tattn.LAUNCHES == before + 1 and got.shape == q.shape and got.dtype == dtype
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [192, 256, 200, 320, 512, 1024])
@pytest.mark.parametrize("L", [64, 200, 1000])
def test_cuda_kernel_above_head_dim_128_matches_plain_version(cuda_device, dtype, Dh, L):
    """The wide route (head dims above 128, 200 padded to 256; 320 ends in a
    half slice of O's columns), at every key split and through `attend`,
    with a ragged mask and a sample with no valid key; the temperature is
    sqrt(the true head dim)."""
    q, k, v, valid = _inputs(21, 4, 2, L, Dh, dtype, cuda_device)
    want = tattn.attention_reference(q, k, v, valid)
    atol, rtol = (F32_ATOL, 0) if dtype == torch.float32 else (BF16_TOL, BF16_TOL)
    for key_split in (None, 1, 2, 4):
        before = tattn.LAUNCHES
        with torch.no_grad():
            got = (tattn.attend(q, k, v, valid) if key_split is None
                   else tattn._launch(q, k, v, valid, None, key_split))
        torch.cuda.synchronize()
        assert tattn.LAUNCHES == before + 1 and got.shape == q.shape and got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [64, 128, 192])
def test_cuda_kernel_long_keys_with_a_common_value(cuda_device, Dh):
    """18000 keys whose V is 1 + 0.1 N(0, 1): o grows with the keys, where
    the tensor cores' truncating adds would show (zero-mean V hides them).
    f32 at every key split, at the f32 bar."""
    q, k, v, valid = _inputs(24, 1, 2, 18000, Dh, torch.float32, cuda_device)
    v = 1.0 + 0.1 * v
    want = tattn.attention_reference(q, k, v, valid)
    for key_split in (None, *tattn.key_splits(Dh)):
        with torch.no_grad():
            got = (tattn.attend(q, k, v, valid) if key_split is None
                   else tattn._launch(q, k, v, valid, None, key_split))
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_past_65535_heads(cuda_device, dtype):
    """B * H = 70000, past the 65535 blocks an earlier grid took along y:
    one launch, every key split, held to the plain version."""
    q, k, v, valid = _inputs(23, 35000, 2, 16, 64, dtype, cuda_device)
    want = tattn.attention_reference(q, k, v, valid)
    atol, rtol = (F32_ATOL, 0) if dtype == torch.float32 else (BF16_TOL, BF16_TOL)
    for key_split in (None, *tattn.key_splits(64)):
        before = tattn.LAUNCHES
        with torch.no_grad():
            got = (tattn.attend(q, k, v, valid) if key_split is None
                   else tattn._launch(q, k, v, valid, None, key_split))
        torch.cuda.synchronize()
        assert tattn.LAUNCHES == before + 1
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


# The narrow route at the main path's shapes (PERF.md's forward table: the
# served decoder at T = 512 and 1000, the train decoder, the FSCL upstream,
# the vmapped adaptation, the bf16 upstream layout) and the sequence-parallel
# upstream's Lq != Lk, at both of its key splits, with and without row
# stats; samples with ragged, all, no and one valid key.
NARROW_MAIN_SHAPES = [(8, 2, 512, 512, 128), (8, 2, 1000, 1000, 128), (16, 2, 512, 512, 128),
                      (32, 16, 199, 199, 64), (32, 2, 256, 256, 128), (8, 16, 1000, 1000, 64),
                      (32, 16, 100, 200, 64), (32, 16, 200, 100, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("with_stats", [False, True], ids=["serve", "stats"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Lq,Lk,Dh", NARROW_MAIN_SHAPES)
def test_narrow_route_at_main_path_shapes(cuda_device, dtype, B, H, Lq, Lk, Dh, with_stats):
    rng = np.random.default_rng(31)
    q = torch.from_numpy(rng.normal(size=(B, H, Lq, Dh)).astype(np.float32)).to(cuda_device, dtype)
    k, v = (torch.from_numpy(a).to(cuda_device, dtype)
            for a in rng.normal(size=(2, B, H, Lk, Dh)).astype(np.float32))
    lens = np.resize(np.array([max(1, Lk - Lk // 3), Lk, 0, 1]), B)
    valid = torch.from_numpy(np.arange(Lk)[None, :] < lens[:, None]).to(cuda_device)
    want = tattn.attention_reference(q, k, v, valid)
    atol, rtol = (F32_ATOL, 0) if dtype == torch.float32 else (BF16_TOL, BF16_TOL)
    mean_v = v[2].float().mean(dim=1, keepdim=True).expand(H, Lq, Dh)
    for split in tattn.NARROW_SPLITS:
        stats = torch.full((B, H, Lq, 2), float("nan"), device=cuda_device) if with_stats else None
        got = tattn._launch(q, k, v, valid, None, split, stats)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
        torch.testing.assert_close(got[2].float(), mean_v, atol=atol, rtol=rtol)
        if with_stats:
            assert torch.isfinite(stats).all() and bool((stats[3, ..., 1] == 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,Dh", [(64, 128), (512, 128), (1000, 128), (199, 64), (199, 40)])
def test_narrow_route_same_bits_alone_and_batched(cuda_device, dtype, L, Dh):
    """The wrapper's key split depends on the query length, the head dim and
    row stats alone, and no block reads another's rows: each sample's
    output, and its row stats, are the same bits alone (B * H = 2) and in a
    batch of 8 (B * H = 16)."""
    q, k, v, valid = _inputs(32, 8, 2, L, Dh, dtype, cuda_device)
    stats = torch.empty(8, 2, L, 2, device=cuda_device)
    batched = tattn.attention_cuda(q, k, v, valid, None, stats)
    for b in range(8):
        one = torch.empty(1, 2, L, 2, device=cuda_device)
        alone = tattn.attention_cuda(*(t[b:b + 1].contiguous() for t in (q, k, v, valid)), None, one)
        torch.cuda.synchronize()
        assert torch.equal(alone[0], batched[b]) and torch.equal(one[0], stats[b])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,Dh", [(64, 128), (512, 128), (199, 64), (199, 40), (399, 48)])
def test_wrapper_launches_the_split_of_the_true_head_dim(cuda_device, dtype, L, Dh):
    """The wrapper launches the key split `narrow_split` gives the caller's
    head dim (before padding), without and with row stats: its output and
    row stats are the bits of that split's launch."""
    q, k, v, valid = _inputs(33, 8, 2, L, Dh, dtype, cuda_device)
    for with_stats in (False, True):
        stats, want_stats = (torch.empty(8, 2, L, 2, device=cuda_device) if with_stats else None
                             for _ in range(2))
        got = tattn.attention_cuda(q, k, v, valid, None, stats)
        want = tattn._launch(q, k, v, valid, None, tattn.narrow_split(L, Dh, with_stats),
                             want_stats)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert not with_stats or torch.equal(stats, want_stats)


@pytest.mark.cuda
@pytest.mark.parametrize("Dh,L", [(128, 77), (64, 129), (128, 512), (192, 200), (512, 200)])
def test_attention_function_grads_match_plain_autograd(cuda_device, Dh, L):
    q, k, v, valid = _inputs(7, 4, 2, L, Dh, torch.float32, cuda_device)
    g = torch.from_numpy(np.random.default_rng(8).normal(size=q.shape).astype(np.float32))
    g = g.to(cuda_device)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before, bwd_before = tattn.LAUNCHES, tattn.BWD_LAUNCHES
    out = tattn.attend(*leaves, valid)
    got = torch.autograd.grad(out, leaves, g)
    assert tattn.LAUNCHES == before + 1          # the backward launches no forward
    # the backward kernels (two launches) at head dims up to 128, the recompute above
    assert tattn.BWD_LAUNCHES == bwd_before + 2 * (Dh <= 128)
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
    through `attend` on the card (the kernel forward, the backward kernel,
    whose derivative is the recompute's), against the same through the plain
    version."""
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


# Per V1 stage width: a ragged T; T = 1; a T shorter than the widest halo (5).
STAGE_SHAPES = [(256, 517, False), (128, 1031, False), (64, 2053, False), (32, 4099, True)] + [
    (C, T, C == 32) for C in (256, 128, 64, 32) for T in (1, 5)]
# The stage kernel's time tile is the library's (route_on_card(C, bf16).m:
# 256, 384 or 512 rows by width and type), of which a fused pair stores
# M - (k - 1) rows and a pair in two launches all M. T = M - cut + dt, per V1
# stage width and type: one either side of each kernel size's output rows
# (odd T, padded to a multiple of 4 rows), one either side of M, and M + 4 (a
# multiple of 4 past it, as every served T, no padding).
TILE_EDGES = [(k - 1, dt) for k in (3, 7, 11) for dt in (-1, 1)] + [(0, -1), (0, 1), (0, 4)]
# Each kernel size at its largest reach (k - 1) / 2 * d <= 32, and C = 512
# (the bf16 route's two-launch pairs, as f32 above C = 128).
REACH_SHAPES = [(3, 16), (7, 10), (11, 6)]


def _check_stage(cuda_device, rbs, conv_post, x, compute_dtype):
    for m in rbs + ([conv_post] if conv_post is not None else []):
        m.to(cuda_device)
    x = x.to(cuda_device)
    want = tmrf.mrf_stage_reference(x, rbs, conv_post, compute_dtype)
    before = tmrf.LAUNCHES, tmrf.CONV_LAUNCHES, tmrf.POST_LAUNCHES
    got = tmrf.mrf_stage(x, rbs, conv_post, compute_dtype)
    torch.cuda.synchronize()
    B, C, T = x.shape
    # the library's own count of the kernels it queued: a launch a pair
    # where the route fuses it, else two, and conv_post
    fused = tmrf.route_on_card(C, compute_dtype == torch.bfloat16).fused
    n_pairs = sum(len(rb.dilations) for rb in rbs)
    assert (tmrf.LAUNCHES - before[0], tmrf.CONV_LAUNCHES - before[1],
            tmrf.POST_LAUNCHES - before[2]) == (1, n_pairs * (1 if fused else 2),
                                                int(conv_post is not None))
    assert got.shape == want.shape == ((B, T) if conv_post is not None else (B, C, T))
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    if compute_dtype == torch.float32:
        assert err.mean() < STAGE_F32_MEAN and err.max() < STAGE_F32_MAX
    else:
        scale = want.abs().max()
        assert err.mean() < STAGE_BF16_MEAN * scale and err.max() < STAGE_BF16_MAX * scale


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("C,T,post", STAGE_SHAPES)
def test_mrf_stage_kernel_matches_plain_version(cuda_device, compute_dtype, C, T, post):
    rbs, conv_post = _stage(C, post)
    rng = np.random.default_rng(C)
    x = torch.from_numpy(rng.normal(size=(2, C, T)).astype(np.float32))
    _check_stage(cuda_device, rbs, conv_post, x, compute_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cut,dt", TILE_EDGES)
@pytest.mark.parametrize("C", [256, 128, 64, 32])
def test_mrf_stage_kernel_at_the_tile_edges(cuda_device, compute_dtype, C, cut, dt):
    T = tmrf.route_on_card(C, compute_dtype == torch.bfloat16).m - cut + dt
    rbs, conv_post = _stage(C, C == 32)
    x = torch.from_numpy(np.random.default_rng(T).normal(size=(2, C, T)).astype(np.float32))
    _check_stage(cuda_device, rbs, conv_post, x, compute_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("k,d", REACH_SHAPES)
@pytest.mark.parametrize("C", [64, 512])
def test_mrf_stage_kernel_at_the_largest_reach(cuda_device, compute_dtype, k, d, C):
    """One resblock of dilations 1 and d at the kernel's largest reach, over
    T = 700 (several tiles, a ragged last one)."""
    torch.manual_seed(k)
    rbs = [ResBlock1(C, k, (1, d))]
    x = torch.from_numpy(np.random.default_rng(d).normal(size=(2, C, 700)).astype(np.float32))
    _check_stage(cuda_device, rbs, None, x, compute_dtype)


# (C, compute dtype) -> (NP, M, fused): NP the largest of 128, 64, 32
# dividing C; a pair is one launch at the first height built for NP (f32:
# 256 at NP = 128, 384 at 64, 512 or 256 at 32; bf16: 256 at 128 and 64, 512
# or 256 at 32) for which h (M + 12 rows x C channels, 4 bytes in f32, 2 in
# bf16) fits beside the rings: f32 up to C = 128, bf16 up to 256.
ROUTES = [
    (32, False, 32, 512, True), (64, False, 64, 384, True), (96, False, 32, 256, True),
    (128, False, 128, 256, True), (160, False, 32, 512, False), (192, False, 64, 384, False),
    (256, False, 128, 256, False), (512, False, 128, 256, False),
    (32, True, 32, 512, True), (64, True, 64, 256, True), (96, True, 32, 256, True),
    (128, True, 128, 256, True), (192, True, 64, 256, True), (256, True, 128, 256, True),
    (288, True, 32, 512, False), (320, True, 64, 256, False), (384, True, 128, 256, False),
    (512, True, 128, 256, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("C,round_bf16,np_,m,fused", ROUTES)
def test_mrf_stage_route_is_the_rule(cuda_device, C, round_bf16, np_, m, fused):
    """The library's route (csrc/mrf_stage.cu:route) at the widths that set
    it, and its NP the one the host packs the weights for."""
    r = tmrf.route_on_card(C, round_bf16)
    assert (r.np, r.m, r.fused) == (np_, m, fused)
    assert r.np == tmrf.pass_width(C)


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


def _tune_system(device, speaker="dvec"):
    from fscl_tpu_torch.systems.tune import TransEmbTuneSystem
    cfg = C.ModelConfig(
        transformer=C.TransformerConfig(
            encoder_layer=2, decoder_layer=2, encoder_hidden=128, decoder_hidden=128,
            encoder_head=2, decoder_head=2, conv_filter_size=256, encoder_dropout=0.0,
            decoder_dropout=0.0),
        variance_predictor=C.VariancePredictorConfig(dropout=0.0), max_seq_len=256,
        speaker=C.SpeakerConfig(emb_type=speaker, n_speakers=4, n_ref_slices=3))
    torch.manual_seed(0)
    system = TransEmbTuneSystem(cfg, (("xx", 40),), device=device)
    system.model.postnet.dropout.p = 0.0
    return system


def _tune_batches(seed, n, B=4):
    """Batches with d-vector references of 3 slices of 40 frames, one
    sample's padded."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(40, 82)).astype(np.float32)
    out = []
    for _ in range(n):
        b = _train_batch(rng, B, table)
        slices = rng.normal(size=(B, 3, 40, 40)).astype(np.float32)
        mask = np.ones((B, 3), np.float32)
        mask[-1, 1:] = 0.0
        out.append(b._replace(speaker_args=DvecRefs(slices, mask)))
    return out


@pytest.mark.cuda
def test_tune_adaptation_step_card_matches_cpu(cuda_device):
    """One SGD adaptation step of a 2 + 2 layer trunk with GE2E d-vectors
    (eval mode, GE2E's cuDNN LSTM differentiated), from the same weights on
    the card and on the CPU: the loss 1e-5 relative (the forward's summation
    order), every parameter within 1e-6 (lr 1e-3 times gradients 1e-5
    relative apart), GE2E moved on both."""
    from fscl_tpu_torch.systems.tune import adaptable_params, adapt_on_chip
    card, cpu = _tune_system(cuda_device), _tune_system("cpu")
    cpu.load_state_dict(card.state_dict(), strict=True)
    batches = _tune_batches(21, 1)
    got = {}
    for system in (card, cpu):
        before = tattn.LAUNCHES
        got[system.device.type] = adapt_on_chip(system, adaptable_params(system), batches,
                                                lr=1e-3, symbol_id="xx")
        assert tattn.LAUNCHES - before == (4 if system is card else 0)
        assert not system.training
    (p_card, l_card), (p_cpu, l_cpu) = got["cuda"], got["cpu"]
    torch.testing.assert_close(l_card.cpu(), l_cpu, rtol=1e-5, atol=0)
    before = adaptable_params(cpu)
    for name, value in p_cpu.items():
        torch.testing.assert_close(p_card[name].cpu(), value, atol=1e-6, rtol=0, msg=name)
        if "ge2e.lstm.weight_hh" in name:
            assert not torch.equal(value, before[name]), name


@pytest.mark.cuda
def test_adapt_many_dvec_on_card_matches_sequential(cuda_device):
    """Two tasks of two SGD steps adapted at once under vmap (GE2E on its
    written-out gates, the attention Function's vmap rule folding both
    tasks into one launch per layer) against each task adapted alone
    (cuDNN's LSTM): losses 1e-5 relative, parameters within 1e-6."""
    from fscl_tpu_torch.systems.tune import adaptable_params, adapt_many_on_chip, adapt_on_chip
    system = _tune_system(cuda_device)
    params = adaptable_params(system)
    tasks = [_tune_batches(30 + t, 2) for t in range(2)]
    before = tattn.LAUNCHES
    many, many_losses = adapt_many_on_chip(system, params, tasks, lr=1e-3, symbol_id="xx")
    assert tattn.LAUNCHES - before == 4 * 2
    assert many_losses.shape == (2, 2)
    for t, batches in enumerate(tasks):
        one, losses = adapt_on_chip(system, params, batches, lr=1e-3, symbol_id="xx")
        torch.testing.assert_close(many_losses[t], losses, rtol=1e-5, atol=0)
        for name, value in one.items():
            torch.testing.assert_close(many[name][t], value, atol=1e-6, rtol=0, msg=name)


@pytest.mark.cuda
def test_cli_trains_on_the_card(cuda_device, tmp_path):
    """`train` through the command line with its default device: two steps
    on a small store at d_model 128 (head dim 64), one attention launch per
    FFT block, finite losses, a checkpoint of CPU tensors."""
    from fscl_tpu_torch.cli import main
    from fscl_tpu_torch.core.checkpoint import CheckpointManager
    from torch_corpus import MODEL_YAML, write_corpus

    data = write_corpus(str(tmp_path), "en-mini", "en", 0, 3)
    model = tmp_path / "model.yaml"
    model.write_text(MODEL_YAML.replace("hidden: 32", "hidden: 128"))
    train = tmp_path / "train.yaml"
    train.write_text("optimizer:\n  batch_size: 4\n  warm_up_step: 2\n"
                     "step:\n  total_step: 2\n  log_step: 1\n  save_step: 2\n")
    before = tattn.LAUNCHES
    system, state = main(["train", "--data_config", data, "--model_config", str(model),
                          "--train_config", str(train), "--exp_dir", str(tmp_path / "exp")])
    assert system.device.type == "cuda" and state.step == 2
    assert tattn.LAUNCHES - before == 2 * 2
    with open(tmp_path / "exp" / "log" / "log.txt") as f:
        losses = [float(l.split("Total Loss: ")[1].split(" ")[0]) for l in f]
    assert len(losses) == 2 and np.isfinite(losses).all()
    raw = CheckpointManager(str(tmp_path / "exp" / "ckpt")).restore()
    assert raw["step"] == 2 and all(t.device.type == "cpu" for t in raw["params"].values())


@pytest.mark.cuda
def test_checkpoint_round_trip_of_card_tensors(cuda_device, tmp_path):
    """Two train steps on the card, saved, then restored in full into a
    fresh system on the card: parameters, buffers, moments and step equal,
    on the card."""
    from fscl_tpu_torch.core.checkpoint import CheckpointManager
    cfg = C.ModelConfig(
        transformer=C.TransformerConfig(
            encoder_layer=1, decoder_layer=1, encoder_hidden=128, decoder_hidden=128,
            conv_filter_size=256), max_seq_len=256)
    optim = C.OptimConfig(lr=2e-3, warmup_step=2)
    rng = np.random.default_rng(4)
    table = rng.normal(size=(152, 82)).astype(np.float32)
    torch.manual_seed(0)
    system = BaselineSystem(cfg, (("en", 152),), device=cuda_device, optim_cfg=optim)
    state = system.init_state()
    for _ in range(2):
        state, _ = system.train_step(state, to_device(_train_batch(rng, 4, table), cuda_device))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state.step, system, state)
    torch.manual_seed(1)
    fresh = BaselineSystem(cfg, (("en", 152),), device=cuda_device, optim_cfg=optim)
    got = mgr.restore_into(fresh, fresh.init_state(), full=True)
    assert got.step == 2 and got.opt_state.count == 2
    for k, v in system.state_dict().items():
        assert fresh.state_dict()[k].device.type == "cuda"
        assert torch.equal(fresh.state_dict()[k], v), k
    for a, b in zip(got.opt_state.mu + got.opt_state.nu, state.opt_state.mu + state.opt_state.nu):
        assert a.device.type == "cuda" and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B,F", [(16, 1), (16, 2), (16, 173), (3, 1723), (2, 20000)])
def test_dio_contour_kernel_equals_plain_version(cuda_device, B, F):
    """The contour-fix kernel bit for bit against its plain version: random
    steady runs with jumps, spikes and unvoiced gaps, and zigzag runs of
    jumps whose parity decides every frame; F = 20000 gives each thread a
    span of 79 frames."""
    from fscl_tpu_torch.ops import dio_contour as dc
    rng = np.random.default_rng(F)
    base = np.repeat(rng.uniform(80, 300, size=(B, F // 8 + 1)), 8, axis=1)[:, :F]
    cand = np.where(rng.random((B, F)) < 0.15, 0.0, base)
    cand = np.where(rng.random((B, F)) < 0.1, cand * 1.25, cand).astype(np.float32)
    zigzag = rng.choice(np.float32([100, 130, 101, 0]), size=(B, F), p=[0.45, 0.45, 0.05, 0.05])
    for x in (torch.from_numpy(cand).to(cuda_device), torch.from_numpy(zigzag).to(cuda_device)):
        before = dc.LAUNCHES
        got = dc.dio_contour(x)
        want = dc.dio_contour_reference(x)
        torch.cuda.synchronize()
        assert dc.LAUNCHES == before + 1
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="range"):
        dc.dio_contour_cuda(torch.zeros(0, 8, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("tracker", ["yin", "world"])
def test_batched_f0_card_matches_cpu(cuda_device, tracker):
    """Batched YIN and DIO on the card against the CPU at the F0 bars of
    chip_smoke.py phase 13 (voicing 99 %, relative median 1e-5, max 1e-3),
    padding frames 0."""
    from fscl_tpu_torch.dsp.pitch_device import yin_f0_batched
    from fscl_tpu_torch.dsp.world_device import world_f0_batched
    fn = yin_f0_batched if tracker == "yin" else world_f0_batched
    sr, T = 22050, 4 * 22050
    rng = np.random.default_rng(2)
    t = np.arange(T) / sr
    wavs = np.stack([0.4 * np.sin(2 * np.pi * f * t) + 0.1 * np.sin(4 * np.pi * f * t)
                     + 0.01 * rng.standard_normal(T) for f in (110, 180, 260, 0.0)])
    wavs = wavs.astype(np.float32)
    lens = np.array([T, T - 5000, T // 2, 0])
    got, want = (fn(torch.from_numpy(wavs).to(d), torch.from_numpy(lens).to(d)).cpu().numpy()
                 for d in (cuda_device, "cpu"))
    valid = np.arange(got.shape[1])[None, :] < (1 + lens // 256)[:, None]
    assert (got[~valid] == 0).all()
    agree = ((got > 0) == (want > 0))[valid].mean()
    both = (got > 0) & (want > 0)
    rel = np.abs(got[both] - want[both]) / want[both]
    assert agree >= 0.99 and np.median(rel) <= 1e-5 and rel.max() <= 1e-3, (agree, rel.max())


@pytest.mark.cuda
def test_cli_preprocess_runs_in_f32_on_the_card(cuda_device, tmp_path):
    """`preprocess` through the command line with `--device cuda` on a
    small raw corpus: every utterance ok, and afterwards TF32 is off for
    cuDNN and cuBLAS although it was on before: the port sets the flags
    itself."""
    from fscl_tpu_torch.cli import main
    from torch_corpus import write_raw_corpus
    corpus, tg = write_raw_corpus(str(tmp_path / "raw"), 4, 1, seconds=(1.5, 3.0))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    out = main(["preprocess", corpus, str(tmp_path / "store"), "--parse_raw", "--preprocess",
                "--textgrid_dir", tg, "--pitch_method", "world_device", "--n_workers", "1",
                "--device", "cuda"])
    assert out["n_ok"] == out["n_queries"] == 4
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


# -- the T2U family -------------------------------------------------------------

T2U_LOGIT_ATOL, T2U_INFER_MARGIN = 1e-4, 1e-4


def _tiny_cfg(d, heads):
    return C.ModelConfig(
        transformer=C.TransformerConfig(
            encoder_layer=1, decoder_layer=1, encoder_hidden=d, decoder_hidden=d,
            encoder_head=heads, decoder_head=heads, conv_filter_size=2 * d),
        max_seq_len=256)


def _small_t2u_cfg(n_units=40):
    from fscl_tpu_torch.models.tacotron2_t2u import T2UConfig
    return T2UConfig(n_units=n_units, d_unit=32, symbols_embedding_dim=32,
                     encoder_embedding_dim=64, prenet_dim=32, attention_rnn_dim=64,
                     decoder_rnn_dim=64, attention_dim=32)


@pytest.mark.cuda
def test_tacot2u_card_matches_cpu(cuda_device):
    """Teacher-forced logits in train mode (every dropout, on the same
    masks) within 1e-4, and `infer`'s unit ids equal up to the first step
    where the CPU's top-2 margin falls below 1e-4 (an argmax near-tie may
    go either way under another summation order)."""
    from fscl_tpu_torch.models.tacotron2_t2u import TacoT2U, draw_masks
    cfg = _small_t2u_cfg()
    torch.manual_seed(0)
    cpu = TacoT2U(cfg)
    card = TacoT2U(cfg).to(cuda_device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    B, L, T = 4, 24, 32
    lens = torch.tensor([24, 17, 9, 3])
    emb = torch.from_numpy(rng.normal(size=(B, L, 32)).astype(np.float32))
    emb[torch.arange(L)[None] >= lens[:, None]] = 0
    units = torch.from_numpy(rng.integers(1, 40, (B, T)))
    masks = draw_masks(cfg, B, L, T, True, torch.Generator().manual_seed(1), "cpu")
    on = lambda m: type(m)(*(None if x is None else x.to(cuda_device) for x in m))
    want, _ = cpu.train()(emb, lens, units, masks=masks)
    got, _ = card.train()(emb.to(cuda_device), lens.to(cuda_device), units.to(cuda_device),
                          masks=on(masks))
    np.testing.assert_allclose(got.detach().cpu().numpy(), want.detach().numpy(),
                               atol=T2U_LOGIT_ATOL, rtol=0)
    card.load_state_dict(cpu.state_dict())       # train mode moved the BatchNorm statistics
    masks = draw_masks(cfg, B, L, 10 * L, False, torch.Generator().manual_seed(2), "cpu")
    with torch.no_grad():
        wl, wp, _, _ = cpu.eval().infer(emb, lens, masks=masks)
        gl, gp, _, _ = card.eval().infer(emb.to(cuda_device), lens.to(cuda_device),
                                         masks=on(masks))
    top2 = wl.topk(2, dim=-1).values
    ties = ((top2[..., 0] - top2[..., 1]).min(dim=0).values < T2U_INFER_MARGIN).nonzero()
    upto = int(ties[0]) if len(ties) else wl.shape[1]
    assert upto > 8
    assert torch.equal(gp.cpu()[:, :upto], wp[:, :upto])


@pytest.mark.cuda
def test_gradient_reversal_on_card(cuda_device):
    """Identity forward; the gradient through it is -scale times the
    gradient without it, on the card as on the CPU."""
    from fscl_tpu_torch.systems.t2u import GradientReversal
    rng = np.random.default_rng(4)
    x, w = (torch.from_numpy(rng.normal(size=(3, 9, 40)).astype(np.float32)) for _ in range(2))
    grads = {}
    for dev in ("cpu", cuda_device):
        leaf = x.to(dev).requires_grad_()
        out = GradientReversal(0.7)(leaf)
        assert torch.equal(out.detach().cpu(), x)
        (g,) = torch.autograd.grad((out * w.to(dev)).sum(), leaf)
        grads[str(dev)] = g.cpu()
    torch.testing.assert_close(grads["cuda"], -0.7 * w, atol=0, rtol=0)
    torch.testing.assert_close(grads["cuda"], grads["cpu"], atol=0, rtol=0)


@pytest.mark.cuda
def test_transemb_c_t2u_episode_card_matches_cpu(cuda_device):
    """A tiny fscl-t2u-c episode (a 2-layer custom upstream of dim 128,
    Downstream2 at d_model 32: an encoder block through the kernel, then
    the codeformer) in eval mode on the card and on the CPU with the same
    weights and prenet masks: the table and the loss within 1e-4 relative
    (chip_smoke.py's FSCL-T2U bars); then one train step on the card with a
    finite loss."""
    from fscl_tpu_torch.data.batch import SupInfo
    from fscl_tpu_torch.models.tacotron2_t2u import draw_masks
    from fscl_tpu_torch.systems.t2u import T2UBatch, T2UEpisode, TransEmbCT2USystem
    cfg = C.ModelConfig(upstream=C.UpstreamConfig(name="custom", dim=128, n_layers=3),
                        codebook=C.CodebookConfig(size=8, num_heads=2, dim=32))
    t2u = _small_t2u_cfg()
    n_sym = 12
    torch.manual_seed(0)
    cpu = TransEmbCT2USystem(cfg, n_sym, t2u, device="cpu", optim_cfg=C.OptimConfig(lr=1e-4))
    card = TransEmbCT2USystem(cfg, n_sym, t2u, device=cuda_device,
                              optim_cfg=C.OptimConfig(lr=1e-4))
    card.load_state_dict(cpu.state_dict(), strict=True)
    rng = np.random.default_rng(5)
    S, T_wav = 3, 16000
    wav_lens = np.array([16000, 12000, 9000], np.int32)
    wavs = (0.3 * rng.normal(size=(S, T_wav))) * (np.arange(T_wav)[None] < wav_lens[:, None])
    avg_frames = rng.integers(1, 6, (S, 8)).astype(np.int32)
    sup = SupInfo(np.round(wavs * 32767).astype(np.int16), wav_lens, avg_frames,
                  rng.integers(1, n_sym, (S, 8)).astype(np.int32), n_sym)
    B, L, T = 3, 10, 16
    src_lens = np.array([10, 7, 3], np.int32)
    texts = rng.integers(1, n_sym, (B, L)).astype(np.int32) * (np.arange(L)[None] < src_lens[:, None])
    unit_lens = np.array([16, 11, 5], np.int32)
    units = rng.integers(1, 40, (B, T)).astype(np.int32) * (np.arange(T)[None] < unit_lens[:, None])
    ep = T2UEpisode(sup, T2UBatch(np.zeros(B, np.int32), texts, src_lens, units, unit_lens,
                                  np.zeros(B, np.int32)))
    masks = draw_masks(t2u, B, L, T, False, torch.Generator().manual_seed(2), "cpu")
    got = {}
    for name, s in (("card", card), ("cpu", cpu)):
        e = to_device(ep, s.device)
        m = type(masks)(*(None if x is None else x.to(s.device) for x in masks))
        before = tattn.LAUNCHES
        with torch.no_grad():
            hidden, _ = s.extract_ssl(e.sup.wavs, e.sup.wav_lens)
            table = s.build_embedding_table(hidden, e.sup)
            loss, _ = s.loss_and_metrics(e, masks=m)
        if name == "card":     # 2 upstream layers + Downstream2's encoder block, twice
            assert tattn.LAUNCHES - before == 2 * (s.upstream.n_layers + 1)
        got[name] = (table.cpu(), float(loss))
    (t_card, l_card), (t_cpu, l_cpu) = got["card"], got["cpu"]
    assert float((t_card - t_cpu).abs().max() / t_cpu.abs().max()) <= 1e-4
    assert abs(l_card - l_cpu) / abs(l_cpu) <= 1e-4
    state, metrics = card.train_step(card.init_state(), to_device(ep, cuda_device))
    assert state.step == 1 and np.isfinite(float(metrics["Total Loss"]))


@pytest.mark.cuda
def test_downstream1_through_the_kernel_matches_plain(cuda_device, monkeypatch):
    """Downstream1 at the FSCL-T2U width (d_model 256 in 2 heads of 128, the
    25 HuBERT layers) under autograd: the attention kernel through
    `AttentionFunction` against the same module on the plain version, on
    the card; output and every gradient within 1e-4."""
    from fscl_tpu_torch.nn import downstreams
    torch.manual_seed(0)
    m = downstreams.Downstream1(n_in_layers=25, d_in=1024).to(cuda_device).eval()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(4, 199, 25, 1024)).astype(np.float32)).to(cuda_device)
    valid = torch.arange(199, device=cuda_device)[None] < torch.tensor(
        [[199], [150], [77], [10]], device=cuda_device)

    def run():
        out = m(x, valid)
        loss = (out * out).mean()
        return out.detach(), torch.autograd.grad(loss, list(m.parameters()))

    before = tattn.LAUNCHES
    got_out, got_grads = run()
    assert tattn.LAUNCHES - before == 2
    monkeypatch.setattr(downstreams, "attend", lambda q, k, v, key_valid=None, temperature=None:
                        tattn.attention_reference(q, k, v, key_valid, temperature))
    want_out, want_grads = run()
    torch.testing.assert_close(got_out, want_out, atol=1e-4, rtol=0)
    for g, w in zip(got_grads, want_grads):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_e2e_gradient_through_frozen_u2s_card_matches_cpu(cuda_device):
    """One E2E loss and its gradient to the T2U through a frozen u2s trunk
    (d_model 128 in 2 heads: the kernel's head dim 64) on the card and on
    the CPU: loss 1e-5 relative, gradients 1e-4 absolute; none reaches the
    u2s, which stays in eval mode."""
    from fscl_tpu_torch.models.tacotron2_t2u import draw_masks
    from fscl_tpu_torch.systems.t2u import T2UBatch
    from fscl_tpu_torch.systems.t2u_tune import E2EBatch, E2ETuneSystem
    cfg = _tiny_cfg(128, 2)
    n_units = 40
    rng = np.random.default_rng(3)
    systems = {}
    for name, dev in (("cpu", "cpu"), ("card", cuda_device)):
        torch.manual_seed(0)
        u2s = BaselineSystem(cfg, (("u", n_units),), device=dev)
        systems[name] = E2ETuneSystem(cfg, (("xx", 30),), _small_t2u_cfg(n_units), u2s,
                                      device=dev, u2s_symbol_id="u")
    systems["card"].load_state_dict(systems["cpu"].state_dict())
    B, L, TU = 3, 16, 32
    texts = rng.integers(1, 30, (B, L)).astype(np.int32)
    units = rng.integers(9, n_units, (B, TU)).astype(np.int32)
    units[1, 20:] = 0
    t2u = T2UBatch(np.zeros(B, np.int32), texts, np.full(B, L, np.int32), units,
                   np.array([TU, 20, TU], np.int32), np.zeros(B, np.int32))
    samples = []
    for i in range(B):
        dur = rng.integers(1, 4, TU - 1)
        samples.append(dict(id=str(i), text="", phonemes=units[i, :-1], duration=dur, speaker=0,
                            lang_id=0, mel=rng.normal(size=(int(dur.sum()), 80)),
                            pitch=rng.normal(size=TU - 1), energy=rng.normal(size=TU - 1)))
    _, u2s_batch = collate_batch(samples, pitch_feature="phoneme_level",
                                 energy_feature="phoneme_level")
    batch = E2EBatch(t2u, u2s_batch)
    masks = None
    out = {}
    for name, system in systems.items():
        if masks is None:
            masks = draw_masks(system.t2u_cfg, B, L, TU, True, torch.Generator().manual_seed(4),
                               "cpu")
        on = type(masks)(*(None if x is None else x.to(system.device) for x in masks))
        system.train()
        assert not system.u2s_system.training
        loss, _ = system.loss_and_metrics(to_device(batch, system.device), masks=on)
        names = [n for n, p in system.named_parameters() if system.trainable_mask()[n]]
        params = dict(system.named_parameters())
        grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
        assert not any(n.startswith("u2s_system.") for n in names)
        out[name] = (float(loss.detach()), {n: None if g is None else g.cpu() for n, g in zip(names, grads)})
    np.testing.assert_allclose(out["card"][0], out["cpu"][0], rtol=1e-5)
    for n, w in out["cpu"][1].items():
        if w is not None:
            torch.testing.assert_close(out["card"][1][n], w, atol=1e-4, rtol=0, msg=n)


def _pr_cfg():
    """The PR systems at Downstream1's full head dim (256 in 2 heads of 128)
    over a custom upstream of dim 128 (2 heads of 64, 2 layers): both of
    the kernel's instances."""
    import dataclasses
    cfg = _tiny_cfg(256, 2)
    return dataclasses.replace(cfg, upstream=C.UpstreamConfig(name="custom", dim=128, n_layers=3),
                               codebook=C.CodebookConfig(size=16, num_heads=2, dim=256))


def _pr_batch(rng, wav_lens, n_sym):
    from fscl_tpu_torch.systems.pr import PRBatch
    B, W = len(wav_lens), 32000
    wavs = (0.3 * rng.normal(size=(B, W))).astype(np.float32)
    wavs[np.arange(W)[None] >= np.array(wav_lens)[:, None]] = 0
    avg = np.zeros((B, 12), np.int32)
    ph = rng.integers(1, n_sym, (B, 12)).astype(np.int32)
    for b, n in enumerate(wav_lens):
        avg[b] = 1 + rng.multinomial(n // 320 - 12, np.ones(12) / 12)
    return PRBatch(wavs, np.array(wav_lens, np.int32), avg, ph, np.zeros(B, np.int32), n_sym, "xx")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pr-ssl-protonet", "pr-trans-head", "pr-ssl-linear",
                                  "pr-ssl-baseline", "pr-ssl-cluster"])
def test_pr_system_card_matches_cpu(cuda_device, kind):
    """Each PR system's loss (dropout off) and every trainable gradient on
    the card against the same system on the CPU: loss 1e-5 relative,
    gradients 1e-4 relative to each tensor's largest magnitude; the episode
    launches the attention kernel where the system attends."""
    from fscl_tpu_torch.core.registry import SYSTEMS
    from fscl_tpu_torch.systems.pr import PREpisode
    rng = np.random.default_rng(5)
    n_sym = 30
    sup = _pr_batch(rng, [32000, 21000, 9000, 6400], n_sym)
    qry = _pr_batch(rng, [30000, 12000], n_sym)
    batch = PREpisode(sup, qry) if kind in ("pr-ssl-protonet", "pr-trans-head") else sup
    out = {}
    for name, dev in (("cpu", "cpu"), ("card", cuda_device)):
        torch.manual_seed(0)
        system = SYSTEMS.get(kind)(_pr_cfg(), (("xx", n_sym),), device=dev, upstream_seed=0)
        if name == "card":
            system.load_state_dict(cpu_sd)
        cpu_sd = system.state_dict()
        for m in system.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        mask = system.trainable_mask()
        names = [n for n, _ in system.named_parameters() if mask[n]]
        params = dict(system.named_parameters())
        before = tattn.LAUNCHES
        system.train()
        loss, _ = system.loss_and_metrics(to_device(batch, dev))
        grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
        system.eval()
        if name == "card":
            assert tattn.LAUNCHES > before
        out[name] = (float(loss.detach()), {n: None if g is None else g.cpu()
                                            for n, g in zip(names, grads)})
    np.testing.assert_allclose(out["card"][0], out["cpu"][0], rtol=1e-5)
    for n, w in out["cpu"][1].items():
        if w is not None:
            scale = max(float(w.abs().max()), 1e-3)
            assert float((out["card"][1][n] - w).abs().max()) <= 1e-4 * scale, n


@pytest.mark.cuda
def test_bilstm_downstream_card_matches_cpu_on_ragged_lengths(cuda_device):
    """cuDNN's LSTMs with the backward direction reversed within each row's
    length by a device gather: output within 1e-5 of the CPU's, padding
    zero and out of the valid frames."""
    from fscl_tpu_torch.nn.downstreams import BiLSTMDownstream
    torch.manual_seed(0)
    cpu = BiLSTMDownstream(4, 64, 32)
    card = BiLSTMDownstream(4, 64, 32).to(cuda_device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(3, 40, 4, 64)).astype(np.float32))
    valid = torch.arange(40)[None] < torch.tensor([[40], [23], [1]])
    want = cpu(x, valid)
    got = card(x.to(cuda_device), valid.to(cuda_device)).cpu()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert not got[~valid].any()


def _maml_system(device):
    """A second-order MAML system at d_model 128 (head dim 64 and 128 on
    the kernel's own instances) with GE2E d-vectors and a 2-layer custom
    upstream of dim 128, dropout off."""
    from fscl_tpu_torch.systems.maml import MAMLTransEmbSystem
    cfg = C.ModelConfig(
        transformer=C.TransformerConfig(
            encoder_layer=2, decoder_layer=2, encoder_hidden=128, decoder_hidden=128,
            encoder_head=2, decoder_head=2, conv_filter_size=256, encoder_dropout=0.0,
            decoder_dropout=0.0),
        variance_predictor=C.VariancePredictorConfig(dropout=0.0), max_seq_len=256,
        speaker=C.SpeakerConfig(emb_type="dvec", n_speakers=4, n_ref_slices=3),
        codebook=C.CodebookConfig(size=16, num_heads=2, dim=128),
        upstream=C.UpstreamConfig(name="custom", dim=128, n_layers=3))
    torch.manual_seed(0)
    system = MAMLTransEmbSystem(cfg, 40, device=device, adaptation_lr=1e-2, adaptation_steps=2)
    system.model.postnet.dropout.p = 0.0
    return system


@pytest.mark.cuda
def test_second_order_maml_episode_card_matches_cpu(cuda_device):
    """One second-order MAML episode (the attention Function differentiated
    twice, GE2E unrolled under `create_graph`): the loss 1e-5 relative and
    every gradient 1e-4 relative to its own largest entry, plus 1e-6
    absolute where it is 0 in exact arithmetic (an attention key's bias, a
    conv bias before a train-mode BatchNorm: rounding alone), card vs CPU;
    the PostNet's running statistics untouched on both."""
    from fscl_tpu_torch.data.batch import SupInfo
    from fscl_tpu_torch.systems.fscl import Episode
    rng = np.random.default_rng(41)
    batches = _tune_batches(41, 2)
    wav_lens = np.array([8000, 6100], np.int32)
    wavs = np.where(np.arange(8000)[None] < wav_lens[:, None],
                    0.3 * rng.normal(size=(2, 8000)), 0.0).astype(np.float32)
    sup = SupInfo(wavs, wav_lens, rng.integers(0, 4, (2, 8)).astype(np.int32),
                  rng.integers(1, 40, (2, 8)).astype(np.int32), 40)
    ep = Episode(sup=sup, qry=batches[0], sup_batch=batches[1])
    card, cpu = _maml_system(cuda_device), _maml_system("cpu")
    cpu.load_state_dict(card.state_dict(), strict=True)
    out = {}
    for system in (card, cpu):
        stats = {k: v.clone() for k, v in system.state_dict().items() if "running" in k}
        mask = system.trainable_mask()
        names = [n for n, _ in system.named_parameters() if mask[n]]
        params = dict(system.named_parameters())
        before = tattn.LAUNCHES
        system.train()
        loss, _ = system.loss_and_metrics(to_device(ep, system.device))
        grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
        system.eval()
        if system is card:
            assert tattn.LAUNCHES > before
        for k, v in system.state_dict().items():
            if "running" in k:
                assert torch.equal(v, stats[k]), k
        out[system.device.type] = (float(loss.detach()), {
            n: torch.zeros(params[n].shape) if g is None else g.cpu() for n, g in zip(names, grads)})
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for n, w in out["cpu"][1].items():
        assert torch.isfinite(out["cuda"][1][n]).all(), n
        zero = n.endswith("attn.w_ks.bias") or (
            ".postnet.convolutions." in n and n.endswith(".conv.bias"))
        err, scale = float((out["cuda"][1][n] - w).abs().max()), float(w.abs().max())
        assert err <= 1e-4 * scale + (1e-6 if zero else 0.0), (n, err, scale)


@pytest.mark.cuda
def test_lstm_unrolled_matches_cudnn_on_card(cuda_device):
    """GE2E's LSTM written out step by step against cuDNN's forward on the
    same weights, on the card (f32, TF32 off): within 1e-5."""
    from fscl_tpu_torch.nn.speaker_encoder import GE2EEncoder, lstm_unrolled
    torch.manual_seed(3)
    enc = GE2EEncoder().to(cuda_device)
    x = torch.randn(12, 160, 40, device=cuda_device)
    with torch.no_grad():
        want, _ = enc.lstm(x)
        got = lstm_unrolled(enc.lstm, x)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# -- bf16 compute, remat, return_weights (phase 17's paths) --------------------

BF16_GRAD_REL = 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("L", [77, 512])
def test_bf16_attention_function_grads_match_plain_autograd(cuda_device, L):
    """`attend` in bf16 under autograd (the kernel forward, the backward
    kernel in f32, each gradient rounded to bf16) against autograd through
    the plain version (which rounds its weights to bf16): the forward within
    the bf16 bars, each gradient within 1e-2 of its largest |entry|."""
    q, k, v, valid = _inputs(12, 4, 2, L, 128, torch.bfloat16, cuda_device)
    g = torch.from_numpy(np.random.default_rng(13).normal(size=q.shape).astype(np.float32))
    g = g.to(cuda_device, torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = tattn.LAUNCHES
    out = tattn.attend(*leaves, valid)
    got = torch.autograd.grad(out, leaves, g)
    assert tattn.LAUNCHES == before + 1 and out.dtype == torch.bfloat16
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(tattn.attention_reference(*ref_leaves, valid), ref_leaves, g)
    torch.testing.assert_close(out.float(), tattn.attention_reference(q, k, v, valid).float(),
                               atol=BF16_TOL, rtol=BF16_TOL)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16
        err = float((a.float() - b.float()).abs().max())
        assert err <= BF16_GRAD_REL * float(b.float().abs().max()), (name, err)
    assert float(got[1][2].float().abs().max()) == 0.0   # sample 2 has no valid key


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_on_card_matches_no_remat(cuda_device, dtype):
    """A 2 + 2 layer FastSpeech2 at d_model 128 (head dim 64) with dropout on:
    remat recomputes each block in the backward (the attention kernel
    launched again, through the Function) and gives the same loss and
    gradients (tests/test_remat.py's bars: loss 1e-6, gradients rtol 1e-5,
    atol 1e-6; cuDNN's convolution backward may add atomics' order)."""
    from fscl_tpu_torch.core.stats import DEFAULT_STATS
    from fscl_tpu_torch.models.fastspeech2 import FastSpeech2

    rng = np.random.default_rng(14)
    B, L, T = 3, 24, 80
    dur = torch.from_numpy(rng.integers(1, 4, (B, L))).to(cuda_device)
    emb = torch.from_numpy(rng.normal(size=(B, L, 128)).astype(np.float32)).to(cuda_device)
    src_lens = torch.tensor([24, 17, 9], device=cuda_device)
    mel_lens = dur.sum(1).clamp(max=T)
    target = torch.from_numpy(rng.normal(size=(B, T, 80)).astype(np.float32)).to(cuda_device)
    pitch, energy = (torch.from_numpy(rng.normal(size=(B, L)).astype(np.float32)).to(cuda_device)
                     for _ in range(2))
    results = []
    for remat in (False, True):
        cfg = C.ModelConfig(
            transformer=C.TransformerConfig(
                encoder_layer=2, decoder_layer=2, encoder_hidden=128, decoder_hidden=128,
                encoder_head=2, decoder_head=2, conv_filter_size=256),
            max_seq_len=256, remat=remat, compute_dtype=dtype)
        torch.manual_seed(0)
        model = FastSpeech2(cfg, DEFAULT_STATS).to(cuda_device).train()
        before = tattn.LAUNCHES
        torch.cuda.manual_seed(1)
        out = model(emb, src_lens, T, speaker_args=torch.zeros(B, dtype=torch.long,
                                                                device=cuda_device),
                    mel_lens=mel_lens, p_targets=pitch, e_targets=energy, d_targets=dur,
                    lang_args=torch.zeros(B, dtype=torch.long, device=cuda_device))
        loss = ((out.postnet_mel - target) ** 2).mean()
        fwd = tattn.LAUNCHES - before
        grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
        results.append((float(loss.detach()), grads, fwd, tattn.LAUNCHES - before - fwd))
    (l1, g1, f1, b1), (l2, g2, f2, b2) = results
    assert (f1, b1, f2, b2) == (4, 0, 4, 4)
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    for a, b in zip(g1, g2):
        if a is not None:
            torch.testing.assert_close(b.float(), a.float(), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_return_weights_on_card_come_from_the_plain_version(cuda_device, dtype):
    """`return_weights=True` on CUDA tensors: the output and weights of the
    plain version on the card (as fscl_tpu sends that case to
    `xla_attention`), no kernel launch; without it the kernel runs."""
    q, k, v, valid = _inputs(15, 4, 2, 96, 128, dtype, cuda_device)
    before = tattn.LAUNCHES
    with torch.no_grad():
        out, w = tattn.attend(q, k, v, valid, return_weights=True)
    assert tattn.LAUNCHES == before and w.device.type == "cuda" and w.dtype == dtype
    want, w_want = tattn.attention_reference(q, k, v, valid, return_weights=True)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(w, w_want, rtol=0, atol=0)
    with torch.no_grad():
        tattn.attend(q, k, v, valid)
    assert tattn.LAUNCHES == before + 1


# Lq query rows against Lk keys: the sequence-parallel upstream's shape
# (HuBERT-large at 4 s on 2 ranks: 100 local frames against 200 gathered),
# a ragged pair past both tile edges, fewer keys than queries, and keys
# shorter than one ring stage.
@pytest.mark.cuda
@pytest.mark.parametrize("key_split", [None, 1, 2, "stats"], ids=["auto", "ks1", "ks2", "stats"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Lq,Lk,Dh", [
    (4, 16, 100, 200, 64), (4, 16, 37, 199, 64), (3, 2, 64, 128, 128), (3, 2, 129, 65, 128),
    (3, 2, 200, 17, 64)])
def test_cuda_kernel_at_unequal_lengths_matches_plain_version(cuda_device, dtype, B, H, Lq,
                                                             Lk, Dh, key_split):
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.normal(size=(B, H, Lq, Dh)).astype(np.float32)).to(cuda_device, dtype)
    k, v = (torch.from_numpy(a).to(cuda_device, dtype)
            for a in rng.normal(size=(2, B, H, Lk, Dh)).astype(np.float32))
    lens = np.resize(np.array([max(1, Lk - Lk // 3), Lk, 0]), B)
    valid = torch.from_numpy(np.arange(Lk)[None, :] < lens[:, None]).to(cuda_device)
    before = tattn.LAUNCHES
    if key_split == "stats":
        stats = torch.full((B, H, Lq, 2), float("nan"), device=cuda_device)
        got = tattn.attention_cuda(q, k, v, valid, None, stats)
        assert torch.isfinite(stats).all()
    else:
        got = (tattn.attend(q, k, v, valid) if key_split is None
               else tattn._launch(q, k, v, valid, None, key_split))
    torch.cuda.synchronize()
    assert tattn.LAUNCHES == before + 1 and got.shape == q.shape
    want = tattn.attention_reference(q, k, v, valid)
    atol, rtol = (F32_ATOL, 0) if dtype == torch.float32 else (BF16_TOL, BF16_TOL)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_attention_function_at_unequal_lengths_grads_match_plain_autograd(cuda_device):
    rng = np.random.default_rng(12)
    q = torch.from_numpy(rng.normal(size=(2, 4, 100, 64)).astype(np.float32)).to(cuda_device)
    k, v = (torch.from_numpy(a).to(cuda_device)
            for a in rng.normal(size=(2, 2, 4, 200, 64)).astype(np.float32))
    valid = torch.arange(200, device=cuda_device)[None] < torch.tensor([[150], [200]],
                                                                       device=cuda_device)
    g = torch.randn_like(q)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    got = torch.autograd.grad(tattn.attend(qa, ka, va, valid), (qa, ka, va), g)
    qb, kb, vb = (t.clone().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(tattn.attention_reference(qb, kb, vb, valid), (qb, kb, vb), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0)


@pytest.mark.cuda
def test_two_ranks_on_the_card_over_gloo_match_one_process(cuda_device, tmp_path):
    """The data-parallel step on 2 ranks sharing the card (gloo, host-staged
    gathers) against the single process on the card."""
    import sys
    import os
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_parallel as tp
    from fscl_tpu_torch.parallel import multihost
    inp = tp.inputs()
    res = multihost.launch(_card_dp, 2, inp, device_type="cuda", workdir=str(tmp_path))
    system = tp.baseline(inp["sd"], device=cuda_device)
    state = system.init_state()
    losses = []
    for b in inp["batches"]:
        state, m = system.train_step(state, to_device(b, cuda_device))
        losses.append(float(m["Total Loss"]))
    for r in res:
        np.testing.assert_allclose(r["losses"][0], losses[0], rtol=TRAIN_FIRST_RTOL)
        np.testing.assert_allclose(r["losses"], losses, rtol=TRAIN_LATER_RTOL)
        assert r["backend"] == "gloo"


def _card_dp(rank, device, inp):
    import test_torch_parallel as tp
    from fscl_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from fscl_tpu_torch.train.trainer import make_parallel_train_step
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(2, 1, device)
    system = tp.baseline(inp["sd"], device=device)
    state = system.init_state()
    step = make_parallel_train_step(system, mesh)
    losses = []
    for b in inp["batches"]:
        state, m = step(state, to_device(shard_batch(b, mesh), device))
        losses.append(float(m["Total Loss"]))
    return {"losses": losses, "backend": torch.distributed.get_backend()}


# -- the backward kernel (csrc/attention_bwd.cu) ------------------------------

def _bwd_inputs(seed, B, H, Lq, Lk, Dh, dtype, device):
    """q, g (B, H, Lq, Dh), k, v (B, H, Lk, Dh); keys all valid, one, none,
    ragged (B cycles through them)."""
    rng = np.random.default_rng(seed)
    q, g = (torch.from_numpy(a).to(device, dtype)
            for a in rng.normal(size=(2, B, H, Lq, Dh)).astype(np.float32))
    k, v = (torch.from_numpy(a).to(device, dtype)
            for a in rng.normal(size=(2, B, H, Lk, Dh)).astype(np.float32))
    lens = np.resize(np.array([Lk, 1, 0, max(2, Lk - Lk // 3)]), B)
    valid = torch.from_numpy(np.arange(Lk)[None, :] < lens[:, None]).to(device)
    return q, k, v, valid, g


# (B, H, Lq, Lk, Dh): the train step's encoder and decoder (B = 16, L = 128
# and T = 512), an FSCL episode's query batch (B = 8), the tune adaptation
# (B = 4), the vmapped adaptation's 8 tasks folded (B = 32, L = 64, T = 256),
# the sequence-parallel Lq != Lk, a padded head dim, HuBERT-large's heads.
BWD_SHAPES = [(16, 2, 128, 128, 128), (16, 2, 512, 512, 128), (8, 2, 128, 128, 128),
              (8, 2, 512, 512, 128), (4, 2, 128, 128, 128), (4, 2, 512, 512, 128),
              (32, 2, 64, 64, 128), (32, 2, 256, 256, 128), (4, 2, 100, 200, 64),
              (4, 2, 77, 77, 40), (4, 16, 199, 199, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Lq,Lk,Dh", BWD_SHAPES)
def test_backward_kernel_matches_plain_version(cuda_device, dtype, B, H, Lq, Lk, Dh):
    """The kernel's (dq, dk, dv) from the forward's row stats against `attention_bwd`: f32 within GRAD_ATOL, bf16 within BF16_GRAD_REL
    of each gradient's largest |entry| (with one valid key, sample 1, dv sums
    g over every query row); the sample with no valid key gets dk exactly 0
    and the plain version's dv."""
    q, k, v, valid, g = _bwd_inputs(B * Lq + Dh, B, H, Lq, Lk, Dh, dtype, cuda_device)
    stats = torch.empty(B, H, Lq, 2, device=cuda_device)
    tattn.attention_cuda(q, k, v, valid, None, stats)
    before = tattn.BWD_LAUNCHES
    got = tattn.attention_bwd_cuda(q, k, v, valid, None, g, stats)
    torch.cuda.synchronize()
    assert tattn.BWD_LAUNCHES == before + 2
    want = tattn.attention_bwd(q, k, v, valid, None, g)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == b.shape and torch.isfinite(a.float()).all()
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0, msg=f"d{name}")
        else:
            err = float((a.float() - b.float()).abs().max())
            assert err <= BF16_GRAD_REL * float(b.float().abs().max()), (name, err)
    assert float(got[1][2].float().abs().max()) == 0.0
    bar = GRAD_ATOL if dtype == torch.float32 else BF16_GRAD_REL * float(want[2].float().abs().max())
    assert float((got[2][2].float() - want[2][2].float()).abs().max()) <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("L", [512, 2000])
def test_backward_kernel_with_one_valid_key_sums_dv_as_the_plain_version(cuda_device, L):
    """One valid key: every query row's weight is on it and dv there sums g
    over every query row (tens), where f32 sums in different orders differ
    past 1e-5. The kernel's weights are the forward's exactly (1 at that
    key) and it sums dv over the query rows in ascending order, as cuBLAS's
    f32 product does: dv is the plain version's bits, dk exactly 0 (D is
    that key's dP), dq within GRAD_ATOL. A sample with no valid key beside
    it: dk exactly 0, dv (g's mean) within GRAD_ATOL."""
    q, k, v, _, g = _bwd_inputs(31, 2, 2, L, L, 128, torch.float32, cuda_device)
    valid = torch.arange(L, device=cuda_device)[None] < torch.tensor([[1], [0]], device=cuda_device)
    stats = torch.empty(2, 2, L, 2, device=cuda_device)
    tattn.attention_cuda(q, k, v, valid, None, stats)
    got = tattn.attention_bwd_cuda(q, k, v, valid, None, g, stats)
    plain = tattn.attention_bwd(q, k, v, valid, None, g)
    assert float(plain[2][0].abs().max()) > 20
    assert torch.equal(got[2][0], plain[2][0])
    assert float(got[1].abs().max()) == 0.0
    torch.testing.assert_close(got[0], plain[0], atol=GRAD_ATOL, rtol=0)
    torch.testing.assert_close(got[2][1], plain[2][1], atol=GRAD_ATOL, rtol=0)


@pytest.mark.cuda
def test_function_takes_the_backward_kernel_twice_differentiable(cuda_device):
    """Through `attend` on the card at the train shape: a first-order
    backward launches the backward kernels once (two launches); a double
    backward (MAML's
    create_graph), grad of grad and vmap(grad) over 3 tasks (one kernel call
    for all) match the same through the plain version."""
    from torch.func import grad, vmap
    q, k, v, valid, w = _bwd_inputs(32, 4, 2, 128, 128, 128, torch.float32, cuda_device)
    before = tattn.BWD_LAUNCHES
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.autograd.grad(tattn.attend(*leaves, valid), leaves, w)
    assert tattn.BWD_LAUNCHES == before + 2

    us = _bwd_inputs(34, 4, 2, 128, 128, 128, torch.float32, cuda_device)[:3]

    def second(attn):          # the first gradient against u, differentiated again
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        first = torch.autograd.grad((attn(*leaves, valid) * w).sum(), leaves, create_graph=True)
        return torch.autograd.grad(sum((d * u).sum() for d, u in zip(first, us)), leaves)

    for a, b in zip(second(tattn.attend), second(tattn.attention_reference)):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0)

    def loss(attn):
        return lambda q_, k_, v_: (attn(q_, k_, v_, valid) * w).sum()

    tasks = [t.expand(3, *t.shape).contiguous() for t in (q, k, v)]
    before = tattn.BWD_LAUNCHES
    got = vmap(grad(loss(tattn.attend), argnums=(0, 1, 2)))(*tasks)
    assert tattn.BWD_LAUNCHES == before + 2      # the tasks folded into one call
    want = vmap(grad(loss(tattn.attention_reference), argnums=(0, 1, 2)))(*tasks)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0)


@pytest.mark.cuda
def test_backward_kernel_folded_tasks_same_bits_as_alone(cuda_device):
    """The backward kernels' tiles do not depend on B * H: 8 tasks of B = 4
    folded into one call give each task the bits of its own call, from the
    same row stats (the forward's key split, which does depend on B * H,
    may move the last bits of its row sums)."""
    q, k, v, valid, g = _bwd_inputs(33, 32, 2, 64, 64, 128, torch.float32, cuda_device)
    stats = torch.empty(32, 2, 64, 2, device=cuda_device)
    tattn.attention_cuda(q, k, v, valid, None, stats)

    def grads(*t):
        return tattn.attention_bwd_cuda(*t[:4], None, *t[4:])

    folded = grads(q, k, v, valid, g, stats)
    for n in range(8):
        rows = slice(4 * n, 4 * n + 4)
        alone = grads(*(t[rows].contiguous() for t in (q, k, v, valid, g, stats)))
        for a, b in zip(folded, alone):
            assert torch.equal(a[rows], b)


# Lq and Lk that cut the backward kernel's 64-row blocks and 32-row tiles
# raggedly, one query row against one key, and B * H past one wave of
# blocks (one a streaming multiprocessor) at L = 2000.
# In bf16 the one-row shape is held by test_backward_kernel_one_row_one_key:
# every gradient but dv is 0 there, so the bar relative to the plain
# gradient's max would be 0.
BWD_EDGE_SHAPES = [(8, 2, 1000, 1000, 128), (4, 2, 65, 130, 64), (2, 2, 1, 1, 128),
                   (4, 2, 2000, 2000, 128)]
BWD_EDGE_CASES = [(dtype, *shape) for shape in BWD_EDGE_SHAPES
                  for dtype in (torch.float32, torch.bfloat16)
                  if dtype == torch.float32 or shape[2:4] != (1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,H,Lq,Lk,Dh", BWD_EDGE_CASES)
def test_backward_kernel_matches_plain_version_at_ragged_and_long_shapes(
        cuda_device, dtype, B, H, Lq, Lk, Dh):
    """As test_backward_kernel_matches_plain_version, at the edges of the
    kernel's tiles and past one wave of blocks: f32 within GRAD_ATOL, bf16
    within BF16_GRAD_REL of each gradient's largest |entry|; where there is
    a sample with no valid key (B >= 3), its dk exactly 0 and the plain
    version's dv."""
    q, k, v, valid, g = _bwd_inputs(B * Lq + Lk + Dh, B, H, Lq, Lk, Dh, dtype, cuda_device)
    stats = torch.empty(B, H, Lq, 2, device=cuda_device)
    tattn.attention_cuda(q, k, v, valid, None, stats)
    before = tattn.BWD_LAUNCHES
    got = tattn.attention_bwd_cuda(q, k, v, valid, None, g, stats)
    torch.cuda.synchronize()
    assert tattn.BWD_LAUNCHES == before + 2
    want = tattn.attention_bwd(q, k, v, valid, None, g)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == b.shape and torch.isfinite(a.float()).all()
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0, msg=f"d{name}")
        else:
            err = float((a.float() - b.float()).abs().max())
            assert err <= BF16_GRAD_REL * float(b.float().abs().max()), (name, err)
    if B >= 3:
        assert float(got[1][2].float().abs().max()) == 0.0
        bar = (GRAD_ATOL if dtype == torch.float32
               else BF16_GRAD_REL * float(want[2].float().abs().max()))
        assert float((got[2][2].float() - want[2][2].float()).abs().max()) <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("n_valid", [2, 3, 8])
def test_backward_kernel_with_few_valid_keys_against_float64(cuda_device, n_valid):
    """A few valid keys per sample at L = 2000 (the first ones in sample 0,
    scattered in sample 1): every query row's weight sits on them, so their
    dk and dv sum tens over the rows. The kernel's dk and dv within
    GRAD_ATOL of each gradient's largest |entry| of float64 computed on the
    host; the plain version's distance is printed beside them."""
    B, H, L, Dh = 2, 2, 2000, 128
    q, k, v, _, g = _bwd_inputs(40 + n_valid, B, H, L, L, Dh, torch.float32, cuda_device)
    rng = np.random.default_rng(n_valid)
    valid = np.zeros((B, L), dtype=bool)
    valid[0, :n_valid] = True
    valid[1, rng.choice(L, n_valid, replace=False)] = True
    valid = torch.from_numpy(valid).to(cuda_device)
    stats = torch.empty(B, H, L, 2, device=cuda_device)
    tattn.attention_cuda(q, k, v, valid, None, stats)
    got = tattn.attention_bwd_cuda(q, k, v, valid, None, g, stats)
    plain = tattn.attention_bwd(q, k, v, valid, None, g)
    d = distance_from_float64(q, k, v, valid, g, got, plain)
    for name in ("dk", "dv"):
        print(f"{n_valid} valid keys {name}: kernel {d[name]:.3g}, plain "
              f"{d['plain_' + name]:.3g} of max {d['max_abs_' + name]:.3g}")
        assert d[name] <= GRAD_ATOL, (name, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_one_row_one_key(cuda_device, dtype):
    """One query row against one key (B = 2, H = 2, Dh = 128): the weight is
    exactly 1 (the kernel recomputes the forward's scores, in bf16 on the
    bf16 tensor cores as the forward does), so dk is exactly 0 and dv is g,
    the plain version's bits; dq = ((P * dP) K - D (P K)) / temp, a
    difference of two rounded products, within GRAD_ATOL of the plain
    version's 0."""
    q, k, v, valid, g = _bwd_inputs(77, 2, 2, 1, 1, 128, dtype, cuda_device)
    assert bool(valid.all())
    stats = torch.empty(2, 2, 1, 2, device=cuda_device)
    tattn.attention_cuda(q, k, v, valid, None, stats)
    got = tattn.attention_bwd_cuda(q, k, v, valid, None, g, stats)
    want = tattn.attention_bwd(q, k, v, valid, None, g)
    torch.cuda.synchronize()
    assert float(want[0].float().abs().max()) == 0.0 and float(want[1].float().abs().max()) == 0.0
    assert float(got[1].float().abs().max()) == 0.0
    assert torch.equal(got[2], want[2])
    assert float(got[0].float().abs().max()) <= GRAD_ATOL
