"""The mel Tacotron2 of the port against fscl_tpu's `models/tacotron2.py`,
on the CPU in float32.

fscl_tpu's weights (its own init, BatchNorm statistics made non-trivial) go
to the port through `convert.tacotron2_state_dict`, and back through
`tacotron2_variables`. The prenet's dropout is on in both packages even at
inference, so the port takes the masks fscl_tpu draws, rebuilt from its key
schedule (`torch_parity.t2u_scan_masks`: each step folds t into the key and
splits it in two, as the mel decoder's steps do in both the teacher-forced
scan and `infer`). Eval mode (the deterministic forward): the encoder's and
PostNet's dropouts are off and the BatchNorms read their statistics.

Bars: mel, postnet_mel, gate logits and alignments 1e-5 absolute at
unit-scale outputs over 4-6 LSTM steps (f32 products in another order);
`infer`'s frame counts exactly, its mels 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fscl_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from fscl_tpu.models.tacotron2 import Tacotron2Config as JaxConfig
from fscl_tpu_torch.convert import tacotron2_state_dict, tacotron2_variables
from fscl_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from torch_parity import t2u_scan_masks

ATOL = 1e-5
SMALL = dict(n_mels=8, n_frames_per_step=2, symbols_embedding_dim=16,
             encoder_embedding_dim=32, prenet_dim=16, attention_rnn_dim=32,
             decoder_rnn_dim=32, attention_dim=16, attention_location_n_filters=4,
             attention_location_kernel_size=7)
B, L, T = 3, 7, 12


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    jcfg, tcfg = JaxConfig(**SMALL), Tacotron2Config(**SMALL)
    jmodel = JaxTacotron2(jcfg)
    key = jax.random.PRNGKey(0)
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        key, jnp.zeros((B, L, 16)), jnp.full((B,), L), jnp.zeros((B, T, 8)), key))
    for bn in list(variables["batch_stats"]["postnet"].values()) + \
            list(variables["batch_stats"]["encoder"].values()):
        bn["mean"] = rng.normal(0.0, 0.2, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    port = Tacotron2(tcfg)
    port.load_state_dict(tacotron2_state_dict(variables), strict=True)
    port.eval()
    return jmodel, variables, port, tcfg


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(B, L, 16)).astype(np.float32)
    lens = np.array([7, 5, 2], np.int32)
    mels = rng.normal(size=(B, T, 8)).astype(np.float32)
    return emb, lens, mels


def test_converter_round_trip(models):
    _, variables, port, _ = models
    back = tacotron2_variables(port.state_dict())
    flat_a = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=str(k))


def test_teacher_forced_forward_matches(models):
    jmodel, variables, port, cfg = models
    emb, lens, mels = _inputs()
    key = jax.random.PRNGKey(3)
    want = jmodel.apply(variables, jnp.asarray(emb), jnp.asarray(lens), jnp.asarray(mels), key)
    masks = t2u_scan_masks(cfg.as_t2u(), key, B, T // cfg.n_frames_per_step, train=False,
                           infer=True)
    with torch.no_grad():
        got = port(torch.from_numpy(emb), torch.from_numpy(lens), torch.from_numpy(mels), masks)
    for name, g, w in zip(("mel", "postnet_mel", "gates", "alignments"), got, want):
        assert tuple(g.shape) == np.shape(w), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0, err_msg=name)
    np.testing.assert_allclose(got.alignments.sum(-1).numpy(), 1.0, atol=1e-5)


def test_infer_matches(models):
    jmodel, variables, port, cfg = models
    emb, lens, _ = _inputs(2)
    key, steps = jax.random.PRNGKey(4), 6
    want = jmodel.apply(variables, jnp.asarray(emb), jnp.asarray(lens), key, steps,
                        method=JaxTacotron2.infer)
    masks = t2u_scan_masks(cfg.as_t2u(), key, B, steps, train=False, infer=True)
    got = port.infer(torch.from_numpy(emb), torch.from_numpy(lens), steps, masks=masks)
    np.testing.assert_array_equal(got.n_frames.numpy(), np.asarray(want[2]))
    for name, g, w in zip(("mel", "postnet_mel", "alignments"),
                          (got.mel, got.postnet_mel, got.alignments),
                          (want[0], want[1], want[3])):
        assert tuple(g.shape) == np.shape(w), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0, err_msg=name)
    assert got.mel.shape == (B, steps * cfg.n_frames_per_step, cfg.n_mels)


def test_infer_draws_its_masks_from_a_generator(models):
    """Without masks, `infer` and the forward draw them up front from the
    generator given: the same generator state gives the same output; train
    mode draws the encoder and both RNN dropouts too."""
    _, _, port, cfg = models
    emb, lens, mels = (torch.from_numpy(x) for x in _inputs(3))
    outs = [port.infer(emb, lens, 5, generator=torch.Generator().manual_seed(9))
            for _ in range(2)]
    torch.testing.assert_close(outs[0].mel, outs[1].mel, rtol=0, atol=0)
    masks = port.draw_masks(B, L, T // 2, True, torch.Generator().manual_seed(1), "cpu")
    assert masks.encoder.shape == (cfg.encoder_n_convolutions, B, L, cfg.encoder_embedding_dim)
    assert masks.attention.shape == (T // 2, B, cfg.attention_rnn_dim)
    port.train()
    try:
        out = port(emb, lens, mels, masks)
    finally:
        port.eval()
    assert torch.isfinite(out.postnet_mel).all() and out.gates.shape == (B, T // 2)
