"""The port stands alone: no JAX, flax, optax or fscl_tpu behind it, and
its entry points ask for CUDA unless told otherwise."""
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "fscl_tpu")
IMPORT_RE = re.compile(
    r"^\s*(?:import\s+(?:jax|flax|optax)\b|from\s+(?:jax|flax|optax)\b"
    r"|import\s+fscl_tpu(?!_torch)\b|from\s+fscl_tpu(?!_torch)\b)", re.M)


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "fscl_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith((".py", ".cu"))]
    return sorted(paths)


def test_importing_every_submodule_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import fscl_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(fscl_tpu_torch.__path__, 'fscl_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 15 else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


CLI_AND_DATA_MODULES = (
    "fscl_tpu_torch.cli", "fscl_tpu_torch.cli.__main__", "fscl_tpu_torch.cli.train_cmd",
    "fscl_tpu_torch.cli.tune_cmd", "fscl_tpu_torch.cli.synth_cmd",
    "fscl_tpu_torch.core.checkpoint", "fscl_tpu_torch.core.registry",
    "fscl_tpu_torch.data.datamodules", "fscl_tpu_torch.data.datasets",
    "fscl_tpu_torch.data.episodic", "fscl_tpu_torch.data.feature_store",
    "fscl_tpu_torch.data.samplers", "fscl_tpu_torch.dsp.audio_io", "fscl_tpu_torch.obs.loggers",
    "fscl_tpu_torch.cli.preprocess_cmd", "fscl_tpu_torch.data.parsers",
    "fscl_tpu_torch.data.scripts", "fscl_tpu_torch.dsp.preprocess", "fscl_tpu_torch.dsp.pitch",
    "fscl_tpu_torch.dsp.pitch_device", "fscl_tpu_torch.dsp.world_device",
    "fscl_tpu_torch.dsp.cpp_bindings", "fscl_tpu_torch.dsp.textgrid",
    "fscl_tpu_torch.frontend.kog2p", "fscl_tpu_torch.ops.dio_contour", "fscl_tpu_torch.ops.stft",
    "fscl_tpu_torch.cli.pack_cmd", "fscl_tpu_torch.cli.clean_cmd",
    "fscl_tpu_torch.cli.evaluate_cmd", "fscl_tpu_torch.data.shards",
    "fscl_tpu_torch.data.native_loader", "fscl_tpu_torch.eval.metrics",
    "fscl_tpu_torch.eval.drivers", "fscl_tpu_torch.eval.task_generation",
    "fscl_tpu_torch.eval.protonet_eval", "fscl_tpu_torch.systems.pr",
    "fscl_tpu_torch.nn.asr_center", "fscl_tpu_torch.nn.phoneme_embedding",
    "fscl_tpu_torch.cli.rehearse_cmd", "fscl_tpu_torch.systems.maml",
    "fscl_tpu_torch.systems.ada", "fscl_tpu_torch.systems.conti_ae")


def test_cli_and_data_modules_load_no_jax():
    """The command line runs as `python -m fscl_tpu_torch.cli` in a fresh
    interpreter (its help, then a call without a card that asks for one)
    and loads no JAX; the config, data, checkpoint, logger and
    preprocessing modules with it."""
    code = (
        "import importlib, subprocess, sys\n"
        f"mods = {CLI_AND_DATA_MODULES!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "from fscl_tpu_torch.cli import main\n"
        "import torch\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        main(['train', '--data_config', 'missing.yaml'])\n"
        "        sys.exit('no error')\n"
        "    except RuntimeError as e:\n"
        "        assert 'cuda' in str(e), e\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for cmd in ("synth", "preprocess"):
        proc = subprocess.run([sys.executable, "-m", "fscl_tpu_torch.cli", cmd, "--help"],
                              cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0 and "--device" in proc.stdout, proc.stderr
    # the host-only subcommands take fscl_tpu's flags and no device
    for cmd, flag in (("evaluate", "--pl_filter"), ("pack", "--fscl"), ("clean", "--output")):
        proc = subprocess.run([sys.executable, "-m", "fscl_tpu_torch.cli", cmd, "--help"],
                              cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0 and flag in proc.stdout, proc.stderr
        assert "--device" not in proc.stdout


PRECISION_AND_OBS_MODULES = (
    "fscl_tpu_torch.core.prng", "fscl_tpu_torch.utils", "fscl_tpu_torch.utils.tool",
    "fscl_tpu_torch.train.precision", "fscl_tpu_torch.obs", "fscl_tpu_torch.obs.figures",
    "fscl_tpu_torch.obs.tracking", "fscl_tpu_torch.obs.synth_saver",
    "fscl_tpu_torch.obs.codebook_analysis", "fscl_tpu_torch.obs.fscl_saver",
    "fscl_tpu_torch.obs.t2u_saver", "fscl_tpu_torch.models.tacotron2")


def test_precision_obs_and_tacotron2_modules_load_no_jax_nor_matplotlib():
    """The seeding, precision, observability and mel Tacotron2 modules load
    no JAX, and no matplotlib either: a figure imports it when it is drawn,
    so the savers' device work runs where it is not installed."""
    code = (
        "import importlib, sys\n"
        f"for m in {PRECISION_AND_OBS_MODULES!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r} + ('matplotlib',))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


PARALLEL_RANK_MODULES = (
    "fscl_tpu_torch.parallel", "fscl_tpu_torch.parallel.mesh",
    "fscl_tpu_torch.parallel.multihost", "fscl_tpu_torch.parallel.pipeline",
    "fscl_tpu_torch.parallel.sequence_parallel", "fscl_tpu_torch.parallel.serving",
    "fscl_tpu_torch.parallel.tensor_parallel", "fscl_tpu_torch.cli.train_cmd",
    "fscl_tpu_torch.systems.tune", "test_torch_parallel")


def test_parallel_layer_and_every_rank_module_load_no_jax():
    """`import fscl_tpu_torch.parallel` and every module a spawned rank
    imports (the parallel layer, the train command whose `_rank_run` a
    rank runs, the tests' rank suites) load no JAX, flax, optax or
    fscl_tpu: a rank on the card has none of them."""
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r})\n"
        f"for m in {PARALLEL_RANK_MODULES!r}: importlib.import_module(m)\n"
        "import fscl_tpu_torch.parallel as p\n"
        "assert (p.DATA_AXIS, p.MODEL_AXIS) == ('data', 'model') and callable(p.make_mesh)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_attend_off_the_cpu_launches_the_kernel_unless_weights_are_asked_for():
    """No fallback: a tensor off the CPU (here on the meta device) goes to
    the kernel's wrapper, which takes CUDA tensors only and raises; with
    `return_weights=True` the weights come from the plain version on the
    tensors' own device, as fscl_tpu sends that case to `xla_attention`."""
    import torch
    from fscl_tpu_torch.ops import attention as tattn
    q, k, v = (torch.empty(2, 2, 8, 64, device="meta") for _ in range(3))
    valid = torch.ones(2, 8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        tattn.attend(q, k, v, valid)
    with torch.no_grad(), pytest.raises(ValueError, match="takes CUDA tensors"):
        tattn.attend(q, k, v, valid)
    out, w = tattn.attend(q, k, v, valid, return_weights=True)
    assert out.device.type == w.device.type == "meta"
    assert tuple(w.shape) == (2, 2, 8, 8) and w.dtype == v.dtype


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax(path):
    with open(path, encoding="utf-8") as f:
        src = f.read()
    assert not IMPORT_RE.search(src), f"{path} imports JAX or fscl_tpu"


def test_baseline_system_asks_for_cuda_by_default():
    import torch
    from fscl_tpu_torch.systems.baseline import BaselineSystem
    if torch.cuda.is_available():
        assert BaselineSystem().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            BaselineSystem()


def test_serve_asks_for_cuda_by_default():
    import torch
    from fscl_tpu_torch.serve import serve
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve(["hello"], {})


def _no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")


def test_vocoder_asks_for_cuda_by_default():
    _no_card()
    from fscl_tpu_torch.audio_out.vocoder import Vocoder, build_generator
    with pytest.raises(RuntimeError, match="cuda"):
        Vocoder(build_generator("MelGAN"))


def test_serve_wav_asks_for_cuda_by_default():
    _no_card()
    from fscl_tpu_torch.serve import serve_wav
    with pytest.raises(RuntimeError, match="cuda"):
        serve_wav(["hello"], {}, {})


@pytest.mark.parametrize("entry", ["make_text2wav", "chunked_vocode", "make_streaming_text2wav"])
def test_audio_entry_points_ask_for_cuda_by_default(entry):
    _no_card()
    from fscl_tpu_torch.audio_out import pipeline, streaming
    from fscl_tpu_torch.models.hifigan import HiFiGANGenerator
    gen = HiFiGANGenerator(upsample_initial_channel=32)
    call = {
        "make_text2wav": lambda: pipeline.make_text2wav(object(), gen, 16),
        "chunked_vocode": lambda: next(streaming.chunked_vocode(gen, [[[0.0] * 80]])),
        "make_streaming_text2wav": lambda: streaming.make_streaming_text2wav(object(), gen, 16),
    }[entry]
    with pytest.raises(RuntimeError, match="cuda"):
        call()


def test_a_cuda_device_comes_with_tf32_off(monkeypatch):
    """`resolve_device` turns TF32 off for cuDNN and cuBLAS when it hands out
    a CUDA device (the port's float32 precision, fscl_tpu's on the CPU), and
    leaves the flags alone for the CPU."""
    import torch
    from fscl_tpu_torch.core.device import resolve_device
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device("cuda").type == "cuda"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("key", ["pr-ssl-linear", "pr-ssl-baseline", "pr-ssl-cluster",
                                 "pr-trans-head", "pr-ssl-protonet"])
def test_pr_systems_ask_for_cuda_by_default(key):
    _no_card()
    from fscl_tpu_torch.core.config import ModelConfig
    from fscl_tpu_torch.core.registry import SYSTEMS
    import fscl_tpu_torch.systems  # noqa: F401 (registers the systems)
    with pytest.raises(RuntimeError, match="cuda"):
        SYSTEMS.get(key)(ModelConfig(), (("en", 152),))
