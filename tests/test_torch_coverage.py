"""Every public name of fscl_tpu has a counterpart in the port.

Reads source with `ast` only (imports neither package): each public
top-level function and class of each `fscl_tpu/` module must be defined, or
assigned, at the top level of the port's module of the same path under
`fscl_tpu_torch/`, or stand in EXEMPT with its reason. Every module of
fscl_tpu must have its port module but those in MODULES_LEFT_OUT.
"""
import ast
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = REPO / "fscl_tpu", REPO / "fscl_tpu_torch"

# modules the port writes otherwise, by the North star (ROADMAP.md)
MODULES_LEFT_OUT = {
    "ops/conv_mxu.py": "the im2col conv suits XLA on the TPU; the port calls cuDNN's conv",
    "ops/hifigan_fused.py": "its stage kernel is ops/mrf_stage.py; its sample-packed ops suit "
                            "XLA on the TPU",
}

# (module, name) -> why the port has no name of its own for it
EXEMPT = {
    ("data/native_loader.py", "native_available"):
        "the port builds the C++ reader at first use or raises; no probe falls back in silence",
    ("dsp/pitch_device.py", "get_yin_device_fn"): "a cache of jitted functions",
    ("dsp/world_device.py", "get_world_device_fn"): "a cache of jitted functions",
    ("models/hifigan.py", "SubpixelUpsample"):
        "a TPU re-expression of ConvTranspose1d; the port runs ConvTranspose1d",
    ("models/hifigan.py", "convert_torch_checkpoint"):
        "torch keys to flax params; the port's load_torch_checkpoint keeps the torch keys",
    ("models/hubert.py", "convert_torch_checkpoint"):
        "torch keys to flax params; the port's load_torch_checkpoint keeps the torch keys",
    ("models/hubert.py", "storage_cast"):
        "a jitted cast of a param tree; the port casts the module once (FrozenUpstream)",
    ("models/hubert.py", "stack_layer_params"):
        "the scan layout; the port's layers run as a plain loop",
    ("models/hubert.py", "adapt_layer_layout"):
        "the scan layout; load_torch_checkpoint and convert.hubert_state_dict read both",
    ("models/melgan.py", "MelGANResnetBlock"): "the port keeps melgan-neurips's ResnetBlock",
    ("models/melgan.py", "convert_torch_checkpoint"):
        "torch keys to flax params; the port's load_torch_checkpoint keeps the torch keys",
    ("nn/speaker_encoder.py", "convert_resemblyzer_checkpoint"):
        "torch keys to flax params; the port's GE2EEncoder keeps resemblyzer's keys",
    ("ops/attention.py", "xla_attention"):
        "the XLA route; the port's plain version is ops/attention.py:attention_reference",
    ("ops/attention.py", "pallas_attention"):
        "the Pallas route; the port's kernel is csrc/attention.cu through attention_cuda",
    ("parallel/mesh.py", "batch_sharding"): "a jax NamedSharding; the port shards by rank",
    ("parallel/mesh.py", "replicated"): "a jax NamedSharding; the port broadcasts from rank 0",
    ("parallel/tensor_parallel.py", "state_shardings"):
        "jax NamedShardings of a TrainState; each rank holds its own shards",
    ("systems/base.py", "create_state"): "optax's state; the port's systems own their Adam",
    ("systems/base.py", "apply_grads"): "optax's update; the port's is train/optim.py:Adam",
    ("systems/base.py", "jit_init"): "jitted flax init; the port initialises on the device",
    ("systems/base.py", "jit_frozen_extract"):
        "a jitted frozen forward; the port's is models/hubert.py:frozen_upstream_features",
    ("train/optim.py", "make_optimizer"):
        "an optax chain; the port writes it by hand as train/optim.py:Adam",
}


def _public_defs(tree):
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def _top_level_names(tree):
    names = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, ast.Assign):
            names.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            names.add(n.target.id)
    return names


def _parse(path):
    return ast.parse(path.read_text(), filename=str(path))


def _modules():
    return sorted(p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py"))


def test_every_module_has_a_port_module():
    missing = [m for m in _modules()
               if m not in MODULES_LEFT_OUT and not (PORT_PKG / m).exists()]
    assert not missing, f"fscl_tpu modules with no port module: {missing}"
    assert all((JAX_PKG / m).exists() for m in MODULES_LEFT_OUT)


def test_every_public_name_has_a_counterpart():
    missing = []
    for m in _modules():
        if m in MODULES_LEFT_OUT:
            continue
        have = _top_level_names(_parse(PORT_PKG / m))
        missing += [f"{m}:{name}" for name in _public_defs(_parse(JAX_PKG / m))
                    if name not in have and (m, name) not in EXEMPT]
    assert not missing, f"public fscl_tpu names the port lacks: {missing}"


def test_exemptions_are_live_and_reasoned():
    """Each exemption names a public fscl_tpu name that the port does not
    define, with a one-line reason."""
    for (m, name), reason in EXEMPT.items():
        assert name in _public_defs(_parse(JAX_PKG / m)), (m, name)
        assert name not in _top_level_names(_parse(PORT_PKG / m)), (m, name)
        assert reason.strip() and "\n" not in reason, (m, name)
