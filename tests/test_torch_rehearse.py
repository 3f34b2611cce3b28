"""`rehearse`, each flow, at `--preset tiny --device cpu` against fscl_tpu's
`cli/rehearse_cmd.py`.

fscl_tpu's flows are read from its source (`ast`), not run: each flow's
phase names (with the shared helpers'), the keys it writes into
rehearsal.json (with `_finish`'s) and its gates (name and numeric bar). The
port's flows run on synthetic corpora in a cache shared by the module, and
their rehearsal.json must hold exactly those phases, keys and gates. The
helpers that import no JAX at module level (`_gate`, `_finish`,
`_preset_cfg`, `_t2u_cfg`) are called in both packages: the same records,
exit codes and configurations. The fscl flow runs as
`python -m fscl_tpu_torch.cli` in a fresh interpreter, at the `serious`
step count (its gates enforced), and its exit code follows its gates.
"""
import ast
import json
import os
import subprocess
import sys
import types

import pytest
import torch

import fscl_tpu.cli.rehearse_cmd as jreh
import fscl_tpu.core.config as jax_config
import fscl_tpu_torch.cli.rehearse_cmd as preh
import fscl_tpu_torch.core.config as torch_config
from fscl_tpu_torch.cli.__main__ import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOWS = {"fscl": "run_fscl", "t2u": "run_t2u", "pr": "run_pr"}


def _calls(node, name):
    return [c for c in ast.walk(node) if isinstance(c, ast.Call)
            and getattr(c.func, "id", getattr(c.func, "attr", None)) == name]


def _const(x):
    return x.value if isinstance(x, ast.Constant) else None


def reference_flow(fn_name, path=jreh.__file__):
    """(phases, report keys, {gate name: bar}) of a flow of a rehearse_cmd.py
    (fscl_tpu's by default), with the shared helpers' phases and `_finish`'s
    keys; "vocode" and "wav_dir" come only with --write_wavs."""
    tree = ast.parse(open(path).read())
    fns = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    fn = fns[fn_name]
    phases = [_const(c.args[0]) for c in _calls(fn, "phases")]
    helpers = {c.func.id for c in ast.walk(fn) if isinstance(c, ast.Call)
               and isinstance(c.func, ast.Name)
               and c.func.id in ("_corpora", "_tasks", "_write_wavs")}
    for h in helpers:
        phases += [_const(c.args[0]) for c in _calls(fns[h], "phases")]
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript) \
                and getattr(node.targets[0].value, "id", None) == "report":
            keys.add(_const(node.targets[0].slice))
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "report":
            keys |= {_const(k) for k in node.value.keys}
    for node in ast.walk(fns["_finish"]):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript):
            keys.add(_const(node.targets[0].slice))
    gates = {}
    for c in _calls(fn, "_gate"):
        bar = next((_const(k.value) for k in c.keywords if k.arg == "bar"), None)
        gates[_const(c.args[1])] = bar
    keys.add("gates")
    return set(phases), keys, gates


THREADS = 2      # tier-1 runs six test processes on eight cores


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """torch on THREADS threads in this process (the t2u and pr flows run in
    it), as the other torch test files do."""
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("corpora"))


def _check_report(flow, exp_dir):
    with open(os.path.join(exp_dir, "rehearsal.json")) as f:
        report = json.load(f)
    phases, keys, gates = reference_flow(FLOWS[flow])
    assert set(report["phase_seconds"]) == phases - {"vocode"}
    assert set(report) == keys - {"wav_dir"}
    assert {n: g.get("bar") for n, g in report["gates"].items()} == gates
    assert report["flow"] == flow and report["preset"] == "tiny"
    return report


def test_fscl_flow_through_the_cli(tmp_path, cache):
    """40 episodes are cut to 3; --adapt_steps 100, the `serious` count, so
    the three gates are enforced and the exit code is 1 exactly when one of
    them fails."""
    exp = str(tmp_path / "fscl")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # the child's torch takes one thread per core unless told: beside five
    # other test processes its OpenMP threads oversubscribe the host (the
    # flow took 543 s of a tier-1 run, 30 s alone on 2 threads)
    env.update(OMP_NUM_THREADS=str(THREADS), MKL_NUM_THREADS=str(THREADS))
    proc = subprocess.run(
        [sys.executable, "-m", "fscl_tpu_torch.cli", "rehearse", "--flow", "fscl", "--preset",
         "tiny", "--device", "cpu", "--episodes", "3", "--adapt_steps", "100", "--exp_dir", exp,
         "--corpus_cache", cache],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode in (0, 1), proc.stdout[-2000:] + proc.stderr[-3000:]
    report = _check_report("fscl", exp)
    assert all(g["enforced"] for g in report["gates"].values())
    failed = [n for n, g in report["gates"].items() if not g["ok"]]
    assert proc.returncode == (1 if failed else 0), (failed, proc.stdout[-1500:])
    assert report["episodes"] == 3 and report["adapt_steps"] == 100
    for phase in report["phase_seconds"]:
        assert f"[rehearse] {phase} done in" in proc.stdout
    assert "launches: attention_fwd 0, mrf_stage 0, dio_contour 0" in proc.stdout


@pytest.mark.parametrize("flow", ["t2u", "pr"])
def test_t2u_and_pr_flows(tmp_path, cache, flow):
    """3 episodes, 3 u2s and 3 tune steps (the gates advisory), with
    --write_wavs on the t2u flow (its vocode phase and wav_dir)."""
    exp = str(tmp_path / flow)
    extra = ["--u2s_steps", "3", "--tune_steps", "3", "--write_wavs"] if flow == "t2u" else []
    rc = main(["rehearse", "--flow", flow, "--preset", "tiny", "--device", "cpu", "--episodes",
               "3", "--exp_dir", exp, "--corpus_cache", cache] + extra)
    assert rc == 0
    with open(os.path.join(exp, "rehearsal.json")) as f:
        report = json.load(f)
    phases, keys, gates = reference_flow(FLOWS[flow])
    if flow == "t2u":
        assert set(report["phase_seconds"]) == phases and set(report) == keys
        assert len(os.listdir(report["wav_dir"])) == 2     # the task's 2 queries
    else:
        _check_report(flow, exp)
    assert not any(g["enforced"] for g in report["gates"].values())


def test_gate_finish_and_configs_match_fscl_tpu(tmp_path):
    """`_gate` and `_finish` give the same records, summary and exit codes
    in both packages (1 when an enforced gate fails, 0 when only an
    advisory one does); `_preset_cfg` and `_t2u_cfg` the same configs."""
    args = types.SimpleNamespace(exp_dir=str(tmp_path), flow="fscl")
    for enforced, want_rc in ((True, 1), (False, 0)):
        reports = []
        for mod in (preh, jreh):
            report = {"flow": "fscl"}
            mod._gate(report, "adapt_loss_improves", False, "1 -> 2", enforced=enforced)
            mod._gate(report, "duration_fer_margin", True, "0.01", enforced=enforced,
                      bar="duration_fer < 0.06")
            phases = types.SimpleNamespace(times={"corpus": 1.5, "eval": 0.5},
                                           order=["corpus", "eval"])
            assert mod._finish(args, phases, report, ["line"]) == want_rc
            with open(tmp_path / "rehearsal.json") as f:
                reports.append(json.load(f))
        assert reports[0] == reports[1]
    for preset in ("tiny", "full"):
        assert torch_config.to_dict(preh._preset_cfg(preset)) == \
            jax_config.to_dict(jreh._preset_cfg(preset))
        assert preh._t2u_cfg(preset, 77)._asdict() == jreh._t2u_cfg(preset, 77)._asdict()
    full = preh._preset_cfg("full")
    assert full.upstream.compute_dtype == "bfloat16" and full.upstream.scan_layers


def test_port_flows_write_fscl_tpu_phases_keys_and_gates_in_source():
    """The port's flows name the same phases, keys and gates (with bars) as
    fscl_tpu's, read from the two sources alike."""
    for fn_name in FLOWS.values():
        assert reference_flow(fn_name, preh.__file__) == reference_flow(fn_name), fn_name
