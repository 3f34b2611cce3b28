"""The PR family's evaluation against fscl_tpu, on the CPU: the PER / FER
metrics on hand cases and random infos, `TaskGenerator`'s task files,
`run_protonet_eval` / `run_trans_head_eval` / `batched_pr_logits` (the
port's logits within 1e-5 of fscl_tpu's on the same weights, and, given
fscl_tpu's logits, the same task JSONs byte for byte: the same chunking,
prototypes and decoding), `evaluate` and `evaluate --pl_filter` (the same
printed lines), and the C++ CTC beam decoder.
"""
import json
import os

import numpy as np
import pytest
import torch

import fscl_tpu.eval.drivers as jdrivers
import fscl_tpu.eval.metrics as jmetrics
import fscl_tpu.eval.protonet_eval as jpe
import fscl_tpu_torch.core.config as torch_config
from fscl_tpu.cli.__main__ import main as jax_main
from fscl_tpu.data.feature_store import FeatureStore as JStore
from fscl_tpu.dsp.cpp_bindings import cpp_ctc_beam_decode as jax_ctc
from fscl_tpu.eval.task_generation import TaskGenerator as JTaskGenerator
from fscl_tpu_torch.cli.__main__ import main
from fscl_tpu_torch.data.datasets import PRDataset
from fscl_tpu_torch.data.feature_store import FeatureStore, write_queries_to_txt
from fscl_tpu_torch.dsp.cpp_bindings import cpp_ctc_beam_decode
from fscl_tpu_torch.eval import drivers, metrics
from fscl_tpu_torch.eval import protonet_eval as ppe
from fscl_tpu_torch.eval.task_generation import TaskGenerator

from test_torch_pr import _jax_upstream, build
from torch_corpus import write_corpus
from torch_parity import to_jax

LOGIT_RTOL = 1e-5
PHONES = ("AA", "B", "D", "IY")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _infos(seed, n=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 7))
        gt = [PHONES[int(i)] for i in rng.integers(0, 4, k)]
        pred = [PHONES[int(i)] for i in rng.integers(0, 4, int(rng.integers(1, 8)))]
        seg = lambda m: [[round(0.02 * a, 4), round(0.02 * b, 4)] for a, b in zip(
            np.concatenate([[0], np.cumsum(rng.integers(1, 6, m))[:-1]]),
            np.cumsum(rng.integers(1, 6, m)))]
        out.append({"gt": " ".join(gt), "pred": " ".join(pred), "gt_segment": seg(len(gt)),
                    "pred_segment": seg(len(pred))})
    return out


def test_metrics_match():
    assert metrics.levenshtein("kitten", "sitting") == 3
    assert metrics.wer("a b c", "a c") == pytest.approx(1 / 3)
    assert metrics.wer("", "") == 0.0 and metrics.wer("", "x") == 1.0
    assert metrics.frame_error_rate("a b", "a b", [[0, 0.04], [0.04, 0.1]],
                                    [[0, 0.04], [0.04, 0.1]]) == 0.0
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(9, 80)), rng.normal(size=(7, 80))
    assert metrics.mel_cepstral_distortion(a, b) == jmetrics.mel_cepstral_distortion(a, b)
    for seed in range(4):
        infos = _infos(seed)
        assert metrics.per_over_infos(infos) == jmetrics.per_over_infos(infos)
        assert metrics.fer_over_infos(infos) == jmetrics.fer_over_infos(infos)
        for tol in (0.02, 0.05):
            assert (metrics.segmentation_recall_over_infos(infos, tol)
                    == jmetrics.segmentation_recall_over_infos(infos, tol))
        for i in infos:
            assert (metrics.segment2duration(i["gt_segment"], 0.02)
                    == jmetrics.segment2duration(i["gt_segment"], 0.02))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 16 kHz corpus of 16 utterances whose phonemes come from 4 symbols
    (so that supports can cover queries), and two generated task trees:
    2- and 4-shot tasks of 3 queries each, by fscl_tpu (`a`) and the port
    (`b`) from the same seed."""
    root = tmp_path_factory.mktemp("eval")
    cfg = write_corpus(str(root), "en", "en", 0, seed=9, n_train=16, n_val=0,
                       frames=(20, 40), n_phones=(3, 6))
    store = FeatureStore(str(root / "en" / "features"))
    rng = np.random.default_rng(2)
    for q in store.load_metadata():
        n = len(store.phoneme.read_from_query(q).split())
        store.phoneme.save(" ".join(PHONES[int(i)] for i in rng.integers(0, 4, n)), q)
    store.flush()
    split = str(root / "en" / "splits" / "train.txt")
    write_queries_to_txt(store, store.load_metadata(), split)
    for side, gen in (("a", JTaskGenerator("en", JStore(store.root), 0, "en", seed=4)),
                      ("b", TaskGenerator("en", store, 0, "en", seed=4))):
        gen.generate(split, str(root / side), shots=(2, 4), n_qry=3, n_tasks=2)
    return {"root": root, "cfg": cfg, "store": store}


def test_task_generator_writes_fscl_tpu_tasks(corpus):
    files = []
    for dirpath, _, names in os.walk(corpus["root"] / "a"):
        files += [os.path.relpath(os.path.join(dirpath, n), corpus["root"] / "a") for n in names]
    assert len(files) == 12            # 2 shot counts x 2 tasks x (train, val, config)
    for rel in files:
        assert ((corpus["root"] / "a" / rel).read_bytes()
                == (corpus["root"] / "b" / rel).read_bytes()), rel


def _run_evals(kind, task_root, out_dir, monkeypatch):
    """Run fscl_tpu's and the port's eval of one system kind over
    `task_root`: the port's logits held to fscl_tpu's, then decoded from
    fscl_tpu's. Returns (fscl_tpu JSON paths, port JSON paths)."""
    jsys, v, psys, _, _ = build(kind, seed=6)
    params = to_jax(v["params"])
    jsys.upstream_params = to_jax(_jax_upstream())
    seen = []

    def jax_tap(predict, samples, *args, **kw):
        seen.append([np.asarray(predict(s)) for s in samples])
        return jdrivers.evaluate_pr_task(predict, samples, *args, **kw)

    def port_tap(predict, samples, *args, **kw):
        want = seen.pop(0)
        for s, w in zip(samples, want):
            got = predict(s)
            assert got.shape == w.shape
            assert np.abs(got - w).max() <= LOGIT_RTOL * np.abs(w).max()
        it = iter(want)
        by_id = {id(s): next(it) for s in samples}
        return drivers.evaluate_pr_task(lambda s: by_id[id(s)], samples, *args, **kw)

    monkeypatch.setattr(jpe, "evaluate_pr_task", jax_tap)
    monkeypatch.setattr(ppe, "evaluate_pr_task", port_tap)
    run_j = jpe.run_protonet_eval if kind == "pr-ssl-protonet" else jpe.run_trans_head_eval
    run_p = ppe.run_protonet_eval if kind == "pr-ssl-protonet" else ppe.run_trans_head_eval
    want = run_j(jsys, params, task_root, str(out_dir / "a"), batch_size=2)
    got = run_p(psys, task_root, str(out_dir / "b"), batch_size=2)
    assert not seen
    return want, got


@pytest.mark.parametrize("kind", ["pr-ssl-protonet", "pr-trans-head"])
def test_eval_writes_fscl_tpu_task_jsons(corpus, tmp_path, monkeypatch, kind):
    """Zero-shot transcription of the 4-shot tasks (support chunks of 2, the
    last query chunk padded by repetition)."""
    want, got = _run_evals(kind, str(corpus["root"] / "a" / "4-shot"), tmp_path, monkeypatch)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == [
        "task-0.json", "task-1.json"]
    for g, w in zip(got, want):
        assert open(g, "rb").read() == open(w, "rb").read()


def test_batched_pr_logits_match(corpus):
    """The linear / baseline heads' chunked logits."""
    jsys, v, psys, _, _ = build("pr-ssl-baseline", seed=6)
    jsys.upstream_params = to_jax(_jax_upstream())
    sid = psys.id2symbols[0][0]
    ds = PRDataset(str(corpus["root"] / "en" / "splits" / "train.txt"), corpus["store"],
                   torch_config.read_data_config(corpus["cfg"]))
    samples = [ds[i] for i in range(5)]
    got = ppe.batched_pr_logits(psys, samples, sid, psys.id2symbols[0][1], batch_size=2)
    want = jpe.batched_pr_logits(jsys, to_jax(v["params"]), samples, sid, psys.id2symbols[0][1],
                                 batch_size=2)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.abs(g - w).max() <= LOGIT_RTOL * np.abs(w).max()


def test_evaluate_prints_what_fscl_tpu_prints(tmp_path, capsys):
    out = tmp_path / "tasks"
    for t in range(3):
        jdrivers.dump_task_results(_infos(10 + t), str(out), f"task-{t}")
    printed = []
    for run, metric in ((jax_main, "both"), (main, "both"), (jax_main, "per"), (main, "per")):
        result = run(["evaluate", str(out), "--metric", metric])
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and printed[2] == printed[3] and "PER" in printed[1]
    assert "FER" in printed[1] and "FER" not in printed[3]
    assert len(result["per"]) == 3 and not result["fer"]


def test_evaluate_pl_filter_prints_what_fscl_tpu_prints(corpus, tmp_path, capsys):
    """The confidence sweep over lp matrices with a unify map that leaves
    one phoneme out (its utterances skipped, as the reference's strict map)."""
    store = corpus["store"]
    unit = store.get_ssl_unit_store("u4")
    rng = np.random.default_rng(3)
    for q in store.load_metadata():
        seg = store.mfa_segment.read_from_query(q)
        n = len(metrics.expand(store.phoneme.read_from_query(q).split(),
                               metrics.segment2duration(seg, 0.02)))
        unit.lp_matrix.save(rng.uniform(size=(n - int(rng.integers(0, 2)), 4))
                            .astype(np.float32), q)
    maps = tmp_path / "unify.json"
    maps.write_text(json.dumps({"ref2unify": {"AA": "x0", "B": "x1", "D": "x2"},
                                "pred2unify": {str(i): f"x{i}" for i in range(4)}}))
    printed = []
    for run in (jax_main, main):
        run(["evaluate", store.root, "--pl_filter", "--unit_name", "u4", "--unify_map",
             str(maps), "--thresholds", "0.1,0.5,0.9"])
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and "skipped: " in printed[1] and "Threshold 0.9" in printed[1]
    assert (drivers.evaluate_pl_filter(store, "u4", thresholds=(0.5,))
            == jdrivers.evaluate_pl_filter(JStore(store.root), "u4", thresholds=(0.5,)))


def test_ctc_beam_decode_matches():
    rng = np.random.default_rng(4)
    for T, C, beam in ((12, 5, 4), (30, 9, 16), (1, 3, 2)):
        x = rng.normal(size=(T, C)).astype(np.float32) * 3
        lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
        assert cpp_ctc_beam_decode(lp, 0, beam) == jax_ctc(lp, 0, beam)
