"""The port's corpus walkers, `parse_corpus` and corpus scripts
(`data/parsers.py`, `data/scripts.py`) against fscl_tpu's, on the CPU.

Every walker runs on the fixture layouts of tests/test_parsers.py: each of
that file's tests is run with fscl_tpu's registry lookup wrapped so that the
port's walker of the same name walks the same tree with the same arguments,
and the two item lists must be equal. `parse_corpus` (the port's pool of 2
spawned workers against fscl_tpu's in process) writes the same metadata,
speakers, text and wavs. `make_synthetic_corpus` (the port's stage 2 on the
CPU) gives fscl_tpu's store: every array feature within atol 1e-4 (the
STFT's bar; pitch from the same host C++, exactly), the rest exactly, its
cache restores the same tree; `prepare_mfa_corpus`, `jsut_hts_to_textgrid`,
`merge_global_stats`, `prepare_hifigan_tune_data`, `mfa_align_command` and
`build_korean_lexicon` give fscl_tpu's outputs exactly.
"""
import json
import os

import numpy as np
import pytest

import fscl_tpu.data.parsers  # noqa: F401 (fills fscl_tpu's registry)
import fscl_tpu_torch.data.parsers  # noqa: F401 (fills the port's)
from fscl_tpu.core import registry as jreg
from fscl_tpu.data import scripts as jscripts
from fscl_tpu.data.feature_store import FeatureStore as JStore
from fscl_tpu_torch.core import registry as preg
from fscl_tpu_torch.data import scripts as pscripts
from fscl_tpu_torch.data.feature_store import FeatureStore

import test_parsers
from torch_corpus import write_raw_corpus

LAYOUTS = sorted(n for n in dir(test_parsers)
                 if n.startswith("test_") and n != "test_registry_has_all_13")
STORE_ATOL = 1e-4


def test_registry_has_fscl_tpus_walkers():
    assert sorted(preg.RAW_PARSERS.keys()) == sorted(jreg.RAW_PARSERS.keys())
    assert len(list(preg.RAW_PARSERS)) == 12


@pytest.mark.parametrize("layout", LAYOUTS)
def test_walker_matches_fscl_tpu_on_its_fixture_layout(layout, tmp_path, monkeypatch):
    walked = []
    lookup = jreg.RAW_PARSERS.get

    def get(name):
        jwalk, pwalk = lookup(name), preg.RAW_PARSERS.get(name)

        def walk(*args, **kwargs):
            items = list(jwalk(*args, **kwargs))
            assert list(pwalk(*args, **kwargs)) == items
            walked.append((name, len(items)))
            return iter(items)
        return walk

    monkeypatch.setattr(jreg.RAW_PARSERS, "get", get)
    getattr(test_parsers, layout)(tmp_path)
    assert walked and all(n > 0 for _, n in walked)


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_parse_corpus_matches_fscl_tpu(tmp_path):
    corpus, _ = write_raw_corpus(str(tmp_path / "raw"), 4, 5, seconds=(0.5, 1.0))
    jq = fscl_tpu.data.parsers.parse_corpus("LJSpeech", corpus, JStore(str(tmp_path / "j")),
                                            n_workers=1)
    pq = fscl_tpu_torch.data.parsers.parse_corpus(
        "LJSpeech", corpus, FeatureStore(str(tmp_path / "p")), n_workers=2)
    assert pq == jq and len(pq) == 4
    jt, pt = _tree(tmp_path / "j"), _tree(tmp_path / "p")
    assert sorted(jt) == sorted(pt) and len(jt) == 2 * 4 + 3
    assert all(pt[k] == jt[k] for k in jt)


def _compare_stores(proot, jroot):
    for name in sorted(os.listdir(jroot)):
        jdir, pdir = os.path.join(jroot, name), os.path.join(proot, name)
        if os.path.isdir(jdir):
            assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)), name
            for f in os.listdir(jdir):
                a, b = np.load(os.path.join(pdir, f)), np.load(os.path.join(jdir, f))
                assert a.shape == b.shape and a.dtype == b.dtype, (name, f)
                np.testing.assert_allclose(a, b, atol=STORE_ATOL, rtol=0, err_msg=f"{name}/{f}")
                if name in ("pitch", "interpolate_pitch", "mfa_duration", "wav_22050",
                            "wav_16000", "wav_trim_22050", "wav_trim_16000"):
                    np.testing.assert_array_equal(a, b, err_msg=f"{name}/{f}")
        elif name == "stats.json":
            with open(jdir) as f, open(pdir) as g:
                np.testing.assert_allclose(
                    np.asarray(json.load(g)["energy"]), json.load(f)["energy"], rtol=1e-5)
        else:
            with open(jdir, "rb") as f, open(pdir, "rb") as g:
                assert g.read() == f.read(), name


def test_make_synthetic_corpus_matches_fscl_tpu(tmp_path):
    kw = dict(name="x", n_utts=3, seed=3, f0_base=150.0)
    jcfg = jscripts.make_synthetic_corpus(str(tmp_path / "j"), **kw)
    cache = str(tmp_path / "cache")
    pcfg = pscripts.make_synthetic_corpus(str(tmp_path / "p"), device="cpu",
                                          cache_dir=cache, **kw)
    _compare_stores(str(tmp_path / "p" / "features"), str(tmp_path / "j" / "features"))
    for rel in ("splits/train.txt", "splits/val.txt"):
        assert (tmp_path / "p" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes()
    assert (open(pcfg).read().replace(str(tmp_path / "p"), "R")
            == open(jcfg).read().replace(str(tmp_path / "j"), "R"))
    pscripts.make_synthetic_corpus(str(tmp_path / "q"), device="cpu", cache_dir=cache, **kw)
    assert len(os.listdir(cache)) == 1
    a, b = _tree(tmp_path / "p" / "features"), _tree(tmp_path / "q" / "features")
    assert a == b


def test_corpus_scripts_match_fscl_tpu(tmp_path):
    lab = tmp_path / "u.lab"
    lab.write_text("0 1000000 xx^xx-sil+k=a\n1000000 3000000 xx^sil-k+a=w\n"
                   "3000000 5000000 sil^k-a+w=a\n5000000 6000000 k^a-sil+xx=xx\n")
    assert pscripts.parse_hts_labels(str(lab)) == jscripts.parse_hts_labels(str(lab))
    pscripts.jsut_hts_to_textgrid(str(lab), str(tmp_path / "p" / "u.TextGrid"))
    jscripts.jsut_hts_to_textgrid(str(lab), str(tmp_path / "j" / "u.TextGrid"))
    assert ((tmp_path / "p" / "u.TextGrid").read_text()
            == (tmp_path / "j" / "u.TextGrid").read_text())
    assert (pscripts.synthetic_textgrid(["HH", "AY1"], 0.1)
            == jscripts.synthetic_textgrid(["HH", "AY1"], 0.1))
    assert (pscripts.mfa_align_command("d", "l.txt", "m.zip", "o", 4)
            == jscripts.mfa_align_command("d", "l.txt", "m.zip", "o", 4))

    paths = []
    for i, s in enumerate(({"pitch": [50, 900, 180, 40], "energy": [0, 500, 50, 40]},
                           {"pitch": [60, 950, 200, 50], "energy": [0, 520, 60, 35]})):
        paths.append(str(tmp_path / f"s{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump(s, f)
    got = pscripts.merge_global_stats(paths, str(tmp_path / "p.json"))
    want = jscripts.merge_global_stats(paths, str(tmp_path / "j.json"))
    assert got.as_flat() == want.as_flat()
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()

    texts = ["안녕하세요 물고기 있다", "물고기 여덟 abc", "한국어 공부"]
    assert (pscripts.build_korean_lexicon(texts, str(tmp_path / "p.lex"))
            == jscripts.build_korean_lexicon(texts, str(tmp_path / "j.lex")) == 6)
    assert (tmp_path / "p.lex").read_bytes() == (tmp_path / "j.lex").read_bytes()


def test_store_scripts_match_fscl_tpu(tmp_path):
    """prepare_mfa_corpus, prepare_hifigan_tune_data and the lexicon from a
    store, on one store written by fscl_tpu's synthetic corpus."""
    jscripts.make_synthetic_corpus(str(tmp_path / "c"), n_utts=2, seed=1)
    root = str(tmp_path / "c" / "features")
    P, J = FeatureStore(root), JStore(root)
    queries = [{"spk": "spk0", "basename": f"u{i}"} for i in range(2)]
    assert (pscripts.prepare_mfa_corpus(P, str(tmp_path / "pm"), queries)
            == jscripts.prepare_mfa_corpus(J, str(tmp_path / "jm"), queries) == 2)
    assert _tree(tmp_path / "pm") == _tree(tmp_path / "jm")
    assert (pscripts.prepare_hifigan_tune_data(P, queries, str(tmp_path / "ph"))
            == jscripts.prepare_hifigan_tune_data(J, queries, str(tmp_path / "jh")) == 2)
    assert _tree(tmp_path / "ph") == _tree(tmp_path / "jh")
