"""The port's Korean g2p (`frontend/kog2p.py`, its own copy of fscl_tpu's)
on the 475-entry golden set of the reference engine
(tests/fixtures/kog2p_testset_golden.json, as tests/test_kog2p_golden.py
holds fscl_tpu's): every entry's phones equal the golden ones and
fscl_tpu's, word by word too."""
import json
import os

import pytest

from fscl_tpu.frontend import kog2p as jkog2p
from fscl_tpu_torch.frontend import kog2p

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "kog2p_testset_golden.json")


def _rows():
    with open(FIXTURE, encoding="utf-8") as f:
        return json.load(f)


def test_golden_set():
    rows = _rows()
    assert len(rows) == 475
    bad = [(r["in"], " ".join(kog2p.g2p_ko(r["in"])), r["phones"]) for r in rows
           if " ".join(kog2p.g2p_ko(r["in"])) != r["phones"]]
    assert not bad, f"{len(bad)} divergences, first 5: {bad[:5]}"


def test_equals_fscl_tpu_word_by_word():
    words = sorted({w for r in _rows() for w in r["in"].split()})
    assert len(words) > 400
    for w in words:
        assert kog2p.g2p_ko(w) == jkog2p.g2p_ko(w), w
        assert kog2p.g2p_ko_string(w) == jkog2p.g2p_ko_string(w), w


@pytest.mark.parametrize("text,phones", [
    ("한국어", "h0 aa nf k0 uu k0 vv"), ("안녕", "aa nf nn yv ng"), ("있다", "ii tf tt aa"),
    ("같이", "k0 aa ch ii"), ("음악", "xx mm aa kf"), ("국물", "k0 uu ng mm uu ll"),
    ("좋다", "c0 oo th aa"), ("abc 123", "")])
def test_basic_shapes(text, phones):
    assert kog2p.g2p_ko_string(text) == phones
