"""Text frontend: text <-> phoneme-id sequences.

API-compatible with the reference's `text/__init__.py:18-58`
(text_to_sequence / sequence_to_text with curly-brace phoneme notation and
per-language symbol tables keyed by symbol_id).

The port's own copy of `fscl_tpu/frontend` (the Korean g2p in
`frontend/kog2p.py`); ids match symbol for symbol.
"""
from __future__ import annotations

import re
from typing import Dict, List

from fscl_tpu_torch.frontend.cleaners import clean_text, CLEANERS
from fscl_tpu_torch.frontend.define import (
    LANGS,
    LANG_ID2NAME,
    LANG_ID2SYMBOLS,
    LANG_NAME2ID,
    n_symbols,
    register_symbols,
    register_unit_symbols,
)
from fscl_tpu_torch.frontend.symbols import common_symbols, en_symbols, zh_symbols, symbols

_symbol_to_id: Dict[str, Dict[str, int]] = {}
_id_to_symbol: Dict[str, Dict[int, str]] = {}


def rebuild_symbol_maps() -> None:
    _symbol_to_id.clear()
    _id_to_symbol.clear()
    for key, syms in LANG_ID2SYMBOLS.items():
        _symbol_to_id[key] = {s: i for i, s in enumerate(syms)}
        _id_to_symbol[key] = {i: s for i, s in enumerate(syms)}


rebuild_symbol_maps()

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


def _keep(s: str, lang_id: str) -> bool:
    return s in _symbol_to_id[lang_id] and s not in ("_", "~")


def _symbols_to_sequence(syms, lang_id: str) -> List[int]:
    return [_symbol_to_id[lang_id][s] for s in syms if _keep(s, lang_id)]


def _phonemes_to_sequence(text: str, lang_id: str) -> List[int]:
    return _symbols_to_sequence(["@" + s for s in text.split()], lang_id)


def text_to_sequence(text: str, cleaner_names, lang_id: str = "en") -> List[int]:
    """Convert text (with optional {PHONEME ...} spans) to symbol ids."""
    sequence: List[int] = []
    while text:
        m = _curly_re.match(text)
        if not m:
            sequence += _symbols_to_sequence(clean_text(text, cleaner_names), lang_id)
            break
        sequence += _symbols_to_sequence(clean_text(m.group(1), cleaner_names), lang_id)
        sequence += _phonemes_to_sequence(m.group(2), lang_id)
        text = m.group(3)
    return sequence


def units_to_sequence(unit_string: str, unit_name: str):
    """Map a space-separated pseudo-unit string directly by the unit symbol
    table (reference: per-dataset unit2id dicts, t2u/DADataset.py:29,45 —
    units are plain tokens, not @-prefixed phonemes)."""
    table = _symbol_to_id[unit_name]
    return [table[tok] for tok in unit_string.split() if tok in table]


def sequence_to_text(sequence, lang_id: str = "en") -> str:
    result = ""
    for sid in sequence:
        sid = int(sid)
        if sid in _id_to_symbol[lang_id]:
            s = _id_to_symbol[lang_id][sid]
            if len(s) > 1 and s[0] == "@":
                s = "{%s}" % s[1:]
            result += s
    return result.replace("}{", " ")
