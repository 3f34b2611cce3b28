"""Language registry: symbol tables per language.

Same 10-language registry and per-language symbol-table contract as the
reference (text/define.py:16-35): en/zh have built-in inventories; fr/de/es/
jp/ko load `MFA/<Lang>/phoneset.txt` relative to a configurable root; the
rest are empty. Pseudo-unit symbol tables (for t2u) are registered at
runtime via `register_unit_symbols` (reference: lightning/build.py:24-31
`build_id2symbols` "common_symbols + unit ids").
"""
from __future__ import annotations

import os
from typing import Dict, List

from fscl_tpu_torch.frontend.symbols import common_symbols, en_symbols, zh_symbols

LANGS = ["en", "zh", "fr", "de", "ru", "es", "jp", "cz", "ko", "nl"]
LANG_ID2NAME = {i: name for i, name in enumerate(LANGS)}
LANG_NAME2ID = {name: i for i, name in enumerate(LANGS)}

_MFA_LANG_DIRS = {
    "fr": "French", "de": "German", "es": "Spanish",
    "jp": "Japanese", "ko": "Korean",
}

MFA_ROOT = os.environ.get("FSCL_MFA_ROOT", "MFA")


def load_phoneme_set(path: str, encoding: str = "utf-8") -> List[str]:
    phns = []
    with open(path, "r", encoding=encoding) as f:
        for line in f:
            line = line.strip()
            if line:
                phns.append("@" + line)
    return phns


def _mfa_symbols(lang: str) -> List[str]:
    path = os.path.join(MFA_ROOT, _MFA_LANG_DIRS[lang], "phoneset.txt")
    if not os.path.isfile(path):
        return []
    return common_symbols + load_phoneme_set(path)


def build_lang_id2symbols() -> Dict[str, List[str]]:
    table: Dict[str, List[str]] = {lang: [] for lang in LANGS}
    table["en"] = list(en_symbols)
    table["zh"] = list(zh_symbols)
    for lang in _MFA_LANG_DIRS:
        table[lang] = _mfa_symbols(lang)
    return table


LANG_ID2SYMBOLS: Dict[str, List[str]] = build_lang_id2symbols()


def register_symbols(symbol_id: str, syms: List[str]) -> None:
    LANG_ID2SYMBOLS[symbol_id] = list(syms)
    from fscl_tpu_torch.frontend import rebuild_symbol_maps
    rebuild_symbol_maps()


def register_unit_symbols(unit_name: str, n_units: int) -> None:
    """Pseudo-unit inventory: common symbols + unit ids as string symbols
    (reference: lightning/build.py:24-31)."""
    register_symbols(unit_name, common_symbols + [str(i) for i in range(n_units)])


def n_symbols(symbol_id: str) -> int:
    return len(LANG_ID2SYMBOLS[symbol_id])
