"""Text cleaners: english / transliteration / basic pipelines.

Same cleaner surface as the reference (text/cleaners.py) — selected by name
from data configs — but dependency-free: ASCII transliteration uses Unicode
NFKD decomposition instead of the `unidecode` package.
"""
from __future__ import annotations

import re

from fscl_tpu_torch.frontend.numbers_en import normalize_numbers

_whitespace_re = re.compile(r"\s+")

_ABBREVIATIONS = {
    "mrs": "misess", "mr": "mister", "dr": "doctor", "st": "saint",
    "co": "company", "jr": "junior", "maj": "major", "gen": "general",
    "drs": "doctors", "rev": "reverend", "lt": "lieutenant",
    "hon": "honorable", "sgt": "sergeant", "capt": "captain",
    "esq": "esquire", "ltd": "limited", "col": "colonel", "ft": "fort",
}
_abbrev_res = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in _ABBREVIATIONS.items()
]


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbrev_res:
        text = regex.sub(replacement, text)
    return text


def expand_numbers(text: str) -> str:
    return normalize_numbers(text)


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return _whitespace_re.sub(" ", text)


def convert_to_ascii(text: str) -> str:
    """unidecode-grade transliteration (frontend/translit.py): accented
    Latin via NFKD, Cyrillic romanization, pinyin for common hanzi — the
    scripts live in the reference's corpora (CSS10-ru, AISHELL-3)."""
    from fscl_tpu_torch.frontend.translit import transliterate
    return transliterate(text)


def basic_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text: str) -> str:
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    return collapse_whitespace(text)


CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
    "english_cleaners": english_cleaners,
}


def clean_text(text: str, cleaner_names) -> str:
    for name in cleaner_names:
        if name not in CLEANERS:
            raise KeyError(f"Unknown cleaner: {name}")
        text = CLEANERS[name](text)
    return text
