"""Symbol inventories.

Same symbol *data* (standard ARPAbet + pinyin initial/final inventories, pad,
punctuation, silences) and the same ordering contract as the reference
(text/symbols.py:10-33, text/cmudict.py, text/pinyin.py), generated
programmatically. IDs must line up exactly for checkpoint/task parity:
`common_symbols` is the shared prefix of every per-language table.
"""
from __future__ import annotations

# --- ARPAbet (CMUdict) -----------------------------------------------------
_ARPABET_VOWELS = (
    "AA AE AH AO AW AY EH ER EY IH IY OW OY UH UW".split()
)
_ARPABET_CONSONANTS = (
    "B CH D DH F G HH JH K L M N NG P R S SH T TH V W Y Z ZH".split()
)


def _arpabet_symbols():
    # CMUdict ordering: alphabetical over the union of plain consonants and
    # stress-marked vowels (vowel, vowel0, vowel1, vowel2).
    syms = []
    for v in _ARPABET_VOWELS:
        syms.extend([v, v + "0", v + "1", v + "2"])
    syms.extend(_ARPABET_CONSONANTS)
    return sorted(syms)


arpabet_valid_symbols = _arpabet_symbols()

# --- Pinyin (initials + tonal finals + "rr") --------------------------------
_PINYIN_INITIALS = "b c ch d f g h j k l m n p q r s sh t w x y z zh".split()
_PINYIN_FINAL_BASES = (
    "a ai an ang ao e ei en eng er i ia ian iang iao ie ii iii in ing iong "
    "iou o ong ou u ua uai uan uang uei uen uo v van ve vn".split()
)


def _pinyin_finals():
    return [f"{base}{tone}" for base in _PINYIN_FINAL_BASES for tone in range(1, 6)]


pinyin_valid_symbols = _PINYIN_INITIALS + _pinyin_finals() + ["rr"]

# --- Composite tables (ordering contract of text/symbols.py) ----------------
PAD = "_"
_special = ["-"]
_punctuation = list("|!'(),.:;? ")
_letters = [c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"]
_silences = ["@sp", "@spn", "@sil"]

_arpabet = ["@" + s for s in arpabet_valid_symbols]
_pinyin = ["@" + s for s in pinyin_valid_symbols]

symbols = [PAD] + _special + _punctuation + _letters + _arpabet + _pinyin + _silences

common_symbols = [PAD] + _special + _punctuation
en_symbols = common_symbols + _silences + _letters + _arpabet
zh_symbols = common_symbols + _silences + _pinyin
