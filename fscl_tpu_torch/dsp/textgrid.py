"""Minimal Praat TextGrid reader + segment/phoneme extraction.

Replaces the reference's tgt-library TextGrid ingestion
(dlhlp_lib.tts_preprocess textgrid2segment_and_phoneme): parses the "phones"
tier, merges leading/trailing silences, and emits (segments, phonemes) where
silences become "sp"/"spn"/"sil" tokens like MFA output.

The port's own copy of `fscl_tpu/dsp/textgrid.py`.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

SILENCES = {"sil", "sp", "spn", ""}


def parse_textgrid(path: str) -> Dict[str, List[Tuple[float, float, str]]]:
    """Parse a (long-format) TextGrid into {tier_name: [(xmin, xmax, text)]}."""
    with open(path, encoding="utf-8") as f:
        content = f.read()
    tiers: Dict[str, List[Tuple[float, float, str]]] = {}
    tier_blocks = re.split(r"item\s*\[\d+\]:", content)[1:]
    for block in tier_blocks:
        m = re.search(r'name\s*=\s*"([^"]*)"', block)
        if not m:
            continue
        name = m.group(1)
        intervals = []
        for im in re.finditer(
            r'xmin\s*=\s*([\d.eE+-]+)\s*\n\s*xmax\s*=\s*([\d.eE+-]+)'
            r'\s*\n\s*text\s*=\s*"([^"]*)"', block,
        ):
            intervals.append((float(im.group(1)), float(im.group(2)),
                              im.group(3).strip()))
        tiers[name] = intervals
    return tiers


def textgrid_to_segments_and_phonemes(
    path: str, tier: str = "phones",
) -> Tuple[List[Tuple[float, float]], List[str]]:
    """MFA phones tier -> (segments, phoneme tokens); empty labels become
    'sp' silences, '<unk>'/'spn' kept as spn."""
    tiers = parse_textgrid(path)
    if tier not in tiers:
        for k in tiers:
            if "phone" in k.lower():
                tier = k
                break
    intervals = tiers[tier]
    segments, phonemes = [], []
    for xmin, xmax, text in intervals:
        if xmax - xmin <= 0:
            continue
        label = text
        if label in ("", "sil", "sp"):
            label = "sp"
        elif label in ("spn", "<unk>", "unk"):
            label = "spn"
        segments.append((xmin, xmax))
        phonemes.append(label)
    # trim leading/trailing silences (reference trims wav to the voiced span)
    start, end = 0, len(phonemes)
    while start < end and phonemes[start] == "sp":
        start += 1
    while end > start and phonemes[end - 1] == "sp":
        end -= 1
    return segments[start:end], phonemes[start:end]
