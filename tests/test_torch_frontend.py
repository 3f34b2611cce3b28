"""The port's own copy of the text frontend gives fscl_tpu's ids."""
import pytest

import fscl_tpu.frontend as jfront
import fscl_tpu_torch.frontend as tfront

CASES = [
    ("Hello world, this is a plain sentence.", ["english_cleaners"], "en"),
    ("In 1984 he paid $3.50 for 2,000 apples on the 21st.", ["english_cleaners"], "en"),
    ("Mr. Smith met Dr. Jones at St. Paul's, Ltd.", ["english_cleaners"], "en"),
    ("Say {HH AH0 L OW1} to {W ER1 L D} now.", ["english_cleaners"], "en"),
    ("Café naïve résumé — Ångström façade.", ["english_cleaners"], "en"),
    ("Привет мир", ["transliteration_cleaners"], "en"),
    ("{n i3 h ao3} {sp} {sh ii4 j ie4}", ["basic_cleaners"], "zh"),
]


@pytest.mark.parametrize("text,cleaners,lang", CASES)
def test_text_to_sequence_matches(text, cleaners, lang):
    want = jfront.text_to_sequence(text, cleaners, lang)
    assert want, "case must map to symbols"
    assert tfront.text_to_sequence(text, cleaners, lang) == want
    assert tfront.sequence_to_text(want, lang) == jfront.sequence_to_text(want, lang)


def test_symbol_tables_match():
    assert len(tfront.LANG_ID2SYMBOLS["en"]) == 152
    assert len(tfront.LANG_ID2SYMBOLS["zh"]) == 225
    for lang in ("en", "zh"):
        assert tfront.LANG_ID2SYMBOLS[lang] == jfront.LANG_ID2SYMBOLS[lang]
