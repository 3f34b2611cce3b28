"""English number normalization, dependency-free.

Re-provides the behavior of the reference's text/numbers.py (which relies on
the `inflect` package): commas stripped, currency expanded, decimals read as
"point", ordinals and cardinals spelled out, years read in pairs.
"""
from __future__ import annotations

import re

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    (10 ** 12, "trillion"), (10 ** 9, "billion"), (10 ** 6, "million"),
    (10 ** 3, "thousand"), (100, "hundred"),
]

_ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _under_hundred(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def number_to_words(n: int, andword: str = "", zero: str = "zero") -> str:
    if n == 0:
        return zero
    if n < 0:
        return "minus " + number_to_words(-n, andword)
    parts = []
    for scale, name in _SCALES:
        if n >= scale:
            parts.append(number_to_words(n // scale) + " " + name)
            n %= scale
    if n > 0:
        if parts and andword:
            parts.append(andword)
        parts.append(_under_hundred(n))
    return " ".join(p for p in parts if p)


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    hy_head, hy, hy_last = last.rpartition("-")
    if hy_last in _ORDINAL_SPECIAL:
        last_ord = (hy_head + hy if hy else "") + _ORDINAL_SPECIAL[hy_last]
    elif hy_last.endswith("y"):
        last_ord = (hy_head + hy if hy else "") + hy_last[:-1] + "ieth"
    else:
        last_ord = (hy_head + hy if hy else "") + hy_last + "th"
    return (head + " " if head else "") + last_ord


def _two_digit_pairs(n: int) -> str:
    """Read a 4-digit year-like number in pairs: 1984 -> nineteen eighty-four."""
    hi, lo = divmod(n, 100)
    if lo == 0:
        return number_to_words(hi) + " hundred"
    lo_words = _under_hundred(lo) if lo >= 10 else "oh " + _ONES[lo]
    return number_to_words(hi) + " " + lo_words


_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        d_unit = "dollar" if dollars == 1 else "dollars"
        c_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {d_unit}, {cents} {c_unit}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return _two_digit_pairs(num)
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    text = _comma_number_re.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _pounds_re.sub(r"\1 pounds", text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_number_re.sub(lambda m: m.group(1).replace(".", " point "), text)
    text = _ordinal_re.sub(lambda m: ordinal_to_words(int(m.group(0)[:-2])), text)
    text = _number_re.sub(_expand_number, text)
    return text
