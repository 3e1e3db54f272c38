"""Number normalization for English text.

Reimplements the reference's number expansion (reference text/numbers.py)
without the ``inflect`` dependency: a self-contained English number-to-words
converter tuned to produce the same strings inflect does on the paths the
cleaners actually exercise — cardinals with ``andword=''``, two-digit grouping
for years (``group=2, zero='oh'``), and ordinal suffix words.
"""

from __future__ import annotations

import re

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    (10 ** 33, "decillion"), (10 ** 30, "nonillion"), (10 ** 27, "octillion"),
    (10 ** 24, "septillion"), (10 ** 21, "sextillion"), (10 ** 18, "quintillion"),
    (10 ** 15, "quadrillion"), (10 ** 12, "trillion"), (10 ** 9, "billion"),
    (10 ** 6, "million"), (10 ** 3, "thousand"),
]

_IRREGULAR_ORDINALS = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int) -> str:
    """0..99 in words ('forty-two', 'seventeen')."""
    if n < 20:
        return _UNITS[n]
    tens, units = divmod(n, 10)
    word = _TENS[tens]
    return f"{word}-{_UNITS[units]}" if units else word


def _three_digits(n: int, andword: str) -> str:
    """0..999 in words; inflect puts `andword` between hundreds and the rest."""
    if n < 100:
        return _two_digits(n)
    hundreds, rest = divmod(n, 100)
    head = f"{_UNITS[hundreds]} hundred"
    if not rest:
        return head
    joiner = f" {andword} " if andword else " "
    return head + joiner + _two_digits(rest)


def number_to_words(n: int, andword: str = "and") -> str:
    """Cardinal words for a non-negative integer.

    Matches inflect's comma placement: scale groups are joined with ', '
    (e.g. 1234567 -> 'one million, two hundred thirty-four thousand, five
    hundred sixty-seven' with andword='').
    """
    if n < 0:
        return "minus " + number_to_words(-n, andword)
    if n < 1000:
        return _three_digits(n, andword)
    if n >= 1000 * _SCALES[0][0]:
        # beyond the named scales: read digit-by-digit (never crash on
        # pathological digit runs)
        return " ".join(_UNITS[int(d)] for d in str(n))
    parts = []
    remainder = n
    for scale_value, scale_name in _SCALES:
        if remainder >= scale_value:
            count, remainder = divmod(remainder, scale_value)
            parts.append(f"{_three_digits(count, andword)} {scale_name}")
    if remainder:
        parts.append(_three_digits(remainder, andword))
    return ", ".join(parts)


def _year_group_words(digit_pair: str, zero: str = "oh") -> str:
    """Words for one 2-digit group in year style ('06' -> 'oh six')."""
    if digit_pair[0] == "0":
        if digit_pair[1] == "0":
            return f"{zero} {zero}"
        return f"{zero} {_UNITS[int(digit_pair[1])]}"
    return _two_digits(int(digit_pair))


def number_to_words_grouped(n: int, zero: str = "oh") -> str:
    """Two-digit grouping used for years — inflect's group=2 with ', '
    collapsed to spaces by the caller (reference numbers.py:57)."""
    digits = str(n)
    if len(digits) % 2:
        digits = digits  # odd length: leading group is a single digit
    groups = []
    i = 0
    if len(digits) % 2:
        groups.append(_UNITS[int(digits[0])] if digits[0] != "0" else zero)
        i = 1
    while i < len(digits):
        groups.append(_year_group_words(digits[i:i + 2], zero))
        i += 2
    return " ".join(groups)


def ordinal_words(n: int) -> str:
    """Ordinal words for an integer ('21' -> 'twenty-first')."""
    cardinal = number_to_words(n, andword="")
    head, sep, last = cardinal.rpartition("-")
    if not sep:
        head, sep, last = cardinal.rpartition(" ")
    if last in _IRREGULAR_ORDINALS:
        ordinal_last = _IRREGULAR_ORDINALS[last]
    elif last.endswith("y"):
        ordinal_last = last[:-1] + "ieth"
    else:
        ordinal_last = last + "th"
    return head + sep + ordinal_last


# --- Regex pipeline (behavior of reference numbers.py:64-71) ---

_COMMA_NUM_RE = re.compile(r"([0-9][0-9\,]+[0-9])")
_DECIMAL_RE = re.compile(r"([0-9]+\.[0-9]+)")
_POUNDS_RE = re.compile(r"£([0-9\,]*[0-9]+)")
_DOLLARS_RE = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ORDINAL_RE = re.compile(r"[0-9]+(st|nd|rd|th)")
_NUMBER_RE = re.compile(r"[0-9]+")


def _strip_commas(m: re.Match) -> str:
    return m.group(1).replace(",", "")


def _decimal_to_point(m: re.Match) -> str:
    return m.group(1).replace(".", " point ")


def _dollars_to_words(m: re.Match) -> str:
    amount = m.group(1)
    parts = amount.split(".")
    if len(parts) > 2:
        return amount + " dollars"  # unexpected format; leave digits
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        return "%s %s, %s %s" % (
            dollars, "dollar" if dollars == 1 else "dollars",
            cents, "cent" if cents == 1 else "cents")
    if dollars:
        return "%s %s" % (dollars, "dollar" if dollars == 1 else "dollars")
    if cents:
        return "%s %s" % (cents, "cent" if cents == 1 else "cents")
    return "zero dollars"


def _ordinal_to_words(m: re.Match) -> str:
    return ordinal_words(int(m.group(0)[:-2]))


def _cardinal_to_words(m: re.Match) -> str:
    num = int(m.group(0))
    # Year-style reading for 1001..2999 (reference numbers.py:50-60).
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100, andword="")
        if num % 100 == 0:
            return number_to_words(num // 100, andword="") + " hundred"
        return number_to_words_grouped(num)
    return number_to_words(num, andword="")


def normalize_numbers(text: str) -> str:
    """Expand digits, currency, decimals, and ordinals into words."""
    text = _COMMA_NUM_RE.sub(_strip_commas, text)
    text = _POUNDS_RE.sub(r"\1 pounds", text)
    text = _DOLLARS_RE.sub(_dollars_to_words, text)
    text = _DECIMAL_RE.sub(_decimal_to_point, text)
    text = _ORDINAL_RE.sub(_ordinal_to_words, text)
    text = _NUMBER_RE.sub(_cardinal_to_words, text)
    return text
