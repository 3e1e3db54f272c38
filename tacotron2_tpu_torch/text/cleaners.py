"""Text cleaners: normalization pipelines run before symbol encoding.

Same pipeline surface as the reference (reference text/cleaners.py):
``basic_cleaners``, ``transliteration_cleaners``, ``english_cleaners``. The
Unidecode dependency is replaced by a self-contained ASCII transliterator
(NFKD decomposition + a table for letters that don't decompose), which covers
the Latin-script accents that occur in LJSpeech-style corpora.
"""

from __future__ import annotations

import re
import unicodedata

from tacotron2_tpu_torch.text.numbers import normalize_numbers

_WHITESPACE_RE = re.compile(r"\s+")

# Letters with no NFKD decomposition to ASCII, mapped the way Unidecode does.
_TRANSLIT_TABLE = {
    "æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE",
    "ß": "ss", "ẞ": "SS",
    "ø": "o", "Ø": "O", "đ": "d", "Đ": "D",
    "ð": "d", "Ð": "D", "þ": "th", "Þ": "Th",
    "ł": "l", "Ł": "L", "ħ": "h", "Ħ": "H",
    "ı": "i", "İ": "I", "ŋ": "ng", "Ŋ": "NG",
    "—": "--", "–": "-", "‒": "-", "―": "--",
    "‘": "'", "’": "'", "‚": ",", "“": '"', "”": '"', "„": '"',
    "…": "...", "•": "*", "·": "*",
    "¡": "!", "¿": "?", "«": '"', "»": '"', "‹": "<", "›": ">",
    "×": "x", "÷": "/", "°": " deg ", "µ": "u",
    "½": " 1/2", "¼": " 1/4", "¾": " 3/4",
    "№": "No", "™": "(tm)", "©": "(c)", "®": "(r)",
}

_ABBREVIATION_EXPANSIONS = [
    ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
    ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
    ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
    ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
    ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
]
_ABBREVIATION_RES = [
    (re.compile(r"\b%s\." % abbr, re.IGNORECASE), expansion)
    for abbr, expansion in _ABBREVIATION_EXPANSIONS
]


def to_ascii(text: str) -> str:
    """Transliterate to ASCII: special-case table, then strip combining marks."""
    text = "".join(_TRANSLIT_TABLE.get(ch, ch) for ch in text)
    decomposed = unicodedata.normalize("NFKD", text)
    stripped = "".join(ch for ch in decomposed if not unicodedata.combining(ch))
    return stripped.encode("ascii", "ignore").decode("ascii")


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return _WHITESPACE_RE.sub(" ", text)


def expand_abbreviations(text: str) -> str:
    for regex, expansion in _ABBREVIATION_RES:
        text = regex.sub(expansion, text)
    return text


def expand_numbers(text: str) -> str:
    return normalize_numbers(text)


def basic_cleaners(text: str) -> str:
    """Lowercase + whitespace collapse, no transliteration."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    """ASCII transliteration + lowercase + whitespace collapse."""
    return collapse_whitespace(lowercase(to_ascii(text)))


def english_cleaners(text: str) -> str:
    """Full English pipeline: ASCII, lowercase, numbers, abbreviations."""
    text = to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text


CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
    "english_cleaners": english_cleaners,
}
