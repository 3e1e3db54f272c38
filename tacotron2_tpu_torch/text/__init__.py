"""Text frontend: string -> symbol-ID sequence.

Equivalent of reference text/__init__.py:15-53 (`text_to_sequence` /
`sequence_to_text`): cleaner pipeline + symbol encoding, with `{ARPAbet}`
curly-brace passthrough. IDs index the 148-symbol embedding table.
"""

from __future__ import annotations

import re
from typing import List, Sequence

from tacotron2_tpu_torch.text.cleaners import CLEANERS
from tacotron2_tpu_torch.text.cmudict import CMUDict
from tacotron2_tpu_torch.text.symbols import (
    ARPABET, ID_TO_SYMBOL, N_SYMBOLS, PAD, SYMBOL_TO_ID, SYMBOLS,
)

__all__ = [
    "text_to_sequence", "sequence_to_text", "SYMBOLS", "N_SYMBOLS", "PAD",
    "SYMBOL_TO_ID", "ID_TO_SYMBOL", "ARPABET", "CMUDict",
]

# "leading text { arpabet block } trailing text"
_CURLY_RE = re.compile(r"(.*?)\{(.+?)\}(.*)")

# Symbols never emitted: pad and the (legacy) eos marker.
_DROPPED = {"_", "~"}


def _clean(text: str, cleaner_names: Sequence[str]) -> str:
    for name in cleaner_names:
        cleaner = CLEANERS.get(name)
        if cleaner is None:
            raise KeyError(f"unknown cleaner {name!r}")
        text = cleaner(text)
    return text


def _encode_symbols(symbols: Sequence[str]) -> List[int]:
    return [SYMBOL_TO_ID[s] for s in symbols
            if s in SYMBOL_TO_ID and s not in _DROPPED]


def _encode_arpabet(block: str) -> List[int]:
    return _encode_symbols(["@" + phone for phone in block.split()])


def text_to_sequence(text: str, cleaner_names: Sequence[str]) -> List[int]:
    """Convert text to symbol IDs; ``{HH AW1 S}`` blocks encode as ARPAbet."""
    sequence: List[int] = []
    while text:
        m = _CURLY_RE.match(text)
        if not m:
            sequence.extend(_encode_symbols(_clean(text, cleaner_names)))
            break
        sequence.extend(_encode_symbols(_clean(m.group(1), cleaner_names)))
        sequence.extend(_encode_arpabet(m.group(2)))
        text = m.group(3)
    return sequence


def sequence_to_text(sequence: Sequence[int]) -> str:
    """Inverse mapping for debugging; ARPAbet IDs render as {PHONE}."""
    out = []
    for symbol_id in sequence:
        s = ID_TO_SYMBOL.get(int(symbol_id))
        if s is None:
            continue
        if len(s) > 1 and s.startswith("@"):
            s = "{%s}" % s[1:]
        out.append(s)
    return "".join(out).replace("}{", " ")
