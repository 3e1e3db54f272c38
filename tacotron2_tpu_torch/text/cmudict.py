"""CMU pronouncing dictionary loader.

Equivalent of reference text/cmudict.py:19-64: parses the cmudict file
format into word -> [ARPAbet pronunciation] mappings, validating phones
against the symbol inventory. Used for optional {ARPAbet} curly-brace input.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from tacotron2_tpu_torch.text.symbols import ARPABET

_VALID_PHONES = frozenset(ARPABET)
_VARIANT_SUFFIX_RE = re.compile(r"\([0-9]+\)")


def _validated_pronunciation(s: str) -> Optional[str]:
    phones = s.strip().split(" ")
    if any(p not in _VALID_PHONES for p in phones):
        return None
    return " ".join(phones)


def parse_cmudict(lines) -> Dict[str, List[str]]:
    entries: Dict[str, List[str]] = {}
    for line in lines:
        if not line or not ("A" <= line[0] <= "Z" or line[0] == "'"):
            continue
        parts = line.split("  ")
        if len(parts) < 2:
            continue
        word = _VARIANT_SUFFIX_RE.sub("", parts[0])
        pron = _validated_pronunciation(parts[1])
        if pron:
            entries.setdefault(word, []).append(pron)
    return entries


class CMUDict:
    """Word -> ARPAbet pronunciation lookup."""

    def __init__(self, file_or_path, keep_ambiguous: bool = True):
        if isinstance(file_or_path, str):
            with open(file_or_path, encoding="latin-1") as f:
                entries = parse_cmudict(f)
        else:
            entries = parse_cmudict(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, word: str) -> Optional[List[str]]:
        """All ARPAbet pronunciations of ``word``, or None if unknown."""
        return self._entries.get(word.upper())
