"""Mixed grapheme/phoneme text encoding (the JAX package's
``text/arpabet.py``).

Stochastically swaps words for their CMUdict {ARPAbet} pronunciations
before symbol encoding — the standard phoneme-aware training recipe for
the reference family. The reference ships the dictionary loader
(reference text/cmudict.py) but never uses it in training; here
``encode_mixed`` wires it in, keeping punctuation attached to words and
falling back to graphemes for OOV words.
"""

from __future__ import annotations

import re
from typing import List, Optional

from tacotron2_tpu_torch.text import text_to_sequence
from tacotron2_tpu_torch.text.cmudict import CMUDict

_WORD_RE = re.compile(r"([a-zA-Z']+)")


def words_to_arpabet(text: str, cmudict: CMUDict, rng,
                     p_arpabet: float) -> str:
    """Swap each alphabetic word for {PRONUNCIATION} with prob p_arpabet.
    Ambiguous words use their first listed pronunciation (the reference
    loader keeps all; first is CMUdict's primary)."""
    def maybe_swap(match: re.Match) -> str:
        word = match.group(1)
        if rng.random() >= p_arpabet:
            return word
        prons = cmudict.lookup(word)
        if not prons:
            return word
        return "{%s}" % prons[0]
    return _WORD_RE.sub(maybe_swap, text)


def encode_mixed(text: str, cleaner_names, cmudict: Optional[CMUDict],
                 rng, p_arpabet: float) -> List[int]:
    """text -> symbol IDs with stochastic phoneme substitution.

    NOTE: substitution happens on the RAW text; the cleaner pipeline then
    runs on the non-braced spans only (text_to_sequence's curly-brace
    protocol), so numbers/abbreviations in grapheme spans still expand.
    """
    if cmudict is not None and p_arpabet > 0.0:
        text = words_to_arpabet(text, cmudict, rng, p_arpabet)
    return text_to_sequence(text, cleaner_names)
