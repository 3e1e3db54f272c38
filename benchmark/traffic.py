"""Traffic and corpus generation from a seed and a mix's parameters.

Every seed gets the same multiset of sizes and gaps, in another order: the
lengths are fixed quantiles of the mix's distribution and the gaps fixed
quantiles of an exponential, shuffled by the seed. The words of each text
are drawn from the seed. So two seeds give the same work, in a different
order and with different text.

Text lengths follow LJSpeech's transcripts by the text bucket they fall in
(``SHARES``), uniform within a bucket. ``SHARES`` is a frozen copy of
``tacotron2_tpu_torch/tools/bench_buckets.py:27`` (the JAX script's, from
the reference's train filelist).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

# tacotron2_tpu_torch/tools/bench_buckets.py:27 (frozen copy)
SHARES = {64: 0.171, 128: 0.602, 192: 0.228}  # LJSpeech text lengths

# Lowercase words that english_cleaners leaves as they are (no digits, no
# abbreviation it expands), so a text's symbol count is its length.
WORDS = (
    "the of and to in that was he it with as his on be at by had not are "
    "but from or have an they which one you were her all she there would "
    "their we him been has when who will more no if out so said what up "
    "its about into than them can only other new some could time these two "
    "may then do first any my now such like our over man me even most made "
    "after also did many before must through back years where much your way "
    "well down should because each just those people how too little state "
    "good very make world still own see men work long get here between both "
    "life being under never day same another know while last might us great "
    "old year off come since against go came right used take three states "
    "himself few house use during without again place american around "
    "however home small found thought went say part once general high upon "
    "school every does got united left number course war until always away "
    "something fact though water less public put think almost hand enough "
    "far took head yet government system better set told nothing night end "
    "why called didn eyes find going look asked later knew point next city "
    "business give group toward young let room president side social given "
    "present several order national possible rather second face per among "
    "form important often things looked early white case john become large "
    "big need four within felt along children saw best church ever least "
    "power development light thing family interest want members mind country "
    "area others done turned although open god service certain kind problem "
    "began different door thus help sense means whole matter perhaps itself "
    "york times human law line above name example action company hands local "
    "show whether five history gave today either act feet across taken past "
    "quite anything seen having death week experience").split()

# english_cleaners expands these when a period follows them
_ABBREVIATIONS = {"mrs", "mr", "dr", "st", "co", "jr", "maj", "gen", "drs",
                  "rev", "lt", "hon", "sgt", "capt", "esq", "ltd", "col",
                  "ft"}

# The reference's symbol table for the characters a generated text uses
# (tacotron2_tpu_torch/text/symbols.py: pad, "-", punctuation, letters).
_SYMBOLS = (["_", "-"] + list("!'(),.:;? ")
            + list("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"))
SYMBOL_ID = {s: i for i, s in enumerate(_SYMBOLS)}


def text_ids(text: str) -> np.ndarray:
    """The symbol ids of a generated text (one id a character)."""
    return np.asarray([SYMBOL_ID[c] for c in text], np.int64)


def _bucket_ranges(shares: Dict[int, float], shortest: int
                   ) -> List[Tuple[int, int, float]]:
    total = sum(shares.values())
    out, lo = [], shortest
    for b in sorted(shares):
        out.append((lo, b, shares[b] / total))
        lo = b + 1
    return out


def length_quantiles(n: int, shares: Dict[int, float] = SHARES,
                     shortest: int = 8) -> np.ndarray:
    """``n`` text lengths at the quantiles (i + 0.5) / n of the mix: a
    bucket's share of them, uniform over its lengths."""
    ranges = _bucket_ranges(shares, shortest)
    out = np.empty(n, np.int64)
    for i in range(n):
        u = (i + 0.5) / n
        for lo, hi, p in ranges:
            if u < p or (lo, hi, p) == ranges[-1]:
                f = min(u / p, 1.0 - 1e-9)
                out[i] = lo + int(f * (hi - lo + 1))
                break
            u -= p
    return out


def exponential_gaps(n: int, span_s: float) -> np.ndarray:
    """``n`` gaps at the quantiles (i + 0.5) / n of an exponential,
    scaled so that they add up to ``span_s``."""
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u)
    return gaps * (span_s / gaps.sum())


def make_text(rng: np.random.RandomState, length: int) -> str:
    """Words from ``WORDS``, exactly ``length`` characters, ending in a
    period."""
    words: List[str] = []
    size = -1
    while size < length - 1:
        w = WORDS[rng.randint(len(WORDS))]
        words.append(w)
        size += len(w) + 1
    body = " ".join(words)[:length - 1]
    last = body.rsplit(" ", 1)[-1]
    if last in _ABBREVIATIONS:
        body = body[:len(body) - len(last)] + "z" + last[1:]
    return body + "."


def shares_of(mix: dict) -> Dict[int, float]:
    """A mix's bucket shares (``"shares"``, keys as strings in JSON), or
    LJSpeech's."""
    got = mix.get("shares")
    return {int(k): float(v) for k, v in got.items()} if got else SHARES


def texts(seed: int, n: int, shares: Dict[int, float] = SHARES,
          shortest: int = 8) -> List[str]:
    """``n`` texts: the fixed lengths in the seed's order, the seed's
    words."""
    rng = np.random.RandomState(seed % (1 << 32))
    lengths = length_quantiles(n, shares, shortest)
    rng.shuffle(lengths)
    return [make_text(rng, int(n_)) for n_ in lengths]


def arrivals(seed: int, rate: float, span_s: float) -> np.ndarray:
    """Open-loop due times in [0, span_s): round(rate * span_s) requests,
    the fixed gaps in the seed's order."""
    n = max(1, int(round(rate * span_s)))
    rng = np.random.RandomState((seed + 1) % (1 << 32))
    gaps = exponential_gaps(n, span_s)
    rng.shuffle(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def corpus_lengths(seed: int, n: int, frames_per_char: float,
                   jitter: float, max_frames: int,
                   shares: Dict[int, float] = SHARES,
                   shortest: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """(text lengths, mel frames) of ``n`` utterances: the same pairs for
    every seed, in the seed's order. Frames are ``frames_per_char`` a
    character times a factor in [1 - jitter, 1 + jitter] spread evenly
    over the utterances (golden-ratio steps), capped at ``max_frames``."""
    lengths = length_quantiles(n, shares, shortest)
    spread = (np.arange(n) * 0.6180339887498949) % 1.0
    frames = np.minimum(np.round(lengths * frames_per_char
                                 * (1.0 - jitter + 2.0 * jitter * spread)),
                        max_frames).astype(np.int64)
    order = np.random.RandomState((seed + 2) % (1 << 32)).permutation(n)
    return lengths[order], frames[order]


def bucket_of(length: int, buckets: Sequence[int]) -> int:
    """The smallest bucket that holds ``length`` (texts never exceed the
    last one here)."""
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(f"length {length} past the last bucket {buckets[-1]}")


def mel_bucket(frames: int, step: int, cap: int) -> int:
    return min(step * math.ceil(frames / step), cap)
