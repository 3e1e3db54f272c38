"""Static length buckets for the serving paths.

The port's copy of the JAX package's ``text_bucket`` and ``mel_bucket``:
every batch is padded to one of a few fixed text lengths, and a vocoder
request to a multiple of a fixed number of mel frames, so the serving hot
path sees a bounded set of shapes.
"""

from __future__ import annotations

import math
import warnings
from typing import Sequence

_EXTENSION_WARNED: set = set()


def text_bucket(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length.

    Lengths beyond the last configured bucket AUTO-EXTEND the grid (next
    multiple of the last inter-bucket spacing) rather than clamping: a clamp
    would silently truncate the transcript tail. A warning (once per
    extended shape) flags the config as undersized.
    """
    for b in buckets:
        if length <= b:
            return b
    spacing = buckets[-1] - buckets[-2] if len(buckets) >= 2 else buckets[-1]
    extended = (buckets[-1]
                + spacing * math.ceil((length - buckets[-1]) / spacing))
    key = (tuple(buckets), extended)
    if key not in _EXTENSION_WARNED:
        _EXTENSION_WARNED.add(key)
        warnings.warn(
            f"text length {length} exceeds the largest configured text "
            f"bucket {buckets[-1]}; auto-extending to a {extended} bucket "
            f"(one extra shape). Add larger text_buckets to the config to "
            f"silence this.", stacklevel=2)
    return extended


def mel_bucket(length: int, step: int, max_length: int) -> int:
    """Smallest multiple of ``step`` >= length, capped at ``max_length``."""
    return min(step * math.ceil(length / step), max_length)
