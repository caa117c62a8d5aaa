"""Exact C-integer helpers (the port's copy of the parts of
``tpu_ffv1/core/intmath.py`` it calls).

Behavioral parity references: libavutil/intmath.h (av_log2),
libavutil/common.h (AV_CEIL_RSHIFT).
"""
from __future__ import annotations


def av_log2(v: int) -> int:
    """Index of the highest set bit; av_log2(0) == 0."""
    return v.bit_length() - 1 if v > 0 else 0


def ceil_rshift(a: int, s: int) -> int:
    """AV_CEIL_RSHIFT."""
    return -((-a) >> s)
