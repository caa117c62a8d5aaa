"""Range-coded symbol layer: FFV1's unsigned/signed exp-Golomb-style
bitplane code over 32-state context vectors.

The port's copy of ``tpu_ffv1/bitstream/symbols.py`` (the two-pass
statistics hook of ``put_symbol`` is left out: the port has no two-pass
mode).

Behavioral parity references: libavcodec/ffv1enc.c:185-231
(put_symbol_inline), libavcodec/ffv1dec.c:42-63 (get_symbol_inline).

State layout within a 32-byte context (CONTEXT_SIZE):
  [0]      zero flag
  [1..10]  exponent unary chain (capped at 10)
  [11..21] sign, indexed by min(e,10)
  [22..31] mantissa bitplanes, indexed by min(i,9)
"""
from __future__ import annotations

from ..core.intmath import av_log2
from ..core.rac import RangeDecoder, RangeEncoder


def put_symbol(c: RangeEncoder, states, v: int, is_signed: bool):
    """Code one integer symbol; ``states`` is a mutable 32-entry uint8 view."""
    def bit(idx, b):
        c.put_rac(states, idx, b)

    if v:
        a = abs(v)
        e = av_log2(a)
        bit(0, 0)
        if e <= 9:
            for i in range(e):
                bit(1 + i, 1)
            bit(1 + e, 0)
            for i in range(e - 1, -1, -1):
                bit(22 + i, (a >> i) & 1)
            if is_signed:
                bit(11 + e, v < 0)
        else:
            for i in range(e):
                bit(1 + min(i, 9), 1)
            bit(1 + 9, 0)
            for i in range(e - 1, -1, -1):
                bit(22 + min(i, 9), (a >> i) & 1)
            if is_signed:
                bit(11 + 10, v < 0)
    else:
        bit(0, 1)


def get_symbol(c: RangeDecoder, states, is_signed: bool) -> int:
    """Decode one integer symbol (mirror of put_symbol)."""
    if c.get_rac(states, 0):
        return 0
    e = 0
    while c.get_rac(states, 1 + min(e, 9)):
        e += 1
        if e > 31:
            raise ValueError("invalid symbol exponent")
    a = 1
    for i in range(e - 1, -1, -1):
        a += a + c.get_rac(states, 22 + min(i, 9))
    neg = -(is_signed and c.get_rac(states, 11 + min(e, 10)))
    return (a ^ neg) - neg
