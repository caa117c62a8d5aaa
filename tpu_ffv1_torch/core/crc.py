"""CRC-32 (IEEE poly, FFmpeg av_crc bit order) used for FFV1 error
detection (global-header CRC and per-slice CRCs).

The port's copy of ``tpu_ffv1/core/crc.py``, whose table and
byte-at-a-time loop are the normative definition.  The port computes the
same checksum through ``zlib.crc32``: av_crc with that table is the
MSB-first CRC-32 (poly 0x04C11DB7, no reflection, no final xor) kept
byte-swapped, and an MSB-first CRC is the bit-reversal of the reflected
CRC (zlib's) over bit-reversed bytes.  ``tests/test_torch_host.py`` holds
it against ``tpu_ffv1.core.crc`` on random bytes.

Behavioral parity reference: libavutil/crc.c:310-341 (table build, le=0,
bits=32, poly 0x04C11DB7, byte-swapped entries) and :357-378 (update loop).
The resulting checksum has the property that appending the little-endian
32-bit CRC makes the CRC of the whole buffer zero — which is exactly how
the FFV1 decoder validates (ffv1dec.c:609-618, :963-980).
"""
from __future__ import annotations

import zlib

# bit reversal of every byte value, as a bytes.translate table
_REV8 = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _rev32(v: int) -> int:
    return int(f"{v & 0xFFFFFFFF:032b}"[::-1], 2)


def _bswap32(v: int) -> int:
    return int.from_bytes((v & 0xFFFFFFFF).to_bytes(4, "big"), "little")


def crc32_ieee(data: bytes, crc: int = 0) -> int:
    """av_crc(AV_CRC_32_IEEE) — returns the 32-bit checksum."""
    # av_crc's register is the MSB-first register byte-swapped; zlib
    # keeps the reflected register, inverted before and after
    start = _rev32(_bswap32(crc)) ^ 0xFFFFFFFF
    reflected = zlib.crc32(bytes(data).translate(_REV8), start) ^ 0xFFFFFFFF
    return _bswap32(_rev32(reflected))
