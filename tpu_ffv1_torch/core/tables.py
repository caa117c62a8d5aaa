"""Normative FFV1 constant tables.

These are *specification data* for the FFV1 bitstream (quantization tables,
the version-2+ default state-transition table).  They are re-derived from
their mathematical structure where possible; the state-transition table is
normative opaque data from the FFV1 specification.

The port's copy of ``tpu_ffv1/core/tables.py``.

Behavioral parity references (reference tree, read-only):
  - quant tables:       libavcodec/ffv1enc.c:44-118 (quant5/quant5_10bit/
                        quant9_10bit/quant11), combined at ffv1enc.c:846-867
  - ver2 state table:   libavcodec/ffv1enc.c:120-137 (also normative in the
                        IETF FFV1 spec, "default state transition")
  - context counts:     libavcodec/ffv1enc.c:868-869
  - log2 run table:     libavcodec/bitstream.c:40-48 (ff_log2_run)
"""
from __future__ import annotations

import numpy as np

MAX_PLANES = 4
CONTEXT_SIZE = 32
MAX_QUANT_TABLES = 8
MAX_SLICES = 256

# Coder kinds (ffv1.h:56-59)
AC_GOLOMB_RICE = 0
AC_RANGE_DEFAULT_TAB = 1
AC_RANGE_CUSTOM_TAB = 2
AC_RANGE_DEFAULT_TAB_FORCE = -2


def _quant_from_thresholds(thresholds: list[int]) -> np.ndarray:
    """Build a symmetric 256-entry signed-difference quantizer.

    Index i encodes the difference d = i for i<128 and d = i-256 for i>=128.
    ``thresholds[k]`` is the smallest |d| mapped to level k+1.  The negative
    side mirrors the positive one, with index 128 (d = -128) mapped like
    -|d_max| (i.e. -level(127)).
    """
    pos = np.zeros(128, dtype=np.int32)
    for level, t in enumerate(thresholds, start=1):
        pos[t:] = level
    tab = np.zeros(256, dtype=np.int32)
    tab[:128] = pos
    tab[129:] = -pos[127:0:-1]
    tab[128] = -pos[127]
    return tab


# 8-bit-depth quantizers (ffv1enc.c:63-80, :101-118)
QUANT5 = _quant_from_thresholds([1, 4])
QUANT11 = _quant_from_thresholds([1, 2, 5, 12, 35])
# >8-bit-depth quantizers (ffv1enc.c:44-61, :82-99)
QUANT5_10BIT = _quant_from_thresholds([11, 50])
QUANT9_10BIT = _quant_from_thresholds([5, 13, 27, 56])


def default_quant_tables(bits_per_raw_sample: int) -> np.ndarray:
    """The encoder's two built-in quant-table sets (ffv1enc.c:846-867).

    Returns int16 array of shape (2, 5, 256): table set 0 is the 3-input
    model (11*11*11 contexts), set 1 the 5-input model (11*11*5*5*5).
    """
    if bits_per_raw_sample <= 8:
        q11, q5 = QUANT11, QUANT5
    else:
        q11, q5 = QUANT9_10BIT, QUANT5_10BIT
    tabs = np.zeros((2, 5, 256), dtype=np.int16)
    tabs[0, 0] = q11
    tabs[0, 1] = 11 * q11
    tabs[0, 2] = 11 * 11 * q11
    tabs[1, 0] = q11
    tabs[1, 1] = 11 * q11
    tabs[1, 2] = 11 * 11 * q5
    tabs[1, 3] = 5 * 11 * 11 * q5
    tabs[1, 4] = 5 * 5 * 11 * 11 * q5
    return tabs


# Context counts for the two built-in models (ffv1enc.c:868-869).  The
# halving reflects sign symmetry: ctx and -ctx share (sign-flipped) state.
CONTEXT_COUNTS = ((11 * 11 * 11 + 1) // 2, (11 * 11 * 5 * 5 * 5 + 1) // 2)


# Default state-transition table for coder=AC_RANGE_CUSTOM_TAB ("ver2"),
# normative opaque data (ffv1enc.c:120-137; FFV1 spec "default state
# transition" table).
VER2_STATE = np.array([
      0,  10,  10,  10,  10,  16,  16,  16,  28,  16,  16,  29,  42,  49,  20,  49,
     59,  25,  26,  26,  27,  31,  33,  33,  33,  34,  34,  37,  67,  38,  39,  39,
     40,  40,  41,  79,  43,  44,  45,  45,  48,  48,  64,  50,  51,  52,  88,  52,
     53,  74,  55,  57,  58,  58,  74,  60, 101,  61,  62,  84,  66,  66,  68,  69,
     87,  82,  71,  97,  73,  73,  82,  75, 111,  77,  94,  78,  87,  81,  83,  97,
     85,  83,  94,  86,  99,  89,  90,  99, 111,  92,  93, 134,  95,  98, 105,  98,
    105, 110, 102, 108, 102, 118, 103, 106, 106, 113, 109, 112, 114, 112, 116, 125,
    115, 116, 117, 117, 126, 119, 125, 121, 121, 123, 145, 124, 126, 131, 127, 129,
    165, 130, 132, 138, 133, 135, 145, 136, 137, 139, 146, 141, 143, 142, 144, 148,
    147, 155, 151, 149, 151, 150, 152, 157, 153, 154, 156, 168, 158, 162, 161, 160,
    172, 163, 169, 164, 166, 184, 167, 170, 177, 174, 171, 173, 182, 176, 180, 178,
    175, 189, 179, 181, 186, 183, 192, 185, 200, 187, 191, 188, 190, 197, 193, 196,
    197, 194, 195, 196, 198, 202, 199, 201, 210, 203, 207, 204, 205, 206, 208, 214,
    209, 211, 221, 212, 213, 215, 224, 216, 217, 218, 219, 220, 222, 228, 223, 225,
    226, 224, 227, 229, 240, 230, 231, 232, 233, 234, 235, 236, 238, 239, 237, 242,
    241, 243, 242, 244, 245, 246, 247, 248, 249, 250, 251, 252, 252, 253, 254, 255,
], dtype=np.uint8)


def _log2_run() -> np.ndarray:
    """Run-length code table (bitstream.c:40-48): geometric ramp of run
    exponents: 4x{0,1,2,3}, 2x{4..7}, then 8..24."""
    out = [v for v in range(4) for _ in range(4)]
    out += [v for v in range(4, 8) for _ in range(2)]
    out += list(range(8, 25))
    return np.array(out, dtype=np.int32)


LOG2_RUN = _log2_run()
assert LOG2_RUN.shape == (41,)
