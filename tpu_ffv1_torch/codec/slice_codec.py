"""Per-slice scalar encode of PCM slices (slice_coding_mode 1).

What the version-4 PCM retry (ffv1enc.c:1207-1217) needs of
``tpu_ffv1/codec/slice_codec.py``: ``encode_line``'s PCM branch, run by
``encode_plane`` and ``encode_rgb_frame``.  A PCM slice codes each raw
sample's bits, most significant first, each through a fresh 128 state of
the range coder (ffv1enc.c:294-303): no context, no prediction, no RCT,
and no adaptive state read or advanced, so the row buffers, edge fills
and plane indices of the other modes are left out.  Sequential numpy, as
the original; it runs on the host for the rare slice whose range-coded
bytes would overflow the reference's buffer budget.

Behavioral parity references: libavcodec/ffv1enc.c:271-303 (encode_line,
PCM), :373-411 (encode_plane), :413-473 (encode_rgb_frame).
"""
from __future__ import annotations

import numpy as np


def put_pcm(rc, row, bits: int):
    """One line in PCM (ffv1enc.c:294-303): each sample's ``bits`` low
    bits, most significant first, each through a fresh 128 state."""
    state = np.full(1, 128, dtype=np.uint8)
    for v in row.tolist():
        for i in range(bits - 1, -1, -1):
            state[0] = 128
            rc.put_rac(state, 0, (v >> i) & 1)


def encode_plane_pcm(rc, src: np.ndarray, bits: int, packed_at_lsb: bool):
    """One (h, w) plane of a slice in PCM (ffv1enc.c:373-411): above 8
    bits the samples are shifted down to ``bits`` unless packed at the
    LSB, then wrapped to the reference's int16_t sample buffer (which
    matters only at 16 bits)."""
    for row in src:
        vals = row.astype(np.int64)
        if bits > 8:
            if not packed_at_lsb:
                vals >>= 16 - bits
            vals = ((vals + 0x8000) & 0xFFFF) - 0x8000
        put_pcm(rc, vals, bits)


def encode_rgb_pcm(rc, planes, bits: int, alpha: bool):
    """One slice of RGB in PCM (ffv1enc.c:413-473): each row's G, B, R
    (and A) lines, untransformed, at the samples' own width ``bits``.
    ``planes``: an (h, w, 4) uint8 array in B, G, R, A memory order, or
    the three (h, w) uint16 planes of gbrp in FFmpeg's order, of which
    the reference reads plane 0 as "b" and plane 1 as "g"
    (ffv1enc.c:441-444)."""
    if isinstance(planes, np.ndarray) and planes.ndim == 3:
        b, g, r, a = (planes[..., k] for k in range(4))
    else:
        b, g, r = planes
        a = np.zeros_like(g)            # the reference codes A as 0 here
    lines = (g, b, r) + ((a,) if alpha else ())
    for y in range(len(g)):
        for line in lines:
            put_pcm(rc, line[y].astype(np.int64), bits)
