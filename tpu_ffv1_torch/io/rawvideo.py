"""Raw planar frame I/O (the framework's rawvideo demuxer/muxer analog;
reference: libavformat/rawvideodec.c and FATE's .yuv fixtures).

The port's own copy of ``tpu_ffv1/io/rawvideo.py``.
"""
from __future__ import annotations

import numpy as np

from ..core.intmath import ceil_rshift
from ..codec.pixfmt import get_pix_fmt


def frame_shape(pix_fmt: str, width: int, height: int):
    """List of (shape, dtype) per stored plane for one frame."""
    fmt = get_pix_fmt(pix_fmt)
    dt = np.uint8 if fmt.bits <= 8 else np.uint16
    if fmt.colorspace == 1:
        if fmt.bits <= 8:
            return [((height, width, 4), np.uint8)]
        return [((height, width), np.uint16)] * 3
    if fmt.interleaved:  # ya8
        return [((height, width, 2), np.uint8)]
    shapes = [((height, width), dt)]
    if fmt.chroma_planes:
        ch = ceil_rshift(height, fmt.chroma_v_shift)
        cw = ceil_rshift(width, fmt.chroma_h_shift)
        shapes += [((ch, cw), dt)] * 2
    if fmt.transparency:
        shapes.append(((height, width), dt))
    return shapes


def frame_size_bytes(pix_fmt: str, width: int, height: int) -> int:
    return sum(int(np.prod(s)) * np.dtype(d).itemsize
               for s, d in frame_shape(pix_fmt, width, height))


def read_frames(path: str, pix_fmt: str, width: int, height: int):
    """Read all frames of a raw planar file (little-endian 16-bit)."""
    shapes = frame_shape(pix_fmt, width, height)
    fsz = frame_size_bytes(pix_fmt, width, height)
    frames = []
    with open(path, "rb") as f:
        data = f.read()
    n = len(data) // fsz
    for i in range(n):
        off = i * fsz
        planes = []
        for shape, dt in shapes:
            nbytes = int(np.prod(shape)) * np.dtype(dt).itemsize
            planes.append(np.frombuffer(
                data, dtype="<u2" if dt == np.uint16 else np.uint8,
                count=int(np.prod(shape)), offset=off).reshape(shape)
                .astype(dt))
            off += nbytes
        frames.append(planes)
    return frames


def write_frames(path: str, frames):
    with open(path, "wb") as f:
        for planes in frames:
            for p in planes:
                arr = np.asarray(p)
                if arr.dtype == np.uint16:
                    f.write(arr.astype("<u2").tobytes())
                else:
                    f.write(arr.astype(np.uint8).tobytes())
