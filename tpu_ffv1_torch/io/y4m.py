"""YUV4MPEG2 (.y4m) muxer/demuxer analog.

Stream layout mirrors the reference (libavformat/yuv4mpegenc.c:29-141,
yuv4mpegdec.c): an ASCII stream header
``YUV4MPEG2 W<w> H<h> F<num>:<den> I<p|t|b> A<n>:<d>[ C<tag>...]\n``
followed by per-frame ``FRAME[ params]\n`` + raw planes (Y, Cb, Cr),
>8-bit samples little-endian, chroma dims ceil-shifted.

Only progressive streams are produced; the demuxer accepts any
interlacing tag but returns plain planar frames (field handling is the
caller's concern, as in rawvideo).

The port's own copy of ``tpu_ffv1/io/y4m.py``: the file reader and
writers, and the stream readers the streaming server ingests a
publisher's socket with.
"""
from __future__ import annotations

import numpy as np

from ..core.intmath import ceil_rshift
from ..codec.pixfmt import get_pix_fmt

# colorspace tag <-> pix_fmt (yuv4mpegenc.c:69-136).  Writing picks the
# first tag listed for a format; reading accepts every alias.
_WRITE_TAGS = {
    "gray8": "Cmono",
    "gray16le": "Cmono16",
    "yuv411p": "C411 XYSCSS=411",
    # no chroma-location metadata in this framework's frames ->
    # the reference's default branch (C420jpeg)
    "yuv420p": "C420jpeg XYSCSS=420JPEG",
    "yuv422p": "C422 XYSCSS=422",
    "yuv444p": "C444 XYSCSS=444",
}
for _b in (9, 10, 12, 14, 16):
    for _c in ("420", "422", "444"):
        _WRITE_TAGS[f"yuv{_c}p{_b}le"] = f"C{_c}p{_b} XYSCSS={_c}P{_b}"

_READ_TAGS = {
    "mono": "gray8",
    "mono16": "gray16le",
    "411": "yuv411p",
    "420jpeg": "yuv420p",
    "420mpeg2": "yuv420p",
    "420paldv": "yuv420p",
    "420": "yuv420p",
    "422": "yuv422p",
    "444": "yuv444p",
}
for _b in (9, 10, 12, 14, 16):
    for _c in ("420", "422", "444"):
        _READ_TAGS[f"{_c}p{_b}"] = f"yuv{_c}p{_b}le"


def _plane_dims(fmt, width, height):
    dims = [(height, width)]
    if fmt.chroma_planes:
        ch = ceil_rshift(height, fmt.chroma_v_shift)
        cw = ceil_rshift(width, fmt.chroma_h_shift)
        dims += [(ch, cw)] * 2
    return dims


def write_y4m(path: str, frames, pix_fmt: str, width: int, height: int,
              fps=(25, 1)):
    """Write planar frames as a YUV4MPEG2 stream.

    ``frames``: iterable of per-plane numpy lists (the framework's
    colorspace-0 convention).  Alpha and RGB formats are not
    representable in y4m (same set the reference muxer rejects,
    yuv4mpegenc.c:205-210).
    """
    with open(path, "wb") as f:
        write_y4m_stream(f, frames, pix_fmt, width, height, fps)


def write_y4m_stream(f, frames, pix_fmt: str, width: int, height: int,
                     fps=(25, 1)):
    """Write the YUV4MPEG2 byte stream to an open binary file object
    (the streaming form the ffserver analog uses; same wire bytes as
    write_y4m)."""
    fmt = get_pix_fmt(pix_fmt)
    tag = _WRITE_TAGS.get(fmt.name)
    if tag is None or fmt.transparency:
        raise ValueError(f"pix_fmt {pix_fmt!r} not representable in "
                         "yuv4mpegpipe")
    dims = _plane_dims(fmt, width, height)
    f.write(f"YUV4MPEG2 W{width} H{height} F{fps[0]}:{fps[1]} "
            f"Ip A0:0 {tag}\n".encode())
    for planes in frames:
        if not isinstance(planes, (list, tuple)):
            planes = [planes]
        if len(planes) != len(dims):
            raise ValueError("plane count mismatch")
        f.write(b"FRAME\n")
        for p, d in zip(planes, dims):
            arr = np.asarray(p)
            if arr.shape != d:
                raise ValueError(f"plane shape {arr.shape} != {d}")
            if fmt.bits > 8:
                f.write(arr.astype("<u2").tobytes())
            else:
                f.write(arr.astype(np.uint8).tobytes())


def parse_y4m_header(line: bytes):
    """Parse the ``YUV4MPEG2 ...`` stream-header line ->
    (pix_fmt, width, height, (fps_num, fps_den))."""
    if not line.startswith(b"YUV4MPEG2"):
        raise ValueError("not a YUV4MPEG2 stream")
    width = height = 0
    fps = (25, 1)
    pix_fmt = "yuv420p"   # tag-less streams default to 4:2:0 (spec)
    for tok in line.decode("ascii", "replace").split(" ")[1:]:
        if not tok:
            continue
        key, val = tok[0], tok[1:]
        if key == "W":
            width = int(val)
        elif key == "H":
            height = int(val)
        elif key == "F":
            num, den = val.split(":")
            fps = (int(num), int(den))
        elif key == "C":
            base = val.split(",")[0].lower()
            if base not in _READ_TAGS:
                raise ValueError(f"unsupported y4m colorspace C{val}")
            pix_fmt = _READ_TAGS[base]
    if width <= 0 or height <= 0:
        raise ValueError("y4m header missing W/H")
    return pix_fmt, width, height, fps


def _read_line(f, limit=4096):
    """Read up to LF from a binary stream without over-reading past it
    (socket feeds can't be seeked back)."""
    buf = bytearray()
    while len(buf) < limit:
        b = f.read(1)
        if not b:
            break
        if b == b"\n":
            return bytes(buf)
        buf += b
    if len(buf) >= limit:
        raise ValueError("y4m header line too long")
    return bytes(buf) if buf else None


def read_y4m_stream_header(f):
    """Incremental form of the header parse for live ingestion (the
    ffserver-analog feed reads its publisher's socket with this) ->
    (pix_fmt, width, height, fps).  Raises on garbage, returns None on
    immediate EOF."""
    line = _read_line(f)
    if line is None:
        return None
    return parse_y4m_header(line)


def read_y4m_stream_frame(f, pix_fmt: str, width: int, height: int):
    """Read one FRAME from an open binary stream -> plane list, or
    None on clean EOF (publisher closed between frames)."""
    line = _read_line(f)
    if line is None:
        return None
    if not line.startswith(b"FRAME"):
        raise ValueError("bad y4m frame header")
    fmt = get_pix_fmt(pix_fmt)
    dims = _plane_dims(fmt, width, height)
    itemsz = 2 if fmt.bits > 8 else 1
    planes = []
    for h, w in dims:
        need = h * w * itemsz
        chunks = bytearray()
        while len(chunks) < need:
            b = f.read(need - len(chunks))
            if not b:
                raise ValueError("truncated y4m frame")
            chunks += b
        a = np.frombuffer(bytes(chunks),
                          "<u2" if itemsz == 2 else np.uint8).reshape(h, w)
        planes.append(a.astype(np.uint16 if itemsz == 2 else np.uint8))
    return planes


def read_y4m(path: str):
    """Read a YUV4MPEG2 stream -> (frames, pix_fmt, width, height,
    (fps_num, fps_den))."""
    with open(path, "rb") as f:
        data = f.read()
    nl = data.find(b"\n")
    if nl < 0:
        raise ValueError("not a YUV4MPEG2 stream")
    pix_fmt, width, height, fps = parse_y4m_header(data[:nl])
    fmt = get_pix_fmt(pix_fmt)
    dims = _plane_dims(fmt, width, height)
    itemsz = 2 if fmt.bits > 8 else 1
    fsz = sum(h * w for h, w in dims) * itemsz
    frames = []
    pos = nl + 1
    while pos < len(data):
        nl = data.find(b"\n", pos)
        if nl < 0:
            break
        if data[pos:pos + 5] != b"FRAME":
            raise ValueError(f"bad frame header at byte {pos}")
        pos = nl + 1
        if pos + fsz > len(data):
            break   # truncated trailing frame: drop, as the reference does
        planes = []
        for h, w in dims:
            n = h * w
            a = np.frombuffer(data, "<u2" if itemsz == 2 else np.uint8,
                              count=n, offset=pos).reshape(h, w)
            planes.append(a.astype(np.uint16 if itemsz == 2 else np.uint8))
            pos += n * itemsz
        frames.append(planes)
    return frames, pix_fmt, width, height, fps
