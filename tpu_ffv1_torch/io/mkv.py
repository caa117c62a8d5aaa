"""Minimal Matroska (EBML) mux/demux for FFV1 interop.

FFV1-in-MKV is the canonical archival pairing.  The reference (FFmpeg
3.0 era) predates the native "V_FFV1" CodecID and carries FFV1 via
"V_MS/VFW/FOURCC" — a BITMAPINFOHEADER in CodecPrivate with the 'FFV1'
fourcc and the global header appended (libavformat/riff.c:316 mapping,
matroskaenc.c VFW path).  The muxer writes that form; the demuxer
accepts both V_MS/VFW/FOURCC and modern V_FFV1.  Interop-level (ffmpeg
demuxes our files and vice versa), not byte-identical to ffmpeg's muxer.

The port's own copy of ``tpu_ffv1/io/mkv.py``, trimmed to what the
port reaches.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

# EBML element IDs (Matroska spec)
EBML = 0x1A45DFA3
SEGMENT = 0x18538067
INFO = 0x1549A966
TIMESTAMP_SCALE = 0x2AD7B1
MUXING_APP = 0x4D80
WRITING_APP = 0x5741
DURATION = 0x4489
TRACKS = 0x1654AE6B
TRACK_ENTRY = 0xAE
TRACK_NUMBER = 0xD7
TRACK_UID = 0x73C5
TRACK_TYPE = 0x83
CODEC_ID = 0x86
CODEC_PRIVATE = 0x63A2
VIDEO = 0xE0
PIXEL_WIDTH = 0xB0
PIXEL_HEIGHT = 0xBA
DEFAULT_DURATION = 0x23E383
CLUSTER = 0x1F43B675
CLUSTER_TIMESTAMP = 0xE7
SIMPLE_BLOCK = 0xA3
DOC_TYPE = 0x4282
DOC_TYPE_VERSION = 0x4287
DOC_TYPE_READ_VERSION = 0x4285
EBML_VERSION = 0x4286
EBML_READ_VERSION = 0x42F7
EBML_MAX_ID = 0x42F2
EBML_MAX_SIZE = 0x42F3


def _id_bytes(eid: int) -> bytes:
    out = []
    while eid:
        out.append(eid & 0xFF)
        eid >>= 8
    return bytes(reversed(out))


def _vint(value: int, min_len: int = 1) -> bytes:
    """EBML variable-size integer (length marker in the first byte)."""
    for length in range(min_len, 9):
        if value < (1 << (7 * length)) - 1:
            b = value | (1 << (7 * length))
            return b.to_bytes(length, "big")
    raise ValueError("vint overflow")


def _elem(eid: int, payload: bytes) -> bytes:
    return _id_bytes(eid) + _vint(len(payload)) + payload


def _uint_payload(v: int) -> bytes:
    n = max(1, (v.bit_length() + 7) // 8)
    return v.to_bytes(n, "big")


def _float_payload(v: float) -> bytes:
    return struct.pack(">d", v)


@dataclass
class MkvStream:
    width: int = 0
    height: int = 0
    fps: tuple = (25, 1)
    extradata: bytes = b""
    codec_id: str = ""
    packets: list = field(default_factory=list)
    keyflags: list = field(default_factory=list)


def write_mkv(path: str, st: MkvStream):
    rate, scale = st.fps
    frame_ns = int(1e9 * scale / rate) if rate else 40_000_000
    tscale = 1_000_000  # 1 ms ticks

    ebml = _elem(EBML, b"".join([
        _elem(EBML_VERSION, _uint_payload(1)),
        _elem(EBML_READ_VERSION, _uint_payload(1)),
        _elem(EBML_MAX_ID, _uint_payload(4)),
        _elem(EBML_MAX_SIZE, _uint_payload(8)),
        _elem(DOC_TYPE, b"matroska"),
        _elem(DOC_TYPE_VERSION, _uint_payload(2)),
        _elem(DOC_TYPE_READ_VERSION, _uint_payload(2)),
    ]))

    info = _elem(INFO, b"".join([
        _elem(TIMESTAMP_SCALE, _uint_payload(tscale)),
        _elem(MUXING_APP, b"tpu_ffv1"),
        _elem(WRITING_APP, b"tpu_ffv1"),
        _elem(DURATION, _float_payload(
            len(st.packets) * frame_ns / tscale)),
    ]))

    # V_MS/VFW/FOURCC: BITMAPINFOHEADER + extradata (riff.c form)
    bmp = struct.pack("<IiiHHIIiiII", 40 + len(st.extradata),
                      st.width, st.height, 1, 24,
                      int.from_bytes(b"FFV1", "little"),
                      0, 0, 0, 0, 0) + st.extradata
    track_payload = [
        _elem(TRACK_NUMBER, _uint_payload(1)),
        _elem(TRACK_UID, _uint_payload(1)),
        _elem(TRACK_TYPE, _uint_payload(1)),          # video
        _elem(DEFAULT_DURATION, _uint_payload(frame_ns)),
        _elem(CODEC_ID, b"V_MS/VFW/FOURCC"),
        _elem(CODEC_PRIVATE, bmp),
    ]
    track_payload.append(_elem(VIDEO, b"".join([
        _elem(PIXEL_WIDTH, _uint_payload(st.width)),
        _elem(PIXEL_HEIGHT, _uint_payload(st.height)),
    ])))
    tracks = _elem(TRACKS, _elem(TRACK_ENTRY, b"".join(track_payload)))

    clusters = []
    for i, pkt in enumerate(st.packets):
        ts = i * frame_ns // tscale
        key = st.keyflags[i] if i < len(st.keyflags) else True
        block = (_vint(1) +                      # track number
                 struct.pack(">h", 0) +          # relative timestamp
                 bytes([0x80 if key else 0x00]) +  # flags: keyframe
                 bytes(pkt))
        clusters.append(_elem(CLUSTER, b"".join([
            _elem(CLUSTER_TIMESTAMP, _uint_payload(ts)),
            _elem(SIMPLE_BLOCK, block),
        ])))

    segment_payload = info + tracks + b"".join(clusters)
    with open(path, "wb") as f:
        f.write(ebml)
        f.write(_id_bytes(SEGMENT) + _vint(len(segment_payload), 8))
        f.write(segment_payload)


# ---------------------------------------------------------------------------


def _read_id(buf, pos):
    first = buf[pos]
    for length in range(1, 5):
        if first & (0x80 >> (length - 1)):
            return int.from_bytes(buf[pos:pos + length], "big"), pos + length
    raise ValueError("bad EBML id")


def _read_size(buf, pos):
    first = buf[pos]
    for length in range(1, 9):
        if first & (0x80 >> (length - 1)):
            raw = int.from_bytes(buf[pos:pos + length], "big")
            size = raw & ((1 << (7 * length)) - 1)
            unknown = size == (1 << (7 * length)) - 1
            return (None if unknown else size), pos + length
    raise ValueError("bad EBML size")


def read_mkv(path: str) -> MkvStream:
    with open(path, "rb") as f:
        buf = f.read()
    st = MkvStream()

    def walk(pos, end, depth=0):
        while pos < end - 1:
            try:
                eid, pos = _read_id(buf, pos)
                size, pos = _read_size(buf, pos)
            except (ValueError, IndexError):
                return
            psize = (end - pos) if size is None else size
            pend = pos + psize
            if eid in (SEGMENT, TRACKS, TRACK_ENTRY, CLUSTER, VIDEO):
                walk(pos, pend, depth + 1)
            elif eid == CODEC_ID:
                st.codec_id = buf[pos:pend].decode("ascii", "replace")
            elif eid == CODEC_PRIVATE:
                priv = buf[pos:pend]
                if st.codec_id == "V_MS/VFW/FOURCC" and len(priv) >= 40:
                    bisize = int.from_bytes(priv[:4], "little")
                    st.extradata = priv[40:bisize] if bisize > 40 else b""
                else:
                    st.extradata = priv
            elif eid == PIXEL_WIDTH:
                st.width = int.from_bytes(buf[pos:pend], "big")
            elif eid == PIXEL_HEIGHT:
                st.height = int.from_bytes(buf[pos:pend], "big")
            elif eid == DEFAULT_DURATION:
                ns = int.from_bytes(buf[pos:pend], "big")
                if ns:
                    st.fps = (round(1e9 / ns), 1)
            elif eid == SIMPLE_BLOCK or eid == 0xA1:  # Block(Group) data
                p = pos
                _tn, p = _read_size(buf, p)  # track number (vint value)
                p += 2                       # relative timestamp
                flags = buf[p]
                p += 1
                st.packets.append(buf[p:pend])
                st.keyflags.append(bool(flags & 0x80))
            pos = pend

    if buf[:4] != _id_bytes(EBML):
        raise ValueError("not an EBML/Matroska file")
    walk(0, len(buf))
    return st
