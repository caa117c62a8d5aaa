"""Minimal AVI container read/write for FFV1 interop.

Enough of RIFF/AVI to exchange streams with the reference tooling
(fourcc mapping: libavformat/riff.c:316 {FFV1, 'FFV1'}; FATE container:
tests/fate/vcodec.mak FMT=avi).  The reader accepts ffmpeg-written files
(skips JUNK/odml chunks); the writer produces files ffmpeg can demux.

The port's own copy of ``tpu_ffv1/io/avi.py``.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field


@dataclass
class AviStream:
    fourcc: str = "FFV1"
    width: int = 0
    height: int = 0
    fps: tuple = (25, 1)
    extradata: bytes = b""
    packets: list = field(default_factory=list)   # list[bytes]
    keyflags: list = field(default_factory=list)  # list[bool]


def _chunks(buf: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        tag = buf[pos:pos + 4]
        size = struct.unpack("<I", buf[pos + 4:pos + 8])[0]
        yield tag, pos + 8, size
        pos += 8 + size + (size & 1)


def read_avi(path: str) -> AviStream:
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"RIFF" or buf[8:12] != b"AVI ":
        raise ValueError("not an AVI file")
    st = AviStream()
    vid_stream_index = -1
    stream_counter = 0
    idx_flags = {}

    def walk(start, end):
        nonlocal vid_stream_index, stream_counter
        for tag, dstart, size in _chunks(buf, start, end):
            dend = dstart + size
            if tag == b"LIST":
                walk(dstart + 4, dend)
            elif tag == b"strh":
                fcc_type = buf[dstart:dstart + 4]
                if fcc_type == b"vids":
                    vid_stream_index = stream_counter
                    st.fourcc = buf[dstart + 4:dstart + 8].decode(
                        "ascii", "replace")
                    scale, rate = struct.unpack(
                        "<II", buf[dstart + 20:dstart + 28])
                    if scale and rate:
                        st.fps = (rate, scale)
                stream_counter += 1
            elif tag == b"strf" and vid_stream_index == stream_counter - 1 \
                    and not st.width:
                (bisize, w, h) = struct.unpack("<Iii", buf[dstart:dstart + 12])
                st.width, st.height = w, abs(h)
                if size > 40:
                    st.extradata = buf[dstart + 40:dstart + size]
            elif tag == b"idx1":
                for off in range(dstart, dend, 16):
                    ckid = buf[off:off + 4]
                    flags = struct.unpack("<I", buf[off + 4:off + 8])[0]
                    if ckid[2:4] in (b"dc", b"db"):
                        idx_flags[len(idx_flags)] = bool(flags & 0x10)
            elif len(tag) == 4 and tag[2:4] in (b"dc", b"db") and \
                    tag[:2].isdigit():
                if int(tag[:2]) == max(vid_stream_index, 0):
                    st.packets.append(buf[dstart:dend])

    walk(12, len(buf))
    st.keyflags = [idx_flags.get(i, True) for i in range(len(st.packets))]
    return st


def write_avi(path: str, st: AviStream):
    frames = len(st.packets)
    rate, scale = st.fps
    usec_per_frame = int(1_000_000 * scale / rate) if rate else 40000

    strf_data = struct.pack(
        "<IiiHHIIiiII", 40 + len(st.extradata), st.width, st.height, 1, 0,
        int.from_bytes(st.fourcc.encode("ascii"), "little"), 0, 0, 0, 0, 0,
    ) + st.extradata

    strh = struct.pack(
        "<4s4sIHHIIIIIIIIhhhh", b"vids",
        st.fourcc.encode("ascii"), 0, 0, 0, 0,
        scale, rate, 0, frames, 0, 0xFFFFFFFF, 0, 0, 0, st.width, st.height)

    def chunk(tag: bytes, data: bytes) -> bytes:
        pad = b"\x00" if len(data) & 1 else b""
        return tag + struct.pack("<I", len(data)) + data + pad

    def lst(tag: bytes, data: bytes) -> bytes:
        return chunk(b"LIST", tag + data)

    strl = lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf_data))

    avih = struct.pack(
        "<IIIIIIIIIIIIII", usec_per_frame, 0, 0, 0x10, frames, 0, 1,
        1024 * 1024, st.width, st.height, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + strl)

    movi_parts = []
    offsets = []
    pos = 4  # after 'movi'
    for pkt in st.packets:
        offsets.append(pos)
        c = chunk(b"00dc", pkt)
        movi_parts.append(c)
        pos += len(c)
    movi = lst(b"movi", b"".join(movi_parts))

    idx_entries = []
    for i, pkt in enumerate(st.packets):
        flags = 0x10 if (st.keyflags[i] if i < len(st.keyflags) else True) \
            else 0
        idx_entries.append(struct.pack("<4sIII", b"00dc", flags,
                                       offsets[i], len(st.packets[i])))
    idx1 = chunk(b"idx1", b"".join(idx_entries))

    body = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
