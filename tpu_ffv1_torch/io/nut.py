"""Minimal NUT container mux/demux for FFV1 interop.

NUT is FFmpeg's native container and the second FATE container for FFV1
(libavformat/nut*; FFV1 rides the BMP fourcc table via nut.c:225-226 ->
riff.c:316).  This implements the subset needed for interop with the
reference: main/stream headers (a single generic CODED frame-code), one
syncpoint per frame, checksummed packets (CRC-32 IEEE, the same av_crc
flavor as FFV1's slice CRCs).

Structure re-derived from libavformat/nut.h:29-55 (startcodes, frame
flags) and nutenc.c put_packet/write_mainheader/write_streamheader/
nut_write_packet framing.

The port's own copy of ``tpu_ffv1/io/nut.py``, trimmed to what the
port reaches.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..core.crc import crc32_ieee

ID_STRING = b"nut/multimedia container\x00"

MAIN_STARTCODE = 0x7A561F5F04AD + ((ord("N") << 8 | ord("M")) << 48)
STREAM_STARTCODE = 0x11405BF2F9DB + ((ord("N") << 8 | ord("S")) << 48)
SYNCPOINT_STARTCODE = 0xE4ADEECA4569 + ((ord("N") << 8 | ord("K")) << 48)
INDEX_STARTCODE = 0xDD672F23E64E + ((ord("N") << 8 | ord("X")) << 48)
INFO_STARTCODE = 0xAB68B596BA78 + ((ord("N") << 8 | ord("I")) << 48)

FLAG_KEY = 1
FLAG_CODED_PTS = 8
FLAG_STREAM_ID = 16
FLAG_SIZE_MSB = 32
FLAG_CHECKSUM = 64
FLAG_RESERVED = 128
FLAG_HEADER_IDX = 1024
FLAG_MATCH_TIME = 2048
FLAG_CODED = 4096
FLAG_INVALID = 8192

MAX_DISTANCE = 1024 * 32 - 1
MSB_PTS_SHIFT = 7


def put_v(val: int) -> bytes:
    """ff_put_v: 7-bit groups, MSB-first, high bit = continuation."""
    out = [val & 0x7F]
    val >>= 7
    while val:
        out.append((val & 0x7F) | 0x80)
        val >>= 7
    return bytes(reversed(out))


def put_s(val: int) -> bytes:
    return put_v(2 * abs(val) - (1 if val > 0 else 0))


class _Reader:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def get_v(self) -> int:
        v = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            v = (v << 7) | (b & 0x7F)
            if not (b & 0x80):
                return v

    def get_s(self) -> int:
        v = self.get_v() + 1
        return -(v >> 1) if v & 1 else (v >> 1)

    def bytes_(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b


def _packet(startcode: int, content: bytes, checksum: bool = True) -> bytes:
    """put_packet framing (nutenc.c:322-343)."""
    fwd = len(content) + (4 if checksum else 0)
    head = startcode.to_bytes(8, "big") + put_v(fwd)
    out = bytearray(head)
    if fwd > 4096:
        out += int(crc32_ieee(bytes(head))).to_bytes(4, "little")
    if checksum:
        out += content
        out += int(crc32_ieee(content)).to_bytes(4, "little")
    else:
        out += content
    return bytes(out)


@dataclass
class NutStream:
    width: int = 0
    height: int = 0
    fps: tuple = (25, 1)
    extradata: bytes = b""
    packets: list = field(default_factory=list)
    keyflags: list = field(default_factory=list)


def nut_header_bytes(st: NutStream) -> bytes:
    """File-id string + main header + stream header: the streamable
    prefix (everything before the first syncpoint).  Live HTTP streams
    send this once, then nut_frame_bytes per packet."""
    rate, scale = st.fps

    # main header: one generic CODED frame code for all 256 codes
    mh = bytearray()
    mh += put_v(3)                  # version
    mh += put_v(1)                  # stream count
    mh += put_v(MAX_DISTANCE)
    mh += put_v(1)                  # time base count
    mh += put_v(scale)
    mh += put_v(rate)
    # frame code table: flags=CODED, fields=6 -> explicit count 255
    # ('N' is skipped by the reader and marked invalid automatically)
    mh += put_v(FLAG_CODED)
    mh += put_v(6)
    mh += put_s(0)                  # pts_delta
    mh += put_v(1)                  # size_mul
    mh += put_v(0)                  # stream_id
    mh += put_v(0)                  # size_lsb
    mh += put_v(0)                  # reserved
    mh += put_v(255)                # count
    mh += put_v(0)                  # header_count - 1 (no elision)

    # stream header (write_streamheader, nutenc.c)
    sh = bytearray()
    sh += put_v(0)                  # stream id
    sh += put_v(0)                  # class: video
    sh += put_v(4) + b"FFV1"        # fourcc
    sh += put_v(0)                  # time base id
    sh += put_v(MSB_PTS_SHIFT)
    sh += put_v(1)                  # max_pts_distance
    sh += put_v(0)                  # decode delay
    sh += bytes([0])                # stream flags
    sh += put_v(len(st.extradata)) + bytes(st.extradata)
    sh += put_v(st.width)
    sh += put_v(st.height)
    sh += put_v(0) + put_v(0)       # sample aspect ratio (unknown)
    sh += put_v(0)                  # colorspace type

    return bytes(ID_STRING + _packet(MAIN_STARTCODE, bytes(mh)) +
                 _packet(STREAM_STARTCODE, bytes(sh)))


def nut_frame_bytes(i: int, pkt: bytes, key: bool) -> bytes:
    """Syncpoint + frame header + payload for packet ``i`` — the
    per-frame streamable unit (same wire bytes write_nut emits)."""
    # one syncpoint per frame (global_key_pts, back_ptr_div16)
    out = bytearray()
    out += _packet(SYNCPOINT_STARTCODE, put_v(i) + put_v(0))

    flags = FLAG_CODED_PTS | FLAG_SIZE_MSB | FLAG_CHECKSUM
    # max_pts_distance=1 forces per-frame checksums anyway; keep them
    # unconditional for robustness
    if key:
        flags |= FLAG_KEY
    coded_pts = i + (1 << MSB_PTS_SHIFT)  # absolute form
    header = bytearray()
    header += bytes([0])                      # frame code 0
    header += put_v(flags ^ FLAG_CODED)       # coded_flags
    header += put_v(coded_pts)
    header += put_v(len(pkt))                 # size_msb (mul=1)
    header += int(crc32_ieee(bytes(header))).to_bytes(4, "little")
    out += header
    out += bytes(pkt)
    return bytes(out)


def write_nut(path: str, st: NutStream):
    out = bytearray(nut_header_bytes(st))
    for i, pkt in enumerate(st.packets):
        key = st.keyflags[i] if i < len(st.keyflags) else True
        out += nut_frame_bytes(i, pkt, key)
    with open(path, "wb") as f:
        f.write(out)


def read_nut(path: str) -> NutStream:
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(ID_STRING):
        raise ValueError("not a NUT file")
    st = NutStream()
    r = _Reader(buf, len(ID_STRING))

    frame_codes = [dict(flags=FLAG_INVALID, size_mul=1, size_lsb=0,
                        pts_delta=0, stream_id=0) for _ in range(256)]
    time_bases = [(1, 25)]
    msb_shift = MSB_PTS_SHIFT
    last_pts = 0

    def parse_main(content: bytes):
        nonlocal time_bases
        c = _Reader(content)
        version = c.get_v()
        if version > 3:
            c.get_v()
        nstreams = c.get_v()
        _ = nstreams
        c.get_v()  # max distance
        tb_count = c.get_v()
        time_bases = [(c.get_v(), c.get_v()) for _ in range(tb_count)]
        i = 0
        pts = 0
        mul = 1
        stream = 0
        size = 0
        head_idx = 0
        while i < 256:
            flags = c.get_v()
            fields = c.get_v()
            if fields > 0:
                pts = c.get_s()
            if fields > 1:
                mul = c.get_v()
            if fields > 2:
                stream = c.get_v()
            if fields > 3:
                size = c.get_v()
            if fields > 4:
                c.get_v()
            count = c.get_v() if fields > 5 else mul - size
            if fields > 6:
                c.get_s()
            if fields > 7:
                head_idx = c.get_v()
            for extra in range(8, fields):
                c.get_v()
            j = 0
            while j < count and i < 256:
                if i == ord("N"):
                    frame_codes[i]["flags"] = FLAG_INVALID
                    i += 1
                    continue
                frame_codes[i] = dict(flags=flags, size_mul=mul,
                                      size_lsb=size + j, pts_delta=pts,
                                      stream_id=stream, head_idx=head_idx)
                i += 1
                j += 1

    def parse_stream(content: bytes):
        nonlocal msb_shift
        c = _Reader(content)
        c.get_v()               # stream id
        c.get_v()               # class
        fourcc_len = c.get_v()
        c.bytes_(fourcc_len)    # fourcc (FFV1)
        c.get_v()               # time base id
        msb_shift = c.get_v()
        c.get_v()               # max pts distance
        c.get_v()               # decode delay
        c.u8()                  # flags
        n = c.get_v()
        st.extradata = c.bytes_(n)
        st.width = c.get_v()
        st.height = c.get_v()

    while r.pos < len(buf) - 8:
        # startcode or frame?
        word = int.from_bytes(buf[r.pos:r.pos + 8], "big")
        if (word >> 56) == ord("N") and word in (
                MAIN_STARTCODE, STREAM_STARTCODE, SYNCPOINT_STARTCODE,
                INDEX_STARTCODE, INFO_STARTCODE):
            r.pos += 8
            fwd = r.get_v()
            if fwd > 4096:
                r.bytes_(4)     # header checksum
            content = r.bytes_(fwd)
            if word == MAIN_STARTCODE:
                parse_main(content[:-4])
            elif word == STREAM_STARTCODE:
                parse_stream(content[:-4])
            elif word == SYNCPOINT_STARTCODE:
                pass            # pts/back_ptr not needed sequentially
            continue
        # frame
        code = r.u8()
        fc = frame_codes[code]
        flags = fc["flags"]
        if flags & FLAG_INVALID:
            raise ValueError(f"invalid frame code {code} @{r.pos - 1}")
        if flags & FLAG_CODED:
            flags ^= r.get_v()
        if flags & FLAG_STREAM_ID:
            r.get_v()
        pts = last_pts + fc["pts_delta"]
        if flags & FLAG_CODED_PTS:
            coded = r.get_v()
            if coded < (1 << msb_shift):
                mask = (1 << msb_shift) - 1
                delta = last_pts - mask // 2
                pts = ((coded - delta) & mask) + delta
            else:
                pts = coded - (1 << msb_shift)
        size = fc["size_lsb"]
        if flags & FLAG_SIZE_MSB:
            size = r.get_v() * fc["size_mul"] + fc["size_lsb"]
        if flags & FLAG_MATCH_TIME:
            r.get_s()
        if flags & FLAG_HEADER_IDX:
            r.get_v()
        if flags & FLAG_RESERVED:
            for _ in range(r.get_v()):
                r.get_v()
        if flags & FLAG_CHECKSUM:
            r.bytes_(4)
        st.packets.append(r.bytes_(size))
        st.keyflags.append(bool(flags & FLAG_KEY))
        last_pts = pts

    if time_bases:
        st.fps = (time_bases[0][1], time_bases[0][0])
    return st
