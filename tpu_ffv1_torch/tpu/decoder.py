"""PyTorch FFV1 decoder (versions 3 and 4: planar YUV/gray with the range
coder or Golomb-Rice, RGB with the range coder).

Port of the fused planar range-coder and Golomb-Rice paths of
``tpu_ffv1/tpu/decoder.py`` (``TPUFFV1Decoder``).  The host parses the
packet structure (keyframe bit, slice size trailers, CRCs, slice
headers); all slices of a frame, and a ``batch`` of independent
streams, decode as lanes of one lane scan (rc_decode.py: the CUDA
kernel on a CUDA device, its plain version on the CPU).  Adaptive states stay on the device across frames (GOP
context inheritance, ffv1dec.c:376-403).  Each lane's final coder state
then runs the sentinel + byte-count check (ffv1dec.c:459-467); a slice
that fails it, or its CRC, is concealed from the stream's previous
picture (ffv1dec.c:1001-1021).  Golomb-Rice streams (coder 0) decode
through golomb_decode.py (G2 on a CUDA device): each lane's bit reader
starts at the byte after its range-coded slice header and the v3.2
sentinel (ffv1dec.c:427-434), its VLC states carry across the GOP, and
there is no sentinel check (the reference validates only the range
coder's); the CRC still flags slices.  RGB streams (colorspace 1) decode
through rc_decode_rgb (B1 / B1-ext on a CUDA device): each slice row
holds a line of every plane G, B, R(, A) at the coded width (9 for
8-bit samples, bits + 1 above); the inverse colour transform, the grid
assembly and the output packing run as torch ops (ffv1dec.c:264-272).
Output as the host decoder's: 8-bit RGB one (H, W, 4) uint8 array in
memory order B, G, R, A (A = 0 for bgr0), deeper RGB three uint16
planes in the format's order; ya8 (gray + alpha) one (H, W, 2) uint8
array, decoded as a luma and an alpha plane (alpha on state plane 1).

Version 4's slice headers add each slice's RCT coefficients, coding mode
and slice_reset_contexts (ffv1dec.c:345-356): RGB's inverse transform
runs per lane with its slice's (by, ry); a slice with reset_contexts
starts from fresh states (ffv1dec.c:419-420); a PCM slice (coding mode
1) raises NotImplementedError, as the JAX package's class does
(decoder.py:411-421 there): the host decoder reads it.

Planar YUV/gray with the range coder decodes on any slice grid and any
mix of quant tables (the reference's per-slice fallback, decoder.py:
708-782 there, whose per-slice scans run here as grouped lane scans):
the lanes are grouped by (plane geometry, quant table), one K2-family
launch per group (rc_decode.rc_decode_groups); each lane keeps its own
state rows, by the host decoder's rules (a table of another context
count starts from 128s); the frame is placed slice after slice, so a
later slice's samples win where neighbouring chroma crops share a
column or a row.  RGB and Golomb-Rice need a uniform grid and one quant
table per packet, as in the reference; a slice whose planes name
different tables raises (the reference reads only the first).

Every lane decodes at the slice grid's geometry, which no packet can
change.  A slice header is parsed into a copy of the geometry its last
header gave, kept per stream and slice for concealment only: the host
decoder conceals the rect a damaged header parsed to, and so does the
port.  A slice whose header fails is flagged and keeps its adaptive
states, as the host's slice aborts before it touches them; on the
planar range-coder path its lane is not decoded, elsewhere it is decoded
with the others all the same, and the result is discarded.

With ``devices=`` (sharding.py) a planar range-coder frame whose lanes
form one group decodes them in contiguous blocks, one per device,
gathered on the lead device (decoder.py:441-473 of the JAX package);
every other decode runs on the lead device, as the reference's ignores
its mesh there.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..bitstream.headers import read_extra_header, read_slice_header
from ..codec.context import SliceState, slice_grid
from ..codec.pixfmt import reconstruct_pix_fmt
from ..core import tables as T
from ..core.crc import crc32_ieee
from ..core.intmath import ceil_rshift
from ..core.rac import (RangeDecoder, custom_state_tables,
                        default_state_tables)
from .golomb_decode import golomb_decode_planes
from .golomb_encode import fresh_vlc_states
from .pipeline import FramePipeline
from .rc_decode import RGB_BITS, rc_decode_groups, rc_decode_rgb
from .residual import wrap_int16
from .sharding import lane_blocks, resolve_devices


class TorchFFV1Decoder:
    """Device FFV1 decoder.

    ``batch`` > 1 decodes that many independent streams in lockstep
    (lanes = batch x slices).  Use decode_frames([pkt0, pkt1, ...]), or
    submit_frames / collect_frames to keep a frame in flight; each
    result is (planes, keyframe) with host numpy planes.

    ``device_out``: collect_frames returns (planes, keyframes), the
    planes stacked (batch, Hk, Wk) tensors on the device in the dtype
    ``TorchFFV1Encoder.submit_device_frames`` takes (uint8 at 8 bits,
    int32 above; ya8: the luma and alpha pair), so a transcode keeps
    every pixel on the card; concealment needs the previous picture on
    the host, so a damaged
    slice raises RuntimeError instead (decoder.py:91-97, 683-695 of the
    JAX package).  Planar YUV/gray with the range coder on a uniform
    grid only, as there.

    ``devices``: a list of devices over which the planar range-coder
    scan splits its lanes into contiguous blocks when a frame's lanes
    form one group (a uniform grid, one quant table: decoder.py:139-146,
    441-473 of the JAX package's ``mesh=``); its length must divide the
    lane count.  Grouped frames, Golomb-Rice and RGB decode on the lead
    device, ``devices[0]``, as the reference's paths ignore the mesh;
    ``device`` must then name it or be left out.

    One thread submits to and collects from an instance: each submit
    enqueues on the calling thread's current stream, which the pipeline
    captures then, and nothing here is locked.  Threads that decode at
    once (the streaming server's clients) each own an instance.
    """

    def __init__(self, width: int, height: int, extradata: bytes,
                 batch: int = 1, device=None, device_out: bool = False,
                 devices=None):
        self.devices, self.device = resolve_devices(devices, device)
        g = read_extra_header(extradata)
        self.golomb = g.ac == T.AC_GOLOMB_RICE
        self.rgb = g.colorspace == 1
        if g.colorspace not in (0, 1):
            raise NotImplementedError("only planar YUV/gray and RGB are "
                                      "ported")
        if self.rgb and self.golomb:
            raise NotImplementedError("RGB needs the range coder, as in "
                                      "the reference")
        if g.version not in (3, 4):
            raise NotImplementedError("only versions 3 and 4 are ported")
        self.g = g
        self.width = width
        self.height = height
        self.batch = batch
        # the attribute surface read_slice_header reads off a decoder
        self.version = g.version
        self.num_h_slices = g.num_h_slices
        self.num_v_slices = g.num_v_slices
        self.plane_count = g.plane_count
        self.quant_table_count = g.quant_table_count
        self.ec = g.ec
        self.bits = 8 if g.bits_per_raw_sample <= 8 else g.bits_per_raw_sample
        # the coded width: RGB's residuals are one bit wider than its
        # samples (ffv1dec.c:252-255)
        self.coded_bits = (9 if self.bits <= 8 else self.bits + 1) \
            if self.rgb else self.bits
        if self.coded_bits > 17 or \
                (self.rgb and self.coded_bits not in RGB_BITS):
            raise NotImplementedError(f"no {'RGB ' if self.rgb else ''}"
                                      f"format codes at {self.coded_bits} "
                                      f"bits")
        self.pix_fmt = reconstruct_pix_fmt(
            g.colorspace, g.bits_per_raw_sample or 8, g.chroma_planes,
            g.chroma_h_shift, g.chroma_v_shift, g.transparency)
        # ya8 (transparency without chroma, colorspace 0): decoded as a
        # luma + alpha plane pair (alpha on state plane 1), returned as one
        # interleaved (h, w, 2) array (decoder.py:164-167, 808-811 of the
        # JAX package)
        self.ya = not self.rgb and g.transparency and not g.chroma_planes
        if g.ac == T.AC_RANGE_CUSTOM_TAB:
            one, zero = custom_state_tables(g.state_transition)
        else:
            one, zero = default_state_tables()
        self.tables = (one, zero)
        dev = self.device
        self.one_tab = torch.from_numpy(one).to(dev)
        self.zero_tab = torch.from_numpy(zero).to(dev)
        # the grid every lane decodes at; never handed to a header parse
        self.geoms = tuple(slice_grid(width, height, g.num_h_slices,
                                      g.num_v_slices))
        self.n_slices = len(self.geoms)
        self.L = self.n_slices * batch
        if self.devices is not None:
            lane_blocks(self.L, len(self.devices), " (slices x batch)")
        self.qts = [torch.from_numpy(np.asarray(q, np.int32)).to(dev)
                    for q in g.quant_tables]
        g0 = self.geoms[0]
        nh, nv = g.num_h_slices, g.num_v_slices
        self.uniform = (
            all(gm.width == g0.width and gm.height == g0.height
                for gm in self.geoms) and
            width % nh == 0 and height % nv == 0 and
            (not g.chroma_planes or
             (g0.width % (1 << g.chroma_h_shift) == 0 and
              g0.height % (1 << g.chroma_v_shift) == 0)))
        if not self.uniform and (self.rgb or self.golomb):
            raise NotImplementedError(
                f"{'RGB' if self.rgb else 'Golomb-Rice'} needs a uniform "
                f"slice grid, as in the reference")
        if device_out and (self.golomb or self.rgb or not self.uniform):
            raise NotImplementedError(
                "device_out requires the fused planar range-coder decode "
                "path (uniform grid), as in the reference")
        self.device_out = device_out
        self.pipe = FramePipeline(dev)
        # RGB plane p codes on state plane (p + 1) / 2: G 0, B and R 1,
        # A 2 (ffv1dec.c:253)
        self.n_state_planes = (2 if self.rgb else
                               1 + (1 if g.chroma_planes else 0)) + \
            (1 if g.transparency else 0)
        # each slice's coded planes, (w, h, state_plane) in coding order
        self.slice_dims = [tuple(self._plane_specs(gm)) for gm in self.geoms]
        # per quant table index: (qt, context count, the 5-input context)
        self.quant = [(qt, cc, bool(q[3][127])) for qt, cc, q in
                      zip(self.qts, g.context_counts, g.quant_tables)]
        # the range coder's per-lane state rows (n_state_planes x the
        # context count of the table its slice last named; 0: none yet),
        # None while they follow the table's width (see _lane_rows), and
        # the grid's frame-placement maps (_place_maps, built once)
        self.lane_rows = None
        self._place_static = None
        self._fresh_cache = {}
        self.key_frame_ok = [False] * batch
        self.last_planes = [None] * batch
        self.slice_damaged = np.zeros((batch, self.n_slices), bool)
        # the slices whose CRC failed in the last parse of their stream
        # (the P decoder skips them, as the host's does)
        self.crc_failed = np.zeros((batch, self.n_slices), bool)
        # per stream and slice, the geometry its last header parsed to
        # (the host's slice state keeps it): the rect a damaged slice
        # conceals
        self.conceal_geoms = [[dataclasses.replace(gm) for gm in self.geoms]
                              for _ in range(batch)]
        self.states = None
        self.vlc_states = None

    # -------------------------------------------------------------- API

    def reset(self):
        """Flush analog (avcodec_flush_buffers): forget GOP contexts,
        concealment reference and keyframe gate; frames in flight are
        dropped."""
        self.pipe.drain()
        self.key_frame_ok = [False] * self.batch
        self.last_planes = [None] * self.batch
        self.slice_damaged[:] = False
        self.states = None
        self.lane_rows = None
        self.vlc_states = None

    def decode_frame(self, pkt: bytes):
        if self.batch != 1:
            raise ValueError("decode_frame needs batch=1; use decode_frames")
        return self.decode_frames([pkt])[0]

    # ------------------------------------------------------- host parse

    def _split_slices(self, pkt: bytes):
        trailer = 3 + 5 * (1 if self.ec else 0)
        count = 0
        p = len(pkt)
        bounds = []
        while count < T.MAX_SLICES and p > 3:
            size = int.from_bytes(pkt[p - trailer:p - trailer + 3], "big")
            if size + trailer > p:
                break
            bounds.append((p - size - trailer, p))
            p -= size + trailer
            count += 1
        bounds.reverse()
        return bounds

    def _parse_packet(self, bi: int, pkt: bytes, damaged=None):
        """Keyframe bit + slice trailers + CRC + slice headers for one
        stream's packet.  Returns (keyframe, per-slice list of
        (buf, qidx, low, range, pos), per-slice list of (rct_by, rct_ry,
        coding_mode, reset_contexts)); qidx is None for a slice whose
        header failed to parse, and its extras are (1, 1, 0, 0), as below
        version 4.  A Golomb-Rice slice gives low = range = 0 and pos the
        byte its bit reader starts at.

        ``damaged``: bool (n_slices,), the stream's damage flags as this
        frame finds them, updated in place as the host's parse updates
        them (a keyframe clears them, a failed CRC or header sets them);
        default a copy of ``_known_damage``.  The stream's own flags move
        only in the collect, in frame order."""
        if damaged is None:
            damaged = self._known_damage(bi).copy()
        rc = RangeDecoder(pkt, *default_state_tables())
        keystate = np.array([128], dtype=np.uint8)
        keyframe = bool(rc.get_rac(keystate, 0))
        if not keyframe and not self.key_frame_ok[bi]:
            raise ValueError("cannot decode non-keyframe without keyframe")
        if keyframe:
            self.key_frame_ok[bi] = True
        bounds = self._split_slices(pkt)
        if len(bounds) != len(self.geoms):
            raise ValueError("slice count mismatch")
        slices, extras = [], []
        for si, (start, end) in enumerate(bounds):
            if keyframe:
                damaged[si] = False
            self.crc_failed[bi, si] = bool(
                self.ec and crc32_ieee(pkt[start:end]) != 0)
            if self.crc_failed[bi, si]:
                damaged[si] = True
            buf = pkt[start:end] if si else pkt[:end]
            src = RangeDecoder(buf)
            src.set_tables(*self.tables)
            if si == 0:
                src.low, src.range, src.pos = rc.low, rc.range, rc.pos
            # the header writes its geometry before it validates it
            geom = dataclasses.replace(self.conceal_geoms[bi][si])
            try:
                ss = SliceState(geom=geom)
                qidxs, _ = read_slice_header(self, ss, src)
                qidx = qidxs[0]
                if len(set(qidxs)) > 1 and not damaged[si] and not (
                        not keyframe and self._in_flight_sentinel(bi)[si]):
                    # the reference reads only the first index
                    # (decoder.py:288-289 of the JAX package); FFmpeg's
                    # encoders write one index for every plane
                    raise NotImplementedError(
                        "a slice whose planes name different quant tables "
                        "is not ported; use FFV1Decoder")
                ex = (ss.slice_rct_by_coef, ss.slice_rct_ry_coef,
                      ss.slice_coding_mode, ss.slice_reset_contexts)
                if self.golomb and (self.version > 3 or (
                        self.version == 3 and self.g.micro_version > 1)):
                    sentinel = np.array([129], dtype=np.uint8)
                    src.get_rac(sentinel, 0)
            except (ValueError, IndexError):
                damaged[si] = True
                qidx = None
                ex = (1, 1, 0, 0)
            extras.append(ex)
            self.conceal_geoms[bi][si] = geom
            if self.golomb:
                # the bit reader starts at ac_byte_count (ffv1dec.c:427-434)
                slices.append((buf, qidx, 0, 0, max(src.pos - 1, 0)))
            else:
                slices.append((buf, qidx, src.low, src.range, src.pos))
        return keyframe, slices, extras

    def _known_damage(self, bi: int):
        """Stream ``bi``'s damage flags as a frame submitted now finds
        them: the last frame in flight's (its parse started from those
        known at its submit), and, unless a keyframe in flight cleared
        them, the stream's own, which the collects since then may have
        raised (the sentinel check runs in the collect).  The sentinel
        checks of the frames still in flight are not known here; the two
        refusals these flags decide (a slice whose planes name different
        quant tables, ``_parse_packet``; intact RGB or Golomb-Rice slices
        that name different tables, ``_lane_inputs``) ask
        ``_in_flight_sentinel`` before they raise, so they decide as at
        depth 1."""
        own = self.slice_damaged[bi]
        if not self.pipe.pending:
            return own
        flags = self.pipe.pending[-1].meta["damaged"][bi]
        if any(rec.meta["keyframes"][bi] for rec in self.pipe.pending):
            return flags
        return flags | own

    def _in_flight_sentinel(self, bi: int):
        """bool (n_slices,): the slices of stream ``bi`` that the sentinel
        check of a frame in flight flags, from its last keyframe in flight
        on: what the collects will add to the flags a submit sees.  Waits
        for those frames' (low, range, pos), so only a decision that would
        otherwise refuse asks for it; each frame keeps its result for its
        collect."""
        flags = np.zeros(self.n_slices, bool)
        for rec in self.pipe.pending:
            if rec.meta["keyframes"][bi]:
                flags[:] = False
            if "lrp" not in rec.host:
                continue
            if "sentinel" not in rec.meta:
                if rec.event is not None:
                    rec.event.synchronize()
                rec.meta["sentinel"] = self._sentinel_failed(
                    rec.meta["parsed"], self.pipe.host(rec, "lrp"),
                    rec.meta["buflens"])
            flags |= rec.meta["sentinel"][bi]
        return flags

    def _plane_specs(self, geom=None):
        """(w, h, state_plane) per coded plane of a slice of ``geom``
        (default: the grid's first; RGB: G, B, R(, A), whose lines
        interleave row by row)."""
        g = self.g
        g0 = geom or self.geoms[0]
        sw, sh = g0.width, g0.height
        if self.rgb:
            return [(sw, sh, (p + 1) // 2)
                    for p in range(3 + (1 if g.transparency else 0))]
        specs = [(sw, sh, 0)]
        if g.chroma_planes:
            cw = ceil_rshift(sw, g.chroma_h_shift)
            ch = ceil_rshift(sh, g.chroma_v_shift)
            specs += [(cw, ch, 1), (cw, ch, 1)]
        if g.transparency:
            specs.append((sw, sh, 2 if g.chroma_planes else 1))
        return specs

    def _fresh_states(self, qidx: int):
        """(total_cc, 32) uint8 initial states of one lane: the
        extradata's initial_states for quant table ``qidx``, else 128."""
        g = self.g
        cc = g.context_counts[qidx]
        init = g.initial_states[qidx]
        if init is not None:
            return np.tile(np.asarray(init[:cc], np.uint8),
                           (self.n_state_planes, 1))
        return np.full((self.n_state_planes * cc, 32), 128, np.uint8)

    def _reset_lane_vlc(self, keyframes, rows, resets=None):
        """Per-stream keyframe resets and per-lane reset_contexts of the
        Golomb-Rice VLC states (a GOP-persistent per-lane table, fresh on
        every lane where its size changes)."""
        fresh = fresh_vlc_states(1, rows, self.device)[0]
        table = self.vlc_states
        if table is None or table.shape[1] != rows:
            table = fresh[None].repeat(self.L, 1, 1)
        for bi, kf in enumerate(keyframes):
            if kf:
                table[bi * self.n_slices:(bi + 1) * self.n_slices] = fresh
        if resets is not None and resets.any():
            table[self.pipe.put(np.nonzero(resets)[0])] = fresh
        self.vlc_states = table
        return table

    def _lane_extras(self, parsed):
        """Version 4's per-slice extras as lane arrays: RGB's (by, ry)
        int32 tensors (L,) on the device (None below version 4 and for
        YUV, which carries them in its headers only) and reset_contexts
        bool (L,) on the host.  A PCM slice raises: the host decoder
        reads it."""
        ex = np.array([e for p in parsed for e in p[2]], np.int32)
        if (ex[:, 2] != 0).any():
            raise NotImplementedError("version 4 PCM slices are decoded on "
                                      "the host only; use FFV1Decoder")
        by = ry = None
        if self.rgb and self.version > 3:
            by, ry = self.pipe.put(np.ascontiguousarray(ex[:, :2].T))
        return by, ry, ex[:, 3] != 0

    def _header_failed_vlc(self, parsed, rows):
        """{lane: its VLC states before this frame} for the lanes of a
        Golomb-Rice stream whose slice header failed: the host's slice
        aborts before its keyframe reset and its decode (ffv1dec.c:
        282-359), so they keep them.  A lane with no states of this table
        size yet gets the fresh ones the host allocates at the slice's
        next parsed header."""
        table = self.vlc_states
        kept = {}
        for bi, (_kf, sl, _ex) in enumerate(parsed):
            for si, s in enumerate(sl):
                if s[1] is not None:
                    continue
                lane = bi * self.n_slices + si
                if table is not None and table.shape[1] == rows:
                    kept[lane] = table[lane].clone()
                else:
                    kept[lane] = fresh_vlc_states(1, rows, self.device)[0]
        return kept

    # ------------------------------------------------------------ decode

    def _lane_inputs(self, parsed, damaged=None):
        """Lane-major kernel inputs for parsed packets of the Golomb-Rice
        and RGB paths: ``_lane_buffers``' and the quant table index all
        lanes decode with; ``damaged`` (batch, n_slices) the flags the
        frame's parse left (default the streams' own).

        That is the one the intact slices name.  A slice already flagged
        damaged is concealed whatever its lane decodes to, so its quant
        table does not count; where every slice is flagged, the first
        parsed header's table serves, else the stream's first.  Intact
        slices that name different tables raise, as the reference's
        fallback has no Golomb-Rice or RGB branch (decoder.py:377-383
        there); before they do, the sentinel checks of the frames in
        flight are folded in, as depth 1 would have them."""
        damaged = self.slice_damaged if damaged is None else damaged
        named = [(bi, si, s[1]) for bi, (_kf, sl, _ex) in enumerate(parsed)
                 for si, s in enumerate(sl) if s[1] is not None]

        def intact(flags):
            return {q for bi, si, q in named if not flags[bi, si]}
        tables = intact(damaged)
        if len(tables) > 1 and self.pipe.pending:
            tables = intact(damaged | np.stack([
                np.zeros(self.n_slices, bool) if kf else
                self._in_flight_sentinel(bi)
                for bi, (kf, _sl, _ex) in enumerate(parsed)]))
        if len(tables) > 1:
            raise NotImplementedError(
                f"{'RGB' if self.rgb else 'Golomb-Rice'} slices with "
                f"differing quant tables are not ported; use FFV1Decoder")
        qidx0 = tables.pop() if tables else named[0][2] if named else 0
        return (*self._lane_buffers(parsed), qidx0)

    def _lane_buffers(self, parsed):
        """Lane-major kernel inputs for parsed packets: (bufs, lows,
        ranges, poss) on the device, and per-lane buffer lengths."""
        maxlen = max(len(s[0]) for p in parsed for s in p[1])
        cap = max(4096, 1 << (maxlen - 1).bit_length())
        # written straight into the pipeline's pinned staging
        bufs = self.pipe.staging((self.L, cap), np.uint8)
        lrp = np.zeros((3, self.L), np.int32)
        buflens = np.zeros(self.L, np.int64)
        for bi, (_kf, sl, _ex) in enumerate(parsed):
            for si, (buf, _q, lo, ra, po) in enumerate(sl):
                lane = bi * self.n_slices + si
                bufs[lane, :len(buf)] = np.frombuffer(buf, np.uint8)
                bufs[lane, len(buf):] = 0
                lrp[:, lane] = (lo, ra, po)
                buflens[lane] = len(buf)
        bufs_t, lrp_t = self.pipe.upload([bufs, lrp])
        return (bufs_t, lrp_t[0], lrp_t[1], lrp_t[2]), buflens

    def decode_frames(self, pkts):
        """Decode one packet of each of ``batch`` streams."""
        self.submit_frames(pkts)
        return self.collect_frames()

    def submit_frames(self, pkts):
        """The device half of ``decode_frames``: parse one packet of each
        of ``batch`` streams, stage the lane buffers, enqueue the lane
        scans and the frame's assembly, and start the copies of the planes
        (unless ``device_out``) and of each lane's (low, range, pos),
        without waiting for the card.  Pair each submit with a later
        ``collect_frames`` (decoder.py:365-553 of the JAX package).  The
        adaptive states chain on the device in submit order; each frame
        keeps its own damage flags and concealment rects until its
        collect."""
        if len(pkts) != self.batch:
            raise ValueError(f"expected {self.batch} packets, "
                             f"got {len(pkts)}")
        g = self.g
        damaged = np.stack([self._known_damage(bi)
                            for bi in range(self.batch)])
        parsed = [self._parse_packet(bi, pkt, damaged[bi])
                  for bi, pkt in enumerate(pkts)]
        keyframes = [p[0] for p in parsed]
        meta = dict(parsed=parsed, keyframes=keyframes, damaged=damaged,
                    geoms=[list(row) for row in self.conceal_geoms])
        fetch = {}
        if not (self.golomb or self.rgb):
            planes, lrp, meta["buflens"] = self._decode_planar(parsed,
                                                               keyframes)
            fetch["lrp"] = lrp
            if self.device_out:
                meta["planes"] = tuple(
                    x.to(torch.uint8) if self.bits <= 8 else x & 0xFFFF
                    for x in planes)
                self.pipe.fetch(fetch, meta)
                return
            planes = self._narrow(planes)
        else:
            (bufs, lows, ranges, poss), meta["buflens"], qidx0 = \
                self._lane_inputs(parsed, damaged)
            five = bool(g.quant_tables[qidx0][3][127])
            cc = g.context_counts[qidx0]
            specs = tuple((w, h, sp * cc)
                          for (w, h, sp) in self._plane_specs())
            by, ry, resets = self._lane_extras(parsed)
            rows = self.n_state_planes * cc
            if self.golomb:
                planes = self._decode_golomb(parsed, keyframes, bufs, poss,
                                             qidx0, specs, rows, resets,
                                             five)
            else:
                planes, fetch["lrp"] = self._decode_rgb(
                    parsed, keyframes, bufs, lows, ranges, poss, qidx0,
                    specs, rows, resets, five, by, ry)
        fetch.update((f"plane{k}", x) for k, x in enumerate(planes))
        self.pipe.fetch(fetch, meta,
                        owned=[f"plane{k}" for k in range(len(planes))])

    def _decode_golomb(self, parsed, keyframes, bufs, poss, qidx0, specs,
                       rows, resets, five):
        """G2 over all lanes; a lane whose header failed keeps its VLC
        states.  Returns the output planes on the device."""
        kept = self._header_failed_vlc(parsed, rows)
        vlc0 = self._reset_lane_vlc(keyframes, rows, resets)
        planes_dev, vlc_out, _bitpos = golomb_decode_planes(
            bufs, vlc0, self.qts[qidx0], poss, specs, self.bits, five)
        for lane, st in kept.items():
            vlc_out[lane] = st
        self.vlc_states = vlc_out
        return self._narrow([self._assemble(p) for p in planes_dev])

    def _decode_rgb(self, parsed, keyframes, bufs, lows, ranges, poss,
                    qidx0, specs, rows, resets, five, by, ry):
        """B1 / B1-ext over all lanes at quant table ``qidx0``, by the
        planar path's state rules; a lane whose header failed keeps its
        states.  Returns (the output planes, (low, range, pos)) on the
        device."""
        g = self.g
        cc = g.context_counts[qidx0]
        lane_q = [None if s[1] is None else qidx0
                  for p in parsed for s in p[1]]
        self._prepare_states(lane_q, keyframes, resets)
        self._grow_states(rows)
        planes_dev, states_out, low, rng, pos = rc_decode_rgb(
            bufs, self.states[:, :rows].contiguous(), self.one_tab,
            self.zero_tab, self.qts[qidx0], lows, ranges, poss,
            specs[0][0], specs[0][1], len(specs), cc, self.coded_bits, five)
        done = self.pipe.put(np.array([lane for lane, q in enumerate(lane_q)
                                       if q is not None], np.int64))
        self.states[done, :rows] = states_out[done]
        return self._rgb_output(planes_dev, by, ry), \
            torch.stack([low, rng, pos])

    def collect_frames(self):
        """The host half of ``decode_frames`` for the oldest frame in
        flight: wait for its copies, merge its damage flags into the
        streams' in frame order, run the sentinel check (range coder) and
        conceal damaged slices from each stream's previous picture
        (decoder.py:650-706 of the JAX package).  Returns a list of
        (planes, keyframe) per stream; with ``device_out``, (planes,
        keyframes) with the planes on the device, or RuntimeError on a
        damaged slice."""
        rec = self.pipe.pop()
        m = rec.meta
        try:
            for bi, kf in enumerate(m["keyframes"]):
                if kf:
                    self.slice_damaged[bi] = False
            self.slice_damaged |= m["damaged"]
            if "lrp" in rec.host:
                sentinel = m.get("sentinel")
                if sentinel is None:
                    sentinel = self._sentinel_failed(
                        m["parsed"], self.pipe.host(rec, "lrp"),
                        m["buflens"])
                self.slice_damaged |= sentinel
            if self.device_out:
                if self.slice_damaged.any():
                    raise RuntimeError(
                        "damaged slice in device_out mode; decode with "
                        "device_out=False to conceal from the previous "
                        "frame")
                return m["planes"], m["keyframes"]
            planes = [self.pipe.host(rec, k) for k in rec.host
                      if k.startswith("plane")]
            if self.bits > 8:
                planes = [p.view(np.uint16) for p in planes]
            out = [(self._conceal(bi, [p[bi] for p in planes],
                                  m["geoms"][bi]), kf)
                   for bi, kf in enumerate(m["keyframes"])]
            if self.ya:
                # one (h, w, 2) interleaved array, the host decoder's
                # channel-strided ya8 storage (ffv1dec.c:185)
                out = [([np.stack(planes[:2], axis=-1)], kf)
                       for planes, kf in out]
            return out
        finally:
            self.pipe.release(rec)

    # ------------------------------------------ planar range coder (B2)

    def _lane_rows(self):
        """int64 (L,): each lane's state rows in ``self.states``; a table
        installed whole (``decoder_state_from_numpy``) serves every lane
        at its width."""
        if self.lane_rows is None:
            rows = 0 if self.states is None else self.states.shape[1]
            self.lane_rows = np.full(self.L, rows, np.int64)
        return self.lane_rows

    def _fresh(self, qidx: int):
        """One lane's fresh rows for quant table ``qidx`` on the device."""
        if qidx not in self._fresh_cache:
            self._fresh_cache[qidx] = self.pipe.put(self._fresh_states(qidx))
        return self._fresh_cache[qidx]

    def _grow_states(self, rows: int):
        """``self.states`` (L, R, 32) widened to at least ``rows`` rows, the
        new ones 128."""
        if self.states is None or self.states.shape[1] < rows:
            grown = torch.full((self.L, rows, 32), 128, dtype=torch.uint8,
                               device=self.device)
            if self.states is not None:
                grown[:, :self.states.shape[1]] = self.states
            self.states = grown

    def _prepare_states(self, lane_q, keyframes, resets):
        """The host decoder's state rules per lane (codec/decoder.py:
        238-276 of the JAX package) before a range-coder decode:
        a lane whose slice names a table of another context count than
        its states hold starts from 128s; a keyframe's lanes, and those
        whose header sets reset_contexts, from the table's initial
        states (the extradata's, else 128).  A lane whose header failed
        (``lane_q`` None) keeps its states, as the host's slice aborts
        before it touches them."""
        rows_now = self._lane_rows()
        nsp = self.n_state_planes
        want = np.array([rows_now[lane] if q is None else
                         nsp * self.quant[q][1]
                         for lane, q in enumerate(lane_q)], np.int64)
        self._grow_states(int(want.max()))
        changed = np.nonzero(want != rows_now)[0]
        if changed.size:
            # index_fill_ takes the value as a number: an assignment of
            # 128 would copy it to the card and wait
            self.states.index_fill_(0, self.pipe.put(changed), 128)
        fresh = {}
        for lane, q in enumerate(lane_q):
            if q is not None and (keyframes[lane // self.n_slices] or
                                  resets[lane]):
                fresh.setdefault(q, []).append(lane)
        for q, lanes in fresh.items():
            rows = self._fresh(q)
            self.states[self.pipe.put(np.asarray(lanes, np.int64)),
                        :rows.shape[0]] = rows
        self.lane_rows = want

    def _decode_planar(self, parsed, keyframes):
        """Planar YUV/gray with the range coder on any grid and any mix of
        quant tables: the lanes grouped by (plane geometry, quant table),
        one K2-family launch per group (``rc_decode_groups``), the frame
        placed from the groups' planes.  A lane whose header failed is
        not decoded: it is flagged, and its rect is concealed.  Returns
        (per plane a (batch, Hk, Wk) int32 tensor, the lanes' (low, range,
        pos) int32 (3, L), both on the device, the buffer lengths).  With
        ``devices``, a frame of one group splits its launch over them."""
        (bufs, lows, ranges, poss), buflens = self._lane_buffers(parsed)
        _by, _ry, resets = self._lane_extras(parsed)
        lane_q = [s[1] for p in parsed for s in p[1]]
        self._prepare_states(lane_q, keyframes, resets)
        # the groups of this frame (read by chip_smoke.py)
        self.last_groups = self._lane_groups(lane_q)
        planes_g, self.states, low, rng, pos = rc_decode_groups(
            bufs, self.states, self.one_tab, self.zero_tab, self.quant,
            lows, ranges, poss, self.last_groups, self.bits, self.devices)
        full = self._place(self.last_groups, planes_g)
        return full, torch.stack([low, rng, pos]), buflens

    def _lane_groups(self, lane_q):
        """[(lanes, dims, qidx)]: the lanes whose slice names quant table
        ``lane_q[lane]`` (None: not decoded), grouped by their slice's
        plane geometry and that table, in the order of their first
        lane."""
        by_key = {}
        for lane, q in enumerate(lane_q):
            if q is not None:
                by_key.setdefault((self.slice_dims[lane % self.n_slices], q),
                                  []).append(lane)
        return [(lanes, dims, q) for (dims, q), lanes in by_key.items()]

    def _place(self, groups, planes_g):
        """The groups' slice planes -> full frames, per plane a (batch,
        Hk, Wk) tensor.  One group of every lane on a uniform grid is the
        grid's inverse block reshape; otherwise one gather per plane from
        the groups' planes of that kind, flattened in group order, with
        zeros past their end: each pixel reads the lane that the grid's
        map (``_place_maps``) gives it, at that lane's offset in this
        frame's groups plus the pixel's offset in its slice.  A lane that
        is not decoded (a failed header's) and a pixel no slice covers
        read 0, as the host's fresh frame holds."""
        if self.uniform and len(groups) == 1 and \
                list(groups[0][0]) == list(range(self.L)):
            return [self._assemble(p) for p in planes_g[0]]
        if self._place_static is None:
            self._place_static = self._place_maps()
        dev = self.device
        out = []
        for j, (lane_map, offset) in enumerate(self._place_static):
            # each lane's first sample in the flattened groups; L and
            # the lanes of no group point past their end
            base = np.full(self.L + 1, -1, np.int32)
            total = 0
            for lanes, dims, _q in groups:
                w, h, _sp = dims[j]
                base[list(lanes)] = total + w * h * np.arange(len(lanes))
                total += len(lanes) * w * h
            base[base < 0] = total
            pad = max(w * h for w, h, _sp in
                      (dims[j] for dims in self.slice_dims))
            src = torch.cat([p[j].reshape(-1) for p in planes_g] +
                            [torch.zeros(pad, dtype=torch.int32,
                                         device=dev)])
            index = self.pipe.put(base).index_select(
                0, lane_map.reshape(-1)) + offset.reshape(-1)
            out.append(src.index_select(0, index).reshape(lane_map.shape))
        return out

    def _place_maps(self):
        """Per plane (lane, offset), each int32 (batch, Hk, Wk): the lane
        whose slice writes the pixel last, in slice order (L where no
        slice covers it), and the pixel's offset in that slice's plane.
        Slices write at their offsets (chroma at (x >> hs, y >> vs)) one
        after another, so a later slice's samples win where neighbouring
        chroma crops share a column or a row, as the reference writes
        (decoder.py:759-773 of the JAX package).  The grid fixes both
        maps; the frame's groups only move each lane's base."""
        g = self.g
        hs, vs = g.chroma_h_shift, g.chroma_v_shift
        maps = []
        for j in range(len(self.slice_dims[0])):
            sub = g.chroma_planes and j in (1, 2)
            sh, sv = (hs, vs) if sub else (0, 0)
            shape = (self.batch, ceil_rshift(self.height, sv),
                     ceil_rshift(self.width, sh))
            lane_map = np.full(shape, self.L, np.int32)
            offset = np.zeros(shape, np.int32)
            for lane in range(self.L):
                bi, si = divmod(lane, self.n_slices)
                geom = self.geoms[si]
                w, h, _sp = self.slice_dims[si][j]
                y, x = geom.y >> sv, geom.x >> sh
                lane_map[bi, y:y + h, x:x + w] = lane
                offset[bi, y:y + h, x:x + w] = \
                    np.arange(h * w).reshape(h, w)
            maps.append(self.pipe.upload([lane_map, offset]))
        return maps

    def _assemble(self, lanes):
        """Lane-major slice planes (L, h, w) -> full frames (batch, H, W)
        (the inverse block reshape of the uniform grid)."""
        nh, nv = self.g.num_h_slices, self.g.num_v_slices
        _L, h, w = lanes.shape
        x = lanes.reshape(self.batch, nv, nh, h, w)
        return x.permute(0, 1, 3, 2, 4).reshape(self.batch, nv * h, nh * w)

    def _narrow(self, frames):
        """Full planes, each (batch, Hk, Wk) int32 on the device -> the
        wire dtype's bits, still on the device: uint8 at 8 bits, int16
        above (16-bit samples come back int16-wrapped, as the reference's
        int16_t rows hold them; the host views them as uint16)."""
        if self.bits <= 8:
            return [x.to(torch.uint8) for x in frames]
        return [wrap_int16(x).to(torch.int16) for x in frames]

    def _rgb_output(self, samples, by, ry):
        """RCT-domain samples (P, L, h, w) -> the host decoder's output
        layout: the inverse colour transform (ffv1dec.c:264-269) with each
        lane's coefficients (``by``, ``ry``: int32 (L,); None below
        version 4, whose coefficients are (1, 1)), the grid assembly and
        the packing (ffv1dec.c:272); per plane a (batch, ...) tensor on
        the device, in ``_narrow``'s dtypes."""
        offset = 1 << self.bits
        b = samples[1] - offset
        r = samples[2] - offset
        if by is not None:
            g = samples[0] - ((b * by[:, None, None] +
                               r * ry[:, None, None]) >> 2)
        else:
            g = samples[0] - ((b + r) >> 2)
        b = b + g
        r = r + g
        if self.bits <= 8:
            a = samples[3] if len(samples) == 4 else torch.zeros_like(b)
            # one uint32 b | g << 8 | r << 16 | a << 24 per pixel, little
            # endian: the bytes B, G, R, A
            full = torch.stack([self._assemble(c) & 0xFF
                                for c in (b, g, r, a)], dim=-1)
            return [full.to(torch.uint8)]
        return self._narrow([self._assemble(c) for c in (b, g, r)])

    def _sentinel_failed(self, parsed, lrp, buflens):
        """bool (batch, n_slices): the slices whose lane's final coder
        state (``lrp``: low, range, pos per lane) fails the sentinel +
        byte-count check (ffv1dec.c:459-467)."""
        failed = np.zeros((self.batch, self.n_slices), bool)
        low, rng, pos = lrp
        for bi, (_kf, sl, _ex) in enumerate(parsed):
            for si, (buf, *_rest) in enumerate(sl):
                lane = bi * self.n_slices + si
                src = RangeDecoder(buf)
                src.set_tables(*self.tables)
                src.low, src.range, src.pos = (int(low[lane]),
                                               int(rng[lane]),
                                               int(pos[lane]))
                sentinel = np.array([129], dtype=np.uint8)
                try:
                    src.get_rac(sentinel, 0)
                    v = (int(buflens[lane]) - src.pos) - 2 - \
                        5 * (1 if self.ec else 0)
                    if v:
                        raise ValueError("bytestream end mismatch")
                except (ValueError, IndexError):
                    failed[bi, si] = True
        return failed

    def _conceal(self, bi: int, planes, geoms=None):
        """Copy damaged slice rects from the stream's previous picture
        (ffv1dec.c:1001-1021); damage persists until the next keyframe.
        ``geoms``: the rect of each slice as the frame's parse left them
        (default the stream's latest)."""
        g = self.g
        geoms = self.conceal_geoms[bi] if geoms is None else geoms
        if self.last_planes[bi] is not None:
            # YUV's chroma planes are subsampled; RGB's planes (or its
            # one B, G, R, A array) are not
            sub = g.chroma_planes and not self.rgb
            hs, vs = g.chroma_h_shift, g.chroma_v_shift
            for si in range(self.n_slices):
                if not self.slice_damaged[bi, si]:
                    continue
                geom = geoms[si]
                for j, src_p in enumerate(self.last_planes[bi]):
                    if not planes[j].flags.writeable:
                        planes[j] = np.array(planes[j])
                    sh = hs if j in (1, 2) and sub else 0
                    sv = vs if j in (1, 2) and sub else 0
                    ys, xs = geom.y >> sv, geom.x >> sh
                    he = ceil_rshift(geom.y + geom.height, sv)
                    we = ceil_rshift(geom.x + geom.width, sh)
                    planes[j][ys:he, xs:we] = src_p[ys:he, xs:we]
        self.last_planes[bi] = planes
        self.key_frame_ok[bi] = True
        return planes
