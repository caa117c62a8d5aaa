"""PyTorch FFV1 encoder: stencil -> range-coder lane scan -> finalize, or
stencil -> Golomb-Rice lane scan.

Port of the planar range-coder and Golomb-Rice paths and the RGB path
(colorspace 1, range coder) of ``tpu_ffv1/tpu/encoder.py``
(``TPUFFV1Encoder``).  Per frame step:

  host:   keyframe bit + slice headers -> provisional prefixes (cached)
  device: residual/context stencil (residual.py, torch ops)
          lane scan over all slices x streams (rc_encode.py: the CUDA
          kernel on a CUDA device, its plain version on the CPU)
          sentinel/terminate/carry-resolve/compaction (finalize.py)
  host:   per-slice size trailer + CRC, packet concatenation

Golomb-Rice (coder 0, and coder -1 at 8 bits: FFV1's default coder) takes
the same stencil, then the Golomb-Rice lane scan (golomb_encode.py: G1 on
a CUDA device), which writes each lane's final bytes behind its prefix,
the slice header range-coded and terminated after the v3 sentinel
(ffv1enc.c:1176-1183); its VLC states carry across the GOP as the range
coder's states do.

With ``compact=True`` (the counterpart of the JAX package's
``FFV1_PALLAS_COMPACT=1``) coded widths <= 10 run the compact form:
stencil -> K1-compact (8 rows per pixel instead of 2 * bits + 1) ->
finalize_compact; a frame in which some pixel emitted more than 4 bytes
is redone as the reference redoes it (encoder.py:1141-1163 of the JAX
package): the raw scan from the same start states, finalize_packed, and
finalize_packed_full if that overflows too.  Wider coded widths take the
extended raw scan, as in the reference, whose compact form is fast-path
only.  The packets are the same bytes either way.

RGB (bgr0, bgra, gbrp9/10/12/14le; range coder only, as in the
reference) runs the reversible colour transform on the full frame
(RCT coefficients fixed at (1, 1) at version 3), then the stencil on
each transformed plane at the coded width, one bit wider than the
samples (9 at 8 bits), and codes each slice row as its G, B, R(, A)
lines in turn (ffv1enc.c:428-470) on state planes 0, 1, 1(, 2): the
same lane scans, at coded width 9 or 10 through K1, 11..15 through
K1-ext.

Version 4 (``level=4, strict=-2``; encoder.py:87-91, 408-441, 588-670,
1164-1346 of the JAX package) adds three things per frame step:

  device: the per-slice RCT search (rct_search.py) on the uploaded
          samples, for RGB and for 4:4:4 YUV above 8 bits; only the
          (L, 15) cost sums cross to the host, which picks each lane's
          (by, ry) and writes them into its slice header (headers cached
          per slice, keyframe flag and pair).  RGB then runs the RCT per
          slice crop with its lane's pair; YUV carries the pair in the
          headers only.
  device: each lane's emitted bytes at every coded line start (bit 20
          of the raw slots, ``row_bytes``), fetched as one (R, L) array.
  host:   the reference's budget check (ffv1enc.c:283-287): a slice
          whose remaining budget falls below w * 35 bytes at a line
          start, or whose bytes pass the output cap, is re-encoded as
          PCM (slice_coding_mode 1, ffv1enc.c:1207-1217) from the host
          samples (codec/slice_codec.py), and its lane's states restart
          at 128.

The compact form drops the emit flags the budget reads, so version 4
runs the raw form, as the reference does.  Golomb-Rice at version 4
writes the v4 header fields with (1, 1) and has no budget check, as in
the reference.

Slice grids that the frame does not divide (slice_grid's slices then
differ by a column or a row, and neighbouring 4:2:0 chroma crops may
share one) run the same fused path as in the JAX package
(encoder.py:636-651 there): each lane holds its slice's stream at its
own length, the lanes grouped by slice size (at most 4 groups) for one
crop gather and one stencil per group and plane, the rest of the lane
inactive; the scans and finalize take the active mask as they are.
Version 4 searches each group's crops on the card, and off uniform
grids the reference has no row budget: a slice retries as PCM only when
its bytes pass the output cap, taken at the reference's padded length.

Adaptive states stay on the device across frames (GOP context
carry-over, ffv1enc.c:1171-1172): keyframes reset them to 128, or to the
tuned initial states of a pass-2 encoder (``stats_in``,
codec/twopass.py: the sorted custom table and the initial states, which
the extradata carries), other frames continue from the previous frame's
states.  Covered: versions 3 and 4, range coder, planar YUV/gray at
every coded width (<= 10 bits through the fast schedule, 11..16 through
the extended one) on any slice grid, and RGB on uniform grids, context
models 0 and 1 (the 5-input context, whose 2 x 7,563-row state table the
lane scan keeps in global memory); Golomb-Rice for planar YUV/gray on
uniform grids; ya8 (gray + alpha, one (H, W, 2) array per frame) as a
luma and an alpha plane on both coders; everything else raises
NotImplementedError.

With ``devices=`` (sharding.py, the port of the JAX package's ``mesh=``)
the lane scan and finalize, or G1, run on contiguous blocks of lanes,
one per device, and their outputs are gathered on the lead device,
which runs every other stage and keeps the states (encoder.py:138-147,
370-383, 686-793 of the JAX package).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..bitstream.headers import write_extradata, write_slice_header
from ..codec.context import SliceState, slice_grid
from ..codec.slice_codec import encode_plane_pcm, encode_rgb_pcm
from ..codec.params import EncoderParams, resolve
from ..codec.twopass import serialize_stats, tuned_params
from ..core import tables as T
from ..core.crc import crc32_ieee
from ..core.intmath import ceil_rshift
from ..core.rac import (ProvisionalRangeEncoder, RangeEncoder,
                        custom_state_tables, default_state_tables)
from .finalize import finalize_compact, finalize_packed, finalize_packed_full
from .golomb_encode import fresh_vlc_states, golomb_encode_lanes, make_flags
from .pipeline import FramePipeline
from .rc_encode import rc_encode_compact, rc_encode_packed, rc_encode_stats
from .rct_search import pick_rct_coefs, rct_cost_pairs
from .residual import load_plane, rct_transform, residuals_and_contexts
from .sharding import lane_blocks, resolve_devices, shard_lanes

PREFIX_CAP = 96


def row_bytes(packed, offs):
    """Bytes each lane emitted before each coded line start: packed int32
    (N, S, L) raw slots (bit 20 the emit flag), offs int64 (R,) the
    lines' stream offsets -> int32 (R, L) (encoder.py:662-668 of the JAX
    package).  The sums run in the lane-major order the kernels write
    (L, N, S), so the prefix sum runs along each lane's contiguous row:
    along N of an (N, L) array, torch's scan runs each lane serially."""
    emit = packed.permute(2, 0, 1) >> 20                  # (L, N, S)
    emit &= 1
    cum = emit.sum(dim=2, dtype=torch.int32).contiguous().cumsum(
        dim=1, dtype=torch.int32)                         # (L, N)
    gathered = cum[:, (offs - 1).clamp(min=0)]            # (L, R)
    return torch.where(offs[None, :] == 0, 0, gathered).T


class TorchFFV1Encoder:
    """Device FFV1 encoder (versions 3 and 4; planar YUV/gray with the
    range coder or Golomb-Rice, RGB with the range coder).

    ``batch`` > 1 encodes that many independent streams in lockstep:
    lanes = batch x slices, lane index = stream * n_slices + slice.  Use
    encode_frames([stream0_planes, stream1_planes, ...]); a bgr0 or bgra
    frame is one (H, W, 4) uint8 array, a gbrp frame three uint16 planes
    in the format's order (G, B, R), a ya8 frame one (H, W, 2) uint8
    array.  ``compact``
    selects the compact lane-scan form at coded widths <= 10 and version
    3 (see the module docstring); the bytes do not change.

    ``devices``: a list of devices (``sharding.make_devices(n)``, or a
    device named more than once) over which the lanes split into
    contiguous blocks for the lane scan and finalize, or the Golomb-Rice
    scan (encoder.py:138-147, 370-383, 686-793 of the JAX package's
    ``mesh=``); its length must divide the lane count.  The lead device,
    ``devices[0]``, runs everything else and holds the states between
    frames; ``device`` (default "cuda") must then name it or be left
    out.  The packets do not change.

    Two-pass encoding: with ``pass1`` the lane scans are the stats
    instances of K1 and K1-ext, and ``get_stats(stream)`` returns each
    stream's statistics text; ``stats_in`` (pass 2) sorts the custom
    table and starts every fresh lane from the tuned initial states
    (codec/twopass.py).  The packets of pass 1 are one-pass packets.

    One thread submits to and collects from an instance: each submit
    enqueues on the calling thread's current stream, which the pipeline
    captures then, and nothing here is locked.  Threads that code at
    once (the streaming server's requests) each own an instance.
    """

    def __init__(self, params: EncoderParams, batch: int = 1,
                 device=None, compact: bool = False, devices=None):
        self.devices, self.device = resolve_devices(devices, device)
        self.rp = rp = resolve(params)
        if params.stats_in:
            # pass 2: the sorted custom table and the tuned initial states
            # (codec/encoder.py:53-61 of the JAX package), before the
            # state tables and the extradata below read them
            tuned_params(rp, params.stats_in, self.device)
        self.golomb = rp.ac == T.AC_GOLOMB_RICE
        self.rgb = rp.colorspace == 1
        if rp.version not in (3, 4):
            raise NotImplementedError("only versions 3 and 4 are ported "
                                      "(version 2's output is unreadable "
                                      "in the reference)")
        if rp.colorspace not in (0, 1):
            raise NotImplementedError("only YUV/gray and RGB are ported")
        # ya8 (interleaved luma and alpha): split where a host frame
        # enters (``_host_planes``) into a luma and an alpha plane, which
        # the planar path codes, alpha on state plane 1 (encoder.py:92-96,
        # 853-859 of the JAX package; ffv1enc.c:1196)
        self.ya = rp.colorspace == 0 and rp.fmt.interleaved
        if self.rgb and self.golomb:
            raise NotImplementedError("RGB needs the range coder (coder 1 "
                                      "or 2), as in the reference")
        if rp.context_model not in (0, 1):
            raise NotImplementedError("context models 0 and 1 exist")
        self.raw_bits = 8 if rp.bits_per_raw_sample <= 8 else \
            rp.bits_per_raw_sample
        # the coded width: RGB's residuals are one bit wider than its
        # samples (ffv1enc.c:464-467)
        self.bits = self.raw_bits + 1 if self.rgb else self.raw_bits
        if self.bits > 17:
            raise NotImplementedError("no coded width above 17 bits exists")
        # 11..17-bit coded widths ride the extended schedule (K1-ext),
        # which chains put_symbol's repeated rows 10/31; their finalize
        # compacts to 6 slots per pixel (encoder.py of the JAX package)
        self.s2 = 4 if self.bits <= 10 else 6
        # version 4 searches each slice's RCT coefficients wherever the
        # reference does: RGB, and 4:4:4 YUV above 8 bits, whose planes
        # its unguarded call reads as b, g, r (encoder.py:87-91 of the
        # JAX package)
        self.rct_search = rp.version > 3 and (
            self.rgb or
            (rp.colorspace == 0 and rp.chroma_planes and
             rp.bits_per_raw_sample > 8 and
             rp.chroma_h_shift == 0 and rp.chroma_v_shift == 0))
        if compact and rp.version > 3:
            # the compact slots carry no emit flag, and the v4 row budget
            # reads it: the raw form runs, with the same bytes
            # (encoder.py:194-201 of the JAX package)
            warnings.warn("compact=True is off at version 4: the row "
                          "budget reads the raw form's emit flags")
        # pass 1 counts its decisions in the stats instances of the raw
        # form's scans
        self.pass1 = bool(params.pass1)
        if compact and self.pass1:
            warnings.warn("compact=True is off in pass 1: its statistics "
                          "are counted by the raw form's scans")
        # the compact form is fast-path only (rc_pallas.py:500)
        self.compact = bool(compact) and self.bits <= 10 and \
            rp.version <= 3 and not self.pass1
        self.batch = batch
        self.extradata = write_extradata(rp)
        self.geoms = slice_grid(rp.width, rp.height,
                                rp.num_h_slices, rp.num_v_slices)
        g0 = self.geoms[0]
        nh, nv = rp.num_h_slices, rp.num_v_slices
        self.uniform = (
            all(g.width == g0.width and g.height == g0.height
                for g in self.geoms) and
            rp.width % nh == 0 and rp.height % nv == 0 and
            (not rp.chroma_planes or
             (g0.width % (1 << rp.chroma_h_shift) == 0 and
              g0.height % (1 << rp.chroma_v_shift) == 0)))
        if not self.uniform and (self.rgb or self.golomb):
            raise NotImplementedError(
                f"{'RGB' if self.rgb else 'Golomb-Rice'} needs a uniform "
                f"slice grid, as in the reference")
        if rp.ac == T.AC_RANGE_CUSTOM_TAB:
            one, zero = custom_state_tables(rp.state_transition)
        else:
            one, zero = default_state_tables()
        dev = self.device
        self.pipe = FramePipeline(dev)
        # frames a caller may keep in flight through submit_frames /
        # collect_frames (None: no limit); version 4's PCM retry resets
        # states the next frame already read, so it refuses a frame in
        # flight (_packets)
        self.max_in_flight = 1 if rp.version > 3 and not self.golomb \
            else None
        self.one_tab = torch.from_numpy(one).to(dev)
        self.zero_tab = torch.from_numpy(zero).to(dev)
        self.cc = cc = rp.context_counts[rp.context_model]
        if self.rgb:
            # RGB plane p codes on state plane (p + 1) / 2: G 0, B and R
            # 1, A 2 (ffv1enc.c:461-467)
            n_state_planes = 2 + (1 if rp.transparency else 0)
        else:
            n_state_planes = 1 + (1 if rp.chroma_planes else 0) + \
                (1 if rp.transparency else 0)
        self.total_cc = n_state_planes * cc
        qt = np.asarray(rp.quant_tables[rp.context_model])
        self.qt = torch.from_numpy(qt.astype(np.int32)).to(dev)
        self.five_input = bool(qt[3][127])
        self.n_slices = len(self.geoms)
        self.L = self.n_slices * batch
        if self.devices is not None:
            lane_blocks(self.L, len(self.devices), " (batch x slices)")
        # each lane's stream length (slices of a non-uniform grid differ
        # by a row or a column) and the longest, the lane arrays' width
        self.stream_lens = [self._stream_len(g) for g in self.geoms]
        self.n_max = max(self.stream_lens)
        # output cap per lane: the codeable worst case is ~2.2 B/pixel at
        # 8 bits for the range coder, more at the extended widths, and
        # (12 + bits) / 8 for the Golomb escape.  Off uniform grids the
        # cap is version 4's only PCM trigger, so it takes the reference's
        # length there: n_max padded to its scan chunk (pallas_chunk x
        # unroll 2, encoder.py:205-209, 231-232 of the JAX package)
        cap_len = self.n_max
        if not self.uniform:
            pad = 2 * max(48, (216 // batch) // 8 * 8)
            cap_len = -(-self.n_max // pad) * pad
        self.out_cap = cap_len * (3 if self.bits <= 10 and
                                  not self.golomb else 4) + 4096
        # a fresh lane's states: the tuned initial states of the context
        # model's quant table tiled per state plane (pass 2), else 128
        # (clear_slice_state, codec/context.py:80-88 of the JAX package)
        init = rp.initial_states[rp.context_model]
        self.init_states = None if init is None else torch.from_numpy(
            np.tile(np.asarray(init[:cc], np.uint8),
                    (n_state_planes, 1))).to(dev)
        self.states = self._fresh_states(
            torch.empty((self.L, self.total_cc, 32), dtype=torch.uint8,
                        device=dev))
        self.picture_number = 0
        if self.pass1:
            # each stream's pass-1 statistics (codec/twopass.py of the
            # JAX package, Pass1Stats): the decisions by state and bit,
            # and by context, slot and bit on the context model's quant
            # table; keyframes so far (gob_count, ffv1enc.c:193-200)
            self.rc_stat = torch.zeros((batch, 256, 2), dtype=torch.int64,
                                       device=dev)
            self.rc_stat2 = torch.zeros((batch, cc, 32, 2),
                                        dtype=torch.int64, device=dev)
            self.gob_count = 0
        self._prefix_cache = {}
        # (slice, keyframe, (by, ry)) -> (low, range, provisional bytes)
        self._header_cache = {}
        # the last frame's searched (by, ry) per lane (version 4)
        self.rct_coefs = None
        if not self.uniform:
            self.groups, self.active = self._lane_groups()
        if rp.version > 3 and not self.golomb and self.uniform:
            # the line starts at which the reference checks its budget
            # (off uniform grids it has no row budget: encoder.py:662)
            rows = self._row_offsets(g0)
            self.row_offs = torch.tensor([o for o, _w in rows],
                                         dtype=torch.long, device=dev)
            self.row_widths = np.array([w for _o, w in rows], np.int64)
        if self.golomb:
            # the line/plane flags of a slice's coding order, shared by all
            # lanes (uniform grids), and the GOP's VLC states
            self.gflags = torch.from_numpy(
                make_flags(self._plane_dims(g0))).to(dev)
            assert self.gflags.numel() == self.n_max
            self.vlc_states = fresh_vlc_states(self.L, self.total_cc, dev)

    # -----------------------------------------------------------------

    def _fresh_states(self, like):
        """Fresh start states shaped as ``like`` (L, rows, 32): the tiled
        initial states of a pass-2 encoder, else 128 everywhere."""
        if self.init_states is None:
            return torch.full_like(like, 128)
        return self.init_states.expand_as(like).clone()

    def _plane_dims(self, geom):
        """(w, h, state_plane) of each coded plane of a slice, in coding
        order."""
        rp = self.rp
        dims = [(geom.width, geom.height, 0)]
        if rp.chroma_planes:
            cw = ceil_rshift(geom.width, rp.chroma_h_shift)
            ch = ceil_rshift(geom.height, rp.chroma_v_shift)
            dims += [(cw, ch, 1)] * 2
        if rp.transparency:
            dims.append((geom.width, geom.height,
                         2 if rp.chroma_planes else 1))
        return dims

    def _stream_len(self, geom):
        if self.rgb:
            return geom.width * geom.height * (3 + self.rp.transparency)
        return sum(w * h for (w, h, _sp) in self._plane_dims(geom))

    def _prefix_arrays(self, keyframe: bool):
        """Per-lane host-prefix arrays (keyframe bit + slice headers with
        the RCT coefficients (1, 1)), static per (geometry, keyframe), so
        cached."""
        if keyframe not in self._prefix_cache:
            self._prefix_cache[keyframe] = self._prefix_arrays_rct(
                keyframe, [(1, 1)] * self.L)
        return self._prefix_cache[keyframe]

    def _prefix_arrays_rct(self, keyframe: bool, coefs):
        """Per-lane host-prefix arrays (lows, ranges, prefixes int32 (L,
        PREFIX_CAP), plens) with each lane's RCT coefficients ``coefs``, a
        list of (by, ry) per lane (encoder.py:427-441 of the JAX package,
        which rebuilds every header every frame; here each header is
        built once per slice, keyframe flag and pair)."""
        lows = np.zeros(self.L, np.int32)
        ranges = np.zeros(self.L, np.int32)
        prefixes = np.zeros((self.L, PREFIX_CAP), np.int32)
        plens = np.zeros(self.L, np.int32)
        for lane in range(self.L):
            lo, ra, prov = self._host_prefix(lane % self.n_slices, keyframe,
                                             tuple(coefs[lane]))
            lows[lane], ranges[lane] = lo, ra
            prefixes[lane, :len(prov)] = prov
            plens[lane] = len(prov)
        return self.pipe.upload([lows, ranges, prefixes, plens])

    def _prefix_arrays_golomb(self, keyframe: bool):
        """Per-lane Golomb prefixes (the terminated slice headers, cached
        per keyframe flag): (prefixes int32 (L, PREFIX_CAP), plens)."""
        key = ("golomb", keyframe)
        if key not in self._prefix_cache:
            prefixes = np.zeros((self.L, PREFIX_CAP), np.int32)
            plens = np.zeros(self.L, np.int32)
            for si in range(self.n_slices):
                pb = np.frombuffer(self._host_prefix_golomb(si, keyframe),
                                   np.uint8)
                for bi in range(self.batch):
                    lane = bi * self.n_slices + si
                    prefixes[lane, :len(pb)] = pb
                    plens[lane] = len(pb)
            self._prefix_cache[key] = self.pipe.upload([prefixes, plens])
        return self._prefix_cache[key]

    def _host_prefix_golomb(self, si: int, keyframe: bool) -> bytes:
        """Terminated range-coded slice header for the Golomb path: the
        header is always range coded, the coder terminated after a v3
        sentinel bit, and the bit writer starts at the byte after it
        (ffv1enc.c:1176-1183)."""
        enc = RangeEncoder(*default_state_tables())
        if si == 0:
            keystate = np.array([128], dtype=np.uint8)
            enc.put_rac(keystate, 0, 1 if keyframe else 0)
        write_slice_header(self.rp, self._slice_state(si), enc)
        if self.rp.version > 2:
            sentinel = np.array([129], dtype=np.uint8)
            enc.put_rac(sentinel, 0, 0)
        return enc.terminate()

    def _slice_state(self, si: int, coefs=(1, 1)):
        """The slice fields write_slice_header reads: coding mode 0 and
        the RCT coefficients (by, ry) (written at version 4 only)."""
        return SliceState(geom=self.geoms[si], slice_rct_by_coef=coefs[0],
                          slice_rct_ry_coef=coefs[1])

    def _host_prefix(self, si: int, keyframe: bool, coefs=(1, 1)):
        """(low, range, provisional bytes) of the keyframe bit (slice 0)
        and slice ``si``'s header, cached per (slice, keyframe, coefs)."""
        key = (si, keyframe, coefs)
        if key not in self._header_cache:
            rp = self.rp
            enc = ProvisionalRangeEncoder(*default_state_tables())
            if si == 0:
                keystate = np.array([128], dtype=np.uint8)
                enc.put_rac(keystate, 0, 1 if keyframe else 0)
            if rp.ac == T.AC_RANGE_CUSTOM_TAB:
                enc.set_tables(*custom_state_tables(rp.state_transition))
            write_slice_header(rp, self._slice_state(si, coefs), enc)
            self._header_cache[key] = (enc.low, enc.range, list(enc.prov))
        return self._header_cache[key]

    def _pcm_lanes(self, counts_np, rowpos=None, cap=None):
        """bool (L,): the lanes whose slice retries as PCM.  On a uniform
        grid at version 4 (range coder) ``rowpos`` (R, L) holds each
        lane's byte position at its line starts, checked against the
        budget; off uniform grids the reference has no row budget
        (encoder.py:662 of the JAX package) and its output cap is the only
        trigger.  A count past the cap (default ``out_cap``) raises at
        version 3 and in Golomb-Rice, as the reference does (ffv1enc.c:
        1210)."""
        pcm = np.zeros(self.L, bool)
        if rowpos is not None:
            # remaining budget below w * 35 at any line start
            # (ffv1enc.c:283-287)
            pcm = ((self._slice_budget() - rowpos) <
                   self.row_widths[:, None] * 35).any(axis=0)
        over = counts_np > (self.out_cap if cap is None else cap)
        if over.any():
            if self.rp.version <= 3 or self.golomb:
                raise RuntimeError("encoded slice exceeded output cap (the "
                                   "reference errors here too: "
                                   "ffv1enc.c:1210)")
            pcm |= over
        return pcm

    def _slice_budget(self) -> int:
        """Per-slice output budget at version 4, as the reference's: the
        packet is allocated at 16384 + w * h * 12 bytes (ffv1enc.c:
        1281-1282) and carved evenly across slices (ffv1enc.c:1306-1311;
        encoder.py:1256-1263 of the JAX package)."""
        rp = self.rp
        return (16384 + rp.width * rp.height * 12) // self.n_slices

    def _row_offsets(self, geom):
        """(stream_offset, row_width) of every coded line of a slice in
        planar order: the points where the reference checks its remaining
        budget (encode_line, ffv1enc.c:283-287; encoder.py:1265-1287 of
        the JAX package, whose offsets RGB shares)."""
        rp = self.rp
        out = []
        pos = 0

        def plane(w, h):
            nonlocal pos
            for _ in range(h):
                out.append((pos, w))
                pos += w

        plane(geom.width, geom.height)
        if rp.chroma_planes:
            cw = ceil_rshift(geom.width, rp.chroma_h_shift)
            ch = ceil_rshift(geom.height, rp.chroma_v_shift)
            plane(cw, ch)
            plane(cw, ch)
        if rp.transparency:
            plane(geom.width, geom.height)
        return out

    def _encode_slice_pcm(self, si: int, planes_np, keyframe: bool) -> bytes:
        """Slice ``si`` of one stream re-encoded in PCM (slice_coding_mode
        1) on the host: the reference's retry when the range-coded slice
        would overflow its budget (ffv1enc.c:1207-1217; encoder.py:
        1289-1346 of the JAX package).  Raw samples ride fresh 128 states
        (ffv1enc.c:294-303); the header sets slice_reset_contexts."""
        rp = self.rp
        geom = self.geoms[si]
        if rp.ac == T.AC_RANGE_CUSTOM_TAB:
            slice_tables = custom_state_tables(rp.state_transition)
        else:
            slice_tables = default_state_tables()
        if si == 0:
            rc = RangeEncoder(*default_state_tables())
            keystate = np.array([128], dtype=np.uint8)
            rc.put_rac(keystate, 0, 1 if keyframe else 0)
            if rp.ac == T.AC_RANGE_CUSTOM_TAB:
                rc.set_tables(*slice_tables)
        else:
            rc = RangeEncoder(*slice_tables)
        ss = SliceState(geom=geom, slice_coding_mode=1)
        write_slice_header(rp, ss, rc)

        x, y, w, h = geom.x, geom.y, geom.width, geom.height
        bits, lsb = self.raw_bits, rp.packed_at_lsb
        if self.rgb:
            if rp.fmt.interleaved:
                sp = planes_np[0][y:y + h, x:x + w]
            else:
                sp = [p[y:y + h, x:x + w] for p in planes_np]
            encode_rgb_pcm(rc, sp, bits, rp.transparency)
        else:
            encode_plane_pcm(rc, planes_np[0][y:y + h, x:x + w], bits, lsb)
            if rp.chroma_planes:
                hs, vs = rp.chroma_h_shift, rp.chroma_v_shift
                cx, cy = x >> hs, y >> vs
                cw, ch = ceil_rshift(w, hs), ceil_rshift(h, vs)
                for k in (1, 2):
                    encode_plane_pcm(
                        rc, planes_np[k][cy:cy + ch, cx:cx + cw], bits, lsb)
            if rp.transparency:
                encode_plane_pcm(rc, planes_np[-1][y:y + h, x:x + w], bits,
                                 lsb)
        sentinel = np.array([129], dtype=np.uint8)
        rc.put_rac(sentinel, 0, 0)
        return rc.terminate()

    # -----------------------------------------------------------------

    @staticmethod
    def _crops_uniform(stack, nh, nv):
        """(B, H, W) -> (B*nv*nh, H/nv, W/nh) slice crops, lane order
        bi*n_slices + sy*nh + sx (a block reshape; uniform grids only)."""
        B, H, W = stack.shape
        h, w = H // nv, W // nh
        c = stack.reshape(B, nv, h, nh, w)
        return c.permute(0, 1, 3, 2, 4).reshape(B * nv * nh, h, w)

    def _lane_groups(self):
        """Non-uniform grids: the lanes grouped by slice size (at most 4
        groups: slice_grid's widths differ by at most one, and so do its
        heights), each group's gather indices of its crops and its lanes'
        stream length; and the (L, n_max) active mask (True on each lane's
        stream)."""
        rp = self.rp
        hs, vs = rp.chroma_h_shift, rp.chroma_v_shift
        by_size = {}
        for bi in range(self.batch):
            for si, g in enumerate(self.geoms):
                by_size.setdefault((g.width, g.height), []).append(
                    (bi * self.n_slices + si, bi, g))
        dev = self.device

        def index(members, sh, sv, w, h):
            """(stream, row, column) gather indices of the members' crops
            of a plane subsampled by (sh, sv): each crop starts at (x >>
            sh, y >> sv) and is ceil_rshift(w, sh) x ceil_rshift(h, sv)
            (encoder.py:311-316 of the JAX package; neighbouring chroma
            crops may share a column or a row)."""
            cw, ch = ceil_rshift(w, sh), ceil_rshift(h, sv)
            b = torch.tensor([bi for _l, bi, _g in members], device=dev)
            y = torch.tensor([g.y >> sv for _l, _b, g in members],
                             device=dev)
            x = torch.tensor([g.x >> sh for _l, _b, g in members],
                             device=dev)
            return (b[:, None, None],
                    y[:, None, None] + torch.arange(ch, device=dev)[:, None],
                    x[:, None, None] + torch.arange(cw, device=dev))

        groups = []
        for (w, h), members in by_size.items():
            lanes = torch.tensor([li for li, _b, _g in members], device=dev)
            groups.append(dict(
                lanes=lanes, n=self._stream_len(members[0][2]),
                luma=index(members, 0, 0, w, h),
                chroma=index(members, hs, vs, w, h) if rp.chroma_planes
                else None))
        act = np.zeros((self.L, self.n_max), bool)
        for lane in range(self.L):
            act[lane, :self.stream_lens[lane % self.n_slices]] = True
        return groups, torch.from_numpy(act).to(dev)

    def _streams(self, streams, rct=None):
        """(ctx, diff, active) lane streams, each (L, n_max): the uniform
        grid's block reshape, or one crop gather per slice size."""
        if self.uniform:
            return self._streams_uniform(streams, rct)
        return self._streams_nonuniform(streams)

    def _streams_nonuniform(self, streams):
        """(ctx, diff, active) lane streams, each (L, n_max), for a tuple
        of per-plane (batch, Hk, Wk) integer tensors on a non-uniform grid
        (planar YUV/gray; the same streams as the JAX package's per-lane
        _slice_stream, encoder.py:298, 636-651): per slice size the crops
        of all its lanes go through the stencil as one stack, and their
        rows are scattered into the lanes; past a lane's stream length
        the pixels are inactive."""
        rp = self.rp
        ctxs = torch.zeros((self.L, self.n_max), dtype=torch.int32,
                           device=self.device)
        diffs = torch.zeros_like(ctxs)
        planes = [(streams[0], "luma", 0)]
        if rp.chroma_planes:
            planes += [(streams[1], "chroma", 1), (streams[2], "chroma", 1)]
        if rp.transparency:
            planes.append((streams[-1], "luma", 2 if rp.chroma_planes else 1))
        for grp in self.groups:
            parts_ctx, parts_diff = [], []
            for stack, kind, state_plane in planes:
                s = load_plane(stack[grp[kind]], self.bits, rp.packed_at_lsb)
                c, d = residuals_and_contexts(s, self.qt, self.bits,
                                              self.five_input)
                parts_ctx.append(c.flatten(1) + state_plane * self.cc)
                parts_diff.append(d.flatten(1))
            n = grp["n"]
            ctxs[grp["lanes"], :n] = torch.cat(parts_ctx, dim=1)
            diffs[grp["lanes"], :n] = torch.cat(parts_diff, dim=1)
        return ctxs, diffs, self.active

    def _streams_uniform(self, streams, rct=None):
        """(ctx, diff, active) lane streams, each (L, n_max), for a tuple
        of per-plane (batch, Hk, Wk) integer tensors (bgr0/bgra: one
        (batch, H, W, 4) uint8 tensor).  ``rct``: RGB's per-lane (by, ry)
        int32 (L,) tensors at version 4, else None."""
        rp = self.rp
        nh, nv = rp.num_h_slices, rp.num_v_slices
        if self.rgb:
            return self._streams_uniform_rgb(streams, rct)
        parts_ctx, parts_diff = [], []

        def add(stack, state_plane):
            crops = self._crops_uniform(stack, nh, nv)
            s = load_plane(crops, self.bits, rp.packed_at_lsb)
            c, d = residuals_and_contexts(s, self.qt, self.bits,
                                          self.five_input)
            parts_ctx.append(c.reshape(self.L, -1) + state_plane * self.cc)
            parts_diff.append(d.reshape(self.L, -1))

        add(streams[0], 0)
        if rp.chroma_planes:
            add(streams[1], 1)
            add(streams[2], 1)
        if rp.transparency:
            add(streams[-1], 2 if rp.chroma_planes else 1)
        ctxs = torch.cat(parts_ctx, dim=1)
        diffs = torch.cat(parts_diff, dim=1)
        acts = torch.ones_like(ctxs, dtype=torch.bool)
        return ctxs, diffs, acts

    def _split_rgb(self, streams):
        """(b, g, r, a or None) int32 (batch, H, W) full frames, bound as
        the reference binds them: packed bgr0/bgra by its memory order
        B, G, R, A (ffv1enc.c:433-439); planar gbrp's plane 0 to "b" and
        plane 1 to "g" (ffv1enc.c:441-444), as the host encoder codes
        them."""
        if self.rp.fmt.interleaved:
            x = streams[0].to(torch.int32)
            b, g, r = x[..., 0], x[..., 1], x[..., 2]
            return b, g, r, x[..., 3] if self.rp.transparency else None
        b, g, r = (p.to(torch.int32) for p in streams[:3])
        return b, g, r, None

    def _streams_uniform_rgb(self, streams, rct=None):
        """(ctx, diff, active) lane streams for RGB: the RCT, each
        plane's slice crops through the stencil at the coded width, and
        each slice row's G, B, R(, A) lines in turn (ffv1enc.c:428-470),
        on state planes 0, 1, 1(, 2).  Version 3's fixed coefficients
        transform the full frame (pixel-local, so the same as per slice);
        version 4's per-lane ``rct`` = (by, ry) transform each lane's
        crops (encoder.py:561-575 of the JAX package)."""
        rp = self.rp
        nh, nv = rp.num_h_slices, rp.num_v_slices
        b, g, r, a = self._split_rgb(streams)
        if rct is None:
            g, b, r = rct_transform(g, b, r, self.raw_bits)
            crops = [self._crops_uniform(p, nh, nv) for p in (g, b, r)]
        else:
            by, ry = (c[:, None, None] for c in rct)
            crops = list(rct_transform(
                *(self._crops_uniform(p, nh, nv) for p in (g, b, r)),
                self.raw_bits, by, ry))
        if a is not None:
            crops.append(self._crops_uniform(a, nh, nv))
        offs = (0, self.cc, self.cc, 2 * self.cc)
        ctx_p, diff_p = [], []
        for k, plane in enumerate(crops):
            c, d = residuals_and_contexts(plane, self.qt, self.bits,
                                          self.five_input)   # (L, h, w)
            ctx_p.append(c + offs[k])
            diff_p.append(d)
        ctxs = torch.stack(ctx_p, dim=2).reshape(self.L, -1)
        diffs = torch.stack(diff_p, dim=2).reshape(self.L, -1)
        return ctxs, diffs, torch.ones_like(ctxs, dtype=torch.bool)

    def _host_planes(self, stream):
        """One stream's frame as a list of numpy planes (a bgr0/bgra or ya8
        frame may come as its one array); ya8's (H, W, 2) storage split
        into its luma and alpha planes."""
        planes = [np.asarray(p) for p in
                  (stream if isinstance(stream, (list, tuple)) else [stream])]
        if self.ya:
            return [np.ascontiguousarray(planes[0][..., k]) for k in (0, 1)]
        return planes

    def _upload(self, streams):
        """Per-plane (batch, Hk, Wk) tensors on the device (8-bit planes
        travel as uint8, deeper ones as int32; a bgr0/bgra frame as one
        (batch, H, W, 4) uint8 tensor), staged through the pipeline's
        pinned ring with no wait on the host: uint16 samples cross as
        their int16 bits and widen to int32 on the device, at half the
        bytes."""
        planes = [self._host_planes(s) for s in streams]
        stacks, wide = [], []
        for k in range(len(planes[0])):
            col = [pl[k] for pl in planes]
            wide.append(col[0].dtype == np.uint16)
            if wide[-1]:
                col = [x.view(np.int16) for x in col]
            elif col[0].dtype != np.uint8:
                col = [x.astype(np.int32) for x in col]
            stacks.append(col)
        return tuple(x.to(torch.int32) & 0xFFFF if w else x
                     for x, w in zip(self.pipe.upload(stacks), wide))

    def _device_planes(self, planes):
        """``submit_device_frames``' planes checked: per plane (batch, Hk,
        Wk) on this encoder's device (bgr0/bgra: one (batch, H, W, 4)),
        uint8 at 8 bits, int32 or uint16 (widened here) above."""
        rp = self.rp
        planes = tuple(planes)
        if self.rgb and rp.fmt.interleaved:
            shapes = [(self.batch, rp.height, rp.width, 4)]
        else:
            hs, vs = rp.chroma_h_shift, rp.chroma_v_shift
            luma = (self.batch, rp.height, rp.width)
            chroma = (self.batch, ceil_rshift(rp.height, vs),
                      ceil_rshift(rp.width, hs))
            n = 3 if self.rgb else 1 + 2 * bool(rp.chroma_planes)
            shapes = [luma if self.rgb or k == 0 else chroma
                      for k in range(n)] + [luma] * bool(rp.transparency)
        dtypes = (torch.uint8,) if self.raw_bits <= 8 else \
            (torch.int32, torch.uint16)
        if len(planes) != len(shapes) or any(
                p.device != self.device or tuple(p.shape) != s or
                p.dtype not in dtypes for p, s in zip(planes, shapes)):
            raise ValueError(
                f"expected {len(shapes)} planes of shapes {shapes} and dtype "
                f"{' or '.join(map(str, dtypes))} on {self.device}, got "
                f"{[(tuple(p.shape), p.dtype, str(p.device)) for p in planes]}")
        return tuple(p.to(torch.int32) if p.dtype == torch.uint16 else p
                     for p in planes)

    def _rct_coefs(self, planes):
        """Version 4's search on the uploaded samples (int32 above 8 bits,
        not the stencil's loaded planes): each lane's (by, ry), from the
        (L, 15) cost sums of its slice crops of b, g, r (RGB bound as
        ``_split_rgb`` binds them, YUV's planes 0, 1, 2; encoder.py:
        588-619 of the JAX package).  The picks go into the frame's slice
        headers, so the sums' fetch is the one wait on the card inside a
        version-4 submit, as the reference searches inside its worker."""
        rp = self.rp
        nh, nv = rp.num_h_slices, rp.num_v_slices
        bgr = self._split_rgb(planes)[:3] if self.rgb else planes[:3]
        if self.uniform:
            totals = rct_cost_pairs(*(self._crops_uniform(p, nh, nv)
                                      for p in bgr))
        else:
            # 4:4:4 YUV only (RGB needs a uniform grid): one search per
            # slice size, its sums put back in lane order (the JAX
            # package searches these grids on the host pixels,
            # _rct_coefs_host, with the same picks)
            totals = torch.empty((self.L, 15), dtype=torch.int64,
                                 device=self.device)
            for grp in self.groups:
                totals[grp["lanes"]] = rct_cost_pairs(
                    *(p[grp["luma"]] for p in bgr))
        return pick_rct_coefs(totals.cpu().numpy())

    def _frame_pipeline(self, streams, states0, lows, ranges, prefixes,
                        plens, compact=None, rct=None):
        """Stencil -> lane scan -> finalize for one frame step, in the
        compact form if ``compact`` (default: the encoder's).  Returns
        (bytes, counts, states, overflow, packed, low, range); packed is
        None in the compact form, whose raw slots never exist."""
        compact = self.compact if compact is None else compact
        ctxs, diffs, acts = self._streams(streams, rct)
        return self._scan_finalize(ctxs, diffs, acts, states0, lows, ranges,
                                   prefixes, plens, self.bits, compact)

    def _scan_finalize(self, ctxs, diffs, acts, states0, lows, ranges,
                       prefixes, plens, bits: int, compact: bool = False):
        """Lane scan -> finalize at coded width ``bits`` (the P pipeline
        codes its residuals at bits + 1, pframe/tpu.py; encoder.py:686 of
        the JAX package), in the compact form if ``compact``.  Returns
        (bytes, counts, states, overflow, packed, low, range); packed is
        None in the compact form, whose raw slots never exist; in pass 1
        also each lane's decision counts (stat, stat2: rc_encode_stats).
        With ``devices`` each lane block runs on its device and the
        outputs are gathered on the lead device (the raw slots along their
        lane axis, dim 2)."""

        stats = self.pass1

        def scanfin(ctxs, diffs, acts, states0, one_tab, zero_tab, lows,
                    ranges, prefixes, plens):
            if compact:
                cm, low, rng, states_out = rc_encode_compact(
                    ctxs, diffs, acts, states0, one_tab, zero_tab, lows,
                    ranges, bits)
                out, counts, overflow = finalize_compact(
                    cm, low, rng, prefixes, plens)
                return out, counts, states_out, overflow, None, low, rng
            scan = rc_encode_stats if stats else rc_encode_packed
            packed, low, rng, states_out, *lane_stats = scan(
                ctxs, diffs, acts, states0, one_tab, zero_tab, lows,
                ranges, bits)
            out, counts, overflow = finalize_packed(
                packed, low, rng, prefixes, plens, 4 if bits <= 10 else 6)
            return (out, counts, states_out, overflow, packed, low, rng,
                    *lane_stats)

        return shard_lanes(self.devices, scanfin,
                           (ctxs, diffs, acts, states0, self.one_tab,
                            self.zero_tab, lows, ranges, prefixes, plens),
                           (0, 1, 2, 3, 6, 7, 8, 9),
                           (0, 0, 0, 0, 2, 0, 0) + (0, 0) * stats)

    def _assemble(self, payloads):
        rp = self.rp
        out = bytearray()
        for payload in payloads:
            chunk = bytearray(payload)
            chunk += len(payload).to_bytes(3, "big")
            if rp.ec:
                chunk.append(0)
                chunk += int(crc32_ieee(bytes(chunk))).to_bytes(4, "little")
            out += chunk
        return bytes(out)

    def reset(self):
        """Flush analog (avcodec_flush_buffers): the next frame starts a
        fresh GOP; frames in flight are dropped."""
        self.pipe.drain()
        self.states = self._fresh_states(self.states)
        if self.golomb:
            self.vlc_states = fresh_vlc_states(self.L, self.total_cc,
                                               self.device)
        self.picture_number = 0

    def encode_frame(self, planes):
        """Encode one frame of a single stream (batch must be 1)."""
        if self.batch != 1:
            raise ValueError("encode_frame needs batch=1; use encode_frames")
        return self.encode_frames([planes])[0]

    def encode_frames(self, streams):
        """Encode one frame from each of ``batch`` independent streams;
        returns a list of (packet, keyframe) per stream."""
        self.submit_frames(streams)
        return self.collect_frames()

    def submit_frames(self, streams):
        """The device half of ``encode_frames``: upload one frame of each
        of ``batch`` streams, enqueue its stencil, lane scan and finalize,
        and start the copies of its counts, overflow flags and byte slab
        to the host, without waiting for the card (version 4's search
        aside: ``_rct_coefs``).  Pair each submit with a later
        ``collect_frames``; frame t + 1 may be submitted before frame t
        is collected.  The adaptive states chain on the device in submit
        order (encoder.py:835-904 of the JAX package)."""
        if len(streams) != self.batch:
            raise ValueError(f"expected {self.batch} streams, "
                             f"got {len(streams)}")
        self._submit(self._upload(streams), streams)

    def submit_device_frames(self, planes):
        """``submit_frames`` for a source already on the device: ``planes``
        is a tuple of per-plane (batch, Hk, Wk) tensors (bgr0/bgra: one
        (batch, H, W, 4); ya8: the luma and alpha pair, as the JAX
        package's class takes them) on this encoder's device, uint8 at 8
        bits, int32 or uint16 above: a decoder's ``device_out`` frames, for a
        transcode whose pixels never reach the host.  Only the byte slab
        crosses; a PCM retry at version 4 fetches the failing stream's
        planes (encoder.py:906-934 of the JAX package)."""
        if self.golomb:
            raise NotImplementedError(
                "device-source submit requires the fused range-coder "
                "pipeline, as in the reference")
        if self.rct_search and not self.uniform:
            raise NotImplementedError(
                "device-source v4 search needs a uniform slice grid, as in "
                "the reference (its non-uniform search reads host pixels)")
        self._submit(self._device_planes(planes), None)

    def _keyframe(self) -> bool:
        rp = self.rp
        return rp.gop_size == 0 or self.picture_number % rp.gop_size == 0

    def _submit(self, planes, streams):
        """Enqueue one frame step on ``planes`` (device tensors; the host
        ``streams`` too where they exist, for a PCM retry) and queue what
        its collect reads."""
        keyframe = self._keyframe()
        if self.golomb:
            # Golomb-Rice codes no range-coder decision the statistics
            # count, as the host's VLC path calls no hook
            out, counts = self._encode_golomb(planes, keyframe)
            self._fetch(dict(out=out, counts=counts), keyframe, self.out_cap,
                        planes, streams)
            return
        rct = None
        if self.rct_search:
            coefs = self.rct_coefs = self._rct_coefs(planes)
            lows, ranges, prefixes, plens = self._prefix_arrays_rct(
                keyframe, coefs)
            if self.rgb:
                c = self.pipe.put(np.asarray(coefs, np.int32))
                rct = (c[:, 0], c[:, 1])
        else:
            lows, ranges, prefixes, plens = self._prefix_arrays(keyframe)
        states0 = self._fresh_states(self.states) if keyframe \
            else self.states
        out, counts, states_out, overflow, packed, low, rng, *lane_stats = \
            self._frame_pipeline(planes, states0, lows, ranges, prefixes,
                                 plens, rct=rct)
        self.states = states_out
        self.picture_number += 1
        fetch = dict(out=out, counts=counts, overflow=overflow)
        # pass 1's counts join the streams' tables at collect, without
        # the lanes that retry as PCM
        counted = dict(lane_stats=lane_stats) if lane_stats else {}
        if self.rp.version > 3 and self.uniform:
            # each lane's provisional byte position at its line starts
            fetch["rowpos"] = row_bytes(packed, self.row_offs) + \
                plens[None, :]
        # the compact form's redo reads the frame's planes and start states
        redo = dict(states0=states0, rct=rct) if self.compact else {}
        self._fetch(fetch, keyframe, self.out_cap, planes, streams,
                    packed=packed, low=low, rng=rng, lows=lows, ranges=ranges,
                    prefixes=prefixes, plens=plens, **redo, **counted)

    def _fetch(self, tensors, keyframe: bool, cap: int, planes, streams,
               **meta):
        """Start the copies a collect reads: ``tensors``, the byte slab
        ``out`` cut to ``cap``, the widest a kept lane can be (a count past
        it raises or retries as PCM)."""
        tensors["out"] = tensors["out"][:, :cap]
        self.pipe.fetch(tensors, dict(meta, keyframe=keyframe, cap=cap,
                                      planes=planes, streams=streams))

    def collect_frames(self):
        """The host half of ``encode_frames`` for the oldest frame in
        flight: wait for its copies, redo an overflowing finalize, run the
        version-4 budget check and PCM retry, and assemble each stream's
        packet (encoder.py:1105-1248 of the JAX package).  Returns a list
        of (packet, keyframe) per stream."""
        pipe = self.pipe
        rec = pipe.pop()
        m = rec.meta
        counts = pipe.host(rec, "counts").astype(np.int64)
        out_np = pipe.host(rec, "out")
        if "overflow" in rec.host and pipe.host(rec, "overflow").any():
            out, counts_t = self._redo(m)
            counts = counts_t.cpu().numpy().astype(np.int64)
            out_np = out[:, :m["cap"]].cpu().numpy()
        rowpos = pipe.host(rec, "rowpos") if "rowpos" in rec.host else None
        try:
            return self._packets(out_np, counts, m, rowpos)
        finally:
            pipe.release(rec)

    def _redo(self, m):
        """A frame some pixel of which emitted more slots than finalize
        keeps: the compact form redoes the frame on the raw scan from the
        same start states (the stencil recomputed from the kept planes;
        its states equal the compact launch's, which stay), then, as the
        raw form does, finalizes at full slot width.  Returns (bytes,
        counts) on the device."""
        packed, low, rng = m["packed"], m["low"], m["rng"]
        args = (m["lows"], m["ranges"], m["prefixes"], m["plens"])
        if packed is None:
            out, counts, _st, overflow, packed, low, rng = \
                self._frame_pipeline(m["planes"], m["states0"], *args,
                                     compact=False, rct=m["rct"])
            if not bool(overflow.any()):
                return out, counts
        return finalize_packed_full(packed, low, rng, m["prefixes"],
                                    m["plens"])

    def _encode_golomb(self, planes, keyframe: bool):
        """Stencil -> G1 for one frame step; the VLC states start fresh on a
        keyframe and carry on otherwise.  Returns (bytes, counts)."""
        prefixes, plens = self._prefix_arrays_golomb(keyframe)
        vlc0 = fresh_vlc_states(self.L, self.total_cc, self.device) \
            if keyframe else self.vlc_states
        ctxs, diffs, acts = self._streams_uniform(planes)
        out, counts, self.vlc_states, _ri = shard_lanes(
            self.devices, golomb_encode_lanes,
            (ctxs, diffs, acts, self.gflags, vlc0, prefixes, plens,
             self.bits, self.cc, self.out_cap), (0, 1, 2, 4, 5, 6))
        self.picture_number += 1
        return out, counts

    def _packets(self, out_np, counts_np, m, rowpos=None):
        """Each stream's packet from the lanes' bytes ``out_np`` (L, >=
        counts) and counts on the host.  At version 4 (range coder) a slice
        that fails the budget check or passes the output cap is re-encoded
        in PCM (``_pcm_lanes``; encoder.py:1164-1248 of the JAX package)
        from the frame's host planes, or from its device planes fetched
        per stream; with frames still in flight that raises, as the
        reference does, since the retry resets lanes of the states the
        next frame already read."""
        keyframe = m["keyframe"]
        pcm = self._pcm_lanes(counts_np, rowpos, m["cap"])
        if pcm.any() and self.pipe.pending:
            raise RuntimeError(
                "PCM fallback with frames in flight would corrupt the GOP "
                "context chain; use encode_frames() (depth 1) for version-4 "
                "content that may overflow")
        payloads = [out_np[li, :counts_np[li]].tobytes()
                    for li in range(self.L)]
        fetched = {}
        for li in np.nonzero(pcm)[0]:
            bi, si = divmod(int(li), self.n_slices)
            if bi not in fetched:
                fetched[bi] = self._host_planes(m["streams"][bi]) \
                    if m["streams"] is not None else \
                    [p[bi].cpu().numpy() for p in m["planes"]]
            payloads[li] = self._encode_slice_pcm(si, fetched[bi], keyframe)
        if pcm.any():
            # a PCM slice's header sets slice_reset_contexts, which clears
            # the lane's contexts on both sides (ffv1enc.c:1054-1056,
            # ffv1dec.c:419-420) to their initial states
            mask = torch.from_numpy(pcm).to(self.device)
            self.states[mask] = self._fresh_states(self.states)[mask]
        if self.pass1:
            # counted at collect, as the frame's decisions are: a frame
            # that reset() drops in flight counts in neither
            self.gob_count += keyframe
            if "lane_stats" in m:
                self._add_stats(*m["lane_stats"], pcm)
        return [(self._assemble(payloads[bi * self.n_slices:
                                         (bi + 1) * self.n_slices]),
                 keyframe)
                for bi in range(self.batch)]

    def _add_stats(self, stat, stat2, pcm):
        """Add one frame's per-lane decision counts (stat int32 (L, 256,
        2), stat2 int32 (L, total_cc, 32, 2)) to each stream's tables:
        the lanes of a stream summed, and its state planes' rows summed
        onto the quant table's contexts.  A lane retried as PCM (``pcm``,
        bool (L,)) adds nothing: its packet codes none of the scan's
        decisions."""
        if pcm.any():
            keep = torch.from_numpy(~pcm).to(self.device)
            stat = stat * keep[:, None, None]
            stat2 = stat2 * keep[:, None, None, None]
        self.rc_stat += stat.view(self.batch, -1, 256, 2).sum(
            1, dtype=torch.int64)
        self.rc_stat2 += stat2.view(self.batch, -1, self.cc, 32, 2).sum(
            1, dtype=torch.int64)

    def get_stats(self, stream: int = 0) -> str:
        """Stream ``stream``'s pass-1 statistics as the reference's
        stats_out text (ffv1enc.c:1235-1279; the host encoder's
        get_stats): the decisions of the frames collected so far; feed it
        into a pass-2 EncoderParams.stats_in."""
        if not self.pass1:
            raise RuntimeError("encoder was not created with pass1=True")
        rp = self.rp
        rc_stat2 = [np.zeros((rp.context_counts[i], 32, 2), np.uint64)
                    for i in range(rp.quant_table_count)]
        rc_stat2[rp.context_model] = self.rc_stat2[stream].cpu().numpy()
        return serialize_stats(self.rc_stat[stream].cpu().numpy(), rc_stat2,
                               self.gob_count)
