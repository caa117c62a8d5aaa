"""FFV1-P, the motion-compensated inter codec, on the device.

Port of ``tpu_ffv1/pframe/tpu.py`` (``TPUFFV1PEncoder``,
``TPUFFV1PDecoder``): byte for byte the host ``FFV1PEncoder``'s stream
(``tpu_ffv1/pframe/codec.py``).  Per P frame step of the encoder, all on
the device but the packet assembly:

  motion search  -> rate-aware full or EPZS search over the slice lanes
                    (motion.py), then the per-block intra decision
  OBMC predict   -> each pixel blends the MC predictions of its 2x2
                    nearest blocks with exact-integer tent weights (one
                    gather per tap, ``obmc_predict_dev``)
  residual       -> cur - pred + (1 << bits), coded at bits + 1 (the RGB
                    offset trick, ffv1enc.c:464-467) through the stencil
  MV section     -> per block [flag, d_dy, d_dx] put_symbols on three
                    context rows appended to the state table, ahead of
                    the residuals in one symbol stream
  entropy scan   -> the lane scan + finalize at bits + 1
                    (``TorchFFV1Encoder._scan_finalize``: K1 at 9 or 10
                    bits, K1-ext at 11..16)

Keyframes are the intra encoder's packets; after each, the P chain's
adaptive states restart at 128 and the MV predictors at 0, as the host
codec clears a fresh slice state per GOP.  Reference planes, MV
predictors and states stay on the device across the GOP.

The decoder parses each P packet's slice headers and MV sections on the
host (per lane, with the port's own RangeDecoder), decodes the residual
planes of all lanes in one lane scan at bits + 1 (``rc_decode_planes``:
K2) from each lane's coder state after its MV section, and rebuilds the
frame with OBMC on the device.  Damage follows the host ``FFV1PDecoder``:
a slice whose CRC, header or MV section fails keeps the previous
picture's rect and its adaptive states; a slice that fails the sentinel
check keeps what it decoded; the flags clear at each keyframe only.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..bitstream.symbols import get_symbol
from ..codec.params import EncoderParams
from ..core import tables as T
from ..core.rac import RangeDecoder, default_state_tables
from ..tpu import rc_decode
from ..tpu.decoder import TorchFFV1Decoder
from ..tpu.encoder import TorchFFV1Encoder
from ..tpu.residual import load_plane, residuals_and_contexts
from .codec import BLOCK, LAMBDA, p_extradata, split_p_extradata
from .motion import SEARCH_FNS


def _tent_indices(H, W, by, bx):
    """Static OBMC geometry: per pixel row/column the top/left neighbour
    block and the tent weight of the other one (exact integers; the
    numpy ``obmc_predict`` of tpu_ffv1/pframe/codec.py)."""
    y = np.arange(H)
    x = np.arange(W)
    ty = (2 * y + 1 - by) // (2 * by)
    wy1 = (2 * y + 1 - by) - ty * 2 * by
    tx = (2 * x + 1 - bx) // (2 * bx)
    wx1 = (2 * x + 1 - bx) - tx * 2 * bx
    return ty, wy1, tx, wx1


@functools.lru_cache(maxsize=32)
def _taps(H, W, by, bx, device):
    """The four OBMC taps of an (H, W) plane of (by, bx) blocks: per tap
    the neighbour block row and column of each pixel row and column
    (int64) and the tap's weight per pixel (int32 (H, W)), on ``device``;
    cached, so a frame step uploads none of them (read only)."""
    bh, bw = H // by, W // bx
    ty, wy1, tx, wx1 = _tent_indices(H, W, by, bx)
    taps = []
    for dy in (0, 1):
        iy = np.clip(ty + dy, 0, bh - 1)
        wy = 2 * by - wy1 if dy == 0 else wy1
        for dx in (0, 1):
            ix = np.clip(tx + dx, 0, bw - 1)
            wx = 2 * bx - wx1 if dx == 0 else wx1
            taps.append(tuple(torch.from_numpy(a).to(device,
                                                     non_blocking=True)
                              for a in (
                iy.astype(np.int64), ix.astype(np.int64),
                np.outer(wy, wx).astype(np.int32))))
    return tuple(taps)


def obmc_predict_dev(ref_pad, mvs, intra, mid: int, by: int, bx: int):
    """OBMC over lanes: each pixel blends the MC predictions of its 2x2
    nearest block centres with exact-integer bilinear tent weights
    (partition of unity, sum 4 * by * bx).  ``ref_pad``: int32 (L, H, W),
    H and W multiples of (by, bx); ``mvs``: int32 (L, bh, bw, 2);
    ``intra``: bool (L, bh, bw), whose blocks contribute ``mid``.
    Returns int32 (L, H, W).

    The gather form of the JAX function (tpu.py:133-150 there); its
    one-hot form gives the same integers.  Weights sum to at most 1024
    and samples are below 2^16, so the int32 sum cannot overflow."""
    L, H, W = ref_pad.shape
    dev = ref_pad.device
    shift = 2 + (by - 1).bit_length() + (bx - 1).bit_length()
    flat = ref_pad.reshape(L, -1)
    yy = torch.arange(H, device=dev)[None, :, None]
    xx = torch.arange(W, device=dev)[None, None, :]
    acc = torch.zeros((L, H, W), dtype=torch.int32, device=dev)
    for iy, ix, w in _taps(H, W, by, bx, dev):
        mvb = mvs[:, iy][:, :, ix]                        # (L, H, W, 2)
        inb = intra[:, iy][:, :, ix]                      # (L, H, W)
        ys = (yy + mvb[..., 0]).clamp_(0, H - 1)
        xs = (xx + mvb[..., 1]).clamp_(0, W - 1)
        p = torch.gather(flat, 1, (ys * W + xs).view(L, -1).long())
        p = torch.where(inb, mid, p.view(L, H, W))
        acc += w * p
    return (acc + (1 << (shift - 1))) >> shift


def _pad_edge(x, ph: int, pw: int):
    """Edge-pad the trailing two dims of (L, H, W) by ``ph`` rows and
    ``pw`` columns (pad_to_block on the device)."""
    if ph:
        x = torch.cat([x, x[:, -1:, :].expand(-1, ph, -1)], dim=1)
    if pw:
        x = torch.cat([x, x[:, :, -1:].expand(-1, -1, pw)], dim=2)
    return x


def _chroma_block(rp):
    """(by, bx) of a chroma plane's blocks: BLOCK >> the subsampling,
    at least 2 (pframe/codec.py _residual_jobs)."""
    return (max(BLOCK >> rp.chroma_v_shift, 2),
            max(BLOCK >> rp.chroma_h_shift, 2))


def _chroma_mvs(mvs, rp):
    """Luma vectors scaled to a chroma plane: arithmetic shifts by the
    subsampling (negative vectors round down)."""
    return torch.stack([mvs[..., 0] >> rp.chroma_v_shift,
                        mvs[..., 1] >> rp.chroma_h_shift], dim=-1)


class TorchFFV1PEncoder(TorchFFV1Encoder):
    """Device FFV1-P encoder (experimental, as the host FFV1PEncoder).

    ``batch`` streams advance in lockstep with a shared GOP cadence;
    lanes = batch x slices.  Keyframes are the intra encoder's packets;
    P frames are byte-identical to the host FFV1PEncoder's.  Planar
    YUV/gray up to 15 bits, range coder, version 3, uniform slice grids,
    ``gop_size`` >= 2; ``me`` "full" or "epzs" within ``radius``."""

    def __init__(self, params: EncoderParams, batch: int = 1,
                 radius: int = 7, experimental: bool = False,
                 me: str = "full", device="cuda"):
        if not experimental:
            raise ValueError(
                "FFV1-P motion coding is experimental; pass "
                "experimental=True (mirrors the reference's strict -2 "
                "gate, ffv1enc.c:703-706)")
        if params.gop_size < 2:
            raise ValueError("FFV1-P needs gop_size >= 2")
        if me not in SEARCH_FNS:
            raise ValueError(f"me must be one of {sorted(SEARCH_FNS)}")
        self.me = me
        super().__init__(params, batch=batch, device=device)
        rp = self.rp
        if rp.bits_per_raw_sample > 15 or rp.colorspace != 0 or \
                rp.fmt.interleaved:
            raise NotImplementedError(
                "FFV1-P supports planar YUV/gray input up to 15 bits "
                "(residuals code at bits+1)")
        if rp.ac == T.AC_GOLOMB_RICE:
            raise NotImplementedError("FFV1-P requires the range coder")
        if rp.version != 3:
            raise NotImplementedError("FFV1-P rides version 3")
        if not self.uniform:
            raise NotImplementedError(
                "FFV1-P requires a uniform slice grid")
        self.radius = radius
        g0 = self.geoms[0]
        # blocks never straddle slices: each lane pads its slice to block
        # multiples by edge replication, as the host pads per slice
        self.pad_h = (-g0.height) % BLOCK
        self.pad_w = (-g0.width) % BLOCK
        self.SH = g0.height + self.pad_h
        self.SW = g0.width + self.pad_w
        self.bh, self.bw = self.SH // BLOCK, self.SW // BLOCK
        self.extradata = p_extradata(self.extradata)

        # three MV context rows (flag, dy, dx) after the plane state groups
        self.mv_base = self.total_cc
        self.total_cc += 3
        self.states = torch.full((self.L, self.total_cc, 32), 128,
                                 dtype=torch.uint8, device=self.device)

        # P stream geometry: the MV section (3 slots per block) and the
        # residual planes at bits + 1, padded with inactive slots to the
        # reference's scan chunk (pallas_chunk x unroll 2; encoder.py:
        # 205-209 of the JAX package), and the reference's output cap
        self.p_bits = self.bits + 1
        self.mv_cap = 3 * self.bh * self.bw
        pad = 2 * max(48, (216 // batch) // 8 * 8)
        self.p_n_max = -(-(self.mv_cap + self.stream_lens[0]) // pad) * pad
        self.p_out_cap = self.p_n_max * 3 + 4096

        self.ref_dev = None                 # tuple of (batch, Hk, Wk)
        self.prev_mvs = torch.zeros((self.L, self.bh, self.bw, 2),
                                    dtype=torch.int32, device=self.device)

    # -----------------------------------------------------------------

    def _crops(self, stack):
        return self._crops_uniform(stack.to(torch.int32),
                                   self.rp.num_h_slices,
                                   self.rp.num_v_slices)

    def _search(self, cur_pad, ref_pad, prev_mvs):
        """The motion search over the lanes' padded luma crops and the
        per-block intra decision (pframe/codec.py _search_slice): intra
        where even the best vector costs more than coding around the
        block mean.  Returns (mvs, 0 on intra blocks; intra)."""
        mvs, _sad, cost = SEARCH_FNS[self.me](cur_pad, ref_pad, prev_mvs,
                                              BLOCK, self.radius, LAMBDA)
        B2 = BLOCK * BLOCK
        blocks = cur_pad.reshape(self.L, self.bh, BLOCK, self.bw, BLOCK) \
            .permute(0, 1, 3, 2, 4).reshape(self.L, self.bh, self.bw, B2)
        mean = (blocks.sum(dim=-1, dtype=torch.int32) + B2 // 2) // B2
        intra_sad = (blocks - mean[..., None]).abs().sum(dim=-1,
                                                        dtype=torch.int32)
        intra = cost > intra_sad + B2
        return torch.where(intra[..., None], 0, mvs), intra

    def _mv_stream(self, mvs, intra, prev_mvs):
        """(ctx, diff, active) of the MV section, each (L, 3 * blocks):
        row-major blocks, slots [flag, d_dy, d_dx] on rows mv_base + {0,
        1, 2}; an intra block's deltas are inactive."""
        L, nb = self.L, self.bh * self.bw
        d = (mvs - prev_mvs).reshape(L, nb, 2)
        inter = (~intra).reshape(L, nb)
        diffs = torch.stack([inter.to(torch.int32), d[..., 0], d[..., 1]],
                            dim=2).reshape(L, 3 * nb)
        ctxs = (torch.arange(3 * nb, dtype=torch.int32, device=self.device)
                % 3 + self.mv_base).expand(L, -1)
        acts = torch.stack([torch.ones_like(inter), inter, inter],
                           dim=2).reshape(L, 3 * nb)
        return ctxs, diffs, acts

    def _residual_streams(self, streams, refs, mvs, intra):
        """OBMC + residual + stencil for all planes; (ctx, diff) lane
        streams in coding order (luma, the chroma pair, alpha:
        pframe/codec.py _residual_jobs)."""
        rp = self.rp
        mid = 1 << (self.raw_bits - 1)
        offset = 1 << self.raw_bits
        parts_ctx, parts_diff = [], []

        def add(cur_stack, ref_stack, blk, pmvs, state_plane):
            by, bx = blk
            cur, ref = self._crops(cur_stack), self._crops(ref_stack)
            h, w = cur.shape[1], cur.shape[2]
            ref_p = _pad_edge(ref, (-h) % by, (-w) % bx)
            pred = obmc_predict_dev(ref_p, pmvs, intra, mid, by, bx)
            res = cur - pred[:, :h, :w] + offset
            c, d = residuals_and_contexts(load_plane(res, self.p_bits, True),
                                          self.qt, self.p_bits,
                                          self.five_input)
            parts_ctx.append(c.reshape(self.L, -1) + state_plane * self.cc)
            parts_diff.append(d.reshape(self.L, -1))

        add(streams[0], refs[0], (BLOCK, BLOCK), mvs, 0)
        if rp.chroma_planes:
            cblk, cmvs = _chroma_block(rp), _chroma_mvs(mvs, rp)
            add(streams[1], refs[1], cblk, cmvs, 1)
            add(streams[2], refs[2], cblk, cmvs, 1)
        if rp.transparency:
            add(streams[-1], refs[-1], (BLOCK, BLOCK), mvs,
                2 if rp.chroma_planes else 1)
        return torch.cat(parts_ctx, dim=1), torch.cat(parts_diff, dim=1)

    def _frame_pipeline_p(self, streams, refs, prev_mvs, states0, lows,
                          ranges, prefixes, plens):
        """One P frame step: search -> OBMC -> residual -> the MV section
        and the residuals as one (L, p_n_max) symbol stream, padded with
        inactive slots -> lane scan -> finalize at bits + 1.  Returns
        (bytes, counts, states, overflow, packed, low, range, the next
        frame's MV predictors)."""
        cur_pad = _pad_edge(self._crops(streams[0]), self.pad_h, self.pad_w)
        ref_pad = _pad_edge(self._crops(refs[0]), self.pad_h, self.pad_w)
        mvs, intra = self._search(cur_pad, ref_pad, prev_mvs)
        mv_ctx, mv_diff, mv_act = self._mv_stream(mvs, intra, prev_mvs)
        res_ctx, res_diff = self._residual_streams(streams, refs, mvs, intra)
        tail = self.p_n_max - self.mv_cap - res_ctx.shape[1]
        ctxs = F.pad(torch.cat([mv_ctx, res_ctx], dim=1), (0, tail))
        diffs = F.pad(torch.cat([mv_diff, res_diff], dim=1), (0, tail))
        acts = F.pad(torch.cat([mv_act, torch.ones_like(res_ctx,
                                                        dtype=torch.bool)],
                               dim=1), (0, tail))
        out = self._scan_finalize(ctxs, diffs, acts, states0, lows, ranges,
                                  prefixes, plens, self.p_bits)
        # inter blocks update the MV predictor field; intra keep it
        return (*out, torch.where(intra[..., None], prev_mvs, mvs))

    def reset(self):
        """Flush analog: the next frame is a fresh keyframe; the reference
        planes and the MV predictor chain are dropped."""
        super().reset()
        self.ref_dev = None
        self.prev_mvs.zero_()

    def _submit(self, planes, streams):
        """One frame step (``TorchFFV1Encoder.submit_frames``; pframe/tpu.py:
        379-483 of the JAX package): a keyframe codes as the intra
        encoder's and resets the P chain's states and MV predictors; a P
        frame runs ``_frame_pipeline_p`` against the last submitted planes.
        The collect cuts a P frame's slab at ``p_out_cap``."""
        keyframe = self._keyframe()
        lows, ranges, prefixes, plens = self._prefix_arrays(keyframe)
        if keyframe:
            out, counts, _st, overflow, packed, low, rng = \
                self._frame_pipeline(planes, torch.full_like(self.states, 128),
                                     lows, ranges, prefixes, plens)
            # the keyframe's evolved contexts are not the P chain's: it
            # restarts from 128 after every keyframe
            self.states = torch.full_like(self.states, 128)
            self.prev_mvs.zero_()
            cap = self.out_cap
        else:
            out, counts, self.states, overflow, packed, low, rng, \
                self.prev_mvs = self._frame_pipeline_p(
                    planes, self.ref_dev, self.prev_mvs, self.states, lows,
                    ranges, prefixes, plens)
            cap = self.p_out_cap
        self.ref_dev = planes
        self.picture_number += 1
        self._fetch(dict(out=out, counts=counts, overflow=overflow), keyframe,
                    cap, planes, streams, packed=packed, low=low, rng=rng,
                    lows=lows, ranges=ranges, prefixes=prefixes, plens=plens)


class TorchFFV1PDecoder:
    """Device FFV1-P decoder: the host parses slice headers and MV
    sections, one lane scan decodes the residual planes of all lanes at
    bits + 1, and OBMC rebuilds the frame on the device.  Keyframes ride
    ``TorchFFV1Decoder``; reference planes stay on the device across the
    GOP.  8-bit content, uniform slice grids and one quant table across
    the decoded slices of a frame, as the JAX class; ``batch`` streams
    decode in lockstep with a shared GOP cadence.

    ``stage_ms`` holds the last P frame's host stages (ms): the packet
    parse and the MV sections' parse."""

    def __init__(self, width: int, height: int, extradata: bytes,
                 batch: int = 1, device="cuda"):
        self.base = b = TorchFFV1Decoder(width, height,
                                         split_p_extradata(extradata),
                                         batch=batch, device=device)
        if b.rgb or b.golomb:
            raise NotImplementedError(
                "FFV1-P streams are planar YUV/gray with the range coder")
        if not b.uniform:
            raise NotImplementedError(
                "FFV1-P decode requires a uniform slice grid")
        if b.bits > 8:
            raise NotImplementedError(
                "FFV1-P decode supports 8-bit content")
        self.device = b.device
        self.batch = batch
        self.width, self.height = width, height
        self.L = b.L
        g0 = b.geoms[0]
        self.bh = -(-g0.height // BLOCK)
        self.bw = -(-g0.width // BLOCK)
        self.p_bits = b.bits + 1
        # per lane, host side: the MV section's states and predictors
        self.flag_states = np.full((self.L, 32), 128, np.uint8)
        self.mv_states = np.full((self.L, 2, 32), 128, np.uint8)
        self.prev_mvs = np.zeros((self.L, self.bh, self.bw, 2), np.int32)
        # device side: the residual planes' states, the reference planes
        self.p_states = None
        self.ref_dev = None                 # tuple of (batch, Hk, Wk)
        # the P stream's damage flags (the host FFV1PDecoder's: set by a
        # P slice's CRC, header, MV section or sentinel, cleared at each
        # keyframe)
        self.slice_damaged = np.zeros((batch, b.n_slices), bool)
        self.stage_ms = {}

    def reset(self):
        """Flush analog: drop GOP contexts, MV chain and the reference
        planes; the next packet must be a keyframe."""
        self._reset_gop()
        self.ref_dev = None
        self.base.reset()
        self.slice_damaged[:] = False

    def _reset_gop(self):
        self.flag_states[:] = 128
        self.mv_states[:] = 128
        self.prev_mvs[:] = 0
        self.p_states = None

    def decode_frame(self, pkt: bytes):
        if self.batch != 1:
            raise ValueError("decode_frame needs batch=1; use decode_frames")
        return self.decode_frames([pkt])[0]

    @staticmethod
    def _keyframe_bit(pkt: bytes) -> bool:
        rc = RangeDecoder(pkt, *default_state_tables())
        return bool(rc.get_rac(np.array([128], np.uint8), 0))

    def decode_frames(self, pkts):
        """Decode one packet of each of ``batch`` streams; a list of
        (planes, keyframe) with host numpy planes."""
        b = self.base
        if len(pkts) != self.batch:
            raise ValueError(f"expected {self.batch} packets, "
                             f"got {len(pkts)}")
        keyframes = [self._keyframe_bit(p) for p in pkts]
        if any(keyframes):
            if not all(keyframes):
                raise ValueError("batched FFV1-P streams must share the "
                                 "keyframe cadence")
            results = b.decode_frames(pkts)
            self._reset_gop()
            self.slice_damaged[:] = False
            self.ref_dev = tuple(
                torch.from_numpy(np.stack([r[0][k] for r in results])).to(
                    self.device, torch.int32)
                for k in range(len(results[0][0])))
            return results
        t0 = time.perf_counter()
        parsed = [b._parse_packet(bi, pkt) for bi, pkt in enumerate(pkts)]
        t1 = time.perf_counter()
        # a slice whose CRC or header fails is neither parsed further nor
        # decoded: it keeps the previous picture and its states
        ok = np.array([s[1] is not None and not b.crc_failed[bi, si]
                       for bi, p in enumerate(parsed)
                       for si, s in enumerate(p[1])])
        mvs, intra, lrp, dec = self._parse_mv_sections(parsed, ok)
        t2 = time.perf_counter()
        self.stage_ms = dict(parse=(t1 - t0) * 1e3, mv_parse=(t2 - t1) * 1e3)
        self.slice_damaged |= ~dec.reshape(self.batch, -1)
        full = self.ref_dev
        if dec.any():
            full = self._decode_residuals(parsed, mvs, intra, lrp, dec)
        self.ref_dev = full
        return [(list(planes), False) for planes in zip(*(
            x.to(torch.uint8).cpu().numpy() for x in full))]

    def _parse_mv_sections(self, parsed, ok):
        """Host MV decode of the lanes in ``ok`` (bool (L,)), each from its
        coder state after its slice header.  Returns (mvs int32 (L, bh,
        bw, 2), intra bool (L, bh, bw), (low, range, pos) int32 (3, L) at
        the residual planes, and the lanes to decode: ``ok`` less those
        whose MV section failed).  A failed section leaves its lane's
        predictors as they were, and its states as the failed parse left
        them, as the host's slice aborts."""
        b = self.base
        mvs = np.zeros((self.L, self.bh, self.bw, 2), np.int32)
        intra = np.zeros((self.L, self.bh, self.bw), bool)
        lrp = np.zeros((3, self.L), np.int32)
        dec = ok.copy()
        for lane in np.nonzero(ok)[0]:
            bi, si = divmod(int(lane), b.n_slices)
            buf, _q, lo, ra, po = parsed[bi][1][si]
            src = RangeDecoder(buf)
            src.set_tables(*b.tables)
            src.low, src.range, src.pos = lo, ra, po
            fs, ms, prev = (self.flag_states[lane], self.mv_states[lane],
                            self.prev_mvs[lane])
            try:
                for by in range(self.bh):
                    for bx in range(self.bw):
                        if get_symbol(src, fs, True):
                            mvs[lane, by, bx, 0] = prev[by, bx, 0] + \
                                get_symbol(src, ms[0], True)
                            mvs[lane, by, bx, 1] = prev[by, bx, 1] + \
                                get_symbol(src, ms[1], True)
                        else:
                            intra[lane, by, bx] = True
            except (ValueError, IndexError):
                dec[lane] = False
                continue
            lrp[:, lane] = (src.low, src.range, src.pos)
            self.prev_mvs[lane] = np.where(intra[lane, ..., None], prev,
                                           mvs[lane])
        return mvs, intra, lrp, dec

    def _decode_residuals(self, parsed, mvs, intra, lrp, dec):
        """The residual lane scan at bits + 1 over all lanes, its states
        kept for the decoded lanes (``dec``) only, the sentinel check, and
        the OBMC reconstruction.  Returns the full planes, each int32
        (batch, Hk, Wk) on the device."""
        b = self.base
        qs = {parsed[lane // b.n_slices][1][lane % b.n_slices][1]
              for lane in np.nonzero(dec)[0]}
        if len(qs) > 1:
            raise NotImplementedError(
                "FFV1-P decode requires a shared quant table across "
                "slices; use the host decoder")
        qidx = qs.pop()
        qt, cc, five = b.quant[qidx]
        if self.p_states is None:
            self.p_states = b._fresh(qidx)[None].repeat(self.L, 1, 1)
        (bufs, _lo, _ra, _po), buflens = b._lane_buffers(parsed)
        lows, ranges, poss = torch.from_numpy(lrp).to(self.device)
        specs = tuple((w, h, sp * cc) for (w, h, sp) in b._plane_specs())
        planes, states_out, low, rng, pos = rc_decode.rc_decode_planes(
            bufs, self.p_states, b.one_tab, b.zero_tab, qt, lows, ranges,
            poss, specs, self.p_bits, five)
        dec_t = torch.from_numpy(dec).to(self.device)
        self.p_states = torch.where(dec_t[:, None, None], states_out,
                                    self.p_states)
        # sentinel + byte-count check (ffv1dec.c:459-467); a slice that
        # fails it keeps what it decoded, as the host's does
        kept = b.slice_damaged.copy()
        b.slice_damaged[:] = False
        b._validate(parsed, torch.stack([low, rng, pos]).cpu().numpy(),
                    buflens)
        failed = b.slice_damaged & dec.reshape(self.batch, -1)
        b.slice_damaged[:] = kept | failed
        self.slice_damaged |= failed
        return self._reconstruct(planes, torch.from_numpy(mvs).to(
            self.device), torch.from_numpy(intra).to(self.device), dec_t)

    def _reconstruct(self, planes, mvs, intra, dec):
        """OBMC prediction + residual - offset, clipped, on the decoded
        lanes (``dec`` bool (L,)); the other lanes keep the reference
        picture.  ``planes``: the lane scan's int32 (L, h, w) per plane.
        Returns the full planes."""
        b = self.base
        g = b.g
        bits = b.bits
        mid, offset = 1 << (bits - 1), 1 << bits
        nh, nv = g.num_h_slices, g.num_v_slices
        full = []
        for k, (w, h, _sp) in enumerate(b._plane_specs()):
            if k in (1, 2) and g.chroma_planes:
                (by, bx), pmvs = _chroma_block(g), _chroma_mvs(mvs, g)
            else:
                (by, bx), pmvs = (BLOCK, BLOCK), mvs
            ref = TorchFFV1Encoder._crops_uniform(self.ref_dev[k], nh, nv)
            ref_p = _pad_edge(ref, (-h) % by, (-w) % bx)
            pred = obmc_predict_dev(ref_p, pmvs, intra, mid, by, bx)
            rec = (pred[:, :h, :w] + planes[k] - offset).clamp_(
                0, (1 << bits) - 1)
            full.append(b._assemble(torch.where(dec[:, None, None], rec,
                                                ref)))
        return tuple(full)
