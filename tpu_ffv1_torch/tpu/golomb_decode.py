"""Golomb-Rice decode lane scan (FFV1 coder=0): the CUDA kernel
(csrc/golomb_decode.cu, G2) and its plain PyTorch version.

Port of ``tpu_ffv1/tpu/golomb_dec_lanes.py``
(``golomb_decode_planes_lanes``), same contract:

  in:  bufs uint8 (L, cap) per-lane slice bytes (zero padded), vlc0
       int32 (L, CC, 4) VlcStates (drift, error_sum, bias, count), qt
       int32 (5, 256) quant tables, pos0 int32 (L,) the byte where each
       lane's bit reader starts (after the range-coded slice header),
       plane_specs ((w, h, plane_base), ...) in coding order with
       plane_base = state_plane * cc, bits the coded width, five (the
       5-input context: quant tables 3 and 4 on LL - L and TT - T)
  out: (planes: tuple of int32 (L, h, w), vlc_out int32 (L, CC, 4),
       bitpos int32 (L,) the final bit position); at 16 bits the samples
       are int16-wrapped, as the reference's int16_t sample rows hold
       them

Behaviour of ffv1dec.c:139-170 (run mode), :70-98 (get_vlc_symbol),
golomb.h:268-300 (get_ur_golomb, limit 12, esc_len = bits) and
ffv1.h:192-224 (update_vlc_state).  Bits are read MSB first; a read past
cap gives zero bits.  The context index is clamped into the VLC table,
so damaged streams stay in bounds.  ``golomb_decode_planes`` runs the
plain version for CPU tensors and the kernel for CUDA tensors.  The
kernel keeps the lane's VLC table in shared memory where it fits a
block (context model 0) and in global memory where it does not (context
model 1); the wrapper picks the instance from the table's size
(``build.table_in_global``).  ``golomb_decode_stages`` launches G2's
stage probes (csrc/golomb_decode.cu STAGES): timing instruments with a
stage stubbed, never called by the codec.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..core.tables import LOG2_RUN
from ..kernels.build import expect, load, table_in_global
from .golomb_encode import update_vlc, vlc_k

# kernel launches made by golomb_decode_planes, by kernel instance (read
# by chip_smoke.py): golomb_decode (G2), with the suffix _five for the
# 5-input context and _global for the VLC table in global memory
LAUNCHES: dict = {}

# G2's stage probes: the stages each variant keeps (csrc/golomb_decode.cu
# STAGE_WINDOW 1, the bit window; STAGE_CTX 2, the context's lookups on
# the chain; STAGE_VLC 4, the VLC step; STAGE_RECON 8, the median
# reconstruction)
STAGE_VARIANTS = {"full": 15, "no_window": 14, "no_ctx": 13, "no_vlc": 11,
                  "no_recon": 7}


def ring_words(wmax: int) -> int:
    """The word ring G2 keeps for planes at most ``wmax`` wide: a power
    of two above the words a row can take in (54 bits a pixel, and two
    more), as csrc/golomb_decode.cu's ring_words counts them."""
    need = (54 * wmax + 31) // 32 + 4
    return 1 << (need - 1).bit_length()


def instance(five: bool, CC: int, wmax: int) -> str:
    """The kernel instance golomb_decode_planes launches for the context
    model's ``five``, a VLC table of CC rows and planes at most ``wmax``
    wide.  Beside the table, shared memory holds the quant tables, the
    ring of the slice's words (``ring_words``), four int32 per column
    (two sample rows, each pixel's T and context part) and each row's k
    (a byte a row), as the launcher counts them
    (csrc/golomb_decode.cu)."""
    other = (5 if five else 3) * 256 * 4 + 4 * ring_words(wmax) + \
        16 * (wmax + 1) + 16 + CC
    return "golomb_decode" + ("_five" if five else "") + \
        ("_global" if table_in_global(CC * 16, other) else "")


def golomb_decode_planes_ref(bufs, vlc0, qt, pos0, plane_specs, bits: int,
                             five: bool = False):
    """Plain PyTorch version of G2 (contract in the module docstring): a
    loop over pixels, vectorised over lanes."""
    L, cap = bufs.shape
    CC = vlc0.shape[1]
    dev = bufs.device
    i64 = torch.int64
    mask_v = (1 << bits) - 1
    half = 1 << (bits - 1)
    # flat bytes with five zeros past each lane's end: a 5-byte window at a
    # byte >= cap (clamped to cap) reads zeros
    buf = F.pad(bufs.to(i64), (0, 5)).reshape(-1)
    win = torch.arange(5, device=dev) + \
        (torch.arange(L, device=dev) * (cap + 5))[:, None]
    wscale = torch.tensor([1 << 32, 1 << 24, 1 << 16, 1 << 8, 1],
                          dtype=i64, device=dev)
    l2run = torch.cat([torch.from_numpy(LOG2_RUN).to(dev, i64),
                       torch.zeros(1, dtype=i64, device=dev)])
    q0, q1, q2, q3, q4 = (qt[k].to(dev, i64) for k in range(5))
    st = vlc0.reshape(L * CC, 4).to(i64).clone()
    lane_base = torch.arange(L, device=dev) * CC
    bitpos = pos0.to(i64) * 8
    zero = torch.zeros(L, dtype=i64, device=dev)

    def peek32(bp):
        """32-bit big-endian window at bit position bp (0 past cap)."""
        b = buf[win + (bp >> 3).clamp(max=cap)[:, None]]
        w40 = (b * wscale).sum(1)
        return (w40 >> (8 - (bp & 7))) & 0xFFFFFFFF

    def vlc_symbol(c_abs, act):
        """get_vlc_symbol for the lanes in act: (diff, adapted table)."""
        nonlocal bitpos
        fi = lane_base + c_abs
        row = st[fi]
        drift, esum, bias, count = row.unbind(1)
        k = vlc_k(count, esum)
        w32 = peek32(bitpos)
        e = 32 - torch.frexp(w32.double())[1].to(i64)  # leading zeros
        esc = e >= 12
        nb_n = e + 1 + k
        mant = (w32 >> (32 - nb_n).clamp(min=0)) & ((1 << k) - 1)
        v = torch.where(esc, ((w32 >> (20 - bits)) & mask_v) + 11,
                        (e << k) | mant)
        bitpos = torch.where(act, bitpos + torch.where(esc, 12 + bits,
                                                       nb_n), bitpos)
        sv = (v >> 1) ^ -(v & 1)
        sv = torch.where(2 * drift + count < 0, ~sv, sv)
        diff = ((sv + bias + half) & mask_v) - half
        st[fi] = torch.where(act[:, None], update_vlc(row, sv), row)
        return diff

    planes = []
    for (w, h, pbase) in plane_specs:
        plane = torch.zeros((L, h, w), dtype=i64, device=dev)
        zrow = torch.zeros((L, w), dtype=i64, device=dev)
        run_index = zero
        for y in range(h):
            prev = plane[:, y - 1] if y >= 1 else zrow
            cur2 = plane[:, y - 2] if y >= 2 else zrow      # TT's row
            # the part of each pixel's context that does not depend on the
            # row being decoded: LT - T and T - RT (five: TT - T); LT at
            # x = 0 is the [0] of the row before the previous one
            LTr = torch.cat([cur2[:, :1], prev[:, :-1]], 1)
            RTr = torch.cat([prev[:, 1:], prev[:, -1:]], 1)
            part = q1[(LTr - prev) & 0xFF] + q2[(prev - RTr) & 0xFF]
            if five:
                part = part + q4[(cur2 - prev) & 0xFF]
            Ts, parts = prev.t().unbind(0), part.t().unbind(0)
            # x = 0 borders: L = the previous row's [0], LT = the [0] of
            # the row before that
            Lv, LT, LL = prev[:, 0], cur2[:, 0], zero
            run_mode, run_count = zero, zero
            for x in range(w):
                T = Ts[x]
                ctx = parts[x] + q0[(Lv - LT) & 0xFF]
                if five:
                    ctx = ctx + q3[(LL - Lv) & 0xFF]
                sign = ctx < 0
                ctx = ctx.abs()
                c_abs = (ctx + pbase).clamp(max=CC - 1)
                # run mode (ffv1dec.c:139-170)
                run_mode = torch.where((ctx == 0) & (run_mode == 0), 1,
                                       run_mode)
                in_run = run_mode > 0
                need = ~in_run
                ended = None
                if bool(in_run.any()):
                    refill = in_run & (run_count == 0) & (run_mode == 1)
                    if bool(refill.any()):
                        lr = l2run[run_index.clamp(max=41)]
                        b1 = (peek32(bitpos) >> 31) == 1
                        bitpos = bitpos + refill.long()
                        long_run = refill & b1
                        short = refill & ~b1
                        rc_long = 1 << lr
                        run_index = torch.where(
                            long_run & (x + rc_long <= w), run_index + 1,
                            run_index)
                        nread = torch.where(short, lr, 0)
                        rc_short = torch.where(
                            nread > 0, peek32(bitpos) >> (32 - nread), 0)
                        bitpos = bitpos + nread
                        run_count = torch.where(
                            long_run, rc_long,
                            torch.where(short, rc_short, run_count))
                        run_index = torch.where(short & (run_index > 0),
                                                run_index - 1, run_index)
                        run_mode = torch.where(short, 2, run_mode)
                    run_count = run_count - in_run.long()
                    ended = in_run & (run_count < 0)
                    run_mode = torch.where(ended, 0, run_mode)
                    run_count = run_count.clamp(min=0)
                    need = need | ended
                diff = zero
                if bool(need.any()):
                    diff = vlc_symbol(c_abs, need)
                    if ended is not None:
                        diff = torch.where(ended & (diff >= 0), diff + 1,
                                           diff)
                    diff = torch.where(need, diff, 0)
                diff = torch.where(sign, -diff, diff)
                # the median of L, T and L + T - LT
                pred = torch.clamp(Lv + T - LT, torch.minimum(Lv, T),
                                   torch.maximum(Lv, T))
                val = (pred + diff) & mask_v
                if bits == 16:
                    # int16_t sample-row storage wrap: the median
                    # predictor compares 16-bit samples signed
                    val = ((val + 0x8000) & 0xFFFF) - 0x8000
                plane[:, y, x] = val
                LT = T
                LL = Lv
                Lv = val
        planes.append(plane.to(torch.int32))
    return (tuple(planes), st.to(torch.int32).view(L, CC, 4),
            bitpos.to(torch.int32))


def _launch(name, bufs, vlc0, qt, pos0, plane_specs, bits, five,
            code=None, lib=None):
    """Check the arguments and launch csrc/golomb_decode.cu's
    golomb_decode_launch (with ``code``, the stage entry point
    golomb_decode_stages_launch and its STAGES) for kernel instance
    ``name`` on the current stream, from the loaded library ``lib`` (a
    build of another copy of the source) or the package's.  Returns the
    outputs."""
    dev = bufs.device
    L, cap = bufs.shape
    CC = vlc0.shape[1]
    expect("bufs", bufs, torch.uint8, (L, cap), dev)
    expect("vlc0", vlc0, torch.int32, (L, CC, 4), dev)
    expect("qt", qt, torch.int32, (5, 256), dev)
    expect("pos0", pos0, torch.int32, (L,), dev)
    if not 1 <= len(plane_specs) <= 4:
        raise ValueError("1..4 planes per call")
    if vlc0.data_ptr() % 16:
        vlc0 = vlc0.clone()                 # the kernel copies in 16 B rows
    gtab = name.endswith("_global")
    lib = lib or load("golomb_decode")
    stage = () if code is None else (int(code),)
    fn = lib.golomb_decode_stages_launch if stage else \
        lib.golomb_decode_launch
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, p, p, i, p, i, p, p, i, i, i, i, i] + \
        [i] * len(stage) + [p]
    spec = (ctypes.c_int * (3 * len(plane_specs)))(
        *[v for s in plane_specs for v in s])
    total = sum(w * h for (w, h, _b) in plane_specs)
    out = torch.empty((L, total), dtype=torch.int32, device=dev)
    bitpos = torch.empty((L,), dtype=torch.int32, device=dev)
    # the global-table instance adapts the rows in place, in vlc_out
    vlc_out = vlc0.clone() if gtab else torch.empty_like(vlc0)
    # the runtime launches on the current device: make it the tensors'
    with torch.cuda.device(dev):
        err = fn(bufs.data_ptr(), cap, vlc0.data_ptr(), qt.data_ptr(),
                 pos0.data_ptr(), ctypes.cast(spec, ctypes.c_void_p),
                 len(plane_specs), out.data_ptr(), total, bitpos.data_ptr(),
                 vlc_out.data_ptr(), L, CC, bits, int(five), int(gtab),
                 *stage, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    planes, off = [], 0
    for (w, h, _b) in plane_specs:
        planes.append(out[:, off:off + w * h].view(L, h, w))
        off += w * h
    return tuple(planes), vlc_out, bitpos


def golomb_decode_planes(bufs, vlc0, qt, pos0, plane_specs, bits: int,
                         five: bool = False):
    """Decode all planes of L Golomb-Rice slice lanes; the CUDA kernel for
    CUDA tensors (with the 5-input context if ``five``, the VLC table in
    shared or global memory by its size), the plain version for CPU
    tensors (contract in the module docstring)."""
    if not 1 <= bits <= 16:
        raise NotImplementedError("the Golomb-Rice scan covers bits 1..16")
    five = bool(five)
    plane_specs = tuple(tuple(int(v) for v in s) for s in plane_specs)
    dev = bufs.device
    if dev.type == "cpu":
        return golomb_decode_planes_ref(bufs, vlc0, qt, pos0, plane_specs,
                                        bits, five)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    name = instance(five, vlc0.shape[1],
                    max(w for (w, _h, _b) in plane_specs))
    out = _launch(name, bufs, vlc0, qt, pos0, plane_specs, bits, five)
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1
    return out


def golomb_decode_stages(bufs, vlc0, qt, pos0, plane_specs, bits: int,
                         five: bool, variant: str,
                         instance_name: str | None = None, lib=None):
    """G2 with the stages of ``variant`` (STAGE_VARIANTS) stubbed: a
    timing instrument whose outputs are wrong on purpose, except
    ``full``, which is the production instance (``instance_name``, by
    default the one golomb_decode_planes picks).  CUDA tensors only; on
    the CPU only ``full`` has a plain version."""
    stages = STAGE_VARIANTS[variant]
    five = bool(five)
    plane_specs = tuple(tuple(int(v) for v in s) for s in plane_specs)
    dev = bufs.device
    if dev.type == "cpu":
        if variant != "full":
            raise NotImplementedError("a stubbed stage probe has no plain "
                                      "version: it times the card")
        return golomb_decode_planes_ref(bufs, vlc0, qt, pos0, plane_specs,
                                        bits, five)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    name = instance_name or instance(five, vlc0.shape[1], max(
        w for (w, _h, _b) in plane_specs))
    return _launch(name, bufs, vlc0, qt, pos0, plane_specs, bits,
                   "_five" in name, code=stages, lib=lib)
