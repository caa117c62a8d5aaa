"""Decode lane scans: the CUDA kernels (csrc/rc_decode.cu, bits <= 10;
csrc/rc_decode_ext.cu, bits 11..17) and their plain PyTorch versions,
planar (K2, K2-ext) and line-interleaved RGB (B1, B1-ext).

Port of ``tpu_ffv1/tpu/rc_dec_pallas.py`` (``rc_decode_planes_pallas``,
3-input context, and with ``five`` the 5-input one of context model 1:
the fast schedule at bits <= 10, the extended one with running rows
10/31 at 11..17), same contract:

  in:  bufs uint8 (L, cap) per-lane slice bytes (zero padded), states
       uint8 (L, CC, 32), one_tab/zero_tab uint8 (256,), qt int32
       (5, 256), low0/range0/pos0 int32 (L,) after the host-parsed slice
       headers, plane_specs ((w, h, plane_base), ...) in coding order,
       bits 1..17, five (the 5-input context: quant tables 3 and 4 on
       LL - L and TT - T)
  out: (planes: tuple of int32 (L, h, w), states_out, low, range, pos);
       at 16 bits the samples are int16-wrapped, as the reference's
       int16_t sample rows hold them (dec_scan_lanes.py:189-193)

A read at pos >= cap gives 0, and the context index is clamped into the
state table, so damaged streams stay in bounds (the caller detects them
with the sentinel/byte-count check).  ``rc_decode_planes`` runs the
plain version for CPU tensors and the kernel for CUDA tensors.  The
kernel keeps the lane's state table in shared memory where it fits a
block (context model 0) and in global memory where it does not (context
model 1); the wrapper picks the instance from the table's size
(``build.table_in_global``).

``rc_decode_rgb`` (B1 at coded widths 9 and 10, B1-ext at 11, 13 and
15; the counterpart of dec_scan_lanes.rc_decode_rgb_lanes, which the
JAX package runs as an XLA scan) decodes RGB's line-interleaved planes:
row y decodes a line of each plane G, B, R(, A) in turn from one coder,
each plane from its own 2-row ring; the samples stay in the RCT domain.
Its plain version shares the planar one's pixel step (``_LaneScan``).

``rc_decode_groups`` (B2, the counterpart of the per-slice
dec_scan.rc_decode_plane the JAX package's fallback runs as XLA scans)
decodes lanes of unequal plane geometry or quant table: one
``rc_decode_planes`` launch per group of lanes that share both, one
after another; no kernel of its own.

``rc_decode_stages`` and ``rc_decode_ext_stages`` launch K2's and
K2-ext's stage probes (csrc/rc_decode.cu and rc_decode_ext.cu STAGES),
``rc_decode_rgb_stages`` B1's at 9 bits and B1-ext's at 15: timing
instruments with stages stubbed, never called by the codec.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..kernels.build import count_launch, expect, load, table_in_global

# kernel launches made by rc_decode_planes and rc_decode_rgb, by kernel
# instance (read by chip_smoke.py): rc_decode (K2, bits <= 10) and
# rc_decode_ext (K2-ext, bits 11..17), rc_decode_rgb and
# rc_decode_ext_rgb (B1, B1-ext), each with the suffix _five for the
# 5-input context and _global for the state table in global memory
# (K2-five is rc_decode_five_global)
LAUNCHES: dict = {}

# K2's stage probes: the stages each variant keeps (csrc/rc_decode.cu
# STAGE_CTX 1, STAGE_READ 2, STAGE_TRANS 4, STAGE_WRITE 8, STAGE_REFILL
# 16, STAGE_CHAIN 32, STAGE_LINE 64)
STAGE_VARIANTS = {"full": 127, "no_ctx": 126, "no_read": 125,
                  "no_trans": 123, "no_write": 119, "no_refill": 111,
                  "no_chain": 95}
# B1's: K2's, and without the row pass and the row's output stores
RGB_STAGE_VARIANTS = dict(STAGE_VARIANTS, no_line=63)
# K2-ext's (csrc/rc_decode_ext.cu: the same stages, STAGE_RUN 64, the
# running rows 10/31, and STAGE_LINE 128)
EXT_STAGE_VARIANTS = {"full": 255, "no_ctx": 254, "no_read": 253,
                      "no_trans": 251, "no_write": 247, "no_refill": 239,
                      "no_chain": 223, "no_run": 191}
# B1-ext's: K2-ext's, and no_line
EXT_RGB_STAGE_VARIANTS = dict(EXT_STAGE_VARIANTS, no_line=127)
# the (coded width, instance) each RGB source's probes are built for: the
# rgb8 and rgb14_540p paths' launches
RGB_STAGE_INSTANCES = {"rc_decode": (9, "rc_decode_rgb"),
                       "rc_decode_ext": (15, "rc_decode_ext_rgb")}


def instance(bits: int, five: bool, CC: int, wmax: int,
             rgb_planes: int = 0) -> str:
    """The kernel instance rc_decode_planes (or, with ``rgb_planes`` P >
    0, rc_decode_rgb: B1 / B1-ext over P line-interleaved planes)
    launches for a coded width, the context model's ``five``, a state
    table of CC rows and planes at most ``wmax`` wide.  Beside the
    table, shared memory holds the quant tables, the transition pairs
    (512 B), a 512-byte ring of the slice's bytes and per column a (T,
    context part) pair and two sample rows (RGB: two per plane), int32
    each; the ext instances also one_pow (256 * (bits - 9) B), as the
    launchers count them (csrc/rc_decode.cu, rc_decode_ext.cu)."""
    rings = max(rgb_planes, 1)
    other = (5 if five else 3) * 256 * 4 + 512 + 512 + \
        (2 + 2 * rings) * (wmax + 1) * 4 + \
        (256 * (bits - 9) if bits > 10 else 0)
    return ("rc_decode_ext" if bits > 10 else "rc_decode") + \
        ("_rgb" if rgb_planes else "") + ("_five" if five else "") + \
        ("_global" if table_in_global(CC * 32, other) else "")


class _LaneScan:
    """The plain decode machinery over L lanes, vectorised over lanes (the
    semantics of dec_scan_lanes._machinery at any coded width): the
    lanes' coder (low, range, pos), their state tables and the pixel
    step, one line at a time.  Shared by the planar scan
    (``_decode_planes_ref``) and the line-interleaved RGB scan
    (``rc_decode_rgb_ref``).  Every decision adapts its state at once,
    so the repeated rows 10 and 31 of the extended widths chain
    sequentially."""

    def __init__(self, bufs, states, one_tab, zero_tab, qt, low0, range0,
                 pos0, bits: int, five: bool):
        L, cap = bufs.shape
        self.L, self.cap = L, cap
        self.CC = states.shape[1]
        dev = self.dev = bufs.device
        self.bits, self.five = bits, five
        lanes = torch.arange(L, device=dev)
        # flat bytes with one zero past each lane's end: pos >= cap reads 0
        self.buf = F.pad(bufs.to(torch.int64), (0, 1)).reshape(-1)
        self.buf_base = lanes * (cap + 1)
        # transition rows: [keep | zero | one] (an inactive lane keeps its
        # state)
        self.trans = torch.cat([torch.arange(256, device=dev),
                                zero_tab.to(dev, torch.int64),
                                one_tab.to(dev, torch.int64)])
        self.q = [qt[k].to(dev, torch.int64) for k in range(5)]
        self.st = states.reshape(-1).to(torch.int64)         # (L*CC*32,)
        self.st_base = lanes * (self.CC * 32)
        self.low = low0.to(torch.int64)
        self.rng = range0.to(torch.int64)
        self.pos = pos0.to(torch.int64)

    def rac(self, at, act):
        """One get_rac at flat state index ``at`` for the lanes in act;
        returns the decided bit (False where inactive)."""
        st, low, rng = self.st, self.low, self.rng
        s = st[at]
        r1 = (rng * s) >> 8
        r0 = rng - r1
        bit = (low >= r0) & act
        st[at] = self.trans[s + torch.where(bit, 512, 256) * act]
        low = low - r0 * bit
        rng = torch.where(act, torch.where(bit, r1, r0), rng)
        need = act & (rng < 0x100)
        nxt = self.buf[self.buf_base + self.pos.clamp(max=self.cap)]
        self.low = torch.where(need, (low << 8) + nxt, low)
        self.rng = torch.where(need, rng << 8, rng)
        self.pos = self.pos + need
        return bit

    def line(self, prev, prev2, pbase: int):
        """Decode one line of every lane from its plane's previous row
        ``prev`` and the row before it ``prev2`` (int64 (L, w), zeros
        above the plane), with the context's state rows from plane base
        ``pbase``; returns the line, int64 (L, w).  The x = 0 borders: L
        is prev[0], LT prev2[0] (ffv1dec.c:202-203); with ``five`` the
        context adds LL (the previous pixel's L, 0 at x = 0) and TT
        (prev2[x])."""
        L, w, dev, bits = self.L, prev.shape[1], self.dev, self.bits
        q0, q1, q2, q3, q4 = self.q
        e_max = bits - 1
        mask_v = (1 << bits) - 1
        ones = torch.ones((L,), dtype=torch.bool, device=dev)
        cur = torch.zeros((L, w), dtype=torch.int64, device=dev)
        Lv = prev[:, 0]
        LT = prev2[:, 0]
        LL = torch.zeros_like(Lv)
        for x in range(w):
            T = prev[:, x]
            RT = prev[:, min(x + 1, w - 1)]
            ctx = (q0[(Lv - LT) & 0xFF] + q1[(LT - T) & 0xFF] +
                   q2[(T - RT) & 0xFF])
            if self.five:
                ctx = ctx + q3[(LL - Lv) & 0xFF] + \
                    q4[(prev2[:, x] - T) & 0xFF]
            csign = ctx < 0
            row = self.st_base + \
                ((ctx.abs() + pbase).clamp(0, self.CC - 1) << 5)
            nz = ~self.rac(row, ones)
            e = torch.zeros((L,), dtype=torch.int64, device=dev)
            done = ~nz
            for j in range(e_max + 1):       # exponent unary + stop
                if bool(done.all()):
                    break
                bit = self.rac(row + (1 + min(j, 9)), ~done)
                e = e + bit
                done = done | ~bit
            a = torch.ones((L,), dtype=torch.int64, device=dev)
            for j in range(e_max):           # mantissa MSB -> LSB
                act = nz & (j < e)
                if not bool(act.any()):
                    break
                bit = self.rac(row + 22 + (e - 1 - j).clamp(0, 9), act)
                a = torch.where(act, a + a + bit, a)
            sbit = self.rac(row + 11 + e.clamp(max=10), nz)
            diff = torch.where(nz, torch.where(sbit, -a, a), 0)
            diff = torch.where(csign, -diff, diff)
            m = Lv + T - LT
            pred = (Lv + m + T) - torch.minimum(torch.minimum(Lv, m), T) \
                - torch.maximum(torch.maximum(Lv, m), T)
            val = (pred + diff) & mask_v
            if bits == 16:
                # int16_t sample-row storage wrap: the median predictor
                # compares 16-bit samples signed
                val = ((val + 0x8000) & 0xFFFF) - 0x8000
            cur[:, x] = val
            LT = T
            LL = Lv
            Lv = val
        return cur

    def outputs(self):
        """(states_out uint8 (L, CC, 32), low, range, pos int32 (L,))."""
        return (self.st.to(torch.uint8).view(self.L, self.CC, 32),
                self.low.to(torch.int32), self.rng.to(torch.int32),
                self.pos.to(torch.int32))


def _decode_planes_ref(bufs, states, one_tab, zero_tab, qt, low0, range0,
                       pos0, plane_specs, bits: int, five: bool):
    """The planar scan: each plane's lines in turn, from zeroed rows
    (the semantics of dec_scan_lanes.rc_decode_planes_lanes)."""
    scan = _LaneScan(bufs, states, one_tab, zero_tab, qt, low0, range0,
                     pos0, bits, five)
    planes = []
    for (w, h, pbase) in plane_specs:
        zrow = torch.zeros((scan.L, w), dtype=torch.int64, device=scan.dev)
        rows = [zrow, zrow]
        for _y in range(h):
            rows.append(scan.line(rows[-1], rows[-2], pbase))
        planes.append(torch.stack(rows[2:], dim=1).to(torch.int32))
    return (tuple(planes), *scan.outputs())


def rc_decode_planes_ref(bufs, states, one_tab, zero_tab, qt, low0,
                         range0, pos0, plane_specs, bits: int,
                         five: bool = False):
    """Plain PyTorch version of K2 and K2-five (the fast schedule,
    bits <= 10)."""
    if not 1 <= bits <= 10:
        raise ValueError("the fast schedule covers bits <= 10")
    return _decode_planes_ref(bufs, states, one_tab, zero_tab, qt, low0,
                              range0, pos0, plane_specs, bits, five)


def rc_decode_planes_ext_ref(bufs, states, one_tab, zero_tab, qt, low0,
                             range0, pos0, plane_specs, bits: int,
                             five: bool = False):
    """Plain PyTorch version of K2-ext and K2-ext-five (the extended
    schedule, bits 11..17: exponent row 1 + min(j, 9), mantissa row
    22 + min(i, 9), sign row 11 + min(e, 10), the int16 wrap at 16
    bits)."""
    if not 11 <= bits <= 17:
        raise ValueError("the extended schedule covers bits 11..17")
    return _decode_planes_ref(bufs, states, one_tab, zero_tab, qt, low0,
                              range0, pos0, plane_specs, bits, five)


def rgb_specs(w: int, h: int, nplanes: int, cc: int):
    """The plane specs of a line-interleaved RGB slice: planes G, B, R(,
    A), each w x h, on state planes (p + 1) / 2 (ffv1dec.c:253)."""
    return tuple((w, h, (p + 1) // 2 * cc) for p in range(nplanes))


def rc_decode_rgb_ref(bufs, states, one_tab, zero_tab, qt, low0, range0,
                      pos0, w: int, h: int, nplanes: int, cc: int,
                      bits: int, five: bool = False, rows0=None):
    """Plain PyTorch version of B1 and B1-ext: the line-interleaved RGB
    decode (dec_scan_lanes.rc_decode_rgb_lanes, ffv1dec.c:226-255).  Row
    y decodes a line of every plane p = 0..nplanes-1 (G, B, R, A) in
    turn from the same coder, on state plane (p + 1) / 2, each plane
    from its own two previous rows; ``bits`` is the coded width.

    ``rows0``: optional int32 (nplanes, L, 2, w), each plane's two rows
    above the first decoded one (row y0 - 2, then y0 - 1), for a decode
    that resumes at a row y0 from the coder and states a decode of rows
    0..y0-1 ended in; zeros (a slice's start) by default.  Returns
    (RCT-domain samples int32 (nplanes, L, h, w), states_out, low,
    range, pos)."""
    scan = _LaneScan(bufs, states, one_tab, zero_tab, qt, low0, range0,
                     pos0, bits, five)
    specs = rgb_specs(w, h, nplanes, cc)
    if rows0 is None:
        rows = [[torch.zeros((scan.L, w), dtype=torch.int64,
                             device=scan.dev)] * 2 for _ in specs]
    else:
        rows = [[rows0[p, :, k].to(torch.int64) for k in (0, 1)]
                for p in range(nplanes)]
    for _y in range(h):
        for p, (_w, _h, pbase) in enumerate(specs):
            rows[p].append(scan.line(rows[p][-1], rows[p][-2], pbase))
    planes = torch.stack([torch.stack(r[2:], dim=1) for r in rows]) \
        .to(torch.int32) if h else \
        torch.zeros((nplanes, scan.L, 0, w), dtype=torch.int32,
                    device=scan.dev)
    return (planes, *scan.outputs())


def _launch(name, bufs, states, one_tab, zero_tab, qt, low0, range0,
            pos0, plane_specs, bits, five, entry=None, code=None, lib=None):
    """Check the arguments and launch ``<entry>`` (default
    ``<lib>_launch``) of csrc/rc_decode.cu or rc_decode_ext.cu (or of the
    loaded library ``lib``, a build of a copy of that source) for kernel
    instance ``name`` on the current stream; ``code`` is the int passed
    in the bits position.  Returns the outputs."""
    dev = bufs.device
    L, cap = bufs.shape
    CC = states.shape[1]
    expect("bufs", bufs, torch.uint8, (L, cap), dev)
    expect("states", states, torch.uint8, (L, CC, 32), dev)
    expect("one_tab", one_tab, torch.uint8, (256,), dev)
    expect("zero_tab", zero_tab, torch.uint8, (256,), dev)
    expect("qt", qt, torch.int32, (5, 256), dev)
    for arg, t in (("low0", low0), ("range0", range0), ("pos0", pos0)):
        expect(arg, t, torch.int32, (L,), dev)
    if not 1 <= len(plane_specs) <= 4:
        raise ValueError("1..4 planes per call")
    if states.data_ptr() % 16:
        states = states.clone()            # the kernel copies in 16 B words
    gtab = name.endswith("_global")
    src = "rc_decode_ext" if name.startswith("rc_decode_ext") else \
        "rc_decode"
    fn = getattr(lib or load(src), entry or f"{src}_launch")
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, p, p, p, p, p, p, i, p, i, p, p, p, p,
                   i, i, i, i, i, p]
    spec = (ctypes.c_int * (3 * len(plane_specs)))(
        *[v for s in plane_specs for v in s])
    total = sum(w * h for (w, h, _b) in plane_specs)
    out = torch.empty((L, total), dtype=torch.int32, device=dev)
    low = torch.empty((L,), dtype=torch.int32, device=dev)
    rng = torch.empty((L,), dtype=torch.int32, device=dev)
    pos = torch.empty((L,), dtype=torch.int32, device=dev)
    # the global-table instance adapts the rows in place, in states_out
    states_out = states.clone() if gtab else \
        torch.empty((L, CC, 32), dtype=torch.uint8, device=dev)
    # the runtime launches on the current device: make it the tensors'
    with torch.cuda.device(dev):
        err = fn(bufs.data_ptr(), cap, states.data_ptr(), one_tab.data_ptr(),
                 zero_tab.data_ptr(), qt.data_ptr(), low0.data_ptr(),
                 range0.data_ptr(), pos0.data_ptr(),
                 ctypes.cast(spec, ctypes.c_void_p), len(plane_specs),
                 out.data_ptr(), total, low.data_ptr(), rng.data_ptr(),
                 pos.data_ptr(), states_out.data_ptr(), L, CC,
                 bits if code is None else code, int(five), int(gtab),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    planes, off = [], 0
    for (w, h, _b) in plane_specs:
        planes.append(out[:, off:off + w * h].view(L, h, w))
        off += w * h
    return tuple(planes), states_out, low, rng, pos


def rc_decode_planes(bufs, states, one_tab, zero_tab, qt, low0, range0,
                     pos0, plane_specs, bits: int, five: bool = False):
    """Decode all planes of L slice lanes; the CUDA kernel for CUDA
    tensors (K2 at bits <= 10, K2-ext at 11..17, with the 5-input context
    if ``five``, the state table in shared or global memory by its
    size), the plain version for CPU tensors (contract in the module
    docstring)."""
    if not 1 <= bits <= 17:
        raise NotImplementedError("the lane scan covers bits 1..17")
    five = bool(five)
    plane_specs = tuple(tuple(int(v) for v in s) for s in plane_specs)
    dev = bufs.device
    if dev.type == "cpu":
        ref = rc_decode_planes_ext_ref if bits > 10 else \
            rc_decode_planes_ref
        return ref(bufs, states, one_tab, zero_tab, qt, low0, range0, pos0,
                   plane_specs, bits, five)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    name = instance(bits, five, states.shape[1],
                    max(w for (w, _h, _b) in plane_specs))
    out = _launch(name, bufs, states, one_tab, zero_tab, qt, low0, range0,
                  pos0, plane_specs, bits, five)
    count_launch(LAUNCHES, name)
    return out


def rc_decode_groups(bufs, states, one_tab, zero_tab, quant, low0, range0,
                     pos0, groups, bits: int, devices=None):
    """Decode lanes of unequal plane geometry or quant table: one
    ``rc_decode_planes`` launch per group (K2, K2-five, K2-ext or
    K2-ext-five, whichever the group needs), one after another on the
    current stream.  The port of the JAX package's per-slice fallback
    (decoder.py:708-782 there, dec_scan.rc_decode_plane per slice and
    plane), whose lanes run here in groups.

    ``states`` uint8 (L, R, 32): each lane's table in its first rows.
    ``quant``: per quant table index (qt int32 (5, 256), context count,
    five).  ``groups``: [(lanes, dims, qidx)], the lanes (ints) that
    share the planes ``dims`` ((w, h, state_plane), ...) in coding order
    and quant table ``qidx``; a group decodes the first
    ``len(states planes) x cc`` rows of its lanes' tables, so the kernel
    instance (shared or global table) follows the group's own context
    count.  A lane in no group keeps its states and coder state.
    ``devices``: a device list (sharding.py); a frame of one group whose
    lane count it divides splits that group's launch over them
    (``decode_lanes_sharded``), any other frame runs as without it.
    Returns (per group its planes, a tuple of int32 (n, h, w); states_out
    uint8 (L, R, 32); low, range, pos int32 (L,))."""
    dev = bufs.device
    states_out = states.clone()
    low, rng, pos = low0.clone(), range0.clone(), pos0.clone()
    decode = rc_decode_planes
    if devices is not None and len(groups) == 1 and \
            len(groups[0][0]) % len(devices) == 0:
        from .sharding import decode_lanes_sharded  # it imports this module
        decode = functools.partial(decode_lanes_sharded, devices)
    out = []
    for lanes, dims, q in groups:
        qt, cc, five = quant[q]
        rows = (max(sp for _w, _h, sp in dims) + 1) * cc
        # every lane in order: no gather; else an index staged from
        # pageable memory, with no wait on the card
        idx = slice(None) if list(lanes) == list(range(len(low0))) else \
            torch.tensor(list(lanes), dtype=torch.long).to(
                dev, non_blocking=True)
        planes, st, lo, ra, po = decode(
            bufs[idx], states[idx, :rows].contiguous(), one_tab, zero_tab,
            qt, low0[idx], range0[idx], pos0[idx],
            tuple((w, h, sp * cc) for (w, h, sp) in dims), bits, five)
        states_out[idx, :rows] = st
        low[idx], rng[idx], pos[idx] = lo, ra, po
        out.append(planes)
    return out, states_out, low, rng, pos


# the coded widths of the RGB formats: bgr0 and bgra 9, gbrp9 10, gbrp10
# 11, gbrp12 13, gbrp14 15 (B1 at 9 and 10, B1-ext above)
RGB_BITS = (9, 10, 11, 13, 15)


def rc_decode_rgb(bufs, states, one_tab, zero_tab, qt, low0, range0, pos0,
                  w: int, h: int, nplanes: int, cc: int, bits: int,
                  five: bool = False):
    """Decode the line-interleaved RGB planes of L slice lanes (each
    w x h, ``nplanes`` 3 or 4, state plane (p + 1) / 2 x ``cc``) at
    coded width ``bits``; the CUDA kernel for CUDA tensors (B1 at 9 and
    10 bits, B1-ext at 11, 13 and 15, with the 5-input context if
    ``five``, the state table in shared or global memory by its size),
    the plain version (``rc_decode_rgb_ref``) for CPU tensors.  Returns
    (RCT-domain samples int32 (nplanes, L, h, w), states_out, low,
    range, pos)."""
    if bits not in RGB_BITS:
        raise NotImplementedError(f"no RGB format codes at {bits} bits")
    if nplanes not in (3, 4):
        raise ValueError("RGB has 3 planes, or 4 with alpha")
    five = bool(five)
    dev = bufs.device
    if dev.type == "cpu":
        return rc_decode_rgb_ref(bufs, states, one_tab, zero_tab, qt, low0,
                                 range0, pos0, w, h, nplanes, cc, bits,
                                 five)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    name = instance(bits, five, states.shape[1], w, nplanes)
    src = "rc_decode_ext" if bits > 10 else "rc_decode"
    planes, *rest = _launch(name, bufs, states, one_tab, zero_tab, qt, low0,
                            range0, pos0, rgb_specs(w, h, nplanes, cc),
                            bits, five, entry=f"{src}_rgb_launch")
    count_launch(LAUNCHES, name)
    return (torch.stack(planes), *rest)


def _stage_probe(args, plane_specs, five, variant, bits, variants, entry,
                 ref):
    """Launch ``entry`` (a stage entry point) for ``variant`` of
    ``variants`` on the instance rc_decode_planes picks; on the CPU the
    plain version ``ref`` for ``full``."""
    stages = variants[variant]
    five = bool(five)
    plane_specs = tuple(tuple(int(v) for v in s) for s in plane_specs)
    dev = args[0].device
    if dev.type == "cpu":
        if variant != "full":
            raise NotImplementedError("a stubbed stage probe has no plain "
                                      "version: it times the card")
        return ref(*args, plane_specs, bits, five)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    name = instance(bits, five, args[1].shape[1],
                    max(w for (w, _h, _b) in plane_specs))
    return _launch(name, *args, plane_specs, bits, five, entry=entry,
                   code=stages)


def rc_decode_stages(bufs, states, one_tab, zero_tab, qt, low0, range0,
                     pos0, plane_specs, five: bool, variant: str):
    """K2 at 8 bits (either context, either table placement, as
    rc_decode_planes picks them) with the stages of ``variant``
    (STAGE_VARIANTS) stubbed: a timing instrument whose outputs are
    wrong on purpose, except ``full``, which is the production instance.
    CUDA tensors only; on the CPU only ``full`` has a plain version."""
    return _stage_probe((bufs, states, one_tab, zero_tab, qt, low0, range0,
                         pos0), plane_specs, five, variant, 8,
                        STAGE_VARIANTS, "rc_decode_stages_launch",
                        rc_decode_planes_ref)


def rc_decode_ext_stages(bufs, states, one_tab, zero_tab, qt, low0,
                         range0, pos0, plane_specs, five: bool,
                         variant: str, bits: int = 16):
    """K2-ext at 16 bits (either context, either table placement, as
    rc_decode_planes picks them) with the stages of ``variant``
    (EXT_STAGE_VARIANTS) stubbed: a timing instrument whose outputs are
    wrong on purpose, except ``full``, which is the production instance.
    The probes are built at 16 bits only; on the CPU only ``full`` has a
    plain version."""
    if bits != 16:
        raise NotImplementedError("K2-ext's stage probes are built at 16 "
                                  "bits")
    return _stage_probe((bufs, states, one_tab, zero_tab, qt, low0, range0,
                         pos0), plane_specs, five, variant, 16,
                        EXT_STAGE_VARIANTS, "rc_decode_ext_stages_launch",
                        rc_decode_planes_ext_ref)


def rc_decode_rgb_stages(bufs, states, one_tab, zero_tab, qt, low0, range0,
                         pos0, w: int, h: int, nplanes: int, cc: int,
                         bits: int, five: bool, variant: str):
    """B1 at 9 bits or B1-ext at 15 (rc_decode_rgb's arguments; the
    3-input context with the table in shared memory, the instances of
    the rgb8 and rgb14_540p paths) with the stages of ``variant``
    (RGB_STAGE_VARIANTS, EXT_RGB_STAGE_VARIANTS) stubbed: a timing
    instrument whose outputs are wrong on purpose, except ``full``,
    which is the production instance.  Other widths and instances have
    no probes; on the CPU only ``full`` has a plain version."""
    src = "rc_decode_ext" if bits > 10 else "rc_decode"
    want_bits, want = RGB_STAGE_INSTANCES[src]
    name = instance(bits, five, states.shape[1], w, nplanes)
    if bits != want_bits or name != want:
        raise NotImplementedError(f"the RGB stage probes are built for "
                                  f"{want} at {want_bits} bits only")
    variants = EXT_RGB_STAGE_VARIANTS if bits > 10 else RGB_STAGE_VARIANTS
    stages = variants[variant]
    if bufs.device.type == "cpu":
        if variant != "full":
            raise NotImplementedError("a stubbed stage probe has no plain "
                                      "version: it times the card")
        return rc_decode_rgb_ref(bufs, states, one_tab, zero_tab, qt, low0,
                                 range0, pos0, w, h, nplanes, cc, bits,
                                 five)
    if bufs.device.type != "cuda":
        raise ValueError(f"unsupported device {bufs.device}")
    planes, *rest = _launch(name, bufs, states, one_tab, zero_tab, qt, low0,
                            range0, pos0, rgb_specs(w, h, nplanes, cc),
                            bits, five, entry=f"{src}_rgb_stages_launch",
                            code=stages)
    return (torch.stack(planes), *rest)
