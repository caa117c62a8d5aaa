"""Golomb-Rice encode lane scan (FFV1 coder=0): the CUDA kernel
(csrc/golomb_encode.cu, G1) and its plain PyTorch version.

Port of ``tpu_ffv1/tpu/golomb_scan.py`` (``golomb_encode_scan_lanes``
followed by ``finalize_bytes``).  The VLC/run-mode coder is the
reference's default coder (ffv1enc.c:326-367, golomb.h:506-561,
ffv1.h:192-224): per slice lane, pixel-serial, with adaptive VlcState
rows (drift, error_sum, bias, count) and a per-line run-mode state
machine.  Contract, for L slice lanes of N pixels:

  in:  ctx int32 (L, N) context ids (with the state plane's offset
       state_plane * cc, the stencil's output), diff int32 (L, N) folded
       residuals, active bool (L, N), flags int32 (N,) the line/plane
       flag stream shared by all lanes (``make_flags``), vlc0 int32
       (L, CC, 4) VlcStates, prefixes int32 (L, PCAP) per-lane header
       bytes, plens int32 (L,), bits the coded width, cc the context
       count of one state plane
  out: (bytes uint8 (L, T): the prefix, then the bit-packed payload,
       the last byte zero-padded, zeros after; counts int32 (L,), the
       true byte counts, which may exceed T; vlc_out int32 (L, CC, 4);
       run_index int32 (L,))

T is ``out_cap``, by default PCAP + 7 N + 1 (a pixel emits at most 53
bits: a run break of 1 + 24 and a symbol of 28).  The bytes equal
``finalize_bytes(golomb_encode_scan_lanes(...))`` up to each count.
Run bits are emitted eagerly, as the JAX scan emits them (a run chunk's
'1' when it completes, which gives the reference's bit sequence), and
the payload is padded at the first active pixel flagged
FLAG_STREAM_END; bits after the last such pixel are dropped, as there.
Golomb bytes have no carry, so the bytes are final where they are
written: the JAX package's 9-slots-per-pixel array and its sort-based
compaction have no counterpart.

``golomb_encode_lanes`` runs the plain version for CPU tensors and the
kernel for CUDA tensors.  The kernel keeps the lane's VLC table (16 B a
row) in shared memory where it fits a block (context model 0: 2 x 666
rows) and in global memory where it does not (context model 1: 2 x
7,563 rows, 242 KB); the wrapper picks the instance from the table's
size (``build.table_in_global``).  ``golomb_encode_stages`` launches
G1's stage probes (csrc/golomb_encode.cu STAGES): timing instruments
with a stage stubbed, never called by the codec.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.tables import LOG2_RUN
from ..kernels.build import count_launch, expect, load, table_in_global

# kernel launches made by golomb_encode_lanes, by kernel instance (read
# by chip_smoke.py): golomb_encode (G1, VLC table in shared memory) and
# golomb_encode_global (in global memory)
LAUNCHES: dict = {}

FLAG_LINE_START = 1
FLAG_LINE_END = 2
FLAG_PLANE_START = 4
FLAG_STREAM_END = 8
FLAG_SPLANE_SHIFT = 4         # bits 4.. : state-plane index of the pixel

VLC_FRESH = (0, 4, 0, 1)      # drift, error_sum, bias, count (ffv1.c:179)

# shared memory G1 uses beside the VLC table (csrc/golomb_encode.cu
# OTHER_SMEM): the 512-byte output ring, the list of a chunk's VLC-coded
# pixels (context, residual; two more read ahead) and their symbols with
# the rows they were coded under
OTHER_SMEM = 512 + 34 * 8 + 32 * 16

# G1's stage probes: the stages each variant keeps (csrc/golomb_encode.cu
# STAGE_READ 1, the chunk's input read; STAGE_RUN 2, the run machine;
# STAGE_VLC 4, the VLC step; STAGE_PACK 8, the bit packing)
STAGE_VARIANTS = {"full": 15, "no_read": 14, "no_run": 13, "no_vlc": 11,
                  "no_pack": 7}


def make_flags(plane_dims) -> np.ndarray:
    """Static per-pixel flag stream for a slice's coding order.

    plane_dims: sequence of (w, h, state_plane) per coded plane in
    order.  state_plane (0 luma, 1 chroma, 2 transparency) rides in the
    high flag bits so the scan can recover the plane-relative context
    (run mode triggers on quantized context 0, ffv1enc.c:331, while the
    stencil's ctx ids carry the state_plane * cc offset).
    """
    parts = []
    for (w, h, sp) in plane_dims:
        f = np.full((h, w), sp << FLAG_SPLANE_SHIFT, np.int32)
        f[:, 0] |= FLAG_LINE_START
        f[:, w - 1] |= FLAG_LINE_END
        f[0, 0] |= FLAG_PLANE_START | FLAG_LINE_START
        parts.append(f.reshape(-1))
    out = np.concatenate(parts)
    out[-1] |= FLAG_STREAM_END
    return out


def fresh_vlc_states(L: int, rows: int, device) -> torch.Tensor:
    """int32 (L, rows, 4) VlcStates as a stream starts them."""
    # non-blocking from pageable memory: no wait on the card
    return torch.tensor(VLC_FRESH, dtype=torch.int32).to(
        device, non_blocking=True).repeat(L, rows, 1)


def instance(CC: int) -> str:
    """The kernel instance golomb_encode_lanes launches for a VLC table of
    CC rows."""
    return "golomb_encode" + \
        ("_global" if table_in_global(CC * 16, OTHER_SMEM) else "")


def default_out_cap(N: int, pcap: int) -> int:
    return pcap + 7 * N + 1


def _fold(v, bits):
    half = 1 << (bits - 1)
    return ((v + half) & ((1 << bits) - 1)) - half


def _bit_length(x):
    """Bit length of non-negative int64 values below 2^53."""
    return torch.frexp(x.double())[1].to(torch.int64)


def vlc_k(count, esum):
    """Golomb parameter k of a VlcState: the smallest k <= 17 with
    count << k >= error_sum, as get_vlc_symbol's loop of 17 doublings
    finds it (ffv1dec.c:76-79, golomb_scan.py:115-122).  In closed form,
    the kernels' (csrc/golomb_encode.cu, golomb_decode.cu): with a and b
    the bit lengths of count and error_sum, k = max(0, b - a), plus one
    where count << k is still below error_sum; a count of 0 takes all 17
    steps unless error_sum is 0.  Equal to the loop for every count
    0..129 and error_sum 0..0xFFFF (tests/test_torch_golomb.py)."""
    k = (_bit_length(esum) - _bit_length(count)).clamp(min=0)
    k = k + ((count << k) < esum)
    return torch.where(count == 0, torch.where(esum > 0, 17, 0),
                       k.clamp(max=17))


def update_vlc(row, v):
    """update_vlc_state (ffv1.h:192-224) of int64 rows (n, 4) by the
    symbols v (n,); returns the new rows."""
    drift, esum, bias, count = row.unbind(1)
    nesum = (esum + v.abs()) & 0xFFFF
    ndrift = drift + v
    at128 = count == 128
    ncount = torch.where(at128, 64, count) + 1
    ndrift = torch.where(at128, ndrift >> 1, ndrift)
    nesum = torch.where(at128, nesum >> 1, nesum)
    negb = ndrift <= -ncount
    posb = ~negb & (ndrift > 0)
    nbias = torch.where(negb & (bias > -128), bias - 1,
                        torch.where(posb & (bias < 127), bias + 1, bias))
    nd = ndrift + ncount
    nd = torch.where(nd <= -ncount, 1 - ncount, nd)
    nd2 = (ndrift - ncount).clamp(max=0)
    ndrift = torch.where(negb, nd, torch.where(posb, nd2, ndrift))
    return torch.stack([ndrift, nesum, nbias, ncount], dim=1)


def pack_emissions(nbits, vals):
    """MSB-first bytes of the emissions (nbits <= 32, vals), int64 (M,) in
    order; the bits of a last partial byte are dropped."""
    keep = nbits > 0
    nb, va = nbits[keep], vals[keep]
    # bit j of emission m, MSB first, where j < nb[m]: row-major order is
    # the stream's
    shift = nb[:, None] - 1 - torch.arange(32, device=nb.device)
    bits = ((va[:, None] >> shift.clamp(min=0)) & 1)[shift >= 0]
    nbytes = bits.numel() // 8
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1],
                           device=nb.device)
    return (bits[:nbytes * 8].view(nbytes, 8) * weights).sum(1) \
        .to(torch.uint8)


def golomb_encode_lanes_ref(ctx, diff, active, flags, vlc0, prefixes, plens,
                            bits: int, cc: int, out_cap: int | None = None):
    """Plain PyTorch version of G1 (contract in the module docstring): a
    loop over pixels, vectorised over lanes, recording each pixel's
    emissions (run bits, the symbol or the line-end flush, the stream
    end's padding), then the bit packing lane by lane."""
    L, N = ctx.shape
    CC = vlc0.shape[1]
    pcap = prefixes.shape[1]
    T = default_out_cap(N, pcap) if out_cap is None else out_cap
    dev = ctx.device
    i64 = torch.int64
    st = vlc0.reshape(L * CC, 4).to(i64).clone()
    lane_base = torch.arange(L, device=dev) * CC
    # ff_log2_run with a 0 past its end: run indices >= 41 read 0, as the
    # reference scan's one-hot lookup gives
    l2run = torch.cat([torch.from_numpy(LOG2_RUN).to(dev, i64),
                       torch.zeros(1, dtype=i64, device=dev)])
    ctx64, diff64 = ctx.to(i64), diff.to(i64)
    fl = [int(f) for f in flags.tolist()]
    zero = torch.zeros(L, dtype=i64, device=dev)
    run_index, run_mode, run_count, bitcnt = zero, zero, zero, zero
    em_n, em_v = [], []
    for i in range(N):
        f = fl[i]
        c, v, a = ctx64[:, i], diff64[:, i], active[:, i]
        if f & FLAG_PLANE_START:
            run_index = zero
        if f & FLAG_LINE_START:
            run_mode, run_count = zero, zero
        run_mode = torch.where(a & (c == (f >> FLAG_SPLANE_SHIFT) * cc), 1,
                               run_mode)
        in_run = (run_mode == 1) & a
        nA = vA = zero
        if bool(in_run.any()):
            iz = in_run & (v == 0)
            rc1 = run_count + 1
            complete = iz & (rc1 == (1 << l2run[run_index.clamp(max=41)]))
            run_count = torch.where(iz, torch.where(complete, 0, rc1),
                                    run_count)
            run_index = run_index + complete
            brk = in_run & (v != 0)
            lr2 = l2run[run_index.clamp(max=41)]
            nA = torch.where(complete, 1, torch.where(brk, 1 + lr2, 0))
            vA = torch.where(complete, 1, torch.where(brk, run_count, 0))
            run_index = torch.where(brk & (run_index > 0), run_index - 1,
                                    run_index)
            run_count = torch.where(brk, 0, run_count)
            run_mode = torch.where(brk, 0, run_mode)
            v = torch.where(brk & (v > 0), v - 1, v)
        emit = a & (run_mode == 0)
        nB = vB = zero
        if bool(emit.any()):
            fi = lane_base + c.clamp(0, CC - 1)
            row = st[fi]
            drift, esum, bias, count = row.unbind(1)
            vf = _fold(v - bias, bits)
            k = vlc_k(count, esum)
            code = torch.where(2 * drift + count < 0, ~vf, vf)
            code2 = torch.where(code >= 0, 2 * code, -2 * code - 1)
            e = code2 >> k
            esc = e >= 12
            nB = torch.where(emit, torch.where(esc, 12 + bits, e + k + 1), 0)
            vB = torch.where(emit, torch.where(
                esc, code2 - 11, (1 << k) + (code2 & ((1 << k) - 1))), 0)
            st[fi] = torch.where(emit[:, None], update_vlc(row, vf), row)
        if f & FLAG_LINE_END:
            flush = (run_mode == 1) & (run_count > 0) & a
            nB = torch.where(flush, 1, nB)
            vB = torch.where(flush, 1, vB)
        bitcnt = (bitcnt + nA + nB) & 7
        em_n += [nA, nB]
        em_v += [vA, vB]
        if f & FLAG_STREAM_END:
            send = a & (bitcnt > 0)
            em_n.append(torch.where(send, 8 - bitcnt, 0))
            em_v.append(zero)
            bitcnt = torch.where(send, 0, bitcnt)
    nbits, vals = torch.stack(em_n, 1), torch.stack(em_v, 1)
    out = torch.zeros((L, T), dtype=torch.uint8, device=dev)
    counts = torch.zeros(L, dtype=torch.int32, device=dev)
    for lane in range(L):
        plen = int(plens[lane])
        body = torch.cat([prefixes[lane, :plen].to(torch.uint8),
                          pack_emissions(nbits[lane], vals[lane])])
        counts[lane] = body.numel()
        n = min(body.numel(), T)
        out[lane, :n] = body[:n]
    return (out, counts, st.to(torch.int32).view(L, CC, 4),
            run_index.to(torch.int32))


def _launch(name, ctx, diff, active, flags, vlc0, prefixes, plens, bits,
            cc, T, code=None, lib=None):
    """Check the arguments and launch csrc/golomb_encode.cu's
    golomb_encode_launch (with ``code``, the stage entry point
    golomb_encode_stages_launch and its STAGES) for kernel instance
    ``name`` on the current stream, from the loaded library ``lib`` (a
    build of another copy of the source) or the package's.  Returns the
    outputs."""
    dev = ctx.device
    L, N = ctx.shape
    CC, pcap = vlc0.shape[1], prefixes.shape[1]
    expect("ctx", ctx, torch.int32, (L, N), dev)
    expect("diff", diff, torch.int32, (L, N), dev)
    expect("active", active, torch.bool, (L, N), dev)
    expect("flags", flags, torch.int32, (N,), dev)
    expect("vlc0", vlc0, torch.int32, (L, CC, 4), dev)
    expect("prefixes", prefixes, torch.int32, (L, pcap), dev)
    expect("plens", plens, torch.int32, (L,), dev)
    if vlc0.data_ptr() % 16:
        vlc0 = vlc0.clone()                 # the kernel copies in 16 B rows
    gtab = name.endswith("_global")
    lib = lib or load("golomb_encode")
    stage = () if code is None else (int(code),)
    fn = lib.golomb_encode_stages_launch if stage else \
        lib.golomb_encode_launch
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 11 + [i] * (8 + len(stage)) + [p]
    out = torch.zeros((L, T), dtype=torch.uint8, device=dev)
    counts = torch.empty((L,), dtype=torch.int32, device=dev)
    run_index = torch.empty((L,), dtype=torch.int32, device=dev)
    # the global-table instance adapts the rows in place, in vlc_out
    vlc_out = vlc0.clone() if gtab else torch.empty_like(vlc0)
    # the runtime launches on the current device: make it the tensors'
    with torch.cuda.device(dev):
        err = fn(ctx.data_ptr(), diff.data_ptr(), active.data_ptr(),
                 flags.data_ptr(), vlc0.data_ptr(), prefixes.data_ptr(),
                 plens.data_ptr(), out.data_ptr(), counts.data_ptr(),
                 vlc_out.data_ptr(), run_index.data_ptr(), L, N, CC, pcap, T,
                 bits, cc, int(gtab), *stage,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out, counts, vlc_out, run_index


def golomb_encode_lanes(ctx, diff, active, flags, vlc0, prefixes, plens,
                        bits: int, cc: int, out_cap: int | None = None):
    """Encode L Golomb-Rice slice lanes; the CUDA kernel for CUDA tensors
    (the VLC table in shared or global memory by its size), the plain
    version for CPU tensors (contract in the module docstring)."""
    if not 1 <= bits <= 16:
        raise NotImplementedError("the Golomb-Rice scan covers bits 1..16")
    dev = ctx.device
    if dev.type == "cpu":
        return golomb_encode_lanes_ref(ctx, diff, active, flags, vlc0,
                                       prefixes, plens, bits, cc, out_cap)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    L, N = ctx.shape
    T = default_out_cap(N, prefixes.shape[1]) if out_cap is None \
        else out_cap
    name = instance(vlc0.shape[1])
    out = _launch(name, ctx, diff, active, flags, vlc0, prefixes, plens,
                  bits, cc, T)
    count_launch(LAUNCHES, name)
    return out


def golomb_encode_stages(ctx, diff, active, flags, vlc0, prefixes, plens,
                         bits: int, cc: int, out_cap: int | None,
                         variant: str, instance_name: str | None = None,
                         lib=None):
    """G1 with the stages of ``variant`` (STAGE_VARIANTS) stubbed: a
    timing instrument whose outputs are wrong on purpose, except
    ``full``, which is the production instance (``instance_name``, by
    default the one golomb_encode_lanes picks).  CUDA tensors only; on
    the CPU only ``full`` has a plain version."""
    stages = STAGE_VARIANTS[variant]
    dev = ctx.device
    if dev.type == "cpu":
        if variant != "full":
            raise NotImplementedError("a stubbed stage probe has no plain "
                                      "version: it times the card")
        return golomb_encode_lanes_ref(ctx, diff, active, flags, vlc0,
                                       prefixes, plens, bits, cc, out_cap)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    T = default_out_cap(ctx.shape[1], prefixes.shape[1]) \
        if out_cap is None else out_cap
    return _launch(instance_name or instance(vlc0.shape[1]), ctx, diff,
                   active, flags, vlc0, prefixes, plens, bits, cc, T,
                   code=stages, lib=lib)
