"""Encode lane scan: the CUDA kernels (csrc/rc_encode.cu, bits <= 10;
csrc/rc_encode_ext.cu, bits 11..17) and their plain PyTorch versions.

Port of ``tpu_ffv1/tpu/rc_pallas.py`` (``rc_encode_pallas_packed``, raw
packed output: the fast schedule at bits <= 10, the extended one at
11..17).  Contract, for L slice lanes of N pixels:

  in:  ctx int32 (L, N), diff int32 (L, N) folded residuals, active bool
       (L, N), states0 uint8 (L, CC, 32), one_tab/zero_tab uint8 (256,),
       low0/range0 int32 (L,), bits 1..17
  out: packed int32 (N, S, L), S = 2 * bits + 1 (a view of (L, N, S)
       storage); an emitting slot holds the provisional value in bits
       0..16 and the emit flag in bit 20, a silent slot 0.  low/range
       int32 (L,), states uint8 (L, CC, 32).  Slot order: the fast
       schedule (schedule.chain_order_nosign + one sign slot) at
       bits <= 10, schedule.ext_slots above.

The compact form (``rc_encode_compact``, bits <= 10; port of
``rc_encode_pallas_compact``, the Pallas kernel's compact=True branch)
runs the same scan and returns cm int32 (N, 8, L) instead of packed:
rows [the first 4 emitted provisional values (bits 0..16, 0 past the
count), count, overflow (count > 4), 0, 0] per pixel
(``finalize.compact_packed`` of the raw form); low, range and states
are the raw form's.

``rc_encode_packed`` and ``rc_encode_compact`` run the plain version for
CPU tensors and the kernel for CUDA tensors; they never substitute one
for the other.  The kernel keeps the lane's state table in shared memory
where it fits a block (context model 0) and in global memory where it
does not (context model 1: 2 x 7,563 rows, 484 KB per lane); the wrapper
picks the instance from the table's size (``build.table_in_global``).
The plain version works slot by slot over all lanes; K1 and K1-ext code
only a pixel's active decisions, one warp per lane (csrc/rc_encode.cu
and rc_encode_ext.cu, headers); both give the same outputs.

``rc_encode_stats`` (pass 1 of two-pass encoding) returns the raw
form's outputs and each lane's counts of the decisions the host's pass-1
hook counts (tpu_ffv1/bitstream/symbols.py:26-29): stat int32 (L, 256,
2) by the state before the decision and its bit, stat2 int32 (L, CC, 32,
2) by context row, row position and bit.  Inactive pixels count nothing.
At bits <= 10 two kernels of csrc/rc_encode.cu compute them: K1's stats
scan (``rc_encode_stats_kernel``: the scan's body with STATS; the raw
outputs and stat; ``rc_encode_stats_scan``) and the row counts
(``rc_stats_rows_kernel``; ``rc_stats_rows``), which depend on the
residuals alone and run on a side stream beside the scan.  Above 10 bits
K1-ext's stats kernel (csrc/rc_encode_ext.cu) computes all six.  Plain
versions: ``rc_encode_stats_ref`` (``rc_encode_stats_scan_ref`` and
``rc_stats_rows_ref``) and ``rc_encode_ext_stats_ref``.

``rc_encode_stages`` and ``rc_encode_ext_stages`` launch K1's and
K1-ext's stage probes (csrc/rc_encode.cu and rc_encode_ext.cu STAGES):
timing instruments with stages stubbed, never called by the codec.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..kernels.build import count_launch, expect, load, table_in_global

from .finalize import compact_packed
from .schedule import chain_order_nosign, ext_slots

# kernel launches made by rc_encode_packed, rc_encode_compact,
# rc_encode_stats (rc_encode_stats_scan, rc_stats_rows), by kernel
# instance (read by chip_smoke.py): rc_encode (K1, bits <= 10),
# rc_encode_ext (K1-ext, bits 11..17), rc_encode_compact (K1-compact),
# rc_encode_stats and rc_encode_ext_stats (the stats instances of K1 and
# K1-ext), their table-in-global-memory forms (``_global``), and
# rc_stats_rows (K1's row counts)
LAUNCHES: dict = {}

# K1's stage probes: the stages each variant keeps (csrc/rc_encode.cu
# STAGE_READ 1, STAGE_TRANS 2, STAGE_WRITE 4, STAGE_CHAIN 8), the
# variants of scripts/probes/ablate_kernel.py
STAGE_VARIANTS = {"full": 15, "no_read": 14, "no_trans": 13,
                  "no_write": 11, "no_chain": 7, "loops_only": 5}
# K1-ext's (csrc/rc_encode_ext.cu: the same bits, and STAGE_RUN 16, the
# running rows' lookups)
EXT_STAGE_VARIANTS = {"full": 31, "no_read": 30, "no_trans": 29,
                      "no_write": 27, "no_chain": 23, "no_run": 15,
                      "loops_only": 5}


def other_smem_bytes(bits: int, stats: bool = False) -> int:
    """Shared memory a lane scan uses beside the state table: one_tab and
    zero_tab, at bits > 10 K1-ext's one_pow (one_tab applied 1..bits - 10
    times, csrc/rc_encode_ext.cu), and a stats instance's state counts:
    K1's a private (256, 2) int32 column per thread (32 x 2,048 B),
    K1-ext's one shared (256, 2) table."""
    counts = 0 if not stats else 2048 if bits > 10 else 32 * 2048
    return 512 + 256 * max(0, bits - 10) + counts


def instance(bits: int, CC: int, compact: bool = False,
             stats: bool = False) -> str:
    """The kernel instance rc_encode_packed (or, with ``compact``,
    rc_encode_compact; with ``stats``, rc_encode_stats) launches for a
    coded width and a state table of CC rows."""
    name = "rc_encode_ext" if bits > 10 else \
        "rc_encode_compact" if compact else "rc_encode"
    gtab = table_in_global(CC * 32, other_smem_bytes(bits, stats))
    return name + ("_stats" if stats else "") + ("_global" if gtab else "")


def floor_log2(a: torch.Tensor) -> torch.Tensor:
    """31 - clz(max(a, 1)) for non-negative int32 a."""
    _m, ex = torch.frexp(a.clamp(min=1).to(torch.float64))
    return (ex - 1).to(torch.int32)


def _slot_masks(diff, active, bits):
    """Per-slot state position, activity and bit, each (L, N, S), in the
    kernel's slot order (chain_order_nosign + the sign slot)."""
    dev = diff.device
    v = diff.to(torch.int32)
    a = v.abs()
    e = floor_log2(a)[..., None]
    nz = (v != 0)[..., None]
    ap = active.to(torch.bool)[..., None]
    p = torch.tensor(chain_order_nosign(bits), dtype=torch.int32,
                     device=dev)
    is_exp = (p >= 1) & (p <= 10)
    is_man = p >= 22
    act = ((p == 0) | (is_exp & nz & (p - 1 <= e)) |
           (is_man & nz & (p - 22 < e))) & ap
    bit = torch.where(p == 0, ~nz,
                      torch.where(is_exp, p - 1 < e,
                                  ((a[..., None] >> (p - 22).clamp(min=0))
                                   & 1) == 1))
    pos = torch.cat([p.expand(*v.shape, -1), 11 + e], dim=-1)
    act = torch.cat([act, nz & ap], dim=-1)
    bit = torch.cat([bit, (v < 0)[..., None]], dim=-1)
    return pos.long(), act, bit


def _state_counts(at, bit, act, used, L, CC):
    """A stats instance's counts of the active decisions by state: ``at``
    (.., S) each decision's flat state index (lane * CC + row) * 32 +
    slot, ``bit``, ``act`` and ``used`` (the state before the decision)
    alike; returns stat int32 (L, 256, 2)."""
    lane = torch.div(at >> 5, CC, rounding_mode="floor")
    stat = torch.bincount(((lane * 256 + used) * 2 + bit.long())[act],
                          minlength=L * 512)
    return stat.to(torch.int32).view(L, 256, 2)


def _row_counts(at, bit, act, L, CC):
    """The counts of the active decisions by (lane, row, slot, bit), with
    ``at``, ``bit`` and ``act`` as ``_state_counts``'; returns stat2 int32
    (L, CC, 32, 2)."""
    stat2 = torch.bincount((at * 2 + bit.long())[act], minlength=L * CC * 64)
    return stat2.to(torch.int32).view(L, CC, 32, 2)


def _flat_states(ctx, pos, CC):
    """Each slot's flat state index (lane * CC + row) * 32 + position,
    (L, n, S), from the pixels' contexts and the slots' positions."""
    rows = torch.arange(ctx.shape[0], device=ctx.device)[:, None] * CC + \
        ctx.long().clamp(0, CC - 1)
    return (rows << 5)[..., None] + pos


def rc_stats_rows_ref(ctx, diff, active, bits: int, CC: int,
                      _chunk: int = 16384):
    """Plain version of K1's row counts (``rc_stats_rows``, bits <= 10):
    stat2 int32 (L, CC, 32, 2), each lane's active decisions by context
    row, row position and bit; the slots a pixel codes and their bits
    come from its residual alone (``_slot_masks``).  ``_chunk`` pixels at
    a time, to bound memory."""
    L, N = ctx.shape
    stat2 = torch.zeros((L, CC, 32, 2), dtype=torch.int32, device=ctx.device)
    for c0 in range(0, N, _chunk):
        c1 = min(N, c0 + _chunk)
        pos, act, bit = _slot_masks(diff[:, c0:c1], active[:, c0:c1], bits)
        stat2 += _row_counts(_flat_states(ctx[:, c0:c1], pos, CC), bit & act,
                             act, L, CC)
    return stat2


def rc_encode_packed_ref(ctx, diff, active, states0, one_tab, zero_tab,
                         low0, range0, bits: int, stats: bool = False):
    """Plain PyTorch version: a loop over pixels, vectorised over lanes.
    With ``stats``, the stats scan's: also the decision counts by state
    (stat; see the module docstring)."""
    L, N = ctx.shape
    CC = states0.shape[1]
    dev = ctx.device
    S = len(chain_order_nosign(bits)) + 1
    pos, act, bit = _slot_masks(diff, active, bits)
    bit = bit & act
    # flat index of every slot's state, and the row of its transition in
    # trans = [keep | zero | one] (an inactive slot keeps its state)
    at = _flat_states(ctx, pos, CC)                        # (L, N, S)
    sel = (act.long() + bit.long()) << 8
    trans = torch.cat([torch.arange(256, device=dev),
                       zero_tab.to(dev, torch.int64),
                       one_tab.to(dev, torch.int64)])
    st = states0.reshape(-1).to(torch.int64)
    act_l = act.long()
    low = low0.to(torch.int64)
    rng = range0.to(torch.int64)
    nl_all = torch.zeros((L, N, S), dtype=torch.int64, device=dev)
    em_all = torch.zeros((L, N, S), dtype=torch.bool, device=dev)
    no_nl = torch.zeros((L,), dtype=torch.int64, device=dev)
    no_em = torch.zeros((L,), dtype=torch.bool, device=dev)
    # slots no lane codes are exact no-ops: skip them in the chain
    coded = act.any(dim=0).cpu().numpy()                   # (N, S)
    # the state before each decision (the positions of a pixel are
    # pairwise distinct: the state at the pixel's start)
    used = torch.zeros_like(at) if stats else None

    for i in range(N):
        at_i = at[:, i]
        s_all = st[at_i]                                   # (L, S)
        if stats:
            used[:, i] = s_all
        # a lane that does not code slot k sees state 0 and bit 0 there:
        # r1 = 0, so low and range pass through unchanged
        s_k = (s_all * act_l[:, i]).unbind(1)
        b_k = bit[:, i].unbind(1)
        a_k = act[:, i].unbind(1)
        nls, ems = [no_nl] * S, [no_em] * S
        for k in coded[i].nonzero()[0]:
            b = b_k[k]
            r1 = (rng * s_k[k]) >> 8
            t = rng - r1
            nr = torch.where(b, r1, t)
            nl = low + t * b
            em = a_k[k] & (nr < 0x100)
            nls[k], ems[k] = nl, em
            low = torch.where(em, (nl & 0xFF) << 8, nl)
            rng = torch.where(em, nr << 8, nr)
        nl_all[:, i] = torch.stack(nls, dim=1)
        em_all[:, i] = torch.stack(ems, dim=1)
        # deferred adaptation of the touched (pairwise distinct) positions
        st[at_i] = trans[sel[:, i] + s_all]

    pv = (nl_all >> 8) | (((nl_all & 0xFF) != 0).long() << 16) | (1 << 20)
    packed = torch.where(em_all, pv, 0).to(torch.int32)
    out = (packed.permute(1, 2, 0), low.to(torch.int32),
           rng.to(torch.int32), st.to(torch.uint8).view(L, CC, 32))
    if stats:
        out += (_state_counts(at, bit, act, used, L, CC),)
    return out


def _ext_slot_masks(diff, active, bits):
    """Per-slot state position, activity and bit, each (L, n, S), in
    ext_slots order (running slots at positions 10 and 31)."""
    v = diff.to(torch.int64)
    a = v.abs()
    e = floor_log2(a).to(torch.int64)
    nz = v != 0
    ap = active.to(torch.bool)
    apnz = ap & nz
    pos, act, bit = [], [], []
    for sl in ext_slots(bits):
        kind = sl[0]
        if kind == "zero":
            p, ac, b = 0, ap, ~nz
        elif kind == "exp":
            j = sl[1]
            p, ac, b = 1 + min(j, 9), apnz & (j <= e), j < e
        elif kind == "man31":
            r = sl[1]
            p, ac = 31, apnz & (e >= 10 + r)
            b = ((a >> (e - 1 - r).clamp(0, 31)) & 1) == 1
        elif kind == "man":
            i = sl[1]
            p, ac, b = 22 + i, apnz & (i < e), ((a >> i) & 1) == 1
        else:
            p, ac, b = 11 + e.clamp(max=10), apnz, v < 0
        pos.append(torch.full_like(e, p) if isinstance(p, int) else p)
        act.append(ac)
        bit.append(b)
    return (torch.stack(pos, -1), torch.stack(act, -1),
            torch.stack(bit, -1))


def rc_encode_packed_ext_ref(ctx, diff, active, states0, one_tab, zero_tab,
                             low0, range0, bits: int, _chunk: int = 4096,
                             stats: bool = False):
    """Plain PyTorch version of the extended schedule (bits 11..17): a
    loop over pixels, vectorised over lanes (the semantics of
    rc_scan_lanes.rc_encode_scan_lanes_ext).  Rows 10 and 31 carry
    running states through every decision that touches them; the other
    positions adapt once per pixel after the chain.  The per-slot masks
    are built ``_chunk`` pixels at a time to bound memory.  With
    ``stats``, the stats instance's: also the decision counts, each
    running row's decisions with their own states."""
    L, N = ctx.shape
    CC = states0.shape[1]
    dev = ctx.device
    slots = ext_slots(bits)
    S = len(slots)
    run10 = [k for k, sl in enumerate(slots)
             if sl[0] == "exp" and sl[1] >= 9]
    run31 = [k for k, sl in enumerate(slots) if sl[0] == "man31"]
    single = torch.tensor([k for k in range(S)
                           if k not in run10 and k not in run31],
                          device=dev)
    trans = torch.cat([torch.arange(256, device=dev),
                       zero_tab.to(dev, torch.int64),
                       one_tab.to(dev, torch.int64)])
    st = states0.reshape(-1).to(torch.int64)
    low = low0.to(torch.int64)
    rng = range0.to(torch.int64)
    packed = torch.zeros((L, N, S), dtype=torch.int32, device=dev)
    rows_all = (torch.arange(L, device=dev)[:, None] * CC +
                ctx.long().clamp(0, CC - 1)) << 5            # (L, N)
    no_nl = torch.zeros((L,), dtype=torch.int64, device=dev)
    no_em = torch.zeros((L,), dtype=torch.bool, device=dev)
    if stats:
        stat = torch.zeros((L, 256, 2), dtype=torch.int32, device=dev)
        stat2 = torch.zeros((L, CC, 32, 2), dtype=torch.int32, device=dev)

    for c0 in range(0, N, _chunk):
        c1 = min(N, c0 + _chunk)
        n = c1 - c0
        pos, act, bit = _ext_slot_masks(diff[:, c0:c1], active[:, c0:c1],
                                        bits)
        bit = bit & act
        rows = rows_all[:, c0:c1]
        at = rows[..., None] + pos                            # (L, n, S)
        sel = (act.long() + bit.long()) << 8
        act_l = act.long()
        coded = act.any(dim=0).cpu().numpy()                  # (n, S)
        nl_c = torch.zeros((L, n, S), dtype=torch.int64, device=dev)
        em_c = torch.zeros((L, n, S), dtype=torch.bool, device=dev)
        # the state before each decision
        used = torch.zeros_like(at) if stats else None
        for i in range(n):
            at_i = at[:, i]
            s_all = st[at_i]                                  # (L, S)
            s_k = (s_all * act_l[:, i]).unbind(1)
            b_k = bit[:, i].unbind(1)
            a_k = act[:, i].unbind(1)
            sel_k = sel[:, i].unbind(1)
            s10 = s_all[:, run10[0]]
            s31 = s_all[:, run31[0]]
            if stats:
                used[:, i] = s_all
            nls, ems = [no_nl] * S, [no_em] * S
            for k in coded[i].nonzero()[0]:
                b = b_k[k]
                if k in run10:
                    if stats:
                        used[:, i, k] = s10
                    s = s10 * a_k[k]
                    s10 = trans[sel_k[k] + s10]
                elif k in run31:
                    if stats:
                        used[:, i, k] = s31
                    s = s31 * a_k[k]
                    s31 = trans[sel_k[k] + s31]
                else:
                    s = s_k[k]
                r1 = (rng * s) >> 8
                t = rng - r1
                nr = torch.where(b, r1, t)
                nl = low + t * b
                em = a_k[k] & (nr < 0x100)
                nls[k], ems[k] = nl, em
                low = torch.where(em, (nl & 0xFF) << 8, nl)
                rng = torch.where(em, nr << 8, nr)
            nl_c[:, i] = torch.stack(nls, dim=1)
            em_c[:, i] = torch.stack(ems, dim=1)
            # deferred adaptation of the single-touch (pairwise distinct)
            # positions, then the running rows' final states
            st[at_i[:, single]] = trans[sel[:, i, single] + s_all[:, single]]
            row = rows[:, i]
            st[row + 10] = s10
            st[row + 31] = s31
        pv = (nl_c >> 8) | (((nl_c & 0xFF) != 0).long() << 16) | (1 << 20)
        packed[:, c0:c1] = torch.where(em_c, pv, 0).to(torch.int32)
        if stats:
            stat += _state_counts(at, bit, act, used, L, CC)
            stat2 += _row_counts(at, bit, act, L, CC)

    out = (packed.permute(1, 2, 0), low.to(torch.int32),
           rng.to(torch.int32), st.to(torch.uint8).view(L, CC, 32))
    if stats:
        out += (stat, stat2)
    return out


def rc_encode_stats_scan_ref(ctx, diff, active, states0, one_tab, zero_tab,
                             low0, range0, bits: int):
    """Plain version of K1's stats scan (``rc_encode_stats_scan``, bits <=
    10): (packed, low, range, states, stat)."""
    return rc_encode_packed_ref(ctx, diff, active, states0, one_tab,
                                zero_tab, low0, range0, bits, stats=True)


def rc_encode_stats_ref(ctx, diff, active, states0, one_tab, zero_tab,
                        low0, range0, bits: int):
    """Plain version of ``rc_encode_stats`` at bits <= 10, K1's stats scan
    and its row counts: (packed, low, range, states, stat, stat2)."""
    return (*rc_encode_stats_scan_ref(ctx, diff, active, states0, one_tab,
                                      zero_tab, low0, range0, bits),
            rc_stats_rows_ref(ctx, diff, active, bits, states0.shape[1]))


def rc_encode_ext_stats_ref(ctx, diff, active, states0, one_tab, zero_tab,
                            low0, range0, bits: int):
    """Plain version of K1-ext's stats instance (bits 11..17): (packed,
    low, range, states, stat, stat2)."""
    return rc_encode_packed_ext_ref(ctx, diff, active, states0, one_tab,
                                    zero_tab, low0, range0, bits,
                                    stats=True)


def rc_encode_compact_ref(ctx, diff, active, states0, one_tab, zero_tab,
                          low0, range0, bits: int):
    """Plain PyTorch version of the compact form: the raw scan's plain
    version, compacted per pixel."""
    packed, low, rng, st = rc_encode_packed_ref(
        ctx, diff, active, states0, one_tab, zero_tab, low0, range0, bits)
    return compact_packed(packed), low, rng, st


def _launch(name, gtab, ctx, diff, active, states0, one_tab, zero_tab,
            low0, range0, bits, entry=None, code=None, width=None, lib=None,
            stats=False):
    """Check the arguments and launch ``<entry>`` (default
    ``<name>_launch``; with ``stats``, ``<name>_stats_launch``, which
    also returns the decision counts: K1's stat, K1-ext's stat and stat2)
    from csrc/<name>.cu (or the loaded library ``lib``, a build of another
    copy of the source) on the current stream, with the state table in
    global memory if ``gtab``; ``code`` is the int passed in the bits
    position, ``width`` the ints stored per pixel (default 2 * bits + 1).
    Returns the outputs."""
    dev = ctx.device
    L, N = ctx.shape
    CC = states0.shape[1]
    S = width or 2 * bits + 1
    expect("ctx", ctx, torch.int32, (L, N), dev)
    expect("diff", diff, torch.int32, (L, N), dev)
    expect("active", active, torch.bool, (L, N), dev)
    expect("states0", states0, torch.uint8, (L, CC, 32), dev)
    expect("one_tab", one_tab, torch.uint8, (256,), dev)
    expect("zero_tab", zero_tab, torch.uint8, (256,), dev)
    expect("low0", low0, torch.int32, (L,), dev)
    expect("range0", range0, torch.int32, (L,), dev)
    if states0.data_ptr() % 16:
        states0 = states0.clone()          # the kernel copies in 16 B words
    fn = getattr(lib or load(name), entry or
                 f"{name}{'_stats' if stats else ''}_launch")
    counts = ()
    if stats:
        counts = (torch.empty((L, 256, 2), dtype=torch.int32, device=dev),)
        if name == "rc_encode_ext":
            counts += (torch.zeros((L, CC, 32, 2), dtype=torch.int32,
                                   device=dev),)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p] * len(counts) + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p]
    packed = torch.empty((L, N, S), dtype=torch.int32, device=dev)
    low = torch.empty((L,), dtype=torch.int32, device=dev)
    rng = torch.empty((L,), dtype=torch.int32, device=dev)
    # the global-table instance adapts the rows in place, in states
    states = states0.clone() if gtab else \
        torch.empty((L, CC, 32), dtype=torch.uint8, device=dev)
    # the runtime launches on the current device: make it the tensors'
    with torch.cuda.device(dev):
        err = fn(ctx.data_ptr(), diff.data_ptr(), active.data_ptr(),
                 states0.data_ptr(), one_tab.data_ptr(), zero_tab.data_ptr(),
                 low0.data_ptr(), range0.data_ptr(), packed.data_ptr(),
                 low.data_ptr(), rng.data_ptr(), states.data_ptr(),
                 L, N, CC, *(c.data_ptr() for c in counts),
                 bits if code is None else code, int(gtab),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return (packed.permute(1, 2, 0), low, rng, states, *counts)


def _cuda_device(t):
    """``t``'s device, which must be a CUDA one (the wrappers' CPU case is
    handled before)."""
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return t.device


def _lane_scan(ctx, diff, active, states0, one_tab, zero_tab, low0,
               range0, bits: int, stats: bool):
    """K1 (bits <= 10) or K1-ext (11..17), K1's stats scan or K1-ext's
    stats kernel with ``stats``, for CUDA tensors, with the state table in
    shared or in global memory by its size; their plain versions for CPU
    tensors."""
    if not 1 <= bits <= 17:
        raise NotImplementedError("the lane scan covers bits 1..17")
    ext = bits > 10
    if ctx.device.type == "cpu":
        ref = rc_encode_packed_ext_ref if ext else rc_encode_packed_ref
        return ref(ctx, diff, active, states0, one_tab, zero_tab, low0,
                   range0, bits, stats=stats)
    _cuda_device(ctx)
    name = instance(bits, states0.shape[1], stats=stats)
    out = _launch("rc_encode_ext" if ext else "rc_encode",
                  name.endswith("_global"), ctx, diff, active, states0,
                  one_tab, zero_tab, low0, range0, bits, stats=stats)
    count_launch(LAUNCHES, name)
    return out


def rc_stats_rows(ctx, diff, active, bits: int, CC: int):
    """K1's row counts (pass 1, bits <= 10): stat2 int32 (L, CC, 32, 2),
    each lane's active decisions by context row, row position and bit
    (csrc/rc_encode.cu ``rc_stats_rows_kernel``, the table zeroed and
    counted on the current stream) for CUDA tensors; its plain version
    ``rc_stats_rows_ref`` for CPU tensors."""
    if not 1 <= bits <= 10:
        raise NotImplementedError("K1's row counts cover bits 1..10")
    if ctx.device.type == "cpu":
        return rc_stats_rows_ref(ctx, diff, active, bits, CC)
    dev = _cuda_device(ctx)
    L, N = ctx.shape
    expect("ctx", ctx, torch.int32, (L, N), dev)
    expect("diff", diff, torch.int32, (L, N), dev)
    expect("active", active, torch.bool, (L, N), dev)
    stat2 = torch.empty((L, CC, 32, 2), dtype=torch.int32, device=dev)
    fn = load("rc_encode").rc_stats_rows_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    with torch.cuda.device(dev):
        err = fn(ctx.data_ptr(), diff.data_ptr(), active.data_ptr(),
                 stat2.data_ptr(), L, N, CC, bits,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rc_stats_rows kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(LAUNCHES, "rc_stats_rows")
    return stat2


# one side stream per CUDA device, for K1's row counts beside its scan
_SIDE: dict = {}
_SIDE_LOCK = threading.Lock()


def _side_stream(dev):
    with _SIDE_LOCK:
        s = _SIDE.get(dev)
        if s is None:
            s = _SIDE[dev] = torch.cuda.Stream(device=dev)
    return s


def rc_encode_packed(ctx, diff, active, states0, one_tab, zero_tab,
                     low0, range0, bits: int):
    """Encode lane scan; the CUDA kernel for CUDA tensors (K1 at
    bits <= 10, K1-ext at 11..17, each with the state table in shared or
    in global memory by its size), the plain version for CPU tensors
    (see the module docstring for the contract)."""
    return _lane_scan(ctx, diff, active, states0, one_tab, zero_tab, low0,
                      range0, bits, False)


def rc_encode_stats_scan(ctx, diff, active, states0, one_tab, zero_tab,
                         low0, range0, bits: int):
    """K1's stats scan alone (bits <= 10): the CUDA kernel for CUDA
    tensors, ``rc_encode_stats_scan_ref`` for CPU tensors; returns
    (packed, low, range, states, stat int32 (L, 256, 2))."""
    if not 1 <= bits <= 10:
        raise NotImplementedError("K1's stats scan covers bits 1..10")
    return _lane_scan(ctx, diff, active, states0, one_tab, zero_tab, low0,
                      range0, bits, True)


def rc_encode_stats(ctx, diff, active, states0, one_tab, zero_tab,
                    low0, range0, bits: int):
    """Encode lane scan with pass-1 decision counts.  Returns (packed,
    low, range, states, stat int32 (L, 256, 2), stat2 int32 (L, CC, 32,
    2)); the first four are rc_encode_packed's.  For CUDA tensors at bits
    <= 10: K1's stats scan on the current stream and its row counts
    (``rc_stats_rows``) on a side stream of the device, which waits for
    the current stream's work so far and which the current stream waits
    for after the scan (events only: nothing waits on the host); above 10
    bits K1-ext's stats kernel.  Their plain versions for CPU tensors."""
    if bits > 10:
        return _lane_scan(ctx, diff, active, states0, one_tab, zero_tab,
                          low0, range0, bits, True)
    if ctx.device.type == "cpu":
        return rc_encode_stats_ref(ctx, diff, active, states0, one_tab,
                                   zero_tab, low0, range0, bits)
    dev = _cuda_device(ctx)
    main = torch.cuda.current_stream(dev)
    side = _side_stream(dev)
    side.wait_stream(main)
    out = rc_encode_stats_scan(ctx, diff, active, states0, one_tab,
                               zero_tab, low0, range0, bits)
    with torch.cuda.stream(side):
        stat2 = rc_stats_rows(ctx, diff, active, bits, states0.shape[1])
    main.wait_stream(side)
    # stat2 comes from the side stream's pool; it is read on this one
    stat2.record_stream(main)
    return (*out, stat2)


def rc_encode_compact(ctx, diff, active, states0, one_tab, zero_tab,
                      low0, range0, bits: int):
    """Encode lane scan with per-pixel slot compaction (K1-compact,
    bits <= 10): the CUDA kernel for CUDA tensors, its plain version for
    CPU tensors; returns (cm int32 (N, 8, L), low, range, states)."""
    if not 1 <= bits <= 10:
        raise NotImplementedError("the compact form covers bits 1..10 "
                                  "(the fast schedule)")
    dev = ctx.device
    if dev.type == "cpu":
        return rc_encode_compact_ref(ctx, diff, active, states0, one_tab,
                                     zero_tab, low0, range0, bits)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    name = instance(bits, states0.shape[1], compact=True)
    out = _launch("rc_encode", name.endswith("_global"), ctx, diff, active,
                  states0, one_tab, zero_tab, low0, range0, bits,
                  entry="rc_encode_compact_launch", width=8)
    count_launch(LAUNCHES, name)
    return out


def rc_encode_stages(ctx, diff, active, states0, one_tab, zero_tab, low0,
                     range0, variant: str):
    """K1 at 8 bits with the stages of ``variant`` (STAGE_VARIANTS)
    stubbed: a timing instrument whose outputs are wrong on purpose,
    except ``full``, which is the production instance.  CUDA tensors
    only; on the CPU only ``full`` has a plain version."""
    stages = STAGE_VARIANTS[variant]
    dev = ctx.device
    if dev.type == "cpu":
        if variant != "full":
            raise NotImplementedError("a stubbed stage probe has no plain "
                                      "version: it times the card")
        return rc_encode_packed_ref(ctx, diff, active, states0, one_tab,
                                    zero_tab, low0, range0, 8)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    gtab = instance(8, states0.shape[1]).endswith("_global")
    return _launch("rc_encode", gtab, ctx, diff, active, states0, one_tab,
                   zero_tab, low0, range0, 8,
                   entry="rc_encode_stages_launch", code=stages)


def rc_encode_ext_stages(ctx, diff, active, states0, one_tab, zero_tab,
                         low0, range0, variant: str, bits: int = 16):
    """K1-ext at 16 bits with the stages of ``variant``
    (EXT_STAGE_VARIANTS) stubbed: a timing instrument whose outputs are
    wrong on purpose, except ``full``, which is the production instance.
    The probes are built at 16 bits only; on the CPU only ``full`` has a
    plain version."""
    stages = EXT_STAGE_VARIANTS[variant]
    if bits != 16:
        raise NotImplementedError("K1-ext's stage probes are built at 16 "
                                  "bits")
    dev = ctx.device
    if dev.type == "cpu":
        if variant != "full":
            raise NotImplementedError("a stubbed stage probe has no plain "
                                      "version: it times the card")
        return rc_encode_packed_ext_ref(ctx, diff, active, states0, one_tab,
                                        zero_tab, low0, range0, bits)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    gtab = instance(bits, states0.shape[1]).endswith("_global")
    return _launch("rc_encode_ext", gtab, ctx, diff, active, states0,
                   one_tab, zero_tab, low0, range0, bits,
                   entry="rc_encode_ext_stages_launch", code=stages)
