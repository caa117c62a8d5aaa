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

``rc_encode_stages`` and ``rc_encode_ext_stages`` launch K1's and
K1-ext's stage probes (csrc/rc_encode.cu and rc_encode_ext.cu STAGES):
timing instruments with stages stubbed, never called by the codec.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels.build import expect, load, table_in_global

from .finalize import compact_packed
from .schedule import chain_order_nosign, ext_slots

# kernel launches made by rc_encode_packed and rc_encode_compact, by
# kernel instance (read by chip_smoke.py): rc_encode (K1, bits <= 10),
# rc_encode_ext (K1-ext, bits 11..17), rc_encode_compact (K1-compact),
# and their table-in-global-memory forms rc_encode_global,
# rc_encode_ext_global and rc_encode_compact_global
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


def other_smem_bytes(bits: int) -> int:
    """Shared memory a lane scan uses beside the state table: one_tab and
    zero_tab, and at bits > 10 K1-ext's one_pow (one_tab applied 1..bits
    - 10 times, csrc/rc_encode_ext.cu)."""
    return 512 + 256 * max(0, bits - 10)


def instance(bits: int, CC: int, compact: bool = False) -> str:
    """The kernel instance rc_encode_packed (or, with ``compact``,
    rc_encode_compact) launches for a coded width and a state table of
    CC rows."""
    name = "rc_encode_ext" if bits > 10 else \
        "rc_encode_compact" if compact else "rc_encode"
    return name + ("_global" if table_in_global(
        CC * 32, other_smem_bytes(bits)) else "")


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


def rc_encode_packed_ref(ctx, diff, active, states0, one_tab, zero_tab,
                         low0, range0, bits: int):
    """Plain PyTorch version: a loop over pixels, vectorised over lanes."""
    L, N = ctx.shape
    CC = states0.shape[1]
    dev = ctx.device
    S = len(chain_order_nosign(bits)) + 1
    pos, act, bit = _slot_masks(diff, active, bits)
    bit = bit & act
    # flat index of every slot's state, and the row of its transition in
    # trans = [keep | zero | one] (an inactive slot keeps its state)
    rows = torch.arange(L, device=dev)[:, None] * CC + \
        ctx.long().clamp(0, CC - 1)
    at = (rows << 5)[..., None] + pos                      # (L, N, S)
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

    for i in range(N):
        at_i = at[:, i]
        s_all = st[at_i]                                   # (L, S)
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
    return (packed.permute(1, 2, 0), low.to(torch.int32),
            rng.to(torch.int32), st.to(torch.uint8).view(L, CC, 32))


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
                             low0, range0, bits: int, _chunk: int = 4096):
    """Plain PyTorch version of the extended schedule (bits 11..17): a
    loop over pixels, vectorised over lanes (the semantics of
    rc_scan_lanes.rc_encode_scan_lanes_ext).  Rows 10 and 31 carry
    running states through every decision that touches them; the other
    positions adapt once per pixel after the chain.  The per-slot masks
    are built ``_chunk`` pixels at a time to bound memory."""
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
        for i in range(n):
            at_i = at[:, i]
            s_all = st[at_i]                                  # (L, S)
            s_k = (s_all * act_l[:, i]).unbind(1)
            b_k = bit[:, i].unbind(1)
            a_k = act[:, i].unbind(1)
            sel_k = sel[:, i].unbind(1)
            s10 = s_all[:, run10[0]]
            s31 = s_all[:, run31[0]]
            nls, ems = [no_nl] * S, [no_em] * S
            for k in coded[i].nonzero()[0]:
                b = b_k[k]
                if k in run10:
                    s = s10 * a_k[k]
                    s10 = trans[sel_k[k] + s10]
                elif k in run31:
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

    return (packed.permute(1, 2, 0), low.to(torch.int32),
            rng.to(torch.int32), st.to(torch.uint8).view(L, CC, 32))


def rc_encode_compact_ref(ctx, diff, active, states0, one_tab, zero_tab,
                          low0, range0, bits: int):
    """Plain PyTorch version of the compact form: the raw scan's plain
    version, compacted per pixel."""
    packed, low, rng, st = rc_encode_packed_ref(
        ctx, diff, active, states0, one_tab, zero_tab, low0, range0, bits)
    return compact_packed(packed), low, rng, st


def _launch(name, gtab, ctx, diff, active, states0, one_tab, zero_tab,
            low0, range0, bits, entry=None, code=None, width=None, lib=None):
    """Check the arguments and launch ``<entry>`` (default
    ``<name>_launch``) from csrc/<name>.cu (or the loaded library
    ``lib``, a build of another copy of the source) on the current
    stream, with the state table in global memory if ``gtab``; ``code``
    is the int passed in the bits position, ``width`` the ints stored per
    pixel (default 2 * bits + 1).  Returns the outputs."""
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
    fn = getattr(lib or load(name), entry or f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    packed = torch.empty((L, N, S), dtype=torch.int32, device=dev)
    low = torch.empty((L,), dtype=torch.int32, device=dev)
    rng = torch.empty((L,), dtype=torch.int32, device=dev)
    # the global-table instance adapts the rows in place, in states
    states = states0.clone() if gtab else \
        torch.empty((L, CC, 32), dtype=torch.uint8, device=dev)
    err = fn(ctx.data_ptr(), diff.data_ptr(), active.data_ptr(),
             states0.data_ptr(), one_tab.data_ptr(), zero_tab.data_ptr(),
             low0.data_ptr(), range0.data_ptr(), packed.data_ptr(),
             low.data_ptr(), rng.data_ptr(), states.data_ptr(),
             L, N, CC, bits if code is None else code, int(gtab),
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return packed.permute(1, 2, 0), low, rng, states


def rc_encode_packed(ctx, diff, active, states0, one_tab, zero_tab,
                     low0, range0, bits: int):
    """Encode lane scan; the CUDA kernel for CUDA tensors (K1 at
    bits <= 10, K1-ext at 11..17, each with the state table in shared or
    in global memory by its size), the plain version for CPU tensors
    (see the module docstring for the contract)."""
    if not 1 <= bits <= 17:
        raise NotImplementedError("the lane scan covers bits 1..17")
    ext = bits > 10
    dev = ctx.device
    if dev.type == "cpu":
        ref = rc_encode_packed_ext_ref if ext else rc_encode_packed_ref
        return ref(ctx, diff, active, states0, one_tab, zero_tab, low0,
                   range0, bits)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    name = instance(bits, states0.shape[1])
    out = _launch("rc_encode_ext" if ext else "rc_encode",
                  name.endswith("_global"), ctx, diff, active, states0,
                  one_tab, zero_tab, low0, range0, bits)
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1
    return out


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
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1
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
