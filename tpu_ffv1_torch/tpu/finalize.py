"""Finalize the packed lane-scan output into slice payload bytes.

Port of ``tpu_ffv1/tpu/rc_scan_lanes.py`` (``_resolve_compact``,
``finalize_packed``, ``finalize_compact``, ``finalize_packed_full``) as
PyTorch ops, with ``compact_packed``, the per-pixel slot compaction that
the compact lane scan does in its kernel (``rc_pallas.py:419-445``).  The
sentinel and terminate bytes, the carry suffix recurrence and the
overflow verdicts are the JAX package's; the final compaction is a
scatter at rank ``cumsum(valid) - 1`` where the TPU version sorted
(scatter stalled the TPU compiler, rc_scan_lanes.py:373-376).
"""
from __future__ import annotations

import torch


def _pv(lw):
    """core.rac.prov_value on a tensor."""
    return (lw >> 8) | (((lw & 0xFF) != 0).to(torch.int32) << 16)


def _resolve_compact(flat_b, flat_v, low, rng, prefix, prefix_len):
    """Carry-resolve [prefix | slot stream | sentinel+terminate tail]
    per lane, then compact the valid bytes.

    flat_b: int32 (L, M) provisional values (bits 0..16); flat_v: bool
    (L, M) validity, in stream order per lane.  Invalid slots are
    neutral carry propagators (g=0, p=1).  Returns (bytes uint8 (L, T),
    count int32 (L,)); byte ``count`` is the never-flushed last value,
    the bytes after it are 0.
    """
    L = flat_b.shape[0]
    dev = flat_b.device
    pcap = prefix.shape[1]
    # one range-coded 0 at state 129, then ff_rac_terminate
    r1 = (rng * 129) >> 8
    s_emit = (rng - r1) < 0x100
    pv0 = _pv(low)
    low2 = torch.where(s_emit, (low & 0xFF) << 8, low)
    t1 = _pv(low2 + 0xFF)
    t2 = (low2 + 0xFF) & 0xFF
    tail_b = torch.stack([torch.where(s_emit, pv0, t1),
                          torch.where(s_emit, t1, t2),
                          torch.where(s_emit, t2, 0)], dim=1)
    ones = torch.ones((L,), dtype=torch.bool, device=dev)
    tail_v = torch.stack([ones, ones, s_emit], dim=1)

    pvld = torch.arange(pcap, device=dev)[None, :] < prefix_len[:, None]
    vals = torch.cat([prefix.to(torch.int32), flat_b.to(torch.int32),
                      tail_b.to(torch.int32)], dim=1)          # (L, T)
    vld = torch.cat([pvld, flat_v.to(torch.bool), tail_v], dim=1)
    T = vals.shape[1]

    # carry suffix recurrence c_k = g_k | (p_k & c_{k+1}) as a cummax
    # over propagate-run segments of the reversed stream
    g = ((vals >> 8) & 1) * vld
    p = torch.where(vld, ((vals & 0x1FF) == 0xFF) & ((vals >> 16) == 1),
                    True)
    gr = g.flip(1)
    brk = torch.cumsum((~p).flip(1).to(torch.int32), dim=1,
                       dtype=torch.int32)
    m = torch.cummax(gr + 2 * brk, dim=1).values
    carry_out = ((m - 2 * brk) >= 1).flip(1).to(torch.int32)
    carry_in = torch.cat([carry_out[:, 1:],
                          torch.zeros((L, 1), dtype=torch.int32,
                                      device=dev)], dim=1)
    resolved = (((vals & 0x1FF) + carry_in) & 0xFF).to(torch.uint8)

    rank = torch.cumsum(vld.to(torch.int32), dim=1, dtype=torch.int32) - 1
    out = torch.zeros((L, T + 1), dtype=torch.uint8, device=dev)
    out.scatter_(1, torch.where(vld, rank, T).long(), resolved)
    # rank[-1] = valid values - 1: the last value never flushes
    return out[:, :T], rank[:, -1]


def finalize_packed(packed, low, rng, prefix, prefix_len, s2: int = 4):
    """Finalize from the lane-scan output.

    packed: int32 (N, S, L) with bit 20 = emit flag.  Slots compact to
    ``s2`` per pixel, then (for s2 == 4 and N % 16 == 0) to 24 per
    16-pixel group, before the resolve + compaction.  Returns (bytes
    uint8 (L, T), count int32 (L,), overflow bool (L,)); a lane that
    overflows either level must be redone with finalize_packed_full.
    """
    N, S, L = packed.shape
    valid = (packed >> 20) & 1
    pv = packed & 0x1FFFF
    cnt_inc = torch.cumsum(valid, dim=1, dtype=torch.int32)
    cnt_exc = cnt_inc - valid
    total_pix = cnt_inc[:, -1, :]                             # (N, L)
    overflow = total_pix.amax(dim=0) > s2
    pvv = pv * valid
    slots = torch.stack([(pvv * (cnt_exc == k)).sum(dim=1, dtype=torch.int32)
                         for k in range(s2)], dim=1)          # (N, s2, L)
    ar = torch.arange(s2, device=packed.device)
    vld = ar[None, :, None] < total_pix[:, None, :]
    G, C = 16, 24
    if s2 == 4 and N % G == 0:
        gs = slots.reshape(N // G, G * s2, L)
        gv = vld.reshape(N // G, G * s2, L).to(torch.int32)
        ginc = torch.cumsum(gv, dim=1, dtype=torch.int32)
        gexc = ginc - gv
        gcount = ginc[:, -1, :]                               # (N/G, L)
        overflow = overflow | (gcount.amax(dim=0) > C)
        gsv = gs * gv
        slots = torch.stack([(gsv * (gexc == k)).sum(dim=1,
                                                     dtype=torch.int32)
                             for k in range(C)], dim=1)       # (N/G, C, L)
        ac = torch.arange(C, device=packed.device)
        vld = ac[None, :, None] < gcount[:, None, :]
    flat_b = slots.permute(2, 0, 1).reshape(L, -1)
    flat_v = vld.permute(2, 0, 1).reshape(L, -1)
    out, count = _resolve_compact(flat_b, flat_v, low, rng, prefix,
                                  prefix_len)
    return out, count, overflow


def compact_packed(packed):
    """The compact lane scan's per-pixel compaction of a raw (N, S, L)
    scan output (bit 20 = emit flag): cm int32 (N, 8, L), rows [the
    first 4 emitted provisional values (bits 0..16; 0 past the count),
    count, overflow (count > 4), 0, 0].  Slots past the fourth are
    dropped; the count and the overflow flag keep that they existed."""
    valid = (packed >> 20) & 1
    pv = (packed & 0x1FFFF) * valid
    cnt_exc = torch.cumsum(valid, dim=1, dtype=torch.int32) - valid
    total = valid.sum(dim=1, dtype=torch.int32)               # (N, L)
    zero = torch.zeros_like(total)
    rows = [(pv * (cnt_exc == k)).sum(dim=1, dtype=torch.int32)
            for k in range(4)]
    return torch.stack(rows + [total, (total > 4).to(torch.int32), zero,
                               zero], dim=1)


def finalize_compact(cm, low, rng, prefix, prefix_len):
    """Finalize from the compact lane-scan output cm int32 (N, 8, L)
    (see ``compact_packed``).  Returns (bytes uint8 (L, T), count int32
    (L,), overflow bool (L,)); on overflow the frame must be redone on
    the raw scan, since the dropped slots no longer exist."""
    N, _, L = cm.shape
    slots = cm[:, :4, :]
    vld = torch.arange(4, device=cm.device)[None, :, None] < \
        cm[:, 4:5, :]
    overflow = cm[:, 5, :].amax(dim=0) > 0
    flat_b = slots.permute(2, 0, 1).reshape(L, N * 4)
    flat_v = vld.permute(2, 0, 1).reshape(L, N * 4)
    out, count = _resolve_compact(flat_b, flat_v, low, rng, prefix,
                                  prefix_len)
    return out, count, overflow


def finalize_packed_full(packed, low, rng, prefix, prefix_len):
    """Full-width finalize (no per-pixel compaction): the redo path for
    a finalize_packed overflow."""
    N, S, L = packed.shape
    flat = packed.permute(2, 0, 1).reshape(L, N * S)
    return _resolve_compact(flat & 0x1FFFF, ((flat >> 20) & 1) == 1, low,
                            rng, prefix, prefix_len)
