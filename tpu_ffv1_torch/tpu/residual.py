"""Encode-side residual + context stencil as PyTorch int32 ops.

Port of ``tpu_ffv1/tpu/residual.py``.  The median predictor and the
quantized-gradient context depend only on source samples, so the whole
plane is one stencil; every function here works on (..., H, W) so a
stack of slice crops goes through in one call.

Neighbor/border semantics mirror ffv1enc.c:373-411 and ffv1.h:161-190:

    T [y,x] = s[y-1,x]          (0 for y=0)
    RT[y,x] = s[y-1,x+1]        (x=w-1 -> s[y-1,w-1]; 0 for y=0)
    L [y,x] = s[y,x-1]          (x=0   -> s[y-1,0] = T[y,0])
    LT[y,x] = s[y-1,x-1]        (x=0   -> s[y-2,0]; 0 for y<2)
    LL[y,x] = s[y,x-2]          (x=1   -> s[y-1,0]; x=0 -> 0)
    TT[y,x] = s[y-2,x]          (0 for y<2)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _shift_down(s, k):
    """s shifted k rows down along dim -2, zero-filled."""
    if k >= s.shape[-2]:
        return torch.zeros_like(s)
    return F.pad(s[..., :s.shape[-2] - k, :], (0, 0, k, 0))


def neighbors(s: torch.Tensor):
    """All predictor/context neighbors with FFV1 border extension for an
    int32 (..., H, W) plane; returns a dict of int32 (..., H, W)."""
    T = _shift_down(s, 1)
    TT = _shift_down(s, 2)
    RT = torch.cat([T[..., 1:], T[..., -1:]], dim=-1)
    L = torch.cat([T[..., :1], s[..., :-1]], dim=-1)
    LT = torch.cat([TT[..., :1], T[..., :-1]], dim=-1)
    if s.shape[-1] >= 2:
        LL = torch.cat([torch.zeros_like(s[..., :1]), T[..., :1],
                        s[..., :-2]], dim=-1)
    else:
        LL = torch.zeros_like(s)
    return {"L": L, "T": T, "LT": LT, "RT": RT, "LL": LL, "TT": TT}


def _fold(diff, bits):
    half = 1 << (bits - 1)
    return ((diff + half) & ((1 << bits) - 1)) - half


def residuals_and_contexts(s: torch.Tensor, quant_table: torch.Tensor,
                           bits: int, five_input: bool):
    """Per-pixel (context_id >= 0, folded residual), both int32 of the
    shape of ``s`` (..., H, W).

    ``quant_table``: (5, 256) int32 tensor on the device of ``s``,
    indexed by the byte gradient.
    """
    s = s.to(torch.int32)
    n = neighbors(s)
    L, T, LT, RT = n["L"], n["T"], n["LT"], n["RT"]
    ctx = (quant_table[0][(L - LT) & 0xFF] +
           quant_table[1][(LT - T) & 0xFF] +
           quant_table[2][(T - RT) & 0xFF])
    if five_input:
        ctx += (quant_table[3][(n["LL"] - L) & 0xFF] +
                quant_table[4][(n["TT"] - T) & 0xFF])

    # integer median of (L, L+T-LT, T): sum - min - max
    b = L + T - LT
    pred = (L + b + T) - torch.minimum(torch.minimum(L, b), T) \
        - torch.maximum(torch.maximum(L, b), T)
    diff = s - pred
    neg = ctx < 0
    ctx = torch.where(neg, -ctx, ctx)
    diff = torch.where(neg, -diff, diff)
    return ctx, _fold(diff, bits)


def rct_transform(g, b, r, bits: int, by: int = 1, ry: int = 1):
    """Forward reversible colour transform (ffv1enc.c:447-453): b -= g;
    r -= g; g += (b * by + r * ry) >> 2; b and r offset by 1 << bits
    (``bits``: the samples' width).  ``by``/``ry`` are the slice's RCT
    coefficients, (1, 1) at version 3.  Integer tensors of one shape in,
    int32 (g, b, r) out."""
    g = g.to(torch.int32)
    b = b.to(torch.int32) - g
    r = r.to(torch.int32) - g
    g = g + ((b * by + r * ry) >> 2)
    offset = 1 << bits
    return g, b + offset, r + offset


def wrap_int16(v):
    """int16_t storage wrap (sample buffers are int16 in the reference)."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def load_plane(src: torch.Tensor, bits: int, packed_at_lsb: bool):
    """Sample load semantics (ffv1enc.c:390-404) on an integer tensor."""
    v = src.to(torch.int32)
    if bits > 8 and not packed_at_lsb:
        v = v >> (16 - bits)
    if bits > 8:
        v = wrap_int16(v)
    return v
