"""Version-4 per-slice RCT coefficient search as torch ops.

Port of ``tpu_ffv1/tpu/rct_search.py``, which mirrors choose_rct_params
(ffv1enc.c:1064-1144): the same 15 candidate (ry, by) pairs, the same
integer arithmetic (the previous row's first differences wrapped to
int16, as the reference's ``int16_t *sample[3]`` scratch holds them; the
first column passing through raw) and the first-index tie-break.

The JAX version splits each sum into 16-bit halves because JAX runs with
64-bit integers off; here every cost is int32 (below 2^20 per pixel) and
every sum is an exact int64 reduction, so the totals come out whole.
The search is vector work, not a pixel-serial scan: it stays torch ops
on the card (15 reductions over the slice crops), and only the (L, 15)
totals cross to the host, where ``pick_rct_coefs`` takes the argmin.
"""
from __future__ import annotations

import numpy as np
import torch

# (ry, by) candidates in the reference's order (ffv1enc.c:1069-1085;
# the port's copy of tpu_ffv1/codec/rct.py RCT_Y_COEFF)
RCT_Y_COEFF = [
    (0, 0), (1, 1), (2, 2), (0, 2), (2, 0), (4, 0), (0, 4),
    (0, 3), (3, 0), (3, 1), (1, 3), (1, 2), (2, 1), (0, 1), (1, 0),
]


def _hdiff(p):
    """Horizontal first differences; lastX starts at 0 each row, so the
    first column passes through raw (ffv1enc.c:1090-1100)."""
    return torch.cat([p[..., :1], p[..., 1:] - p[..., :-1]], dim=-1)


def _w16(v):
    """int16_t storage wrap of the previous row's first differences
    (ffv1enc.c:1087)."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def rct_cost_pairs(b, g, r):
    """(L, h, w) integer slice crops of the planes the reference reads as
    b, g, r -> int64 (L, 15) exact cost sums, in RCT_Y_COEFF order."""
    ab, ag, ar = (_hdiff(p.to(torch.int32)) for p in (b, g, r))
    bg = ag[:, 1:, 1:] - _w16(ag[:, :-1, 1:])
    bb = ab[:, 1:, 1:] - _w16(ab[:, :-1, 1:])
    br = ar[:, 1:, 1:] - _w16(ar[:, :-1, 1:])
    br = br - bg
    bb = bb - bg
    return torch.stack([
        (bg + ((br * ry + bb * by) >> 2)).abs().sum(dim=(1, 2),
                                                    dtype=torch.int64)
        for ry, by in RCT_Y_COEFF], dim=1)


def pick_rct_coefs(totals: np.ndarray):
    """(L, 15) cost sums -> a list of (by, ry) per lane.  np.argmin takes
    the first minimal index, as the reference's strict-< scan keeps the
    earliest candidate (ffv1enc.c:1137-1140)."""
    idx = np.argmin(np.asarray(totals), axis=1)
    return [(RCT_Y_COEFF[i][1], RCT_Y_COEFF[i][0]) for i in idx]
