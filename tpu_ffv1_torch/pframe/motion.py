"""Block motion search for FFV1-P as torch int32 ops, batched over lanes.

Port of ``tpu_ffv1/pframe/motion.py`` (``candidate_grid``, ``_shift2d``,
``block_motion_search_cost``, ``block_motion_search_epzs``,
``SEARCH_FNS``).  The JAX functions take one (H, W) slice and run under
``jax.vmap``; these take (L, H, W) stacks of slice lanes (H, W block
multiples) and return (mvs int32 (L, bh, bw, 2), sad int32 (L, bh, bw),
cost int32 (L, bh, bw)).

The SAD field is never stacked over candidates (225 x L x H x W int32
is 1.66 GB at 720p with 24 lanes): each candidate is reduced to its
(L, bh, bw) block costs at once and folded into a running minimum.  A
candidate replaces the best only at a strictly smaller cost, so each
block keeps the first minimum in candidate order, as ``jnp.argmin``
does; ties are common on flat and screen content and decide the bytes.

The full search's candidate shifts are static slices of one
edge-padded reference (motion across a border clamps, as ``_shift2d``
clamps); the EPZS search's vectors differ per block, so each of its
candidates is one gather.
"""
from __future__ import annotations

import torch


def candidate_grid(radius: int):
    """All (dy, dx) candidate vectors within a square search window."""
    return [(dy, dx)
            for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)]


def _shift2d(ref, dy: int, dx: int):
    """(..., H, W) shifted by (dy, dx) with edge replication: out[y, x] =
    ref[clip(y + dy), clip(x + dx)]."""
    H, W = ref.shape[-2:]
    dev = ref.device
    ys = (torch.arange(H, device=dev) + dy).clamp(0, H - 1)
    xs = (torch.arange(W, device=dev) + dx).clamp(0, W - 1)
    return ref[..., ys, :][..., xs]


def _edge_pad(ref, r: int):
    """(L, H, W) edge-replicated by ``r`` on every side: (L, H + 2r,
    W + 2r); its [r + dy : r + dy + H, r + dx : r + dx + W] window is
    ``_shift2d(ref, dy, dx)`` for |dy|, |dx| <= r."""
    H, W = ref.shape[-2:]
    dev = ref.device
    ys = (torch.arange(-r, H + r, device=dev)).clamp(0, H - 1)
    xs = (torch.arange(-r, W + r, device=dev)).clamp(0, W - 1)
    return ref[:, ys][:, :, xs]


def _block_sad(cur, pred, block: int):
    """sum |cur - pred| per block: (L, H, W) -> int32 (L, H/b, W/b)."""
    L, H, W = cur.shape
    d = (cur - pred).abs_()
    return d.view(L, H // block, block, W // block, block).sum(
        dim=(2, 4), dtype=torch.int32)


def _penalty(mv_y, mv_x, prev_mvs, lam: int):
    """lam * (|dy - pdy| + |dx - pdx|): the rate term against the block's
    previous-frame vector, the predictor its MV delta is coded against."""
    return ((mv_y - prev_mvs[..., 0]).abs() +
            (mv_x - prev_mvs[..., 1]).abs()) * lam


class _RunningMin:
    """Per-block minimum over candidates taken in order; a candidate
    replaces the best only at a strictly smaller cost (the first minimum,
    ``argmin``'s rule).  Keeps the winner's sad, cost and vector (int32
    (L, bh, bw, 2), or, where every block's candidates are the same
    vectors, its index into them)."""

    def __init__(self):
        self.cost = None

    def add(self, sad, cost, mv):
        if self.cost is None:
            self.sad, self.cost = sad, cost
            self.mv = mv.expand(*cost.shape, 2).clone() \
                if isinstance(mv, torch.Tensor) else \
                torch.full_like(cost, mv)
            return
        better = cost < self.cost
        self.sad = torch.where(better, sad, self.sad)
        self.cost = torch.minimum(cost, self.cost)
        self.mv = torch.where(better[..., None] if isinstance(
            mv, torch.Tensor) else better, mv, self.mv)


def block_motion_search_cost(cur, ref, prev_mvs, block: int = 16,
                             radius: int = 7, lam: int = 16):
    """Rate-aware full-search SAD block matching over lanes.

    cost = SAD + lam * (|dy - pdy| + |dx - pdx|), (pdy, pdx) the same
    block's previous-frame vector; every vector within ``radius`` is
    tried, in ``candidate_grid`` order.  ``cur``, ``ref``: integer
    (L, H, W); ``prev_mvs``: int32 (L, bh, bw, 2).  Returns (mvs, sad,
    cost) of each block's first minimum-cost candidate.  The rate term
    is two tables of lam * |v - p| per vector component, made once; the
    winner is kept as its candidate index, so no candidate crosses from
    the host."""
    L, H, W = cur.shape
    dev = cur.device
    cur = cur.to(torch.int32)
    prev_mvs = prev_mvs.to(torch.int32)
    ref_p = _edge_pad(ref.to(torch.int32), radius)
    v = torch.arange(-radius, radius + 1, dtype=torch.int32,
                     device=dev)[:, None, None, None]
    pen_y = (v - prev_mvs[..., 0]).abs_() * lam      # (2r + 1, L, bh, bw)
    pen_x = (v - prev_mvs[..., 1]).abs_() * lam
    cands = candidate_grid(radius)
    best = _RunningMin()
    for i, (dy, dx) in enumerate(cands):
        sh = ref_p[:, radius + dy:radius + dy + H,
                   radius + dx:radius + dx + W]
        sad = _block_sad(cur, sh, block)
        best.add(sad, sad + pen_y[dy + radius] + pen_x[dx + radius], i)
    # non-blocking from pageable memory: staged before the call returns,
    # with no wait on the card
    table = torch.tensor(cands, dtype=torch.int32).to(dev, non_blocking=True)
    return table[best.mv.long()], best.sad, best.cost


def _sad_cost_at(cur, ref_flat, prev_mvs, mvb, block: int, lam: int):
    """(sad, cost) of per-block vectors ``mvb`` (L, bh, bw, 2): each pixel
    reads ref[clip(y + dy), clip(x + dx)] with its block's vector (one
    gather)."""
    L, H, W = cur.shape
    dev = cur.device
    bh, bw = mvb.shape[1], mvb.shape[2]
    per_px = mvb[:, :, None, :, None, :].expand(
        L, bh, block, bw, block, 2).reshape(L, H, W, 2)
    dy, dx = per_px[..., 0], per_px[..., 1]
    ys = (torch.arange(H, device=dev)[:, None] + dy).clamp_(0, H - 1)
    xs = (torch.arange(W, device=dev)[None, :] + dx).clamp_(0, W - 1)
    idx = (ys * W + xs).view(L, -1).long()
    pred = torch.gather(ref_flat, 1, idx).view(L, H, W)
    sad = _block_sad(cur, pred, block)
    return sad, sad + _penalty(mvb[..., 0], mvb[..., 1], prev_mvs, lam)


def block_motion_search_epzs(cur, ref, prev_mvs, block: int = 16,
                             radius: int = 7, lam: int = 16):
    """Predictor-seeded two-stage search over lanes (EPZS's core idea,
    motion_est.c:977, with no serial chain between blocks):

      stage 1: a coarse uniform grid over the window (the points
               {-r, -(r + 1) // 2, 0, (r + 1) // 2, r} squared), then the
               same block's and its 4 field neighbours' previous-frame
               vectors, clipped to the window
      stage 2: dense +-2 refinement around each block's stage-1 winner,
               clipped to the window

    The same (mvs, sad, cost) contract and first-minimum tie rule as
    ``block_motion_search_cost``."""
    L, H, W = cur.shape
    bh, bw = H // block, W // block
    cur = cur.to(torch.int32)
    prev_mvs = prev_mvs.to(torch.int32)
    ref_flat = ref.to(torch.int32).reshape(L, -1)
    dev = cur.device
    half = (radius + 1) // 2
    pts = sorted({-radius, -half, 0, half, radius})
    r2 = min(2, radius)
    # the coarse grid's vectors, then stage 2's offsets: one upload
    table = torch.tensor(
        [(dy, dx) for dy in pts for dx in pts] +
        [(dy, dx) for dy in range(-r2, r2 + 1) for dx in range(-r2, r2 + 1)],
        dtype=torch.int32).to(dev, non_blocking=True)
    n1 = len(pts) ** 2
    cands = [table[i].expand(L, bh, bw, 2) for i in range(n1)]
    for dy, dx in ((0, 0), (0, -1), (0, 1), (-1, 0), (1, 0)):
        shifted = torch.stack([_shift2d(prev_mvs[..., k], dy, dx)
                               for k in (0, 1)], dim=-1)
        cands.append(shifted.clamp(-radius, radius))
    stage1 = _RunningMin()
    for c in cands:
        stage1.add(*_sad_cost_at(cur, ref_flat, prev_mvs, c, block, lam), c)
    ctr = stage1.mv
    stage2 = _RunningMin()
    for off in table[n1:]:
        c = (ctr + off).clamp_(-radius, radius)
        stage2.add(*_sad_cost_at(cur, ref_flat, prev_mvs, c, block, lam), c)
    return stage2.mv, stage2.sad, stage2.cost


SEARCH_FNS = {"full": block_motion_search_cost,
              "epzs": block_motion_search_epzs}
