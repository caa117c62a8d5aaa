"""Slice grid geometry and per-slice state.

The port's copy of ``tpu_ffv1/codec/context.py``.  The port keeps the
adaptive states of all slices on the device, so it needs only the grid
and the slice-header fields of the slice state; the per-plane host
states (``PlaneState``), their allocators (``alloc_slice_state``,
``clear_slice_state``) and the Golomb-Rice VLC state are left out.

Behavioral parity references: libavcodec/ffv1.c:67-160 (slice state and
grid).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SliceGeometry:
    sx: int          # slice column index
    sy: int          # slice row index
    x: int           # left, luma pixels
    y: int           # top, luma pixels
    width: int
    height: int


def slice_grid(width: int, height: int, num_h: int, num_v: int):
    """Slice bounds (ffv1.c:117-145): edges at width*i/num_h (floor)."""
    out = []
    for i in range(num_h * num_v):
        sx = i % num_h
        sy = i // num_h
        sxs = width * sx // num_h
        sxe = width * (sx + 1) // num_h
        sys = height * sy // num_v
        sye = height * (sy + 1) // num_v
        out.append(SliceGeometry(sx, sy, sxs, sys, sxe - sxs, sye - sys))
    return out


@dataclass
class SliceState:
    geom: SliceGeometry
    slice_coding_mode: int = 0
    slice_rct_by_coef: int = 1
    slice_rct_ry_coef: int = 1
    slice_reset_contexts: int = 0
