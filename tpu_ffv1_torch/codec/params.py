"""Encoder parameter resolution — the framework mirror of encode_init
(the port's copy of ``tpu_ffv1/codec/params.py``).

Behavioral parity reference: libavcodec/ffv1enc.c:669-1028 (version
selection, coder selection, pix_fmt dispatch, quant tables, slice grid).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core import tables as T
from ..core.rac import build_rac_states
from .pixfmt import PixFmt, get_pix_fmt

FF_LEVEL_UNKNOWN = -99
FF_COMPLIANCE_EXPERIMENTAL = -2


@dataclass
class EncoderParams:
    """User-facing knobs, named after the reference CLI/AVOptions."""
    width: int
    height: int
    pix_fmt: str = "yuv420p"
    level: int = FF_LEVEL_UNKNOWN      # -level (FFV1 version)
    coder: int = -1                    # -coder: -1 auto, 0 rice, 1/2 range
    context_model: int = 0             # -context
    slices: int = 0                    # -slices (0 = unset/auto)
    slicecrc: int = -1                 # -slicecrc (-1 = auto: on for v>=3)
    gop_size: int = 12                 # -g (avcodec default 12)
    strict: int = 0                    # -strict (-2 enables experimental)
    pass1: bool = False                # two-pass statistics gathering
    stats_in: str | None = None        # two-pass input statistics
    sar: tuple[int, int] = (0, 1)      # sample aspect ratio written in v3+


@dataclass
class ResolvedParams:
    width: int
    height: int
    fmt: PixFmt
    version: int
    micro_version: int
    ac: int                      # coder kind (AC_* constants)
    colorspace: int
    bits_per_raw_sample: int
    chroma_planes: bool
    chroma_h_shift: int
    chroma_v_shift: int
    transparency: bool
    packed_at_lsb: bool
    plane_count: int
    context_model: int
    quant_tables: np.ndarray     # (quant_table_count, 5, 256) int16
    context_counts: tuple
    quant_table_count: int
    state_transition: np.ndarray  # uint8[256], one_state table for slices
    initial_states: list = field(default_factory=list)  # per quant table or None
    num_h_slices: int = 1
    num_v_slices: int = 1
    ec: int = 0
    intra: int = 1
    gop_size: int = 12
    sar: tuple = (0, 1)

    @property
    def slice_count(self) -> int:
        return self.num_h_slices * self.num_v_slices


def _pick_slice_grid(width: int, height: int, slices: int):
    """Slice-grid search (ffv1enc.c:988-1001)."""
    num_v = 2 if (width > 352 or height > 288 or not slices) else 1
    while num_v < 9:
        num_h = num_v
        while num_h < 2 * num_v:
            if (slices == num_h * num_v and slices <= 64) or not slices:
                return num_h, num_v
            num_h += 1
        num_v += 1
    raise ValueError(
        f"unsupported slice count {slices}; pick e.g. 4, 6, 9, 12, 16 ...")


def resolve(p: EncoderParams) -> ResolvedParams:
    fmt = get_pix_fmt(p.pix_fmt)

    version = 0
    if p.pass1 or p.stats_in is not None or p.slices > 1:
        version = max(version, 2)
    if p.slices == 0 and p.level < 0 and p.width * p.height > 720 * 576:
        version = max(version, 2)
    if p.level <= 0 and version == 2:
        version = 3
    if 0 <= p.level <= 4:
        if p.level < version:
            raise ValueError(
                f"version {version} needed for requested features but "
                f"{p.level} requested")
        version = p.level
    if (version == 2 or version > 3) and p.strict > FF_COMPLIANCE_EXPERIMENTAL:
        raise ValueError("version 2/4 is experimental; pass strict=-2")

    # Coder selection (ffv1enc.c:708-718; -1 = the ffv1 private-option
    # default, Golomb-Rice)
    ac = T.AC_GOLOMB_RICE if p.coder == -1 else p.coder
    if ac == 1:
        ac = T.AC_RANGE_CUSTOM_TAB
    elif ac == T.AC_RANGE_DEFAULT_TAB_FORCE:
        ac = T.AC_RANGE_DEFAULT_TAB

    bits = fmt.bits
    colorspace = fmt.colorspace
    transparency = fmt.transparency
    chroma_planes = fmt.chroma_planes
    if bits > 8 and ac == T.AC_GOLOMB_RICE:
        ac = T.AC_RANGE_CUSTOM_TAB   # forced (ffv1enc.c:755-759, :810-814)
    if bits > 8 or (colorspace == 1 and bits > 8):
        version = max(version, 1)

    plane_count = 3
    if not transparency:
        plane_count = 2
    if not chroma_planes and version > 3:
        plane_count -= 1

    # State transition table for slice data (ffv1enc.c:836-844)
    if ac == T.AC_RANGE_CUSTOM_TAB:
        state_transition = T.VER2_STATE.copy()
    else:
        one, _zero = build_rac_states()
        state_transition = one.copy()
    state_transition[0] = 0

    quant_tables = T.default_quant_tables(bits)
    context_counts = T.CONTEXT_COUNTS

    micro_version = 0
    if version == 3:
        micro_version = 4
    elif version == 4:
        micro_version = 2

    ec = p.slicecrc
    if ec < 0:
        ec = 1 if version >= 3 else 0

    if version > 1:
        num_h, num_v = _pick_slice_grid(p.width, p.height, p.slices)
    else:
        num_h = num_v = 1

    return ResolvedParams(
        width=p.width, height=p.height, fmt=fmt, version=version,
        micro_version=micro_version, ac=ac, colorspace=colorspace,
        bits_per_raw_sample=bits, chroma_planes=chroma_planes,
        chroma_h_shift=fmt.chroma_h_shift, chroma_v_shift=fmt.chroma_v_shift,
        transparency=transparency, packed_at_lsb=fmt.packed_at_lsb,
        plane_count=plane_count, context_model=p.context_model,
        quant_tables=quant_tables, context_counts=context_counts,
        quant_table_count=2, state_transition=state_transition,
        initial_states=[None, None], num_h_slices=num_h, num_v_slices=num_v,
        ec=ec, intra=1 if p.gop_size < 2 else 0, gop_size=p.gop_size,
        sar=p.sar)
