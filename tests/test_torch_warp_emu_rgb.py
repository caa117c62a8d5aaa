"""B1's and B1-ext's CUDA sources (csrc/rc_decode.cu and
csrc/rc_decode_ext.cu with RGB = true, entry points rc_decode_rgb_launch
and rc_decode_ext_rgb_launch) compiled for the host under the warp
emulation of tools/warp_emu, against their plain PyTorch version
rc_decode_rgb_ref on the same inputs (the planar instances of the same
sources are in test_torch_warp_emu_dec.py, whose helpers this file
shares).  The inputs are chip_smoke.py's phase-4 random bytes (garbage
symbols whose exponents run past the width, clamped contexts, every
third lane's coder started 4 bytes before its buffer's end), in every
instance at every RGB width, and the design's edges: lines narrower
than a warp and not a multiple of 32, one pixel wide, 3 and 4 planes,
quant tables that put every pixel, or most pixels, on the row the
pixel before adapted, and pixels that read nearly every byte they can.
Exact: the codec is integer."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import pytest
import torch

from tpu_ffv1_torch.core import tables as T
from tpu_ffv1_torch.tpu import rc_decode as D

from .test_torch_warp_emu import L, build_libs, chip_smoke
from .test_torch_warp_emu_dec import (DECODE_IDS, DECODE_INSTANCES,
                                      _emulate_decode, few_rows_qt,
                                      long_pixel_args)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return build_libs(tmp_path_factory, ("rc_decode", "rc_decode_ext"))


def check_rgb(libs, args, w, h, P, cc, bits, five, gtab):
    """The emulated RGB launch on ``args`` (rgb_decode_random_inputs')
    equal to rc_decode_rgb_ref, every output; returns its outputs."""
    name = "rc_decode_ext" if bits > 10 else "rc_decode"
    got = _emulate_decode(libs[name], f"{name}_rgb_launch", args,
                          D.rgb_specs(w, h, P, cc), bits, five, gtab)
    want = D.rc_decode_rgb_ref(*[torch.from_numpy(a) for a in args], w, h,
                               P, cc, bits, five)
    assert torch.equal(torch.stack(got[0]), want[0])
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    return got


RGB_COMBOS = [(b, i) for b in (9, 10, 11, 13, 15) for i in range(4)]


@pytest.mark.parametrize("bits,inst", RGB_COMBOS,
                         ids=[f"{b}-{DECODE_IDS[i]}" for b, i in RGB_COMBOS])
def test_rc_decode_rgb_sources_match_plain(libs, bits, inst):
    """B1's four instances (csrc/rc_decode.cu, rc_decode_rgb_launch) at 9
    and 10 bits, B1-ext's (csrc/rc_decode_ext.cu) at 11, 13 and 15: the
    3- or 5-input context, the table in shared or global memory; each
    instance over the bits meets every (plane width, planes) of
    chip_smoke.RGB_RANDOM_SHAPES."""
    five, model = DECODE_INSTANCES[inst]
    cc = T.CONTEXT_COUNTS[model]
    k = (chip_smoke.rc_decode.RGB_BITS.index(bits) + inst) % 4
    w, P = chip_smoke.RGB_RANDOM_SHAPES[k]
    h = 3 if w > 2 else 48
    args = chip_smoke.rgb_decode_random_inputs(L, 512, bits, five, cc, P,
                                               130 + bits + 7 * inst)
    got = check_rgb(libs, args, w, h, P, cc, bits, five, model == 1)
    assert int(got[4][2]) >= 512, "lane 2 did not read past its buffer"


# (quant tables, bits, instance, plane width, planes, lines a plane)
EDGES = [("zero", 9, 0, 1, 4, 24), ("few", 9, 0, 31, 3, 3),
         ("few", 9, 0, 45, 4, 2), ("few", 10, 1, 45, 3, 2),
         ("zero", 13, 3, 31, 4, 2), ("few", 15, 0, 1, 3, 24),
         ("zero", 15, 0, 5, 4, 6), ("few", 15, 0, 45, 3, 2)]


@pytest.mark.parametrize("kind,bits,inst,w,P,h", EDGES, ids=[
    f"{k}-{b}-{DECODE_IDS[i]}-w{w}-p{P}" for k, b, i, w, P, _h in EDGES])
def test_rc_decode_rgb_sources_design_edges(libs, kind, bits, inst, w, P,
                                            h):
    """The design's edges, B1 at 9 and 10 bits, B1-ext at 13 and 15,
    mostly the rgb8 and rgb14_540p paths' instance (3-input context,
    table in shared memory): lines 1, 5, 31 and 45 wide (one pixel,
    narrower than a warp, not a multiple of 32), 3 and 4 planes (bgra:
    alpha on the third state plane), lane 2's coder started 4 bytes
    before its buffer's end, and quant tables that put every pixel
    (``zero``) or many (``few``) on the row the pixel before adapted, so
    a pixel's states must be read after that adaptation."""
    five, model = DECODE_INSTANCES[inst]
    cc = T.CONTEXT_COUNTS[model]
    args = chip_smoke.rgb_decode_random_inputs(L, 512, bits, five, cc, P,
                                               700 + bits + 3 * w + P)
    args[4] = few_rows_qt(kind, bits, five, w + P)
    got = check_rgb(libs, args, w, h, P, cc, bits, five, model == 1)
    assert int(got[4][2]) >= 512, "lane 2 did not read past its buffer"


@pytest.mark.parametrize("bits,P", [(9, 4), (15, 3)])
def test_rc_decode_rgb_sources_long_pixels_match_plain(libs, bits, P):
    """B1 at 9 bits (4 planes), B1-ext at 15 (3 planes) on pixels that
    read nearly the 2 * bits + 1 bytes they can, lines 16 wide: every
    renormalisation's byte from the refill window a warp holds, across
    the planes' lines."""
    cc = T.CONTEXT_COUNTS[0]
    w, h = 16, 2
    args = long_pixel_args(bits, cc, n=w * h * P, cap=4096)
    check_rgb(libs, args, w, h, P, cc, bits, False, False)
