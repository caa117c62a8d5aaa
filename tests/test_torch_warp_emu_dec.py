"""The decoders' CUDA sources (csrc/rc_decode.cu: K2, K2-five and B1;
csrc/rc_decode_ext.cu: K2-ext, K2-ext-five and B1-ext;
csrc/golomb_decode.cu: G2) compiled for the host under the warp
emulation of tools/warp_emu, against their plain PyTorch versions on
the same inputs, in every table placement and both contexts (the
encoders' sources are in test_torch_warp_emu.py, whose helpers this file
shares).  The inputs are random bytes: garbage symbols whose exponents
run past the width (e = bits with no stop decision), clamped contexts,
planes 40, 33, 2 and 1 wide (the row borders, the context a warp's 32
columns at a time and its edge), and one lane started 8 bytes before
its buffer's end (reads at pos >= cap give 0); B1's and B1-ext's on
chip_smoke.py's phase-4 inputs, 3 and 4 planes 40, 33, 2 and 1 wide; G2
on chip_smoke.py's random bytes (long runs, escapes, reads past cap).
Exact: the codec is integer."""
import ctypes

import numpy as np
import pytest
import torch

from tpu_ffv1_torch.core import tables as T
from tpu_ffv1_torch.core.rac import custom_state_tables
from tpu_ffv1_torch.tpu import golomb_decode as GD
from tpu_ffv1_torch.tpu import rc_decode as D
from tpu_ffv1_torch.tpu import rc_encode as K

from .test_torch_warp_emu import L, build_libs, chip_smoke


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return build_libs(tmp_path_factory, ("rc_decode", "rc_decode_ext",
                                         "golomb_decode"))


def _decode_args(bits, five, CC, seed, cap=512):
    """Random slice bytes for L lanes, states from 16..240, the quant
    tables of the context (context model 1's with ``five``), and lane
    L - 1's coder started 8 bytes before cap."""
    r = np.random.RandomState(seed)
    one, zero = custom_state_tables(T.VER2_STATE)
    bufs = r.randint(0, 256, (L, cap)).astype(np.uint8)
    pos0 = np.full(L, 2, np.int32)
    pos0[-1] = cap - 8
    low0 = np.minimum(bufs[np.arange(L), pos0 - 2].astype(np.int32) << 8 |
                      bufs[np.arange(L), pos0 - 1], 0xFEFF)
    return [np.ascontiguousarray(a) for a in (
        bufs, r.randint(16, 241, (L, 2 * CC, 32)).astype(np.uint8), one,
        zero, T.default_quant_tables(bits)[int(five)].astype(np.int32),
        low0.astype(np.int32), np.full(L, 0xFF00, np.int32), pos0)]


def _emulate_decode(lib, entry, args, specs, bits, five, gtab):
    bufs, st0 = args[0], args[1]
    cap, CC = bufs.shape[1], st0.shape[1]
    total = sum(w * h for (w, h, _b) in specs)
    out = np.full((L, total), 0x5A5A5A5A, np.int32)
    low, rng, pos = (np.zeros(L, np.int32) for _ in range(3))
    states = st0.copy() if gtab else np.zeros_like(st0)
    spec = (ctypes.c_int * (3 * len(specs)))(*[v for s in specs for v in s])
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, p, p, p, p, p, p, i, p, i, p, p, p, p,
                   i, i, i, i, i, p]
    err = fn(bufs.ctypes.data, cap, *[a.ctypes.data for a in args[1:]],
             ctypes.cast(spec, p), len(specs), out.ctypes.data, total,
             low.ctypes.data, rng.ctypes.data, pos.ctypes.data,
             states.ctypes.data, L, CC, bits, int(five), int(gtab), None)
    assert err == 0
    assert lib.emu_fault_count() == 0, "warp primitives under a divergent " \
        "branch"
    planes, off = [], 0
    for (w, h, _b) in specs:
        planes.append(torch.from_numpy(out[:, off:off + w * h]
                                       .reshape(L, h, w)))
        off += w * h
    return planes, *[torch.from_numpy(x) for x in (states, low, rng, pos)]


DECODE_INSTANCES = [(False, 0), (True, 1), (True, 0), (False, 1)]
DECODE_IDS = ["three_shared", "five_global", "five_shared", "three_global"]


@pytest.mark.parametrize("five,model", DECODE_INSTANCES, ids=DECODE_IDS)
@pytest.mark.parametrize("bits", [8, 10, 11, 16, 17])
def test_rc_decode_sources_match_plain(libs, bits, five, model):
    """K2's four instances (csrc/rc_decode.cu) at 8 and 10 bits, K2-ext's
    (csrc/rc_decode_ext.cu) at 11, 16 and 17: the 3- or 5-input context,
    the table in shared memory (2 x 666 rows) or in global memory (2 x
    7,563)."""
    CC = T.CONTEXT_COUNTS[model]
    args = _decode_args(bits, five, CC, 60 + bits + 10 * model + 5 * five)
    specs = ((40, 3, 0), (33, 2, CC), (2, 2, CC), (1, 2, 0))
    name = "rc_decode_ext" if bits > 10 else "rc_decode"
    got = _emulate_decode(libs[name], f"{name}_launch", args, specs, bits,
                          five, model == 1)
    ref = D.rc_decode_planes_ext_ref if bits > 10 else \
        D.rc_decode_planes_ref
    want = ref(*[torch.from_numpy(a) for a in args], specs, bits, five)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    assert int(got[4][-1]) >= args[0].shape[1], "lane L - 1 did not read " \
        "past its buffer"


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
    name = "rc_decode_ext" if bits > 10 else "rc_decode"
    got = _emulate_decode(libs[name], f"{name}_rgb_launch", args,
                          D.rgb_specs(w, h, P, cc), bits, five, model == 1)
    want = D.rc_decode_rgb_ref(*[torch.from_numpy(a) for a in args], w, h,
                               P, cc, bits, five)
    assert torch.equal(torch.stack(got[0]), want[0])
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    assert int(got[4][2]) >= 512, "lane 2 did not read past its buffer"


def _long_pixel_args(bits, CC):
    """A stream where every pixel reads about one byte per decision, so
    that a pixel consumes more than 32 bytes (at 17 bits 34): the plain
    encoder codes the symbol -2^(bits-1) (e = bits - 1, mantissa zeros)
    in every pixel with each decision's improbable outcome (states 255
    where the bit is 0, 1 where it is 1: the zero flag and the mantissa
    rows 22..31 at 255, the exponent and sign rows 1..21 at 1) and no
    adaptation (identity transition tables); every context row is the
    same, so the decoder's contexts pick the same states."""
    from tpu_ffv1_torch.tpu.finalize import finalize_packed_full
    n, cap = 40, 2048
    row = np.array([255] + [1] * 21 + [255] * 10, np.uint8)
    states = np.ascontiguousarray(np.broadcast_to(row, (L, 2 * CC, 32)))
    ident = np.arange(256, dtype=np.uint8)
    packed, low, rng, _st = K.rc_encode_packed_ext_ref(
        torch.zeros((L, n), dtype=torch.int32),
        torch.full((L, n), -(1 << (bits - 1)), dtype=torch.int32),
        torch.ones((L, n), dtype=torch.bool), torch.from_numpy(states),
        torch.from_numpy(ident), torch.from_numpy(ident),
        torch.zeros(L, dtype=torch.int32),
        torch.full((L,), 0xFF00, dtype=torch.int32), bits)
    out, count = finalize_packed_full(packed, low, rng,
                                      torch.zeros((L, 1), dtype=torch.int32),
                                      torch.zeros(L, dtype=torch.int32))
    bufs = np.zeros((L, cap), np.uint8)
    for lane in range(L):
        bufs[lane, :int(count[lane])] = out[lane, :int(count[lane])].numpy()
    assert int(count.min()) > 32 * n, "a pixel reads fewer than 32 bytes"
    low0 = bufs[:, 0].astype(np.int32) << 8 | bufs[:, 1]
    qt = T.default_quant_tables(bits)[0].astype(np.int32)
    return [np.ascontiguousarray(a) for a in (
        bufs, states, ident, ident, qt, low0, np.full(L, 0xFF00, np.int32),
        np.full(L, 2, np.int32))]


@pytest.mark.parametrize("gtab", [False, True], ids=["shared", "global"])
@pytest.mark.parametrize("bits", [16, 17])
def test_rc_decode_ext_source_long_pixels_match_plain(libs, bits, gtab):
    """K2-ext on pixels that read more than 32 bytes each (a renormalising
    decision's byte then comes from the second 32 bytes a pixel holds),
    in both table placements; every lane decodes the coded symbols."""
    CC = T.CONTEXT_COUNTS[int(gtab)]
    args = _long_pixel_args(bits, CC)
    specs = ((40, 1, 0),)
    got = _emulate_decode(libs["rc_decode_ext"], "rc_decode_ext_launch",
                          args, specs, bits, False, gtab)
    want = D.rc_decode_planes_ext_ref(*[torch.from_numpy(a) for a in args],
                                      specs, bits, False)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("five,model", DECODE_INSTANCES, ids=DECODE_IDS)
def test_golomb_decode_source_matches_plain(libs, five, model):
    """G2's four instances: the 3- or 5-input context, the VLC table in
    shared memory (2 x 666 rows) or in global memory (2 x 7,563)."""
    cc = T.CONTEXT_COUNTS[model]
    cap = 512
    bufs, vlc0, qt, pos0 = chip_smoke.golomb_decode_random_inputs(
        L, cap, cc, five, 95 + 2 * model + five)
    specs = ((40, 3, 0), (33, 2, cc), (2, 2, cc), (1, 2, 0))
    total = sum(w * h for (w, h, _b) in specs)
    out = np.full((L, total), 0x5A5A5A5A, np.int32)
    bitpos = np.zeros(L, np.int32)
    vlc = vlc0.copy() if model == 1 else np.zeros_like(vlc0)
    spec = (ctypes.c_int * (3 * len(specs)))(*[v for s in specs for v in s])
    lib = libs["golomb_decode"]
    fn = lib.golomb_decode_launch
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, p, p, i, p, i, p, p, i, i, i, i, i, p]
    err = fn(bufs.ctypes.data, cap, vlc0.ctypes.data, qt.ctypes.data,
             pos0.ctypes.data, ctypes.cast(spec, p), len(specs),
             out.ctypes.data, total, bitpos.ctypes.data, vlc.ctypes.data, L,
             vlc0.shape[1], 8, int(five), model, None)
    assert err == 0
    assert lib.emu_fault_count() == 0, "warp primitives under a divergent " \
        "branch"
    want = GD.golomb_decode_planes_ref(
        *[torch.from_numpy(a) for a in (bufs, vlc0, qt, pos0)], specs, 8,
        five)
    off = 0
    for (w, h, _b), plane in zip(specs, want[0]):
        assert np.array_equal(out[:, off:off + w * h].reshape(L, h, w),
                              plane.numpy())
        off += w * h
    assert np.array_equal(vlc, want[1].numpy())
    assert np.array_equal(bitpos, want[2].numpy())
    assert int(bitpos[2]) >= 8 * cap, "lane 2 did not read past its buffer"
