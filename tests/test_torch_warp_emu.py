"""The CUDA sources of the lane scans (csrc/rc_encode.cu, K1 and
K1-compact; csrc/rc_encode_ext.cu, K1-ext; csrc/rc_decode.cu, K2,
K2-five and B1, the line-interleaved RGB decode; csrc/rc_decode_ext.cu,
K2-ext, K2-ext-five and B1-ext;
csrc/golomb_encode.cu, G1; csrc/golomb_decode.cu, G2), compiled for
the host under the warp emulation of tools/warp_emu (32 threads per
block, a barrier per warp primitive), against their plain PyTorch
versions on the same inputs, in every table placement (and for the
decoders both contexts).  Exact: the codec is integer.  The encode
inputs reach the designs' edges: runs of one context across the
32-pixel chunk boundary, inactive pixels, zero residuals, and above 10
bits exponents drawn uniformly, so the running rows 10 and 31 carry
from pixel to pixel.  The decode inputs are random bytes: garbage
symbols whose exponents run past the width (e = bits with no stop
decision), clamped contexts, planes 40, 33, 2 and 1 wide (the row
borders, the context a warp's 32 columns at a time and its edge), and
one lane started 8 bytes before its buffer's end (reads at pos >= cap
give 0); B1's and B1-ext's on chip_smoke.py's phase-4 inputs, 3 and 4
planes 40, 33, 2 and 1 wide.  The Golomb-Rice scans run on chip_smoke.py's phase-4 inputs:
G1 on its edge inputs (run chunks, breaks, the line-end flush, zero
residuals, escapes, inactive blocks, carried VLC states, and an output
cap below the counts), G2 on random bytes (long runs, escapes, reads
past cap) in all four instances.  Their pixel-step probe
(csrc/golomb_probe.cu, both modes) runs against its plain loop."""
import concurrent.futures
import ctypes
import os
import sys

import numpy as np
import pytest
import torch

from tpu_ffv1_torch.core import tables as T
from tpu_ffv1_torch.core.rac import custom_state_tables
from tpu_ffv1_torch.kernels import probes
from tpu_ffv1_torch.tpu import golomb_decode as GD
from tpu_ffv1_torch.tpu import golomb_encode as GE
from tpu_ffv1_torch.tpu import rc_decode as D
from tpu_ffv1_torch.tpu import rc_encode as K

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the Golomb-Rice phase-4 inputs)
import warp_emu  # noqa: E402

CSRC = os.path.join(REPO, "tpu_ffv1_torch", "csrc")
L, N = 3, 300


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if warp_emu.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) for the warp emulation")
    out = str(tmp_path_factory.mktemp("warp_emu"))
    names = ("rc_encode", "rc_encode_ext", "rc_decode", "rc_decode_ext",
             "golomb_encode", "golomb_decode", "golomb_probe")
    # one g++ per source, all at once
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(lambda name: warp_emu.build(
            os.path.join(CSRC, f"{name}.cu"), out), names))
    return {name: ctypes.CDLL(path) for name, path in zip(names, paths)}


def _args(bits, CC, seed):
    r = np.random.RandomState(seed)
    one, zero = custom_state_tables(T.VER2_STATE)
    if bits > 10:
        e = r.randint(0, bits, (L, N))
        a = (1 << e) | (r.randint(0, 1 << 30, (L, N)) & ((1 << e) - 1))
        diff = np.where(r.rand(L, N) < 0.5, -a, a)
    else:
        half = 1 << (bits - 1)
        diff = np.where(r.rand(L, N) < 0.3, r.randint(-half, half, (L, N)),
                        r.randint(-3, 4, (L, N)))
    diff = np.where(r.rand(L, N) < 0.1, 0, diff)
    pool = r.randint(0, CC, (L, 4))
    ctx = pool[np.arange(L)[:, None], r.randint(0, 4, (L, N))]
    for lane in range(L):
        p = 0
        while p < N:
            q = min(N, p + r.randint(2, 40))
            if r.randint(3) == 0:
                ctx[lane, p:q] = ctx[lane, p]
            p = q
    ctx[:, 20:80] = ctx[:, 20:21]
    return [np.ascontiguousarray(x.astype(t)) for x, t in (
        (ctx, np.int32), (diff, np.int32), (r.rand(L, N) < 0.95, np.bool_),
        (r.randint(1, 256, (L, CC, 32)), np.uint8), (one, np.uint8),
        (zero, np.uint8), (r.randint(0, 1 << 16, L), np.int32),
        (r.randint(0x100, 0x10000, L), np.int32))]


def _emulate(lib, entry, args, bits, gtab, width):
    ctx, diff, act, st0, one, zero, low0, rng0 = args
    CC = st0.shape[1]
    packed = np.full((L, N, width), 0x5A5A5A5A, np.int32)
    low, rng = np.zeros(L, np.int32), np.zeros(L, np.int32)
    states = st0.copy() if gtab else np.zeros_like(st0)
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    err = fn(*[a.ctypes.data for a in (ctx, diff, act, st0, one, zero, low0,
                                       rng0, packed, low, rng, states)],
             L, N, CC, bits, int(gtab), None)
    assert err == 0
    assert lib.emu_fault_count() == 0, "warp primitives under a divergent " \
        "branch"
    return [torch.from_numpy(x) for x in (packed, low, rng, states)]


def _check(got, want):
    assert torch.equal(got[0].permute(1, 2, 0), want[0])
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("gtab", [False, True], ids=["shared", "global"])
@pytest.mark.parametrize("bits", [11, 16, 17])
def test_rc_encode_ext_source_matches_plain(libs, bits, gtab):
    args = _args(bits, 2 * T.CONTEXT_COUNTS[0], 40 + bits + 100 * gtab)
    got = _emulate(libs["rc_encode_ext"], "rc_encode_ext_launch", args,
                   bits, gtab, 2 * bits + 1)
    assert int(((got[0] >> 20) & 1).sum()) > 0
    _check(got, K.rc_encode_packed_ext_ref(
        *[torch.from_numpy(a) for a in args], bits))


@pytest.mark.parametrize("gtab", [False, True], ids=["shared", "global"])
@pytest.mark.parametrize("compact", [False, True], ids=["raw", "compact"])
@pytest.mark.parametrize("bits", [8, 10])
def test_rc_encode_source_matches_plain(libs, bits, compact, gtab):
    args = _args(bits, 2 * T.CONTEXT_COUNTS[0], 10 + bits + 100 * gtab)
    if compact:
        # states at the extremes, so that some pixels emit more than the
        # compact form's 4 slots
        r = np.random.RandomState(bits)
        args[3] = np.where(r.rand(*args[3].shape) < 0.5,
                           r.randint(1, 9, args[3].shape),
                           r.randint(248, 256, args[3].shape)) \
            .astype(np.uint8)
    targs = [torch.from_numpy(a) for a in args]
    if compact:
        got = _emulate(libs["rc_encode"], "rc_encode_compact_launch", args,
                       bits, gtab, 8)
        want = K.rc_encode_compact_ref(*targs, bits)
        assert int(want[0][:, 5].sum()) > 0, "no pixel overflowed"
    else:
        got = _emulate(libs["rc_encode"], "rc_encode_launch", args, bits,
                       gtab, 2 * bits + 1)
        want = K.rc_encode_packed_ref(*targs, bits)
    _check(got, want)


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


@pytest.mark.parametrize("cap", [None, 120], ids=["full", "capped"])
@pytest.mark.parametrize("model", [0, 1], ids=["shared", "global"])
def test_golomb_encode_source_matches_plain(libs, model, cap):
    """G1 with the VLC table in shared memory (2 x 666 rows) or in global
    memory (2 x 7,563), on the edge inputs, with all bytes kept or an
    output cap below the lanes' counts."""
    cc = T.CONTEXT_COUNTS[model]
    dims = ((40, 6, 0), (20, 3, 1), (20, 3, 1))
    args = chip_smoke.golomb_encode_edge_inputs(L, dims, cc, 90 + model)
    ctx, diff, act, flags, vlc0, pre, plens = args
    N, CC, pcap = ctx.shape[1], vlc0.shape[1], pre.shape[1]
    Tc = GE.default_out_cap(N, pcap) if cap is None else cap
    out = np.zeros((L, Tc), np.uint8)
    counts, run_index = np.zeros(L, np.int32), np.zeros(L, np.int32)
    vlc = vlc0.copy() if model == 1 else np.zeros_like(vlc0)
    lib = libs["golomb_encode"]
    fn = lib.golomb_encode_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    act8 = act.astype(np.uint8)
    err = fn(*[a.ctypes.data for a in (ctx, diff, act8, flags, vlc0, pre,
                                       plens, out, counts, vlc,
                                       run_index)],
             L, N, CC, pcap, Tc, 8, cc, model, None)
    assert err == 0
    assert lib.emu_fault_count() == 0, "warp primitives under a divergent " \
        "branch"
    want = GE.golomb_encode_lanes_ref(*[torch.from_numpy(a) for a in args],
                                      8, cc, cap)
    assert cap is None or int(want[1].max()) > cap
    for got, w in zip((out, counts, vlc, run_index), want):
        assert np.array_equal(got, w.numpy())


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


@pytest.mark.parametrize("mode", ["encode", "decode"])
def test_golomb_step_probe_source_matches_plain(libs, mode):
    """The Golomb-Rice pixel-step probe on context model 0's table (1,332
    rows): the chain's final state, the adapted table and the ring."""
    rows, n = 2 * T.CONTEXT_COUNTS[0], 3000
    vlc0, pix, data, qt = probes.golomb_step_inputs(rows, mode, 11)
    out = np.zeros(4 + 4 * rows + probes.GOLOMB_RING, np.int32)
    lib = libs["golomb_probe"]
    fn = lib.golomb_step_launch
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, p, i, i, p, p]
    err = fn(vlc0.ctypes.data, rows, pix.ctypes.data, data.ctypes.data,
             qt.ctypes.data, n, probes.GOLOMB_MODES[mode], out.ctypes.data,
             None)
    assert err == 0
    assert lib.emu_fault_count() == 0, "warp primitives under a divergent " \
        "branch"
    want = probes.golomb_step_ref(vlc0, pix, data, qt, n, mode)
    assert int(want[0]) > 0
    assert np.array_equal(out, want.numpy())
