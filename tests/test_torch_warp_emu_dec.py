"""The decoders' CUDA sources (csrc/rc_decode.cu: K2 and K2-five;
csrc/rc_decode_ext.cu: K2-ext and K2-ext-five; csrc/golomb_decode.cu:
G2) compiled for the host under the warp emulation of tools/warp_emu,
against their plain PyTorch versions on the same inputs, in every table
placement and both contexts (the encoders' sources are in
test_torch_warp_emu.py, whose helpers this file shares; B1's and
B1-ext's, the same sources' RGB instances, in test_torch_warp_emu_rgb.py).
The inputs are random bytes: garbage symbols whose exponents run past
the width (e = bits with no stop decision), clamped contexts, planes 40,
33, 2 and 1 wide (the row borders, the context a warp's 32 columns at a
time and its edge), and one lane started 8 bytes before its buffer's
end (reads at pos >= cap give 0); quant tables that put every pixel, or
most pixels, on the row the pixel before adapted; pixels that read
nearly every byte they can; G2 on chip_smoke.py's random bytes (long
runs, escapes, reads past cap).  Exact: the codec is integer."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import ctypes

import numpy as np
import pytest
import torch

from tpu_ffv1_torch.core import tables as T
from tpu_ffv1_torch.core.rac import custom_state_tables
from tpu_ffv1_torch.tpu import golomb_decode as GD
from tpu_ffv1_torch.tpu import rc_decode as D
from tpu_ffv1_torch.tpu import rc_encode as K

from tpu_ffv1_torch.tpu import golomb_encode as GE
from tpu_ffv1_torch.tpu.residual import residuals_and_contexts

from .test_torch_warp_emu import (L, build_libs, check_golomb_encode,
                                  chip_smoke)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return build_libs(tmp_path_factory, ("rc_decode", "rc_decode_ext",
                                         "golomb_decode", "golomb_encode"))


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


def few_rows_qt(kind, bits, five, seed):
    """Quant tables (int32 (5, 256)) that keep the context index small:
    ``zero``, every table 0 (every pixel of a plane on its first row,
    the row of the pixel before); ``few``, values in -1..1 (a few rows,
    each pixel often on the row before, the sign flipping)."""
    qt = np.zeros((5, 256), np.int32)
    if kind == "few":
        qt[:5 if five else 3] = np.random.RandomState(seed).randint(
            -1, 2, (5 if five else 3, 256))
    return qt


@pytest.mark.parametrize("kind,bits,inst", [("zero", 8, 0), ("few", 8, 1),
                                            ("few", 10, 0), ("zero", 16, 3),
                                            ("few", 16, 0), ("few", 17, 1)])
def test_rc_decode_sources_on_the_row_the_pixel_before_adapted(libs, kind,
                                                                bits, inst):
    """K2 and K2-ext where a pixel's row is the one the pixel before
    adapted (every pixel with ``zero`` quant tables, many with ``few``,
    the context's sign flipping): its states are read after that
    adaptation.  Planes 45, 5 and 1 wide."""
    five, model = DECODE_INSTANCES[inst]
    CC = T.CONTEXT_COUNTS[model]
    args = _decode_args(bits, five, CC, 300 + bits + 10 * inst)
    args[4] = few_rows_qt(kind, bits, five, bits + inst)
    specs = ((45, 2, 0), (5, 3, CC), (1, 4, CC))
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


def long_pixel_args(bits, CC, n=40, cap=2048):
    """A stream of ``n`` pixels where every pixel reads about one byte per
    decision, so that a pixel consumes nearly the 2 * bits + 1 bytes it
    can (more than 32 at 16 and 17 bits): the plain encoder codes the
    symbol -2^(bits-1) (e = bits - 1, mantissa zeros) in every pixel
    with each decision's improbable outcome (states 255 where the bit is
    0, 1 where it is 1: the zero flag and the mantissa rows 22..31 at
    255, the exponent and sign rows 1..21 at 1) and no adaptation
    (identity transition tables); every context row is the same, so the
    decoder's contexts pick the same states."""
    from tpu_ffv1_torch.tpu.finalize import finalize_packed_full
    row = np.array([255] + [1] * 21 + [255] * 10, np.uint8)
    states = np.ascontiguousarray(np.broadcast_to(row, (L, 2 * CC, 32)))
    ident = np.arange(256, dtype=np.uint8)
    encode = K.rc_encode_packed_ext_ref if bits > 10 else \
        K.rc_encode_packed_ref
    packed, low, rng, _st = encode(
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
    # more than 32 bytes a pixel at 16 and 17 bits, nearly every byte it
    # can below
    assert int(count.min()) > (32 if bits >= 16 else 2 * bits - 2) * n, \
        "a pixel reads fewer bytes than it should"
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
    args = long_pixel_args(bits, CC)
    specs = ((40, 1, 0),)
    got = _emulate_decode(libs["rc_decode_ext"], "rc_decode_ext_launch",
                          args, specs, bits, False, gtab)
    want = D.rc_decode_planes_ext_ref(*[torch.from_numpy(a) for a in args],
                                      specs, bits, False)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)


def emulate_golomb_decode(lib, bufs, vlc0, qt, pos0, specs, bits, five,
                          gtab):
    """G2's source under the emulation: (planes, vlc_out, bitpos)."""
    cap = bufs.shape[1]
    total = sum(w * h for (w, h, _b) in specs)
    out = np.full((L, total), 0x5A5A5A5A, np.int32)
    bitpos = np.zeros(L, np.int32)
    vlc = vlc0.copy() if gtab else np.zeros_like(vlc0)
    spec = (ctypes.c_int * (3 * len(specs)))(*[v for s in specs for v in s])
    fn = lib.golomb_decode_launch
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, p, p, i, p, i, p, p, i, i, i, i, i, p]
    err = fn(bufs.ctypes.data, cap, vlc0.ctypes.data, qt.ctypes.data,
             pos0.ctypes.data, ctypes.cast(spec, p), len(specs),
             out.ctypes.data, total, bitpos.ctypes.data, vlc.ctypes.data, L,
             vlc0.shape[1], bits, int(five), int(gtab), None)
    assert err == 0
    assert lib.emu_fault_count() == 0, "warp primitives under a divergent " \
        "branch"
    planes, off = [], 0
    for (w, h, _b) in specs:
        planes.append(out[:, off:off + w * h].reshape(L, h, w))
        off += w * h
    return planes, vlc, bitpos


def check_golomb_decode(lib, bufs, vlc0, qt, pos0, specs, bits, five, gtab):
    """G2's source against its plain twin; returns the plain outputs."""
    got = emulate_golomb_decode(lib, bufs, vlc0, qt, pos0, specs, bits,
                                five, gtab)
    want = GD.golomb_decode_planes_ref(
        *[torch.from_numpy(a) for a in (bufs, vlc0, qt, pos0)], specs, bits,
        five)
    for a, b in zip(got[0], want[0]):
        assert np.array_equal(a, b.numpy())
    assert np.array_equal(got[1], want[1].numpy())
    assert np.array_equal(got[2], want[2].numpy())
    return want


@pytest.mark.parametrize("five,model", DECODE_INSTANCES, ids=DECODE_IDS)
def test_golomb_decode_source_matches_plain(libs, five, model):
    """G2's four instances: the 3- or 5-input context, the VLC table in
    shared memory (2 x 666 rows) or in global memory (2 x 7,563)."""
    cc = T.CONTEXT_COUNTS[model]
    cap = 512
    bufs, vlc0, qt, pos0 = chip_smoke.golomb_decode_random_inputs(
        L, cap, cc, five, 95 + 2 * model + five)
    specs = ((40, 3, 0), (33, 2, cc), (2, 2, cc), (1, 2, 0))
    want = check_golomb_decode(libs["golomb_decode"], bufs, vlc0, qt, pos0,
                               specs, 8, five, model == 1)
    assert int(want[2][2]) >= 8 * cap, "lane 2 did not read past its buffer"


# planes 64, 33, 2 and 1 wide, as state planes 0, 1, 1, 0
CODED_DIMS = ((64, 12, 0), (33, 4, 1), (2, 5, 1), (1, 4, 0))


def coded_planes(dims, bits, seed):
    """Per lane and plane, samples that reach the Golomb-Rice scans' run
    and window edges: flat rows and blocks (runs across whole lines, long
    chunks, the line end), single spikes of either sign in the flat (runs
    broken by a positive or a negative residual), a ramp (zero residuals
    outside context 0), noise and jumps of 3/4 of the range (escapes: at
    16 bits codes of 28 bits, the samples int16-wrapped as the codec holds
    them); lane 0 noisier (about 6 bits a pixel, so its stream passes the
    ring's words)."""
    r = np.random.RandomState(seed)
    top = (1 << bits) - 1
    out = []
    for lane in range(L):
        planes = []
        for (w, h, _sp) in dims:
            c0 = r.randint(0, top + 1)
            p = np.full((h, w), c0, np.int64)
            yy, xx = np.mgrid[0:h, 0:w]
            noise = r.randint(-40, 41, (h, w)) if lane == 0 else \
                r.randint(-3, 4, (h, w))
            blk = (yy % 6 >= 3) & (xx % 40 < 20)
            p = np.where(blk, c0 + noise, p)
            p = np.where((yy % 6 == 5) & (xx >= w // 2), c0 + 2 * xx, p)
            spikes = (r.rand(h, w) < 0.05) & ~blk
            p = np.where(spikes, c0 + r.choice([-2, -1, 1, 2], (h, w)), p)
            jumps = r.rand(h, w) < 0.03
            p = np.where(jumps, c0 + r.choice([-1, 1], (h, w)) *
                         (top * 3 // 4), p)
            p = np.clip(p, 0, top)
            if bits == 16:                     # int16_t sample rows
                p = ((p + 0x8000) & 0xFFFF) - 0x8000
            planes.append(p)
        out.append(planes)
    return out


def coded_inputs(dims, bits, five, cc, seed):
    """(planes, G1's inputs) of coded_planes: each plane's contexts and
    residuals from the port's stencil (residuals_and_contexts) with the
    state plane's offset, every pixel active, fresh VLC states, prefixes
    of 0..PREFIX_CAP bytes."""
    planes = coded_planes(dims, bits, seed)
    qt = torch.from_numpy(T.default_quant_tables(bits)[int(five)]
                          .astype(np.int32))
    ctxs, diffs = [], []
    for lane in range(L):
        cs_, ds_ = [], []
        for (w, h, sp), p in zip(dims, planes[lane]):
            c, d = residuals_and_contexts(torch.from_numpy(p), qt, bits,
                                          five)
            cs_.append(c.reshape(-1).numpy() + sp * cc)
            ds_.append(d.reshape(-1).numpy())
        ctxs.append(np.concatenate(cs_))
        diffs.append(np.concatenate(ds_))
    rows = (max(sp for (_w, _h, sp) in dims) + 1) * cc
    r = np.random.RandomState(seed + 1)
    flags = GE.make_flags(dims)
    vlc0 = np.ascontiguousarray(np.broadcast_to(
        np.array(GE.VLC_FRESH, np.int32), (L, rows, 4)))
    args = [np.ascontiguousarray(a) for a in (
        np.stack(ctxs).astype(np.int32), np.stack(diffs).astype(np.int32),
        np.ones((L, flags.shape[0]), bool), flags, vlc0,
        r.randint(0, 256, (L, chip_smoke.PREFIX_CAP)).astype(np.int32),
        r.randint(0, chip_smoke.PREFIX_CAP + 1, L).astype(np.int32))]
    return planes, args, qt.numpy()


@pytest.mark.parametrize("five,model,bits", [(False, 0, 8), (True, 1, 8),
                                             (True, 0, 10), (False, 1, 16)],
                         ids=[f"{i}-{b}" for i, b in
                              zip(DECODE_IDS, (8, 8, 10, 16))])
def test_golomb_sources_round_trip_coded_planes(libs, five, model, bits):
    """Coded planes (coded_planes) through G1's source and then G2's, each
    held exact to its plain twin, in every G2 instance (and G1's two
    placements): the decode reads from after each lane's prefix, its
    window refills across words and around the ring, and it gives back
    the source samples."""
    cc = T.CONTEXT_COUNTS[model]
    planes, args, qt = coded_inputs(CODED_DIMS, bits, five, cc,
                                    500 + 10 * model + bits + five)
    enc = check_golomb_encode(libs["golomb_encode"], args, bits, cc,
                              model == 1)
    bufs = enc[0].numpy()
    specs = tuple((w, h, sp * cc) for (w, h, sp) in CODED_DIMS)
    got = check_golomb_decode(libs["golomb_decode"], bufs, args[4], qt,
                              args[6].copy(), specs, bits, five, model == 1)
    for k in range(len(CODED_DIMS)):
        assert np.array_equal(got[0][k].numpy(),
                              np.stack([pl[k] for pl in planes]))
    ring_bits = 32 * GD.ring_words(max(w for (w, _h, _s) in CODED_DIMS))
    read = got[2].numpy() - 8 * args[6]
    assert int(read.max()) > ring_bits, "no lane's stream went round the ring"
    assert np.array_equal(enc[1].numpy(), args[6] + (read + 7) // 8)


@pytest.mark.parametrize("bits", [8, 10, 11])
def test_rc_decode_source_long_pixels_at_fast_widths(libs, bits):
    """K2 at 8 and 10 bits, K2-ext at 11, on pixels that read nearly the
    2 * bits + 1 bytes they can: every renormalisation's byte from the
    refill window a warp holds."""
    CC = T.CONTEXT_COUNTS[0]
    args = long_pixel_args(bits, CC)
    specs = ((40, 1, 0),)
    name = "rc_decode_ext" if bits > 10 else "rc_decode"
    got = _emulate_decode(libs[name], f"{name}_launch", args, specs, bits,
                          False, False)
    ref = D.rc_decode_planes_ext_ref if bits > 10 else \
        D.rc_decode_planes_ref
    want = ref(*[torch.from_numpy(a) for a in args], specs, bits, False)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
