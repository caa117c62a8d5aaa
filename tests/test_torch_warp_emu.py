"""The encoders' CUDA sources (csrc/rc_encode.cu, K1 and K1-compact;
csrc/rc_encode_ext.cu, K1-ext; csrc/golomb_encode.cu, G1) and the
Golomb-Rice pixel-step probe (csrc/golomb_probe.cu), compiled for the
host under the warp emulation of tools/warp_emu (32 threads per block, a
barrier per warp primitive), against their plain PyTorch versions on the
same inputs, in every table placement (the decoders' sources are in
test_torch_warp_emu_dec.py).  Exact: the codec is integer.  The encode
inputs reach the designs' edges: runs of one context across the
32-pixel chunk boundary, inactive pixels, zero residuals, and above 10
bits exponents drawn uniformly, so the running rows 10 and 31 carry
from pixel to pixel.  G1 runs on chip_smoke.py's phase-4 edge inputs
(run chunks, breaks, the line-end flush, zero residuals, escapes,
inactive blocks, carried VLC states, and an output cap below the
counts); the pixel-step probe, both modes, against its plain loop."""
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
from tpu_ffv1_torch.tpu import golomb_encode as GE
from tpu_ffv1_torch.tpu import rc_encode as K

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the Golomb-Rice phase-4 inputs)
import warp_emu  # noqa: E402

CSRC = os.path.join(REPO, "tpu_ffv1_torch", "csrc")
# 4 chunks of 32 pixels per lane: the runs of one context at 20:80
# cross two chunk boundaries
L, N = 3, 128


def build_libs(tmp_path_factory, names):
    """The sources ``names`` of csrc compiled for the emulation, one g++
    per source, all at once; skips without a host C++ compiler."""
    if warp_emu.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) for the warp emulation")
    out = str(tmp_path_factory.mktemp("warp_emu"))
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(lambda name: warp_emu.build(
            os.path.join(CSRC, f"{name}.cu"), out), names))
    return {name: ctypes.CDLL(path) for name, path in zip(names, paths)}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return build_libs(tmp_path_factory, ("rc_encode", "rc_encode_ext",
                                         "golomb_encode", "golomb_probe"))


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
