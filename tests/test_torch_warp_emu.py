"""The encoders' CUDA sources (csrc/rc_encode.cu, K1, K1-compact and K1's
stats instance; csrc/rc_encode_ext.cu, K1-ext and its stats instance;
csrc/golomb_encode.cu, G1; csrc/find_best_state.cu, pass 2's table) and
the Golomb-Rice pixel-step probe (csrc/golomb_probe.cu), compiled for the
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
counts); the pixel-step probe, both modes, against its plain loop; the
stats instances' decision counts on the encode inputs; find_best_state
on the default and a sorted table against its plain version's rows at
the edges of the probabilities (its doubles: the host's own IEEE
operations, as the kernel's explicit __dmul_rn / __dadd_rn)."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import concurrent.futures
import ctypes
import os
import sys

import numpy as np
import pytest
import torch

from tpu_ffv1_torch.codec import twopass as TP
from tpu_ffv1_torch.core import tables as T
from tpu_ffv1_torch.core.rac import build_rac_states, custom_state_tables
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
                                         "golomb_encode", "golomb_probe",
                                         "find_best_state"))


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


def _emulate(lib, entry, args, bits, gtab, width, stats=False):
    ctx, diff, act, st0, one, zero, low0, rng0 = args
    L, N = ctx.shape
    CC = st0.shape[1]
    packed = np.full((L, N, width), 0x5A5A5A5A, np.int32)
    low, rng = np.zeros(L, np.int32), np.zeros(L, np.int32)
    states = st0.copy() if gtab else np.zeros_like(st0)
    # a stats instance writes stat whole; K1-ext's also adds to stat2
    counts = ()
    if stats:
        counts = (np.full((L, 256, 2), -7, np.int32),)
        if bits > 10:
            counts += (np.zeros((L, CC, 32, 2), np.int32),)
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p] * len(counts) + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p]
    err = fn(*[a.ctypes.data for a in (ctx, diff, act, st0, one, zero, low0,
                                       rng0, packed, low, rng, states)],
             L, N, CC, *[c.ctypes.data for c in counts], bits, int(gtab),
             None)
    assert err == 0
    assert lib.emu_fault_count() == 0, "warp primitives under a divergent " \
        "branch"
    return [torch.from_numpy(x) for x in (packed, low, rng, states, *counts)]


def _check(got, want):
    assert len(got) == len(want)
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


@pytest.mark.parametrize("gtab", [False, True], ids=["shared", "global"])
@pytest.mark.parametrize("bits", [8, 10, 11, 16, 17])
def test_rc_encode_stats_source_matches_plain(libs, bits, gtab):
    """The stats instances of K1 (8, 10 bits: the scan's outputs and its
    counts by state, ``rc_encode_stats_scan_ref``) and K1-ext (11, 16, 17:
    the running rows' decisions each with its own state; both count
    tables): every output of the scan and the decision counts, against
    their plain versions."""
    args = _args(bits, 2 * T.CONTEXT_COUNTS[0], 70 + bits + 100 * gtab)
    ext = bits > 10
    got = _emulate(libs["rc_encode_ext" if ext else "rc_encode"],
                   f"rc_encode{'_ext' if ext else ''}_stats_launch", args,
                   bits, gtab, 2 * bits + 1, stats=True)
    twin = K.rc_encode_ext_stats_ref if ext else K.rc_encode_stats_scan_ref
    want = twin(*[torch.from_numpy(a) for a in args], bits)
    assert int(want[4].sum()) > 0
    _check(got, want)


def _shared_state_args(bits, CC, seed, n):
    """Encode inputs where many threads hold one state: every position of
    every row starts at 128 and a lane of ``n`` pixels (several chunks)
    runs over 3 rows, so each pixel's positions meet on a few states."""
    args = _args(bits, CC, seed)
    r = np.random.RandomState(seed)
    half = 1 << (bits - 1)
    args[0] = np.ascontiguousarray(r.randint(0, 3, (L, n)).astype(np.int32))
    args[1] = np.ascontiguousarray(np.where(
        r.rand(L, n) < 0.2, r.randint(-half, half, (L, n)),
        r.randint(-2, 3, (L, n))).astype(np.int32))
    args[2] = np.ascontiguousarray(r.rand(L, n) < 0.9)
    args[3] = np.full((L, CC, 32), 128, np.uint8)
    return args


@pytest.mark.parametrize("gtab", [False, True], ids=["shared", "global"])
def test_rc_encode_stats_source_shared_states(libs, gtab):
    """K1's stats scan where several threads hold one state at once (all
    positions start at 128; three rows), over a lane of 200 pixels (7
    chunks, the last one short), in both table placements (the global
    form at context model 1's table size): the private columns summed
    give the plain version's counts, and the scan's other outputs too."""
    CC = 2 * T.CONTEXT_COUNTS[1 if gtab else 0]
    args = _shared_state_args(8, CC, 90 + gtab, 200)
    got = _emulate(libs["rc_encode"], "rc_encode_stats_launch", args, 8,
                   gtab, 17, stats=True)
    want = K.rc_encode_stats_scan_ref(*[torch.from_numpy(a) for a in args],
                                      8)
    # in each lane, decisions of one pixel counted by several threads
    # that hold state 128 (a fresh row's first nonzero pixel: 3 or more)
    assert bool((want[4][:, 128].sum(-1) >= 3).all())
    _check(got, want)


@pytest.mark.parametrize("bits", [8, 10])
def test_rc_stats_rows_source_matches_plain(libs, bits):
    """K1's row-count kernel against its plain version: contexts past
    both ends of the table (clamped), inactive pixels, zero residuals and
    residuals at +-2^(bits-1); 900 pixels in 3 lanes on the emulation's 2
    SMs (64 one-warp blocks), and 4,500 in 2 lanes, which the warps walk
    three times (grid stride)."""
    lib = libs["rc_encode"]
    fn = lib.rc_stats_rows_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    CC = 2 * T.CONTEXT_COUNTS[0]
    r = np.random.RandomState(bits)
    half = 1 << (bits - 1)
    for lanes, n in ((3, 300), (2, 2_250)):
        ctx = r.randint(-5, CC + 5, (lanes, n)).astype(np.int32)
        diff = np.where(r.rand(lanes, n) < 0.3,
                        r.randint(-half, half, (lanes, n)),
                        r.randint(-3, 4, (lanes, n)))
        diff[:, :4] = [-half, half - 1, 0, 1]
        diff = diff.astype(np.int32)
        act = r.rand(lanes, n) < 0.9
        stat2 = np.full((lanes, CC, 32, 2), -3, np.int32)   # zeroed first
        assert fn(ctx.ctypes.data, diff.ctypes.data, act.ctypes.data,
                  stat2.ctypes.data, lanes, n, CC, bits, None) == 0
        assert lib.emu_fault_count() == 0
        want = K.rc_stats_rows_ref(torch.from_numpy(ctx),
                                   torch.from_numpy(diff),
                                   torch.from_numpy(act), bits, CC)
        assert int(want.sum()) > 0
        assert np.array_equal(stat2, want.numpy())


@pytest.mark.parametrize("table", ["default", "ver2_sorted"])
def test_find_best_state_source_matches_plain(libs, table):
    """The fold and the pick kernels on the whole table; the plain
    version on the probabilities at the edges (i - 10 below 1, i + 10
    past 255) and in the middle, where candidates tie closest.  On the
    default table the fold's counting instance runs, and its count of
    the terms folded is the plain version's."""
    if table == "default":
        one = build_rac_states()[0].copy()
    else:
        one = T.VER2_STATE.copy()
        r = np.random.RandomState(5)
        TP.sort_stt(r.randint(0, 1 << 20, (256, 2)).astype(np.uint64), one)
    one = np.ascontiguousarray(one, np.uint8)
    one[0] = 0
    l2 = TP.l2tab()
    lens = np.zeros((256 * TP.SPAN, 256))
    best = np.zeros((256, 256), np.uint8)
    fn = libs["find_best_state"].find_best_state_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6
    terms = np.zeros(1, np.uint64)
    count = table == "default"
    assert fn(one.ctypes.data, l2.ctypes.data, lens.ctypes.data,
              best.ctypes.data, terms.ctypes.data if count else None,
              None) == 0
    assert libs["find_best_state"].emu_fault_count() == 0
    rows = [0, 1, 5, 10, 11, 64, 127, 128, 129, 200, 245, 246, 254, 255]
    assert np.array_equal(best[rows], TP.find_best_state_ref(one, rows))
    if count:
        assert int(terms[0]) == TP.find_best_state_ref(one, count=True)[1]


def emulate_golomb_encode(lib, args, bits, cc, gtab, cap=None):
    """G1's source under the emulation on numpy inputs (ctx, diff, active,
    flags, vlc0, prefixes, plens): (bytes, counts, vlc_out, run_index)."""
    ctx, diff, act, flags, vlc0, pre, plens = args
    L_, N_ = ctx.shape
    CC, pcap = vlc0.shape[1], pre.shape[1]
    Tc = GE.default_out_cap(N_, pcap) if cap is None else cap
    out = np.zeros((L_, Tc), np.uint8)
    counts, run_index = np.zeros(L_, np.int32), np.zeros(L_, np.int32)
    vlc = vlc0.copy() if gtab else np.zeros_like(vlc0)
    fn = lib.golomb_encode_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    act8 = act.astype(np.uint8)
    err = fn(*[a.ctypes.data for a in (ctx, diff, act8, flags, vlc0, pre,
                                       plens, out, counts, vlc,
                                       run_index)],
             L_, N_, CC, pcap, Tc, bits, cc, int(gtab), None)
    assert err == 0
    assert lib.emu_fault_count() == 0, "warp primitives under a divergent " \
        "branch"
    return out, counts, vlc, run_index


def check_golomb_encode(lib, args, bits, cc, gtab, cap=None):
    """G1's source against its plain twin on ``args``; returns the plain
    version's outputs."""
    got = emulate_golomb_encode(lib, args, bits, cc, gtab, cap)
    want = GE.golomb_encode_lanes_ref(*[torch.from_numpy(a) for a in args],
                                      bits, cc, cap)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    return want


@pytest.mark.parametrize("cap", [None, 120], ids=["full", "capped"])
@pytest.mark.parametrize("model", [0, 1], ids=["shared", "global"])
def test_golomb_encode_source_matches_plain(libs, model, cap):
    """G1 with the VLC table in shared memory (2 x 666 rows) or in global
    memory (2 x 7,563), on the edge inputs, with all bytes kept or an
    output cap below the lanes' counts."""
    cc = T.CONTEXT_COUNTS[model]
    dims = ((40, 6, 0), (20, 3, 1), (20, 3, 1))
    args = chip_smoke.golomb_encode_edge_inputs(L, dims, cc, 90 + model)
    want = check_golomb_encode(libs["golomb_encode"], args, 8, cc,
                               model == 1, cap)
    assert cap is None or int(want[1].max()) > cap


# planes 64, 33, 2 and 1 wide: runs across the 32-pixel chunks and whole
# chunks, lines of one and two pixels (each pixel a line start and end)
EDGE_DIMS = ((64, 6, 0), (33, 3, 1), (2, 4, 1), (1, 5, 0))


def golomb_design_edge_inputs(dims, cc, bits, seed):
    """G1 inputs (numpy, as golomb_encode_lanes takes them) for L lanes
    that reach the edges of its chunked design, segment by segment: runs
    of the plane's context 0 with zero residuals of 20-100 pixels
    (across chunks, whole chunks, to a line end or a plane start), such
    runs ended by a break of a positive or a negative residual, one
    context over consecutive VLC-coded pixels (the forwarded row) and two
    contexts alternating (the same row two pixels apart), large residuals
    (escapes under a small k), blocks of inactive pixels, and zero
    residuals outside context 0; carried VLC states and prefixes of
    0..PREFIX_CAP bytes."""
    r = np.random.RandomState(seed)
    flags = GE.make_flags(dims)
    N_ = flags.shape[0]
    rows = (max(sp for (_w, _h, sp) in dims) + 1) * cc
    pbase = (flags >> GE.FLAG_SPLANE_SHIFT) * cc
    half = 1 << (bits - 1)
    ctx = pbase + r.randint(1, cc, (L, N_))
    diff = r.randint(-5, 6, (L, N_))
    act = np.ones((L, N_), bool)
    for lane in range(L):
        p = 0
        while p < N_:
            kind = r.randint(7)
            q = min(N_, p + (r.randint(20, 101) if kind < 2 else
                             r.randint(2, 24)))
            seg = slice(p, q)
            if kind in (0, 1):                 # a run, maybe broken
                ctx[lane, seg] = pbase[seg]
                diff[lane, seg] = 0
                if kind == 1:
                    diff[lane, q - 1] = r.choice([-1, 1]) * r.randint(1, 4)
            elif kind == 2:                    # one context
                ctx[lane, seg] = pbase[seg] + r.randint(1, cc)
            elif kind == 3:                    # two contexts alternating
                a, b = r.randint(1, cc, 2)
                ctx[lane, seg] = pbase[seg] + np.where(
                    np.arange(q - p) % 2 == 0, a, b)
            elif kind == 4:                    # escapes
                diff[lane, seg] = r.choice([-1, 1], q - p) * r.randint(
                    half * 3 // 4, half, q - p)
            elif kind == 5:
                act[lane, seg] = False
            else:
                diff[lane, seg] = 0
            p = q
    return [np.ascontiguousarray(a) for a in (
        ctx.astype(np.int32), diff.astype(np.int32), act, flags,
        chip_smoke.random_vlc_states(r, L, rows),
        r.randint(0, 256, (L, chip_smoke.PREFIX_CAP)).astype(np.int32),
        r.randint(0, chip_smoke.PREFIX_CAP + 1, L).astype(np.int32))]


@pytest.mark.parametrize("model,cap,bits", [(0, None, 8), (1, 150, 8),
                                            (0, 150, 16), (1, None, 16)],
                         ids=["shared-8", "global-capped-8",
                              "shared-capped-16", "global-16"])
def test_golomb_encode_source_design_edges(libs, model, cap, bits):
    """G1 on golomb_design_edge_inputs, each lane's runs, breaks, forwarded
    rows and escapes held exact to the plain twin, in both table
    placements, at 8 and 16 bits, with all bytes or a cap below the
    counts."""
    cc = T.CONTEXT_COUNTS[model]
    args = golomb_design_edge_inputs(EDGE_DIMS, cc, bits,
                                     300 + 10 * model + bits)
    want = check_golomb_encode(libs["golomb_encode"], args, bits, cc,
                               model == 1, cap)
    assert cap is None or int(want[1].max()) > cap
    ctx, diff, act, flags = args[:4]
    zero = (ctx == (flags >> GE.FLAG_SPLANE_SHIFT) * cc) & (diff == 0) & act
    longest = max(max(map(len, "".join("1" if z else "0" for z in row)
                          .split("0"))) for row in zero)
    assert longest > 64, "no run spans two whole chunks"


# each intrinsic the warp emulation adds for the Golomb-Rice scans, on the
# emulation against its CUDA definition
INTRINSICS_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int U>
__global__ void __launch_bounds__(32) intrinsics_kernel(
    const int32_t* in, int32_t* out, int d) {
  extern __shared__ __align__(16) uint8_t smem[];
  unsigned* words = reinterpret_cast<unsigned*>(smem);
  const int t = threadIdx.x;
  if (t < 4) words[t] = 0;
  __syncwarp();
  const int v = in[t];
  out[t] = __shfl_up_sync(0xffffffffu, v, d);
  out[32 + t] = __shfl_xor_sync(0xffffffffu, v, d);
  const unsigned long long w =
      (unsigned long long)(unsigned)v << 32 | (unsigned)t;
  const unsigned long long x = __shfl_xor_sync(0xffffffffu, w, d);
  out[64 + t] = (int)(x >> 32);
  out[96 + t] = (int)(unsigned)x;
  atomicOr(&words[t & 3], 1u << t);
  __syncwarp();
  if (t < 4) out[128 + t] = (int)words[t];
  out[132 + t] = (int)__funnelshift_l((unsigned)v, (unsigned)in[t ^ 1],
                                      (unsigned)(t * 7 + d));
}

extern "C" int intrinsics_launch(const void* in, void* out, int d) {
  intrinsics_kernel<0><<<1, 32, 16, nullptr>>>((const int32_t*)in,
                                               (int32_t*)out, d);
  return (int)cudaGetLastError();
}
"""


@pytest.mark.parametrize("d", [1, 3, 16])
def test_warp_emu_intrinsics_match_cuda(tmp_path, d):
    """__shfl_up_sync (a thread below d keeps its own value), the int and
    64-bit __shfl_xor_sync (thread t takes t ^ d's), atomicOr on shared
    memory (every thread's bit lands) and __funnelshift_l (the upper word
    of hi:lo shifted left by s & 31) under the emulation, as CUDA defines
    them."""
    if warp_emu.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) for the warp emulation")
    src = tmp_path / "intrinsics.cu"
    src.write_text(INTRINSICS_SRC)
    lib = ctypes.CDLL(warp_emu.build(str(src), str(tmp_path)))
    vals = np.random.RandomState(d).randint(-1 << 31, 1 << 31, 32) \
        .astype(np.int32)
    out = np.zeros(164, np.int32)
    fn = lib.intrinsics_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    assert fn(vals.ctypes.data, out.ctypes.data, d) == 0
    assert lib.emu_fault_count() == 0
    t = np.arange(32)
    assert np.array_equal(out[:32], np.where(t >= d, vals[t - d], vals))
    assert np.array_equal(out[32:64], vals[t ^ d])
    assert np.array_equal(out[64:96], vals[t ^ d])
    assert np.array_equal(out[96:128], (t ^ d).astype(np.int32))
    want = [sum(1 << int(i) for i in t if i % 4 == k) for k in range(4)]
    assert np.array_equal(out[128:132].view(np.uint32),
                          np.array(want, np.uint32))
    lo, hi = vals.view(np.uint32).astype(np.uint64), \
        vals[t ^ 1].view(np.uint32).astype(np.uint64)
    s = ((t * 7 + d) & 31).astype(np.uint64)
    shifted = (((hi << np.uint64(32)) | lo) << s) >> np.uint64(32)
    assert np.array_equal(out[132:].view(np.uint32),
                          (shifted & np.uint64(0xFFFFFFFF)).astype(np.uint32))


@pytest.mark.parametrize("mode", list(probes.GOLOMB_MODES))
def test_golomb_step_probe_source_matches_plain(libs, mode):
    """The Golomb-Rice step probe on context model 0's table (1,332 rows),
    each mode (a VLC-coded pixel of G1 and of G2, G1's run chunk, G2's
    run pixel): the chain's final state, the adapted table and the
    ring."""
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
