"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same CUDA tensors (exact: integer codec), and the slice
end to end against the host encoder, at context models 0 and 1 (whose
state table the kernels keep in global memory), in the raw and the
compact encode form, with the range coder and with Golomb-Rice (G1, G2
in every instance), and RGB (bgr0 and gbrp14le through B1 and B1-ext,
every instance of both on random bytes), version 4 (the RCT search,
the per-lane RCT, the row bytes, the PCM retry); K1's, K1-ext's, K2's and
K2-ext's stage probes, the lookup probes and the Golomb-Rice pixel-step
probe.  Marked ``cuda``; each test skips where
torch.cuda.is_available() is False (this file imports no jax, so it runs
on a machine without it: FFV1_TEST_NO_CACHE=1 python -m pytest
tests/test_torch_cuda.py)."""
import os
import sys

import numpy as np
import pytest
import torch

from tpu_ffv1 import EncoderParams, FFV1Encoder
from tpu_ffv1.core import tables as T
from tpu_ffv1.core.rac import custom_state_tables

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the Golomb-Rice kernels' inputs)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _frames(w, h, n, seed):
    r = np.random.RandomState(seed)
    return [[r.randint(0, 256, s).astype(np.uint8) // (1 + t % 3)
             for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
            for t in range(n)]


def _check_encode(cuda, bits, CC, want_instance):
    from tpu_ffv1_torch.tpu import rc_encode as K
    r = np.random.RandomState(bits)
    L, N = 5, 700
    half = 1 << (bits - 1)
    one, zero = custom_state_tables(T.VER2_STATE)
    diff = np.where(r.rand(L, N) < 0.1, r.randint(-half, half, (L, N)),
                    r.randint(-3, 4, (L, N)))
    args = [torch.from_numpy(np.ascontiguousarray(a).astype(t)).to(cuda)
            for a, t in ((r.randint(0, CC, (L, N)), np.int32),
                         (diff, np.int32), (r.rand(L, N) < 0.9, np.bool_),
                         (r.randint(1, 256, (L, CC, 32)), np.uint8),
                         (one, np.uint8), (zero, np.uint8),
                         (r.randint(0, 1 << 16, L), np.int32),
                         (r.randint(0x100, 0xFF01, L), np.int32))]
    assert K.instance(bits, CC) == want_instance
    before = K.LAUNCHES.get(want_instance, 0)
    got = K.rc_encode_packed(*args, bits)
    assert K.LAUNCHES[want_instance] == before + 1
    ref = K.rc_encode_packed_ext_ref if bits > 10 else \
        K.rc_encode_packed_ref
    want = ref(*args, bits)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bits", [8, 10, 11, 16, 17])
def test_rc_encode_kernel_matches_plain(cuda, bits):
    _check_encode(cuda, bits, 2 * T.CONTEXT_COUNTS[0],
                  "rc_encode_ext" if bits > 10 else "rc_encode")


@pytest.mark.parametrize("bits", [8, 10, 11, 16, 17])
def test_rc_encode_global_kernel_matches_plain(cuda, bits):
    """Context model 1's table (2 x 7,563 rows, 484 KB per lane) does
    not fit shared memory: the instance that keeps it in global memory."""
    _check_encode(cuda, bits, 2 * T.CONTEXT_COUNTS[1],
                  "rc_encode_ext_global" if bits > 10 else
                  "rc_encode_global")


def _compact_args(cuda, CC):
    """K1 inputs at 8 bits, 30% full-range residuals and states from
    1..255, so that some pixels emit more than 4 bytes."""
    r = np.random.RandomState(CC)
    L, N = 5, 700
    one, zero = custom_state_tables(T.VER2_STATE)
    diff = np.where(r.rand(L, N) < 0.3, r.randint(-128, 128, (L, N)),
                    r.randint(-3, 4, (L, N)))
    return [torch.from_numpy(np.ascontiguousarray(a).astype(t)).to(cuda)
            for a, t in ((r.randint(0, CC, (L, N)), np.int32),
                         (diff, np.int32), (r.rand(L, N) < 0.9, np.bool_),
                         (r.randint(1, 256, (L, CC, 32)), np.uint8),
                         (one, np.uint8), (zero, np.uint8),
                         (r.randint(0, 1 << 16, L), np.int32),
                         (r.randint(0x100, 0xFF01, L), np.int32))]


@pytest.mark.parametrize("model", [0, 1], ids=["shared", "global"])
def test_rc_encode_compact_kernel_matches_plain(cuda, model):
    """K1-compact in both table placements, overflowing pixels included."""
    from tpu_ffv1_torch.tpu import rc_encode as K
    CC = 2 * T.CONTEXT_COUNTS[model]
    want_instance = "rc_encode_compact" + ("_global" if model else "")
    assert K.instance(8, CC, compact=True) == want_instance
    args = _compact_args(cuda, CC)
    before = K.LAUNCHES.get(want_instance, 0)
    got = K.rc_encode_compact(*args, 8)
    assert K.LAUNCHES[want_instance] == before + 1
    want = K.rc_encode_compact_ref(*args, 8)
    assert int(want[0][:, 5].sum()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _edge_args(cuda, bits, CC):
    """K1 / K1-ext inputs at their design's edges: runs of 2-64 equal
    contexts (the global-table instances forward the adapted byte; above
    10 bits the running rows 10 and 31 carry), one across the 32-pixel
    chunk boundary, blocks of inactive pixels and of zero residuals,
    residuals at +-2^(bits-1), states from 1..255; above 10 bits the
    other residuals' exponents drawn uniformly over 0..bits-1, 10% of
    them zero."""
    r = np.random.RandomState(100 + bits)
    L, N = 5, 700
    half = 1 << (bits - 1)
    one, zero = custom_state_tables(T.VER2_STATE)
    ctx = r.randint(0, CC, (L, N))
    if bits > 10:
        e = r.randint(0, bits, (L, N))
        a = (1 << e) | (r.randint(0, 1 << 30, (L, N)) & ((1 << e) - 1))
        diff = np.where(r.rand(L, N) < 0.5, -a, a)
        diff = np.where(r.rand(L, N) < 0.1, 0, diff)
    else:
        diff = np.where(r.rand(L, N) < 0.1,
                        r.randint(-half, half + 1, (L, N)),
                        r.randint(-3, 4, (L, N)))
    act = r.rand(L, N) < 0.95
    for lane in range(L):
        p = 0
        while p < N:
            q = min(N, p + r.randint(2, 65))
            kind = r.randint(5)
            if kind in (0, 4):
                ctx[lane, p:q] = ctx[lane, p]
            if kind == 1:
                act[lane, p:q] = False
            elif kind == 2:
                diff[lane, p:q] = 0
            elif kind in (3, 4):
                diff[lane, p:q] = r.choice([-half, half], q - p)
            p = q
    ctx[:, 20:80] = ctx[:, 20:21]
    return [torch.from_numpy(np.ascontiguousarray(a).astype(t)).to(cuda)
            for a, t in ((ctx, np.int32), (diff, np.int32), (act, np.bool_),
                         (r.randint(1, 256, (L, CC, 32)), np.uint8),
                         (one, np.uint8), (zero, np.uint8),
                         (r.randint(0, 1 << 16, L), np.int32),
                         (r.randint(0x100, 0x10000, L), np.int32))]


@pytest.mark.parametrize("bits,compact", [
    (b, c) for b in (8, 9, 10) for c in (False, True)] + [
    (b, False) for b in (11, 16, 17)],
    ids=lambda v: ("compact" if v else "raw") if isinstance(v, bool)
    else str(v))
@pytest.mark.parametrize("model", [0, 1], ids=["shared", "global"])
def test_rc_encode_edges_match_plain(cuda, bits, model, compact):
    """All four K1 instances and both K1-ext instances at the edges of
    their design."""
    from tpu_ffv1_torch.tpu import rc_encode as K
    CC = 2 * T.CONTEXT_COUNTS[model]
    args = _edge_args(cuda, bits, CC)
    fn = K.rc_encode_compact if compact else K.rc_encode_packed
    ref = K.rc_encode_compact_ref if compact else \
        K.rc_encode_packed_ext_ref if bits > 10 else K.rc_encode_packed_ref
    name = K.instance(bits, CC, compact)
    before = K.LAUNCHES.get(name, 0)
    got = fn(*args, bits)
    assert K.LAUNCHES[name] == before + 1
    for a, b in zip(got, ref(*args, bits)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("model", [0, 1], ids=["shared", "global"])
def test_rc_encode_stages_full_is_the_production_instance(cuda, model):
    """The stage entry point's ``full`` variant equals the production
    K1; every stubbed variant launches (timing only: its outputs are
    wrong on purpose)."""
    from tpu_ffv1_torch.tpu import rc_encode as K
    args = _compact_args(cuda, 2 * T.CONTEXT_COUNTS[model])
    want = K.rc_encode_packed(*args, 8)
    got = K.rc_encode_stages(*args, "full")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for variant in K.STAGE_VARIANTS:
        out = K.rc_encode_stages(*args, variant)
        torch.cuda.synchronize()
        assert out[0].shape == want[0].shape


@pytest.mark.parametrize("model", [0, 1], ids=["shared", "global"])
def test_rc_encode_ext_stages_full_is_the_production_instance(cuda, model):
    """K1-ext's stage entry point at 16 bits: ``full`` equals the
    production instance in both placements; every stubbed variant
    launches (timing only: its outputs are wrong on purpose)."""
    from tpu_ffv1_torch.tpu import rc_encode as K
    args = _edge_args(cuda, 16, 2 * T.CONTEXT_COUNTS[model])
    want = K.rc_encode_packed(*args, 16)
    got = K.rc_encode_ext_stages(*args, "full")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for variant in K.EXT_STAGE_VARIANTS:
        out = K.rc_encode_ext_stages(*args, variant)
        torch.cuda.synchronize()
        assert out[0].shape == want[0].shape


@pytest.mark.parametrize("mode", ["row", "byte"])
def test_lookup_probes_match_plain_loops(cuda, mode):
    from tpu_ffv1_torch.kernels import probes
    if mode == "row":
        table = probes.cycle_table(2 * T.CONTEXT_COUNTS[0], 7)
    else:
        table = custom_state_tables(T.VER2_STATE)[0]
    n = 5000
    got = probes.smem_probe(torch.from_numpy(table).to(cuda), n, mode)
    want = probes.smem_probe(torch.from_numpy(table), n, mode)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("mode", ["encode", "decode", "run_encode",
                                  "run_decode"])
def test_golomb_step_probe_matches_plain_loop(cuda, mode):
    from tpu_ffv1_torch.kernels import probes
    host = probes.golomb_step_inputs(2 * T.CONTEXT_COUNTS[0], mode, 7)
    got = probes.golomb_step(*[torch.from_numpy(a).to(cuda) for a in host],
                             5000, mode)
    assert torch.equal(got.cpu(), probes.golomb_step_ref(*host, 5000, mode))


@pytest.mark.parametrize("context_model", [0, 1])
def test_compact_slice_on_cuda_matches_host(cuda, context_model):
    """The compact encode form on the card: the host encoder's bytes."""
    from tpu_ffv1_torch import TorchFFV1Encoder
    w, h = 96, 64
    params = EncoderParams(width=w, height=h, pix_fmt="yuv420p", level=3,
                           coder=2, slices=4, gop_size=2,
                           context_model=context_model)
    streams = [_frames(w, h, 3, 20 + b) for b in range(2)]
    port = TorchFFV1Encoder(params, batch=2, device=cuda, compact=True)
    hosts = [FFV1Encoder(params) for _ in range(2)]
    for t in range(3):
        res = port.encode_frames([streams[b][t] for b in range(2)])
        for b in range(2):
            assert res[b] == hosts[b].encode_frame(streams[b][t])


def _check_decode(K, args, specs, bits, five, want_instance):
    CC = args[1].shape[1]
    assert K.instance(bits, five, CC, max(s[0] for s in specs)) == \
        want_instance
    before = K.LAUNCHES.get(want_instance, 0)
    got = K.rc_decode_planes(*args, specs, bits, five)
    assert K.LAUNCHES[want_instance] == before + 1
    ref = K.rc_decode_planes_ext_ref if bits > 10 else \
        K.rc_decode_planes_ref
    want = ref(*args, specs, bits, five)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    return got


def _decode_stream_check(cuda, context_model, want_instance):
    from tpu_ffv1_torch.tpu import rc_decode as K
    from tpu_ffv1_torch.tpu.decoder import TorchFFV1Decoder
    w, h = 96, 64
    params = EncoderParams(width=w, height=h, pix_fmt="yuv420p", level=3,
                           coder=2, slices=4, context_model=context_model)
    enc = FFV1Encoder(params)
    frame = _frames(w, h, 1, 1)[0]
    pkt = enc.encode_frame(frame)[0]
    dec = TorchFFV1Decoder(w, h, enc.extradata, device=cuda)
    parsed = [dec._parse_packet(0, pkt)]
    (bufs, lows, ranges, poss), _lens, q = dec._lane_inputs(parsed)
    cc = dec.g.context_counts[q]
    specs = tuple((pw, ph, sp * cc) for (pw, ph, sp) in dec._plane_specs())
    states = dec._fresh(q)[None].repeat(dec.L, 1, 1)
    args = (bufs, states, dec.one_tab, dec.zero_tab, dec.qts[q], lows,
            ranges, poss)
    five = bool(dec.g.quant_tables[q][3][127])
    assert five == (context_model == 1)
    got = _check_decode(K, args, specs, 8, five, want_instance)
    assert np.array_equal(got[0][0][0].cpu().numpy(), frame[0][:32, :48])


def test_rc_decode_kernel_matches_plain(cuda):
    _decode_stream_check(cuda, 0, "rc_decode")


def test_rc_decode_five_kernel_matches_plain(cuda):
    """K2-five (the 5-input context, its 2 x 7,563-row table in global
    memory) on a context-model-1 stream of the host encoder."""
    _decode_stream_check(cuda, 1, "rc_decode_five_global")


def _random_decode_args(cuda, bits, CC, model, seed=None, pos0=2):
    """Random slice bytes, states from 16..240, the coder started at
    ``pos0`` (by default 2, after the first two bytes; near cap the reads
    run past the buffer)."""
    r = np.random.RandomState(bits if seed is None else seed)
    L, cap = 5, 2048
    one, zero = custom_state_tables(T.VER2_STATE)
    bufs = r.randint(0, 256, (L, cap)).astype(np.uint8)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (
        bufs, r.randint(16, 241, (L, 2 * CC, 32)).astype(np.uint8), one,
        zero, T.default_quant_tables(bits)[model].astype(np.int32),
        np.minimum(bufs[:, pos0 - 2].astype(np.int32) << 8 |
                   bufs[:, pos0 - 1], 0xFEFF),
        np.full(L, 0xFF00, np.int32), np.full(L, pos0, np.int32))]


@pytest.mark.parametrize("width", [1, 2, 31, 32, 33, 40])
@pytest.mark.parametrize("bits", [8, 9, 10])
def test_rc_decode_random_bytes_match_plain(cuda, bits, width):
    """K2 itself, the main path's instance (3-input context, table in
    shared memory), on random bytes (exponents up to the width with no
    stop decision, clamped contexts): plane widths 1 and 2 (the x = 0
    and x = w - 1 borders at once), 31, 32, 33 and 40 (the context
    computed a warp's 32 columns at a time, and its edge)."""
    from tpu_ffv1_torch.tpu import rc_decode as K
    CC = T.CONTEXT_COUNTS[0]
    half = (width + 1) // 2
    specs = ((width, 6, 0), (half, 4, CC), (half, 4, CC))
    _check_decode(K, _random_decode_args(cuda, bits, CC, 0, 10 * bits +
                                         width), specs, bits, False,
                  "rc_decode")


@pytest.mark.parametrize("bits", [8, 9, 10])
def test_rc_decode_random_bytes_near_cap_match_plain(cuda, bits):
    """K2 with the coder started 8 bytes before the buffer's end, within
    one pixel's worst case of 2 * bits + 1 bytes: reads at pos >= cap
    give 0."""
    from tpu_ffv1_torch.tpu import rc_decode as K
    CC = T.CONTEXT_COUNTS[0]
    args = _random_decode_args(cuda, bits, CC, 0, 103, pos0=2048 - 8)
    got = _check_decode(K, args, ((40, 6, 0),), bits, False, "rc_decode")
    assert (got[4] >= 2048).any(), "no read passed the buffer"


@pytest.mark.parametrize("five,model", [(False, 0), (True, 1), (True, 0),
                                        (False, 1)],
                         ids=["rc_decode", "five_global", "five",
                              "global"])
def test_rc_decode_stages_full_is_the_production_instance(cuda, five,
                                                          model):
    """K2's stage entry point: ``full`` equals the production launch, in
    both contexts and both table placements; every stubbed variant
    launches (timing only: its outputs are wrong on purpose)."""
    from tpu_ffv1_torch.tpu import rc_decode as K
    CC = T.CONTEXT_COUNTS[model]
    args = _random_decode_args(cuda, 8, CC, int(five))
    specs = ((40, 6, 0), (20, 6, CC), (20, 6, CC))
    want = K.rc_decode_planes(*args, specs, 8, five)
    got = K.rc_decode_stages(*args, specs, five, "full")
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    for variant in K.STAGE_VARIANTS:
        out = K.rc_decode_stages(*args, specs, five, variant)
        torch.cuda.synchronize()
        assert out[0][0].shape == want[0][0].shape


@pytest.mark.parametrize("bits", [11, 16, 17])
def test_rc_decode_ext_kernel_matches_plain(cuda, bits):
    """K2-ext on random bytes (garbage symbols reach every row cap, the
    int16 wrap at 16 bits, reads past the buffer) at a 40-pixel-wide
    plane, so the decoded rows span two warps' worth of columns."""
    from tpu_ffv1_torch.tpu import rc_decode as K
    CC = T.CONTEXT_COUNTS[0]
    specs = ((40, 6, 0), (20, 6, CC), (20, 6, CC))
    _check_decode(K, _random_decode_args(cuda, bits, CC, 0), specs, bits,
                  False, "rc_decode_ext")


@pytest.mark.parametrize("width", [1, 2, 31, 32, 33, 40])
@pytest.mark.parametrize("bits", [11, 16, 17])
def test_rc_decode_ext_random_bytes_match_plain(cuda, bits, width):
    """K2-ext, the 16-bit path's instance (3-input context, table in
    shared memory), on random bytes (exponents past the width with no
    stop decision, so the running rows 10 and 31 take their longest
    runs; clamped contexts): plane widths 1 and 2 (the x = 0 and x = w -
    1 borders at once), 31, 32, 33 and 40 (the context computed a warp's
    32 columns at a time, and its edge)."""
    from tpu_ffv1_torch.tpu import rc_decode as K
    CC = T.CONTEXT_COUNTS[0]
    half = (width + 1) // 2
    specs = ((width, 6, 0), (half, 4, CC), (half, 4, CC))
    _check_decode(K, _random_decode_args(cuda, bits, CC, 0, 10 * bits +
                                         width), specs, bits, False,
                  "rc_decode_ext")


@pytest.mark.parametrize("five,model", [(False, 0), (True, 1)],
                         ids=["shared", "global"])
def test_rc_decode_ext_stages_full_is_the_production_instance(cuda, five,
                                                              model):
    """K2-ext's stage entry point at 16 bits: ``full`` equals the
    production launch in both placements (rc_decode_ext and
    rc_decode_ext_five_global); every stubbed variant launches (timing
    only: its outputs are wrong on purpose)."""
    from tpu_ffv1_torch.tpu import rc_decode as K
    CC = T.CONTEXT_COUNTS[model]
    args = _random_decode_args(cuda, 16, CC, int(five))
    specs = ((40, 6, 0), (20, 6, CC), (20, 6, CC))
    want = K.rc_decode_planes(*args, specs, 16, five)
    got = K.rc_decode_ext_stages(*args, specs, five, "full")
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    for variant in K.EXT_STAGE_VARIANTS:
        out = K.rc_decode_ext_stages(*args, specs, five, variant)
        torch.cuda.synchronize()
        assert out[0][0].shape == want[0][0].shape


@pytest.mark.parametrize("bits", [8, 11, 16, 17])
def test_rc_decode_five_global_kernel_matches_plain(cuda, bits):
    """K2-five and K2-ext-five on random bytes, with context model 1's
    quant tables and a 2 x 5,063-row table (the 16-bit extradata's
    count), in global memory."""
    from tpu_ffv1_torch.tpu import rc_decode as K
    CC = 5063
    specs = ((40, 6, 0), (20, 6, CC), (20, 6, CC))
    _check_decode(K, _random_decode_args(cuda, bits, CC, 1), specs, bits,
                  True, "rc_decode_ext_five_global" if bits > 10 else
                  "rc_decode_five_global")


@pytest.mark.parametrize("context_model", [0, 1])
def test_16bit_slice_on_cuda_matches_host(cuda, context_model):
    """yuv444p16le through K1-ext and K2-ext (context model 1: their
    global-table forms, K2-ext with the 5-input context): the host
    encoder's bytes and a lossless decode."""
    from tpu_ffv1_torch import TorchFFV1Decoder, TorchFFV1Encoder
    w, h = 64, 48
    params = EncoderParams(width=w, height=h, pix_fmt="yuv444p16le",
                           level=3, coder=2, slices=4, gop_size=2,
                           context_model=context_model)
    r = np.random.RandomState(16)
    base = np.add.outer(np.arange(h), np.arange(w)) * 1031
    streams = [[[((base + 7919 * k + 977 * t + r.randint(0, 4000, (h, w)))
                  % 65536).astype(np.uint16) for k in range(3)]
                for t in range(3)] for _b in range(2)]
    port = TorchFFV1Encoder(params, batch=2, device=cuda)
    dec = TorchFFV1Decoder(w, h, port.extradata, batch=2, device=cuda)
    hosts = [FFV1Encoder(params) for _ in range(2)]
    for t in range(3):
        res = port.encode_frames([streams[b][t] for b in range(2)])
        for b in range(2):
            assert res[b] == hosts[b].encode_frame(streams[b][t])
        out = dec.decode_frames([r[0] for r in res])
        for b in range(2):
            for x, y in zip(out[b][0], streams[b][t]):
                assert x.dtype == np.uint16 and np.array_equal(x, y)


@pytest.mark.parametrize("context_model", [0, 1])
def test_slice_on_cuda_matches_host(cuda, context_model):
    from tpu_ffv1_torch import TorchFFV1Decoder, TorchFFV1Encoder
    w, h = 96, 64
    params = EncoderParams(width=w, height=h, pix_fmt="yuv420p", level=3,
                           coder=2, slices=4, gop_size=2,
                           context_model=context_model)
    streams = [_frames(w, h, 3, 10 + b) for b in range(2)]
    port = TorchFFV1Encoder(params, batch=2, device=cuda)
    dec = TorchFFV1Decoder(w, h, port.extradata, batch=2, device=cuda)
    hosts = [FFV1Encoder(params) for _ in range(2)]
    for t in range(3):
        res = port.encode_frames([streams[b][t] for b in range(2)])
        for b in range(2):
            assert res[b] == hosts[b].encode_frame(streams[b][t])
        out = dec.decode_frames([r[0] for r in res])
        for b in range(2):
            for x, y in zip(out[b][0], streams[b][t]):
                assert np.array_equal(x, y)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("five", [True, False],
                         ids=["five_shared", "three_global"])
def test_rc_decode_other_placements_match_plain(cuda, bits, five):
    """The placement follows the table's size alone, whatever the
    context: the 5-input context (context model 1's quant tables) with a
    table that fits shared memory, and the 3-input one with a table that
    does not (both reachable with custom quant tables in the
    extradata)."""
    from tpu_ffv1_torch.tpu import rc_decode as K
    CC = T.CONTEXT_COUNTS[0 if five else 1]
    specs = ((40, 6, 0), (20, 6, CC), (20, 6, CC))
    name = ("rc_decode_ext" if bits > 10 else "rc_decode") + \
        ("_five" if five else "_global")
    _check_decode(K, _random_decode_args(cuda, bits, CC, int(five)), specs,
                  bits, five, name)


@pytest.mark.parametrize("cap", [None, 200], ids=["full", "capped"])
@pytest.mark.parametrize("model", [0, 1], ids=["shared", "global"])
def test_golomb_encode_kernel_matches_plain(cuda, model, cap):
    """G1 in both table placements on chip_smoke's edge inputs, with all
    bytes kept and with an output cap below the counts."""
    from tpu_ffv1_torch.tpu import golomb_encode as G
    cc = T.CONTEXT_COUNTS[model]
    arrs = chip_smoke.golomb_encode_edge_inputs(
        5, ((64, 12, 0), (32, 6, 1), (32, 6, 1)), cc, 3 + model)
    args = [torch.from_numpy(a) for a in arrs]
    want_instance = "golomb_encode" + ("_global" if model else "")
    assert G.instance(2 * cc) == want_instance
    before = G.LAUNCHES.get(want_instance, 0)
    got = G.golomb_encode_lanes(*[a.to(cuda) for a in args], 8, cc, cap)
    assert G.LAUNCHES[want_instance] == before + 1
    want = G.golomb_encode_lanes(*args, 8, cc, cap)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("five,model", [(False, 0), (True, 1), (True, 0),
                                        (False, 1)],
                         ids=["three_shared", "five_global", "five_shared",
                              "three_global"])
def test_golomb_decode_kernel_matches_plain(cuda, five, model):
    """G2's four instances on random bytes (long runs, escapes, reads past
    cap), planes 40, 33, 2 and 1 wide."""
    from tpu_ffv1_torch.tpu import golomb_decode as G
    cc = T.CONTEXT_COUNTS[model]
    arrs = chip_smoke.golomb_decode_random_inputs(5, 1024, cc, five,
                                                        7 + model + five)
    args = [torch.from_numpy(a) for a in arrs]
    specs = ((40, 6, 0), (33, 4, cc), (2, 4, cc), (1, 4, 0))
    got = G.golomb_decode_planes(*[a.to(cuda) for a in args], specs, 8, five)
    want = G.golomb_decode_planes(*args, specs, 8, five)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("model", [0, 1], ids=["shared", "global"])
def test_golomb_stages_full_is_the_production_instance(cuda, model):
    """G1's and G2's stage probes: ``full`` equals the production launch,
    every stubbed variant launches (its outputs are wrong on purpose)."""
    from tpu_ffv1_torch.tpu import golomb_decode as GD
    from tpu_ffv1_torch.tpu import golomb_encode as GE
    cc = T.CONTEXT_COUNTS[model]
    arrs = chip_smoke.golomb_encode_edge_inputs(
        5, ((64, 12, 0), (32, 6, 1), (32, 6, 1)), cc, 11 + model)
    args = (*[torch.from_numpy(a).to(cuda) for a in arrs], 8, cc, None)
    want = GE.golomb_encode_lanes(*args)
    got = GE.golomb_encode_stages(*args, "full")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for variant in GE.STAGE_VARIANTS:
        GE.golomb_encode_stages(*args, variant)
    arrs = chip_smoke.golomb_decode_random_inputs(5, 1024, cc, model == 1,
                                                  13 + model)
    specs = ((40, 6, 0), (33, 4, cc), (2, 4, cc), (1, 4, 0))
    args = (*[torch.from_numpy(a).to(cuda) for a in arrs], specs, 8,
            model == 1)
    want = GD.golomb_decode_planes(*args)
    got = GD.golomb_decode_stages(*args, "full")
    assert all(torch.equal(a, b) for a, b in
               zip(chip_smoke.flat_outputs(got),
                   chip_smoke.flat_outputs(want)))
    for variant in GD.STAGE_VARIANTS:
        GD.golomb_decode_stages(*args, variant)
    torch.cuda.synchronize()


@pytest.mark.parametrize("context_model", [0, 1])
def test_golomb_slice_on_cuda_matches_host(cuda, context_model):
    """Golomb-Rice (coder 0) through G1 and G2: the host encoder's
    packets, a lossless decode."""
    from tpu_ffv1_torch import TorchFFV1Decoder, TorchFFV1Encoder
    w, h = 96, 64
    params = EncoderParams(width=w, height=h, pix_fmt="yuv420p", level=3,
                           coder=0, slices=4, gop_size=2,
                           context_model=context_model)
    streams = [_frames(w, h, 3, 20 + b) for b in range(2)]
    port = TorchFFV1Encoder(params, batch=2, device=cuda)
    dec = TorchFFV1Decoder(w, h, port.extradata, batch=2, device=cuda)
    hosts = [FFV1Encoder(params) for _ in range(2)]
    for t in range(3):
        res = port.encode_frames([streams[b][t] for b in range(2)])
        for b in range(2):
            assert res[b] == hosts[b].encode_frame(streams[b][t])
        out = dec.decode_frames([r[0] for r in res])
        for b in range(2):
            for x, y in zip(out[b][0], streams[b][t]):
                assert np.array_equal(x, y)


@pytest.mark.parametrize("five,model", [(False, 0), (True, 1), (True, 0),
                                        (False, 1)],
                         ids=["three_shared", "five_global", "five_shared",
                              "three_global"])
@pytest.mark.parametrize("bits", [9, 10, 11, 13, 15])
def test_rc_decode_rgb_kernels_match_plain(cuda, bits, five, model):
    """B1's (9, 10 bits) and B1-ext's (11, 13, 15) four instances on
    chip_smoke's random inputs, 3 and 4 planes 40, 33, 2 and 1 wide,
    against the plain version; one launch counted each."""
    from tpu_ffv1_torch.tpu import rc_decode as K
    cc = T.CONTEXT_COUNTS[model]
    for w, P in chip_smoke.RGB_RANDOM_SHAPES:
        arrs = chip_smoke.rgb_decode_random_inputs(6, 1024, bits, five, cc,
                                                   P, 40 + bits + w)
        h = 4 if w > 2 else 48
        name = K.instance(bits, five, arrs[1].shape[1], w, P)
        assert name.startswith("rc_decode_ext_rgb" if bits > 10 else
                               "rc_decode_rgb")
        before = K.LAUNCHES.get(name, 0)
        got = K.rc_decode_rgb(*[torch.from_numpy(a).to(cuda) for a in arrs],
                              w, h, P, cc, bits, five)
        assert K.LAUNCHES[name] == before + 1
        want = K.rc_decode_rgb_ref(*[torch.from_numpy(a) for a in arrs], w,
                                   h, P, cc, bits, five)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("bits", [9, 15])
def test_rc_decode_rgb_stages_full_is_the_production_instance(cuda, bits):
    """B1's (9 bits) and B1-ext's (15 bits) stage entry points: ``full``
    equals the production launch of rc_decode_rgb (3-input context, table
    in shared memory), 3 and 4 planes; every stubbed variant, no_line
    among them, launches (timing only: its outputs are wrong on
    purpose)."""
    from tpu_ffv1_torch.tpu import rc_decode as K
    cc = T.CONTEXT_COUNTS[0]
    variants = K.EXT_RGB_STAGE_VARIANTS if bits > 10 else \
        K.RGB_STAGE_VARIANTS
    for w, P in ((40, 3), (33, 4)):
        arrs = chip_smoke.rgb_decode_random_inputs(6, 1024, bits, False, cc,
                                                   P, 60 + bits + w)
        args = [torch.from_numpy(a).to(cuda) for a in arrs]
        want = K.rc_decode_rgb(*args, w, 4, P, cc, bits, False)
        got = K.rc_decode_rgb_stages(*args, w, 4, P, cc, bits, False, "full")
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        for variant in variants:
            out = K.rc_decode_rgb_stages(*args, w, 4, P, cc, bits, False,
                                         variant)
            torch.cuda.synchronize()
            assert out[0].shape == want[0].shape


@pytest.mark.parametrize("context_model", [0, 1])
@pytest.mark.parametrize("pix_fmt", ["bgr0", "gbrp14le"])
def test_rgb_slice_on_cuda_matches_host(cuda, pix_fmt, context_model):
    """RGB through K1 / K1-ext and B1 / B1-ext: the host encoder's
    packets, a lossless decode in the host decoder's layout."""
    from tpu_ffv1_torch import TorchFFV1Decoder, TorchFFV1Encoder
    w, h = 96, 64
    params = EncoderParams(width=w, height=h, pix_fmt=pix_fmt, level=3,
                           coder=2, slices=4, gop_size=2,
                           context_model=context_model)
    gen = chip_smoke.synthetic_streams_bgr0 if pix_fmt == "bgr0" else \
        chip_smoke.synthetic_streams_gbrp14
    streams = gen(2, 3, w, h, 30 + context_model)
    port = TorchFFV1Encoder(params, batch=2, device=cuda)
    dec = TorchFFV1Decoder(w, h, port.extradata, batch=2, device=cuda)
    hosts = [FFV1Encoder(params) for _ in range(2)]
    for t in range(3):
        res = port.encode_frames([streams[b][t] for b in range(2)])
        for b in range(2):
            assert res[b] == hosts[b].encode_frame(streams[b][t])
        out = dec.decode_frames([r[0] for r in res])
        for b in range(2):
            assert len(out[b][0]) == len(streams[b][t])
            for x, y in zip(out[b][0], streams[b][t]):
                assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("pix_fmt", ["bgr0", "gbrp14le", "yuv444p16le"])
def test_v4_slice_on_cuda_matches_host(cuda, pix_fmt):
    """Version 4 on the card: the RCT search, the per-lane RCT (RGB), the
    row bytes; the host encoder's packets, a lossless decode, and some
    lane with a pair other than (1, 1)."""
    from tpu_ffv1_torch import TorchFFV1Decoder, TorchFFV1Encoder
    w, h = 96, 64
    params = EncoderParams(width=w, height=h, pix_fmt=pix_fmt, level=4,
                           strict=-2, coder=2, slices=4, gop_size=2)
    gen = {"bgr0": chip_smoke.synthetic_streams_bgr0,
           "gbrp14le": chip_smoke.synthetic_streams_gbrp14,
           "yuv444p16le": chip_smoke.synthetic_streams16}[pix_fmt]
    streams = gen(2, 3, w, h, 40)
    port = TorchFFV1Encoder(params, batch=2, device=cuda)
    dec = TorchFFV1Decoder(w, h, port.extradata, batch=2, device=cuda)
    hosts = [FFV1Encoder(params) for _ in range(2)]
    picks = set()
    for t in range(3):
        res = port.encode_frames([streams[b][t] for b in range(2)])
        picks |= set(port.rct_coefs)
        for b in range(2):
            assert res[b] == hosts[b].encode_frame(streams[b][t])
        out = dec.decode_frames([r[0] for r in res])
        for b in range(2):
            for x, y in zip(out[b][0], streams[b][t]):
                assert x.dtype == y.dtype and np.array_equal(x, y)
    assert picks - {(1, 1)}


def test_v4_pcm_retry_on_cuda_matches_plain_row_bytes(cuda):
    """chip_smoke's v4_pcm content on the card: stream 0's slices retry as
    PCM in frames 0 and 2 (the host decoder reads them losslessly), and
    row_bytes on the card equals a numpy count of the emit flags (bit 20)
    of a host copy of the slots, summed per pixel and over the lane's
    pixels before each line start."""
    from tpu_ffv1 import FFV1Decoder
    from tpu_ffv1_torch import TorchFFV1Encoder
    from tpu_ffv1_torch.tpu import encoder as E
    params = EncoderParams(**chip_smoke.pcm_kw())
    streams = chip_smoke.synthetic_streams_pcm()
    port = TorchFFV1Encoder(params, batch=2, device=cuda)
    hosts = [FFV1Decoder(params.width, params.height, port.extradata)
             for _ in range(2)]
    for t in range(chip_smoke.PCM_FRAMES):
        frame = [s[t] for s in streams]
        planes = port._upload(frame)
        ctx, diff, act = port._streams_uniform(planes)
        packed = E.rc_encode_packed(
            ctx, diff, act, port.states, port.one_tab, port.zero_tab,
            *port._prefix_arrays_rct(t == 0, port._rct_coefs(planes))[:2],
            port.bits)[0]
        offs = port.row_offs.cpu().numpy()
        cum = np.cumsum(((packed.cpu().numpy() >> 20) & 1).sum(axis=1),
                        axis=0)                           # (N, L)
        plain = np.where(offs[:, None] == 0, 0, cum[np.maximum(offs - 1, 0)])
        assert np.array_equal(E.row_bytes(packed, port.row_offs).cpu()
                              .numpy(), plain)
        res = port.encode_frames(frame)
        for b in range(2):
            out, _ = hosts[b].decode_frame(res[b][0])
            assert all(np.array_equal(np.asarray(x), y)
                       for x, y in zip(out, frame[b]))
            assert [s.slice_coding_mode for s in hosts[b].slices] == \
                [int(b == 0 and t != 1)] * 4


def test_k1_lanes_of_unequal_length_matches_plain(cuda):
    """A non-uniform grid (50x40 yuv420p, 6 slices of two sizes, batch
    2): K1 over lanes of unequal length (the active mask ends each lane
    at its own stream length) against its plain version on the same
    CUDA tensors, and the encoder's packets against the host's."""
    from tpu_ffv1_torch import TorchFFV1Encoder
    from tpu_ffv1_torch.tpu import rc_encode as K
    params = EncoderParams(width=50, height=40, pix_fmt="yuv420p", level=3,
                           coder=2, slices=6, gop_size=2)
    streams = [_frames(50, 40, 2, 90 + b) for b in range(2)]
    port = TorchFFV1Encoder(params, batch=2, device=cuda)
    assert not port.uniform and len(set(port.stream_lens)) > 1
    planes = port._upload([s[0] for s in streams])
    ctx, diff, act = port._streams(planes)
    assert not bool(act.all())
    lows, ranges, _p, _n = port._prefix_arrays(True)
    args = (ctx, diff, act, torch.full_like(port.states, 128), port.one_tab,
            port.zero_tab, lows, ranges, port.bits)
    got = K.rc_encode_packed(*args)
    assert K.LAUNCHES.get("rc_encode")
    want = K.rc_encode_packed_ref(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    hosts = [FFV1Encoder(params) for _ in range(2)]
    for t in range(2):
        res = port.encode_frames([s[t] for s in streams])
        for b in range(2):
            assert res[b] == hosts[b].encode_frame(streams[b][t])


def test_grouped_decode_matches_plain(cuda):
    """rc_decode_groups on the card (K2 and K2-five-global groups, one per
    plane geometry and quant table: a non-uniform 50x40 yuv420p grid of
    6 slices whose even slices name table 0 and odd ones table 1) against
    the same grouping on CPU copies (the plain versions), and the
    decoder's frame against the source."""
    from tpu_ffv1_torch.tpu import rc_decode as K
    from tpu_ffv1_torch.tpu.decoder import TorchFFV1Decoder
    frame = _frames(50, 40, 1, 91)[0]
    pk = []
    for cm in (0, 1):
        enc = FFV1Encoder(EncoderParams(
            width=50, height=40, pix_fmt="yuv420p", level=3, coder=2,
            slices=6, context_model=cm))
        pk.append(enc.encode_frame(frame)[0])
    decs = [TorchFFV1Decoder(50, 40, enc.extradata, device=d)
            for d in (cuda, "cpu")]
    pkt = chip_smoke.splice_packets(decs[1], *pk)
    outs = []
    for dec in decs:
        parsed = [dec._parse_packet(0, pkt)]
        (bufs, lows, ranges, poss), _n = dec._lane_buffers(parsed)
        lane_q = [s[1] for s in parsed[0][1]]
        dec._prepare_states(lane_q, [True], np.zeros(dec.L, bool))
        groups = dec._lane_groups(lane_q)
        assert len(groups) == 4
        K.LAUNCHES.clear()
        outs.append(K.rc_decode_groups(bufs, dec.states, dec.one_tab,
                                       dec.zero_tab, dec.quant, lows,
                                       ranges, poss, groups, 8))
        if dec.device.type == "cuda":
            assert K.LAUNCHES == {"rc_decode": 2,
                                  "rc_decode_five_global": 2}
    (pg, *rest), (pg_ref, *rest_ref) = outs
    for planes, planes_ref in zip(pg, pg_ref):
        for a, b in zip(planes, planes_ref):
            assert torch.equal(a.cpu(), b)
    for a, b in zip(rest, rest_ref):
        assert torch.equal(a.cpu(), b)
    got, _kf = decs[0].decode_frame(pkt)
    for a, b in zip(got, frame):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("pix_fmt,me", [("yuv420p", "full"),
                                        ("yuv420p", "epzs"),
                                        ("yuv422p10le", "full")])
def test_pframe_on_cuda_matches_cpu(cuda, pix_fmt, me):
    """FFV1-P on the card (K1 at 9 bits, K1-ext at 11, K2 at 9) against
    the port on the CPU (the plain versions, held to the host
    FFV1PEncoder in tests/test_torch_pframe.py): the same packets, a
    lossless decode at 8 bits, one launch per frame and lane scan; 64x48
    in 4 slices of 32x24 (8 rows of block padding), GOP 3."""
    from tpu_ffv1_torch import EncoderParams as TorchEncoderParams
    from tpu_ffv1_torch import TorchFFV1PDecoder, TorchFFV1PEncoder
    from tpu_ffv1_torch.tpu import rc_decode, rc_encode
    w, h, n = 64, 48, 5
    gen = chip_smoke.synthetic_streams_pan if pix_fmt == "yuv420p" else \
        chip_smoke.synthetic_streams_pan10
    frames = gen(1, n, w, h, 7)[0]
    params = TorchEncoderParams(width=w, height=h, pix_fmt=pix_fmt, level=3,
                                coder=2, slices=4, gop_size=3)
    encs = [TorchFFV1PEncoder(params, experimental=True, me=me, device=d)
            for d in (cuda, "cpu")]
    rc_encode.LAUNCHES.clear()
    pkts = []
    for f in frames:
        got, want = (e.encode_frames([f])[0] for e in encs)
        assert got == want
        pkts.append(got[0])
    p_inst = "rc_encode" if pix_fmt == "yuv420p" else "rc_encode_ext"
    want = {"rc_encode": n} if p_inst == "rc_encode" else \
        {"rc_encode": 2, "rc_encode_ext": n - 2}
    assert rc_encode.LAUNCHES == want
    if pix_fmt != "yuv420p":
        return
    dec = TorchFFV1PDecoder(w, h, encs[0].extradata, device=cuda)
    rc_decode.LAUNCHES.clear()
    for pkt, f in zip(pkts, frames):
        planes, _kf = dec.decode_frame(pkt)
        for a, b in zip(planes, f):
            assert np.array_equal(a, b)
    assert rc_decode.LAUNCHES == {"rc_decode": n}
    assert not dec.slice_damaged.any()


def _pipelined(enc_or_dec, steps, submit="submit_frames"):
    """Two submits, then a collect before each further submit."""
    getattr(enc_or_dec, submit)(steps[0])
    got = []
    for step in steps[1:] + [None]:
        if step is not None:
            getattr(enc_or_dec, submit)(step)
        got.append(enc_or_dec.collect_frames())
    return got


@pytest.mark.parametrize("pix", ["yuv420p", "yuv444p16le"])
def test_pipelined_paths_on_cuda_match_cpu(cuda, pix):
    """Depth-2 encode and decode on the card (batch 2, 64x48, GOP 2 over
    3 frames: the pinned staging, the copy streams, the events) against
    encode_frames / decode_frames on the CPU, and the transcode chain
    (device_out into submit_device_frames) against the same packets, no
    plane fetched."""
    from tpu_ffv1_torch import TorchFFV1Decoder, TorchFFV1Encoder
    from .util import synth_frames
    w, h = 64, 48
    params = EncoderParams(width=w, height=h, pix_fmt=pix, level=3,
                           coder=2, slices=4, gop_size=2)
    streams = [synth_frames(pix, w, h, 3, seed=120 + b) for b in range(2)]
    steps = [[s[t] for s in streams] for t in range(3)]
    cpu = TorchFFV1Encoder(params, batch=2, device="cpu")
    want = [cpu.encode_frames(s) for s in steps]
    enc = TorchFFV1Encoder(params, batch=2, device=cuda)
    assert _pipelined(enc, steps) == want
    pkts = [[p for p, _k in res] for res in want]
    cpu_dec = TorchFFV1Decoder(w, h, cpu.extradata, batch=2, device="cpu")
    dec_want = [cpu_dec.decode_frames(p) for p in pkts]
    dec = TorchFFV1Decoder(w, h, cpu.extradata, batch=2, device=cuda)
    for got, exp in zip(_pipelined(dec, pkts), dec_want):
        for (gp, gk), (ep, ek) in zip(got, exp):
            assert gk == ek and all(np.array_equal(a, b)
                                    for a, b in zip(gp, ep))
    dev_dec = TorchFFV1Decoder(w, h, cpu.extradata, batch=2, device=cuda,
                               device_out=True)
    frames = [dev_dec.decode_frames(p)[0] for p in pkts]
    trans = TorchFFV1Encoder(params, batch=2, device=cuda)
    assert _pipelined(trans, frames, "submit_device_frames") == want
    assert dev_dec.pipe.fetched_bytes == 3 * 3 * dev_dec.L * 4


def test_submits_make_no_synchronising_call(cuda):
    """Every submit of the intra encoder, the decoder (host and device
    output), the device-source encoder and the P encoder, from the first
    frame of a fresh instance on (the kernels loaded beforehand), runs
    under torch.cuda.set_sync_debug_mode("error"), which raises on any
    call that waits for the card."""
    from tpu_ffv1_torch import (TorchFFV1Decoder, TorchFFV1Encoder,
                                TorchFFV1PEncoder)
    w, h = 64, 48
    params = EncoderParams(width=w, height=h, pix_fmt="yuv420p", level=3,
                           coder=2, slices=4, gop_size=2)
    frames = _frames(w, h, 3, 130)
    warm = TorchFFV1Encoder(params, device=cuda)
    pkts = [warm.encode_frame(f)[0] for f in frames]
    TorchFFV1Decoder(w, h, warm.extradata, device=cuda).decode_frame(pkts[0])

    def strict(fn):
        def call(*a):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return call

    enc = TorchFFV1Encoder(params, device=cuda)
    enc.submit_frames = strict(enc.submit_frames)
    assert [r[0] for r in _pipelined(enc, [[f] for f in frames])] == \
        [(p, t == 0 or t == 2) for t, p in enumerate(pkts)]
    for device_out in (False, True):
        dec = TorchFFV1Decoder(w, h, warm.extradata, device=cuda,
                               device_out=device_out)
        dec.submit_frames = strict(dec.submit_frames)
        out = _pipelined(dec, [[p] for p in pkts])
    trans = TorchFFV1Encoder(params, device=cuda)
    trans.submit_device_frames = strict(trans.submit_device_frames)
    assert [r[0][0] for r in _pipelined(
        trans, [planes for planes, _k in out], "submit_device_frames")] == \
        pkts
    penc = TorchFFV1PEncoder(EncoderParams(width=w, height=h,
                                           pix_fmt="yuv420p", level=3,
                                           coder=2, slices=4, gop_size=3),
                             experimental=True, device=cuda)
    penc.submit_frames = strict(penc.submit_frames)
    assert len(_pipelined(penc, [[f] for f in frames])) == 3
