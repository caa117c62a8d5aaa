"""Decode lane scan: the plain PyTorch versions (which rc_decode_planes
runs for CPU tensors) equal dec_scan_lanes.rc_decode_planes_lanes on
the same inputs: planes, states, low, range and pos, exactly (integer
codec), on intact and on damaged streams, at the fast widths (8, 10)
and the extended ones (12, 16), with the 3-input context and with the
5-input one of context model 1."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ffv1 import EncoderParams, FFV1Encoder
from tpu_ffv1.tpu.dec_scan_lanes import rc_decode_planes_lanes
from tpu_ffv1_torch.tpu.decoder import TorchFFV1Decoder
from tpu_ffv1_torch.tpu.rc_decode import rc_decode_planes

W, H = 32, 24


def _frames(pix, bits, n, seed=4):
    r = np.random.RandomState(seed)
    hi = 1 << bits
    dt = np.uint8 if bits <= 8 else np.uint16
    out = []
    for t in range(n):
        y = (np.add.outer(np.arange(H), np.arange(W)) * (hi // 64) + 5 * t +
             r.randint(0, hi // 16, (H, W))) % hi
        u = r.randint(0, hi, (H // 2, W // 2))
        v = np.full((H // 2, W // 2), hi // 3)
        out.append([p.astype(dt) for p in (y, u, v)])
    return out


def _lane_args(dec, pkts, states):
    parsed = [dec._parse_packet(bi, p) for bi, p in enumerate(pkts)]
    (bufs, lows, ranges, poss), _lens, q = dec._lane_inputs(parsed)
    cc = dec.g.context_counts[q]
    specs = tuple((w, h, sp * cc) for (w, h, sp) in dec._plane_specs())
    if states is None:
        states = dec._fresh(q)[None].repeat(dec.L, 1, 1)
    return (bufs, states, dec.one_tab, dec.zero_tab, dec.qts[q], lows,
            ranges, poss), specs


def _compare(args, specs, bits, five=False):
    got = rc_decode_planes(*args, specs, bits, five)
    want = rc_decode_planes_lanes(
        *[jnp.asarray(a.numpy()) for a in args], specs, bits, five)
    for a, b in zip(want[0], got[0]):
        assert np.array_equal(np.asarray(a), b.numpy())
    for a, b in zip(want[1:], got[1:]):
        assert np.array_equal(np.asarray(a), b.numpy())
    return got


def _gop_carry(pix, bits, context_model):
    """Key frame from fresh states, then a non-key frame continuing from
    the states the first decode returned (2 streams x 4 slices)."""
    params = EncoderParams(width=W, height=H, pix_fmt=pix, level=3,
                           coder=2, slices=4, gop_size=2,
                           context_model=context_model)
    streams = [_frames(pix, bits, 2, seed=s) for s in range(2)]
    encs = [FFV1Encoder(params) for _ in range(2)]
    pkts = [[e.encode_frame(f)[0] for f in fr] for e, fr in zip(encs, streams)]
    dec = TorchFFV1Decoder(W, H, encs[0].extradata, batch=2, device="cpu")
    five = context_model == 1
    args, specs = _lane_args(dec, [p[0] for p in pkts], None)
    got = _compare(args, specs, bits, five)
    assert np.array_equal(got[0][0][0].numpy(), streams[0][0][0][:12, :16])
    args, specs = _lane_args(dec, [p[1] for p in pkts], got[1])
    _compare(args, specs, bits, five)


@pytest.mark.parametrize("pix,bits", [("yuv420p", 8), ("yuv420p10le", 10)])
def test_matches_xla_lanes_with_gop_carry(pix, bits):
    _gop_carry(pix, bits, 0)


@pytest.mark.parametrize("pix,bits", [("yuv420p", 8), ("yuv420p10le", 10)])
def test_five_matches_xla_lanes_with_gop_carry(pix, bits):
    """The 5-input context (context model 1: a 2 x 7,563-row table,
    LL and TT from the 2-row ring)."""
    _gop_carry(pix, bits, 1)


def _damaged(context_model):
    """A flipped byte sends the decoder through garbage symbols: context
    clamping, reads past the buffer and e = bits all have to agree."""
    params = EncoderParams(width=W, height=H, pix_fmt="yuv420p", level=3,
                           coder=2, slices=4, context_model=context_model)
    enc = FFV1Encoder(params)
    pkt = bytearray(enc.encode_frame(_frames("yuv420p", 8, 1)[0])[0])
    for off in (40, 41, 42):
        pkt[off] ^= 0xA5
    dec = TorchFFV1Decoder(W, H, enc.extradata, device="cpu")
    args, specs = _lane_args(dec, [bytes(pkt)], None)
    _compare(args, specs, 8, context_model == 1)


def test_matches_xla_lanes_on_damaged_stream():
    _damaged(0)


def test_five_matches_xla_lanes_on_damaged_stream():
    _damaged(1)


def _frames16(w, h, n, seed):
    """yuv444p16le content whose residuals pass 2^10 (rows 10 and 31)
    and whose samples pass 0x7FFF (the int16 wrap)."""
    r = np.random.RandomState(seed)
    base = np.add.outer(np.arange(h), np.arange(w)) * 2311
    return [[((base + 9001 * k + 4099 * t + r.randint(0, 3000, (h, w)))
              % 65536).astype(np.uint16) for k in range(3)]
            for t in range(n)]


def _stream16(context_model):
    """A 16-bit GOP of the host encoder: two streams x two frames of
    16x12 yuv444p16le, 4 slices (8x6 per lane)."""
    w, h = 16, 12
    params = EncoderParams(width=w, height=h, pix_fmt="yuv444p16le",
                           level=3, coder=2, slices=4, gop_size=2,
                           context_model=context_model)
    frames = [_frames16(w, h, 2, seed=40 + s) for s in range(2)]
    encs = [FFV1Encoder(params) for _ in range(2)]
    pkts = [[e.encode_frame(f)[0] for f in fr] for e, fr in zip(encs, frames)]
    return w, h, encs[0].extradata, frames, pkts


@pytest.fixture(scope="module")
def stream16():
    return _stream16(0)


def _ext_16bit(stream, five):
    w, h, extradata, frames, pkts = stream
    dec = TorchFFV1Decoder(w, h, extradata, batch=2, device="cpu")
    args, specs = _lane_args(dec, [p[0] for p in pkts], None)
    got = _compare(args, specs, 16, five)
    want = frames[0][0][0][:6, :8].astype(np.int32)
    assert np.array_equal(got[0][0][0].numpy() & 0xFFFF, want)
    assert (got[0][0].numpy() < 0).any(), "no sample went through the wrap"
    args, specs = _lane_args(dec, [p[1] for p in pkts], got[1])
    _compare(args, specs, 16, five)


def test_ext_matches_xla_lanes_16bit(stream16):
    """K2-ext's plain version at 16 bits, key frame then a non-key frame
    from the states the first returned: planes (int16-wrapped), states,
    low, range and pos equal the XLA lane decoder's."""
    _ext_16bit(stream16, False)


def test_five_ext_matches_xla_lanes_16bit():
    """K2-ext-five's plain version: a context-model-1 GOP at 16 bits
    (the extradata's 2 x 5,063-row table; LL and TT int16-wrapped)."""
    _ext_16bit(_stream16(1), True)


def test_ext_matches_xla_lanes_on_damaged_16bit_stream(stream16):
    w, h, extradata, _frames, pkts = stream16
    bad = [bytearray(p[0]) for p in pkts]
    for b in bad:
        for off in (20, 21, 22):               # inside the first slice
            b[off] ^= 0xA5
    dec = TorchFFV1Decoder(w, h, extradata, batch=2, device="cpu")
    args, specs = _lane_args(dec, [bytes(b) for b in bad], None)
    _compare(args, specs, 16)


def _plain_12bit(context_model):
    """12 bits, a width no planar format codes: one 16x12 plane per lane
    encoded by the port's stencil + K1-ext's plain version + finalize,
    decoded losslessly by K2-ext's plain version and the XLA decoder."""
    from tpu_ffv1.core import tables as T
    from tpu_ffv1.core.rac import custom_state_tables
    from tpu_ffv1_torch.tpu.finalize import finalize_packed_full
    from tpu_ffv1_torch.tpu.rc_encode import rc_encode_packed
    from tpu_ffv1_torch.tpu.residual import residuals_and_contexts
    L, w, h, bits = 3, 16, 12, 12
    five = context_model == 1
    r = np.random.RandomState(12)
    samples = ((np.add.outer(np.arange(h), np.arange(w)) * 97 +
                r.randint(0, 1500, (L, h, w))) % 4096).astype(np.int32)
    qt = torch.from_numpy(
        T.default_quant_tables(bits)[context_model].astype(np.int32))
    ctx, diff = residuals_and_contexts(torch.from_numpy(samples), qt, bits,
                                       five)
    cc = T.CONTEXT_COUNTS[context_model]
    one, zero = (torch.from_numpy(t)
                 for t in custom_state_tables(T.VER2_STATE))
    states = torch.full((L, cc, 32), 128, dtype=torch.uint8)
    packed, low, rng, _st = rc_encode_packed(
        ctx.reshape(L, -1), diff.reshape(L, -1),
        torch.ones((L, h * w), dtype=torch.bool), states, one, zero,
        torch.zeros(L, dtype=torch.int32),
        torch.full((L,), 0xFF00, dtype=torch.int32), bits)
    out, count = finalize_packed_full(packed, low, rng,
                                      torch.zeros((L, 1), dtype=torch.int32),
                                      torch.zeros(L, dtype=torch.int32))
    cap = 4096
    bufs = torch.zeros((L, cap), dtype=torch.uint8)
    for lane in range(L):
        bufs[lane, :int(count[lane])] = out[lane, :int(count[lane])]
    low0 = (bufs[:, 0].int() << 8) | bufs[:, 1].int()
    args = (bufs, states, one, zero, qt, low0,
            torch.full((L,), 0xFF00, dtype=torch.int32),
            torch.full((L,), 2, dtype=torch.int32))
    got = _compare(args, ((w, h, 0),), bits, five)
    assert np.array_equal(got[0][0].numpy(), samples)


def test_ext_matches_xla_lanes_12bit_plain_encoder_stream():
    _plain_12bit(0)


def test_five_ext_matches_xla_lanes_12bit_plain_encoder_stream():
    _plain_12bit(1)


def _random_bytes_args(bits, CC, model, seed, L=3, cap=1024, pos0=2):
    """Random slice bytes (garbage symbols: exponents up to the width with
    no stop decision, clamped contexts), states from 16..240, and the
    coder started at ``pos0`` (near ``cap``, the reads run past the
    buffer and give 0)."""
    from tpu_ffv1.core import tables as T
    from tpu_ffv1.core.rac import custom_state_tables
    r = np.random.RandomState(seed)
    one, zero = custom_state_tables(T.VER2_STATE)
    bufs = r.randint(0, 256, (L, cap)).astype(np.uint8)
    low0 = np.minimum(bufs[:, pos0 - 2].astype(np.int32) << 8 |
                      bufs[:, pos0 - 1], 0xFEFF)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        bufs, r.randint(16, 241, (L, 2 * CC, 32)).astype(np.uint8), one,
        zero, T.default_quant_tables(bits)[model].astype(np.int32),
        low0.astype(np.int32), np.full(L, 0xFF00, np.int32),
        np.full(L, pos0, np.int32)))


@pytest.mark.parametrize("five", [False, True], ids=["three", "five"])
@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("width", [1, 2, 33])
def test_matches_xla_lanes_on_random_bytes_at_plane_edges(width, bits, five):
    """Plane widths 1 and 2 (x = 0 is also x = w - 1: the row borders)
    and 33 (one past a warp's 32 columns), on random bytes, 3-input and
    5-input contexts."""
    from tpu_ffv1.core import tables as T
    CC = T.CONTEXT_COUNTS[int(five)]
    args = _random_bytes_args(bits, CC, int(five), 7 * width + bits)
    half = (width + 1) // 2
    specs = ((width, 5, 0), (half, 3, CC), (half, 3, CC))
    _compare(args, specs, bits, five)


@pytest.mark.parametrize("five", [False, True], ids=["three", "five"])
@pytest.mark.parametrize("bits", [8, 10])
def test_matches_xla_lanes_with_pos_near_cap(bits, five):
    """The coder starts 8 bytes before the buffer's end, within one
    pixel's worst case of 2 * bits + 1 bytes: reads at pos >= cap give
    0."""
    from tpu_ffv1.core import tables as T
    CC = T.CONTEXT_COUNTS[int(five)]
    cap = 1024
    args = _random_bytes_args(bits, CC, int(five), 103, cap=cap,
                              pos0=cap - 8)
    got = _compare(args, ((16, 4, 0),), bits, five)
    assert (got[4] >= cap).all(), "the reads did not pass the buffer"


def test_stage_probe_full_is_the_plain_version_on_cpu():
    """K2's stage probes have a plain version only for ``full`` (the
    production instance); the stubbed variants time the card."""
    from tpu_ffv1.core import tables as T
    from tpu_ffv1_torch.tpu.rc_decode import (STAGE_VARIANTS,
                                              rc_decode_planes_ref,
                                              rc_decode_stages)
    for five in (False, True):
        CC = T.CONTEXT_COUNTS[int(five)]
        args = _random_bytes_args(8, CC, int(five), 5)
        specs = ((9, 3, 0), (5, 2, CC), (5, 2, CC))
        got = rc_decode_stages(*args, specs, five, "full")
        want = rc_decode_planes_ref(*args, specs, 8, five)
        for a, b in zip(got[0], want[0]):
            assert torch.equal(a, b)
        for a, b in zip(got[1:], want[1:]):
            assert torch.equal(a, b)
        for variant in STAGE_VARIANTS:
            if variant != "full":
                with pytest.raises(NotImplementedError):
                    rc_decode_stages(*args, specs, five, variant)


@pytest.mark.parametrize("five", [False, True], ids=["three", "five"])
def test_ext_stage_probe_full_is_the_plain_version_on_cpu(five):
    """K2-ext's stage probes (built at 16 bits only) have a plain version
    only for ``full`` (the production instance); the stubbed variants
    time the card, and another width has no probes."""
    from tpu_ffv1.core import tables as T
    from tpu_ffv1_torch.tpu.rc_decode import (EXT_STAGE_VARIANTS,
                                              rc_decode_ext_stages)
    CC = T.CONTEXT_COUNTS[int(five)]
    args = _random_bytes_args(16, CC, int(five), 9)
    specs = ((9, 3, 0), (5, 2, CC), (5, 2, CC))
    got = rc_decode_ext_stages(*args, specs, five, "full")
    want = rc_decode_planes(*args, specs, 16, five)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    for variant in EXT_STAGE_VARIANTS:
        if variant != "full":
            with pytest.raises(NotImplementedError):
                rc_decode_ext_stages(*args, specs, five, variant)
    with pytest.raises(NotImplementedError):
        rc_decode_ext_stages(*args, specs, five, "full", bits=12)


@pytest.mark.parametrize("five", [False, True], ids=["three", "five"])
def test_ext_instance_counts_its_shared_memory(five):
    """K2-ext's placement counts what its launcher puts in shared memory
    beside the table (csrc/rc_decode_ext.cu launch): at 16 bits and
    planes 320 wide, the quant tables (3 or 5 x 1 KB), the byte ring and
    the transition pairs (512 B each), one_pow (7 x 256 B) and four int32
    per column.  A table that would fit beside the design before (two
    int32 per column, no ring, no one_pow) but not beside these goes to
    global memory; the largest that fits stays in shared memory."""
    from tpu_ffv1_torch.kernels.build import SMEM_PER_BLOCK
    from tpu_ffv1_torch.tpu.rc_decode import instance
    q = (5 if five else 3) * 1024
    other = q + 512 + 512 + 256 * 7 + 4 * 321 * 4
    before = q + 512 + 2 * 321 * 4
    fit = (SMEM_PER_BLOCK - other) // 32
    name = "rc_decode_ext_five" if five else "rc_decode_ext"
    assert instance(16, five, fit, 320) == name
    assert instance(16, five, fit + 1, 320) == name + "_global"
    only_before = (SMEM_PER_BLOCK - before) // 32
    assert only_before > fit + 1
    assert instance(16, five, only_before, 320) == name + "_global"
    # K2's count at 8 bits stays as it was
    k2 = q + 512 + 512 + 4 * 321 * 4
    assert instance(8, five, (SMEM_PER_BLOCK - k2) // 32, 320) == \
        ("rc_decode_five" if five else "rc_decode")


@pytest.mark.parametrize("bits", [9, 15])
def test_rgb_stage_probe_full_is_the_plain_version_on_cpu(bits):
    """B1's (9 bits) and B1-ext's (15 bits) stage probes have a plain
    version only for ``full`` (rc_decode_rgb_ref, the production
    instance's); the stubbed variants, no_line among them, time the
    card, and other widths and instances have no probes."""
    from tpu_ffv1.core import tables as T
    from tpu_ffv1_torch.tpu import rc_decode as K
    cc = T.CONTEXT_COUNTS[0]
    args = _random_bytes_args(bits, cc, 0, 11 + bits)
    w, h, P = 7, 3, 3
    got = K.rc_decode_rgb_stages(*args, w, h, P, cc, bits, False, "full")
    want = K.rc_decode_rgb_ref(*args, w, h, P, cc, bits, False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    variants = K.EXT_RGB_STAGE_VARIANTS if bits > 10 else \
        K.RGB_STAGE_VARIANTS
    assert "no_line" in variants
    for variant in variants:
        if variant != "full":
            with pytest.raises(NotImplementedError):
                K.rc_decode_rgb_stages(*args, w, h, P, cc, bits, False,
                                       variant)
    other = 10 if bits == 9 else 13
    with pytest.raises(NotImplementedError):
        K.rc_decode_rgb_stages(*_random_bytes_args(other, cc, 0, 1), w, h,
                               P, cc, other, False, "full")
    with pytest.raises(NotImplementedError):      # the 5-input instance
        K.rc_decode_rgb_stages(*_random_bytes_args(bits, cc, 1, 2), w, h,
                               P, cc, bits, True, "full")
