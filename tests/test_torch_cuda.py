"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same CUDA tensors (exact: integer codec), and the slice
end to end against the host encoder.  Marked ``cuda``; each test skips
where torch.cuda.is_available() is False (this file imports no jax, so
it runs on a machine without it: FFV1_TEST_NO_CACHE=1 python -m pytest
tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from tpu_ffv1 import EncoderParams, FFV1Encoder
from tpu_ffv1.core import tables as T
from tpu_ffv1.core.rac import custom_state_tables

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


@pytest.mark.parametrize("bits", [8, 10, 11, 16, 17])
def test_rc_encode_kernel_matches_plain(cuda, bits):
    from tpu_ffv1_torch.tpu import rc_encode as K
    r = np.random.RandomState(bits)
    L, N, CC = 5, 700, 2 * T.CONTEXT_COUNTS[0]
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
    ext = bits > 10
    counter = "LAUNCHES_EXT" if ext else "LAUNCHES"
    before = getattr(K, counter)
    got = K.rc_encode_packed(*args, bits)
    assert getattr(K, counter) == before + 1
    ref = K.rc_encode_packed_ext_ref if ext else K.rc_encode_packed_ref
    want = ref(*args, bits)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_rc_decode_kernel_matches_plain(cuda):
    from tpu_ffv1_torch.tpu import rc_decode as K
    from tpu_ffv1_torch.tpu.decoder import TorchFFV1Decoder
    w, h = 96, 64
    params = EncoderParams(width=w, height=h, pix_fmt="yuv420p", level=3,
                           coder=2, slices=4)
    enc = FFV1Encoder(params)
    pkt = enc.encode_frame(_frames(w, h, 1, 1)[0])[0]
    dec = TorchFFV1Decoder(w, h, enc.extradata, device=cuda)
    parsed = [dec._parse_packet(0, pkt)]
    (bufs, lows, ranges, poss), _lens, q = dec._lane_inputs(parsed)
    cc = dec.g.context_counts[q]
    specs = tuple((pw, ph, sp * cc) for (pw, ph, sp) in dec._plane_specs())
    states = dec._reset_lane_states([True], q)
    args = (bufs, states, dec.one_tab, dec.zero_tab, dec.qts[q], lows,
            ranges, poss, specs, 8)
    before = K.LAUNCHES
    got = K.rc_decode_planes(*args)
    assert K.LAUNCHES == before + 1
    want = K.rc_decode_planes_ref(*args)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bits", [11, 16, 17])
def test_rc_decode_ext_kernel_matches_plain(cuda, bits):
    """K2-ext on random bytes (garbage symbols reach every row cap, the
    int16 wrap at 16 bits, reads past the buffer) at a 40-pixel-wide
    plane, so the decoded rows span two warps' worth of columns."""
    from tpu_ffv1_torch.tpu import rc_decode as K
    r = np.random.RandomState(bits)
    L, cap, CC = 5, 2048, T.CONTEXT_COUNTS[0]
    one, zero = custom_state_tables(T.VER2_STATE)
    bufs = r.randint(0, 256, (L, cap)).astype(np.uint8)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (
        bufs, r.randint(16, 241, (L, 2 * CC, 32)).astype(np.uint8), one,
        zero, T.default_quant_tables(bits)[0].astype(np.int32),
        np.minimum(bufs[:, 0].astype(np.int32) << 8 | bufs[:, 1], 0xFEFF),
        np.full(L, 0xFF00, np.int32), np.full(L, 2, np.int32))]
    specs = ((40, 6, 0), (20, 6, CC), (20, 6, CC))
    before = K.LAUNCHES_EXT
    got = K.rc_decode_planes(*args, specs, bits)
    assert K.LAUNCHES_EXT == before + 1
    want = K.rc_decode_planes_ext_ref(*args, specs, bits)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)


def test_16bit_slice_on_cuda_matches_host(cuda):
    """yuv444p16le through K1-ext and K2-ext: the host encoder's bytes
    and a lossless decode."""
    from tpu_ffv1_torch import TorchFFV1Decoder, TorchFFV1Encoder
    w, h = 64, 48
    params = EncoderParams(width=w, height=h, pix_fmt="yuv444p16le",
                           level=3, coder=2, slices=4, gop_size=2)
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


def test_slice_on_cuda_matches_host(cuda):
    from tpu_ffv1_torch import TorchFFV1Decoder, TorchFFV1Encoder
    w, h = 96, 64
    params = EncoderParams(width=w, height=h, pix_fmt="yuv420p", level=3,
                           coder=2, slices=4, gop_size=2)
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
