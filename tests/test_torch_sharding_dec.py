"""TorchFFV1Decoder(devices=...) on the CPU (``["cpu"] * n``, as in
test_torch_sharding.py): lossless on host packets at 1, 2 and 8 devices
and at depth 2 over 2, a damaged packet decoded as the unsharded decoder
decodes it, and the three legs of ``__graft_entry__.dryrun_multichip`` at two devices (the
intra GOP and its decode against the host encoder, BASELINE config 5's
10-bit 4:2:2 P-frame GOP against the host FFV1PEncoder), and the P
encoder at 1, 2, 4 and 8 devices on a smaller such GOP.  Every
comparison is exact."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import numpy as np
import pytest

from tpu_ffv1 import EncoderParams, FFV1Encoder
from tpu_ffv1_torch import (TorchFFV1Decoder, TorchFFV1Encoder,
                            TorchFFV1PEncoder)

from .test_sharding import _frames
from .test_torch_sharding import _encode, _host_packets, _params, cpus


@pytest.fixture(scope="module")
def range_coded():
    """Host packets of 64x32 yuv420p at coder 2, batch 2, GOP 2, 2
    frames (tests/test_sharding.py's decode case, cut to a key and a
    non-key frame) and their frames."""
    params = _params(coder=2)
    frames = _frames(64, 32, 2)
    encs = [FFV1Encoder(params, engine="spec") for _ in range(2)]
    pkts = [[e.encode_frame(f)[0] for f in frames] for e in encs]
    return params, frames, pkts, encs[0].extradata


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_decoder_lossless_at_every_device_count(range_coded, ndev):
    _params_, frames, pkts, extradata = range_coded
    dec = TorchFFV1Decoder(64, 32, extradata, batch=2, devices=cpus(ndev))
    for t, f in enumerate(frames):
        got = dec.decode_frames([pkts[0][t], pkts[1][t]])
        assert len(dec.last_groups) == 1
        for planes, kf in got:
            assert kf == (t % 2 == 0)
            assert all(np.array_equal(a, b) for a, b in zip(planes, f))


def test_decoder_depth2_over_two_devices(range_coded):
    """Two submits, then two collects, over 2 devices: lossless, as
    decode_frames."""
    _params_, frames, pkts, extradata = range_coded
    dec = TorchFFV1Decoder(64, 32, extradata, batch=2, devices=cpus(2))
    for t in range(2):
        dec.submit_frames([pkts[0][t], pkts[1][t]])
    for t, f in enumerate(frames):
        for planes, kf in dec.collect_frames():
            assert kf == (t % 2 == 0)
            assert all(np.array_equal(a, b) for a, b in zip(planes, f))


def test_damaged_packet_decodes_as_unsharded(range_coded):
    """A byte flipped in stream 1's slice 2 of frame 1: the planes and
    the damage flags over 2 devices equal the unsharded decoder's."""
    _params_, _frames_, pkts, extradata = range_coded
    bad = bytearray(pkts[1][1])
    bad[len(bad) * 5 // 8] ^= 0x40
    steps = [[pkts[0][0], pkts[1][0]], [pkts[0][1], bytes(bad)]]
    one = TorchFFV1Decoder(64, 32, extradata, batch=2, device="cpu")
    two = TorchFFV1Decoder(64, 32, extradata, batch=2, devices=cpus(2))
    for step in steps:
        a, b = one.decode_frames(step), two.decode_frames(step)
        for (pa, ka), (pb, kb) in zip(a, b):
            assert ka == kb
            assert all(np.array_equal(x, y) for x, y in zip(pa, pb))
        assert np.array_equal(one.slice_damaged, two.slice_damaged)
    assert two.slice_damaged[1].any()


# ----------------------------------------- __graft_entry__'s three legs


def test_dryrun_intra_leg_over_two_devices():
    """dryrun_multichip(2)'s intra leg: a 2 x 2 grid of 16x16 slices,
    yuv420p, coder -2, CRCs, GOP 3, batch 2, 3 frames: the host's
    packets."""
    nh, nv, batch = 2, 2, 2
    W, H = 16 * nh, 32
    params = EncoderParams(width=W, height=H, pix_fmt="yuv420p", level=3,
                           coder=-2, slices=nh * nv, slicecrc=1,
                           gop_size=3)
    rng0 = np.random.RandomState(0)

    def frame(t, b):
        y = ((np.add.outer(np.arange(H), np.arange(W)) * (b + 2) + 7 * t)
             % 256 + rng0.randint(0, 8, (H, W))).astype(np.uint8)
        u = rng0.randint(0, 256, (H // 2, W // 2)).astype(np.uint8)
        v = rng0.randint(0, 256, (H // 2, W // 2)).astype(np.uint8)
        return [y, u, v]
    steps = [[frame(t, b) for b in range(batch)] for t in range(3)]
    streams = [[s[b] for s in steps] for b in range(batch)]
    want = _host_packets(params, streams)
    enc = TorchFFV1Encoder(params, batch=batch, devices=cpus(2))
    assert _encode(enc, streams) == want

    # the decode leg: the same streams, losslessly
    dec = TorchFFV1Decoder(W, H, enc.extradata, batch=batch,
                           devices=cpus(2))
    for t in range(3):
        got = dec.decode_frames([want[b][t][0] for b in range(batch)])
        for b, (planes, _kf) in enumerate(got):
            assert all(np.array_equal(a, p)
                       for a, p in zip(planes, steps[t][b]))


@pytest.fixture(scope="module")
def pframes422():
    """A small 10-bit 4:2:2 P-frame GOP (32x32, 2 x 2 slices, coder 2,
    CRCs, GOP 2, batch 2, a key and a P frame: K1 at 10 bits, K1-ext at
    11) and the host FFV1PEncoder's packets of it."""
    from tpu_ffv1.pframe.codec import FFV1PEncoder
    W, H = 32, 32
    params = EncoderParams(width=W, height=H, pix_fmt="yuv422p10le",
                           level=3, coder=2, slices=4, slicecrc=1,
                           gop_size=2)
    base = (np.add.outer(np.arange(H + 8), np.arange(W + 8)) * 13
            % 1024).astype(np.uint16)
    r = np.random.RandomState(5)

    def frame(t, b):
        return [((base[t:t + H, 2 * t:2 * t + w] + 17 * b +
                  r.randint(0, 4, (H, w))) & 1023).astype(np.uint16)
                for w in (W, W // 2, W // 2)]
    steps = [[frame(t, b) for b in range(2)] for t in range(2)]
    hosts = [FFV1PEncoder(params, experimental=True) for _ in range(2)]
    want = [[hosts[b].encode_frame(steps[t][b]) for b in range(2)]
            for t in range(2)]
    assert [k for _p, k in want[0] + want[1]] == [True, True, False, False]
    return params, steps, want


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_pencoder_packets_invariant_to_device_count(pframes422, ndev):
    """TorchFFV1PEncoder over 1, 2, 4 and 8 devices (8 lanes): the host
    FFV1PEncoder's packets, key and P frame."""
    params, steps, want = pframes422
    enc = TorchFFV1PEncoder(params, batch=2, experimental=True,
                            devices=cpus(ndev))
    for t, frames in enumerate(steps):
        assert enc.encode_frames(frames) == want[t], t


def test_dryrun_config5_leg_over_two_devices():
    """dryrun_multichip(2)'s BASELINE config 5 leg: a 10-bit 4:2:2
    P-frame GOP (64x64, 2 x 2 slices, coder 2, CRCs, GOP 3, batch 2, 3
    frames: K1 at 10 bits, K1-ext at 11) through TorchFFV1PEncoder over 2
    devices: the host FFV1PEncoder's packets."""
    from tpu_ffv1.pframe.codec import FFV1PEncoder
    n = 2
    W5, H5 = 32 * n, 64
    p5 = EncoderParams(width=W5, height=H5, pix_fmt="yuv422p10le", level=3,
                       coder=2, slices=n * 2, slicecrc=1, gop_size=3)
    base5 = (np.add.outer(np.arange(H5 + 16), np.arange(W5 + 16)) * 11
             % 1024).astype(np.uint16)

    def pframe5(t, b):
        y = ((base5[t:t + H5, 2 * t:2 * t + W5] + 31 * b) & 1023) \
            .astype(np.uint16)
        u = ((base5[t:t + H5, t:t + W5 // 2] + 7) & 1023).astype(np.uint16)
        v = ((base5[t:t + H5, 3 * t:3 * t + W5 // 2] + 13) & 1023) \
            .astype(np.uint16)
        return [y, u, v]
    penc = TorchFFV1PEncoder(p5, batch=2, experimental=True,
                             devices=cpus(n))
    hosts = [FFV1PEncoder(p5, experimental=True) for _ in range(2)]
    for t in range(3):
        frames = [pframe5(t, b) for b in range(2)]
        got = penc.encode_frames(frames)
        for b in range(2):
            assert got[b] == hosts[b].encode_frame(frames[b]), (t, b)
