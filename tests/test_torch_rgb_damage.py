"""Damaged RGB streams, and a decode batch whose streams are at different
GOP phases, on device="cpu".

A flipped byte and a damaged slice header in a bgr0 and a gbrp12le
stream: the port flags the slices the host decoder (engine="spec")
flags, conceals them from the previous picture as it does, and gives
its values wherever the host wrote one.  TorchFFV1Decoder(batch=2) on
two planar streams whose keyframes fall on different frames (GOP 3 and
GOP 2): every frame equal to the host decoder's, with the range coder
and with Golomb-Rice, at context models 0 and 1 (a keyframe resets only
its own stream's lanes).  Exact: the codec is integer."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import dataclasses

import numpy as np
import pytest

from tpu_ffv1 import EncoderParams, FFV1Decoder, FFV1Encoder
from tpu_ffv1.codec import decoder as host_decoder
from tpu_ffv1_torch import TorchFFV1Decoder

from .test_torch_codec import _frames
from .test_torch_rgb import H, W, params, rgb_frames


def _rect(g):
    return slice(g.y, g.y + g.height), slice(g.x, g.x + g.width)


def _host_decode(extradata, pkts):
    """The spec engine's frames and slice flags, and per frame the pixels
    it left without a value: those no parsed slice header covers (a
    slice whose header fails writes nothing, ffv1dec.c:282-359), and in
    a concealed rect those without a value in the previous frame.  RGB
    planes are not subsampled, so one (H, W) mask serves every plane
    (and the B, G, R, A array)."""
    parsed = []
    parse = host_decoder.read_slice_header

    def recording(f, ss, c):
        out = parse(f, ss, c)
        parsed.append(dataclasses.replace(ss.geom))
        return out

    host = FFV1Decoder(W, H, extradata, engine="spec")
    res, unknown = [], None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(host_decoder, "read_slice_header", recording)
        for pkt in pkts:
            parsed.clear()
            planes, _kf = host.decode_frame(pkt)
            flags = [bool(ss.slice_damaged)
                     for ss in host.slices[:host.slice_count]]
            new = np.ones((H, W), bool)
            for g in parsed:
                new[_rect(g)] = False
            if unknown is not None:
                for si, flagged in enumerate(flags):
                    r = _rect(host.slices[si].geom)
                    if flagged:
                        new[r] = unknown[r]
            unknown = new
            res.append(([np.array(p) for p in planes], flags, unknown))
    return res


def _check_against_host(extradata, pkts):
    host = _host_decode(extradata, pkts)
    port = TorchFFV1Decoder(W, H, extradata, device="cpu")
    flagged = []
    for k, (want, want_flags, unknown) in enumerate(host):
        planes, _kf = port.decode_frame(pkts[k])
        assert list(port.slice_damaged[0]) == want_flags, f"frame {k}"
        flagged.append(sum(want_flags))
        assert len(planes) == len(want)
        for j, (a, b) in enumerate(zip(planes, want)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a[~unknown], b[~unknown]), \
                f"frame {k} plane {j}"
    return flagged            # per frame: damage persists to the next key


@pytest.fixture(scope="module")
def rgb_streams():
    """Per format: the extradata and packets 0-2 (GOP 12) of 48x32 with
    4 slices, from the host encoder."""
    out = {}
    for pix_fmt in ("bgr0", "gbrp12le"):
        enc = FFV1Encoder(params(pix_fmt, gop=12))
        out[pix_fmt] = (enc.extradata, [enc.encode_frame(f)[0] for f in
                                        rgb_frames(pix_fmt, 3, 8)])
    return out


@pytest.mark.parametrize("pix_fmt", ["bgr0", "gbrp12le"])
def test_flipped_byte_flags_and_conceals_as_host(rgb_streams, pix_fmt):
    extradata, pkts = rgb_streams[pix_fmt]
    bad = bytearray(pkts[1])
    bad[len(bad) // 3] ^= 0x40
    pkts = [pkts[0], bytes(bad), pkts[2]]
    assert _check_against_host(extradata, pkts) == [0, 1, 1]


@pytest.mark.parametrize("t", range(3))
@pytest.mark.parametrize("pix_fmt", ["bgr0", "gbrp12le"])
def test_damaged_slice_header_matches_host(rgb_streams, pix_fmt, t):
    """Slice 1's first 3 bytes in packet 1 replaced by random bytes: the
    port flags what the host flags and gives its values in frames
    0-2."""
    extradata, pkts = rgb_streams[pix_fmt]
    dec = TorchFFV1Decoder(W, H, extradata, device="cpu")
    start = dec._split_slices(pkts[1])[1][0]
    bad = bytearray(pkts[1])
    bad[start:start + 3] = np.random.RandomState(t).randint(
        0, 256, 3).astype(np.uint8).tobytes()
    flagged = _check_against_host(extradata, [pkts[0], bytes(bad), pkts[2]])
    assert flagged[0] == 0 and flagged[1] >= 1


# ---------------------------------------------------------------------------
# a decode batch at different GOP phases


@pytest.mark.parametrize("context_model", [0, 1])
@pytest.mark.parametrize("coder", [2, 0], ids=["range", "golomb"])
def test_batch_streams_at_different_gop_phases(coder, context_model):
    """Two yuv420p streams decoded as one batch: stream 0 with GOP 3
    (keyframes 0 and 3), stream 1 with GOP 2 (keyframes 0 and 2), one
    extradata; each frame equal to the host decoder's on its stream."""
    n = 4
    streams, pkts = [], []
    extradata = None
    for b, gop in enumerate((3, 2)):
        enc = FFV1Encoder(EncoderParams(
            width=48, height=32, pix_fmt="yuv420p", level=3, coder=coder,
            slices=4, gop_size=gop, context_model=context_model))
        assert extradata in (None, enc.extradata)
        extradata = enc.extradata
        frames = _frames(48, 32, n, seed=30 + b)
        streams.append(frames)
        pkts.append([enc.encode_frame(f) for f in frames])
    assert [kf for _p, kf in pkts[0]] == [True, False, False, True]
    assert [kf for _p, kf in pkts[1]] == [True, False, True, False]
    hosts = [FFV1Decoder(48, 32, extradata) for _ in range(2)]
    port = TorchFFV1Decoder(48, 32, extradata, batch=2, device="cpu")
    for t in range(n):
        got = port.decode_frames([pkts[b][t][0] for b in range(2)])
        for b in range(2):
            want, wkf = hosts[b].decode_frame(pkts[b][t][0])
            assert got[b][1] == wkf == pkts[b][t][1]
            for a, w, src in zip(got[b][0], want, streams[b][t]):
                assert np.array_equal(a, w), f"stream {b} frame {t}"
                assert np.array_equal(a, src)
        assert not port.slice_damaged.any()
