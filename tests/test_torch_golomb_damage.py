"""Damaged Golomb-Rice slice headers: the port against the host decoder
(spec engine), not against TPUFFV1Decoder, which departs from the host
here (ROADMAP.md queue C).  The method of test_torch_codec.py's
test_damaged_slice_header_matches_host: the slice's first 3 bytes in
packet 1 of a GOP-12 stream (48x40 yuv420p, 4 slices, coder 0) replaced
by np.random.RandomState(t).randint(0, 256, 3), frames 0-3, slices 0 and
1, context models 0 and 1; the 12 seeds' streams decode in the port as
one batch of 12 independent streams.  The port's slice-header parse
hands no geometry to a lane and gives no quant table for a failed
header, and a slice whose header fails keeps its VLC states."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import numpy as np
import pytest

from .test_torch_codec import _frames, _host_decode
from tpu_ffv1 import EncoderParams, FFV1Encoder
from tpu_ffv1_torch import TorchFFV1Decoder

DAMAGES = [
    # (label, context model, damaged slice)
    ("slice0_ctx0", 0, 0),          # slice 0's header, after the key bit
    ("slice1_ctx0", 0, 1),
    ("slice0_ctx1", 1, 0),
    ("slice1_ctx1", 1, 1),
]
DAMAGE_SEEDS = range(12)


@pytest.fixture(scope="module")
def port_runs():
    """Per damage: the extradata, the 12 seeds' packets 0-3 (GOP 12) of
    48x40 yuv420p with 4 slices in Golomb-Rice, packet 1 damaged by
    seed t in stream t, and, per frame, the planes and slice flags a
    TorchFFV1Decoder gives for each stream, the 12 streams decoded in
    lockstep as one batch (48 lanes)."""
    out = {}
    for label, cm, si in DAMAGES:
        enc = FFV1Encoder(EncoderParams(
            width=48, height=40, pix_fmt="yuv420p", level=3, coder=0,
            slices=4, gop_size=12, context_model=cm))
        pkts = [enc.encode_frame(f)[0] for f in _frames(48, 40, 4, seed=8)]
        port = TorchFFV1Decoder(48, 40, enc.extradata,
                                batch=len(DAMAGE_SEEDS), device="cpu")
        assert port.golomb
        start = port._split_slices(pkts[1])[si][0]
        streams = []
        for t in DAMAGE_SEEDS:
            bad = bytearray(pkts[1])
            bad[start:start + 3] = np.random.RandomState(t).randint(
                0, 256, 3).astype(np.uint8).tobytes()
            streams.append([pkts[0], bytes(bad), *pkts[2:]])
        frames = []
        for k in range(4):
            res = port.decode_frames([s[k] for s in streams])
            frames.append(([planes for planes, _kf in res],
                           port.slice_damaged.copy()))
        out[label] = (enc.extradata, streams, frames)
    return out


@pytest.mark.parametrize("t", DAMAGE_SEEDS)
@pytest.mark.parametrize("label", [d[0] for d in DAMAGES])
def test_golomb_damaged_slice_header_matches_host(port_runs, label, t):
    """The port decodes on, flags the slices the host flags, and gives
    the host's planes wherever the host wrote a value, in frames 0-3."""
    extradata, streams, frames = port_runs[label]
    host = _host_decode(extradata, streams[t])
    for k, ((want, want_flags, unknown), (planes, flags)) in enumerate(
            zip(host, frames)):
        assert list(flags[t]) == want_flags, f"frame {k}"
        for j, (a, b, u) in enumerate(zip(planes[t], want, unknown)):
            assert np.array_equal(a[~u], b[~u]), f"frame {k} plane {j}"
