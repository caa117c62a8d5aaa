"""TorchFFV1Decoder's submit/collect and device_out on the CPU: depth 2
(two submits, then a collect before each further submit) against its
own decode_frames and the host FFV1Decoder, on clean packets and on
packets with damaged slices across a GOP boundary (tests/test_tpu.py:
253); the transcode chain, device_out into
TorchFFV1Encoder.submit_device_frames with no plane fetched, at 8 and 16
bits against FFV1Encoder on the source frames (:206); and device_out's
refusals and its damage RuntimeError against TPUFFV1Decoder's."""
import numpy as np
import pytest
import torch

from tpu_ffv1 import EncoderParams, FFV1Decoder, FFV1Encoder
from tpu_ffv1.tpu.decoder import TPUFFV1Decoder
from tpu_ffv1_torch import EncoderParams as TorchEncoderParams
from tpu_ffv1_torch import TorchFFV1Decoder, TorchFFV1Encoder

from .test_torch_pframe_dec import _flip
from .util import synth_frames

W, H = 32, 24


def _encode(pix, n, seed, **kw):
    """n frames of each of 2 streams and their host packets (GOP 2)."""
    params = EncoderParams(width=W, height=H, pix_fmt=pix, level=3,
                           coder=2, slices=4, gop_size=2, slicecrc=1, **kw)
    streams = [synth_frames(pix, W, H, n, seed=seed + b) for b in range(2)]
    encs = [FFV1Encoder(params) for _ in range(2)]
    pkts = [[e.encode_frame(f)[0] for f in s] for e, s in zip(encs, streams)]
    return encs[0].extradata, streams, pkts


def _damage(extradata, pkts):
    """Flipped payload bytes: stream 0's slice 1 in frame 1 (concealed
    until the keyframe at 2), stream 1's slice 3 in keyframe 2 and slice
    0 in frame 3, and stream 0's slice 2 in frame 3."""
    split = TorchFFV1Decoder(W, H, extradata, device="cpu")._split_slices
    bad = [list(s) for s in pkts]
    for b, t, si in ((0, 1, 1), (1, 2, 3), (1, 3, 0), (0, 3, 2)):
        bad[b][t] = _flip(bad[b][t], split(bad[b][t]), si)
    return bad


@pytest.mark.parametrize("damaged", [False, True],
                         ids=["clean", "damaged"])
def test_depth2_decode_matches_decode_frames_and_host(damaged):
    """Batch 2, 4 frames (keyframes 0 and 2): at depth 2 each collect
    returns decode_frames' planes and leaves its damage flags, which
    equal the host decoder's planes and flags; damaged slices keep the
    previous picture's rect (the flags of frame t + 1's parse, already
    submitted, do not reach frame t's concealment)."""
    extradata, streams, pkts = _encode("yuv420p", 4, 90)
    if damaged:
        pkts = _damage(extradata, pkts)
    steps = [[s[t] for s in pkts] for t in range(4)]
    hosts = [FFV1Decoder(W, H, extradata, engine="spec") for _ in range(2)]
    seq = TorchFFV1Decoder(W, H, extradata, batch=2, device="cpu")
    pipe = TorchFFV1Decoder(W, H, extradata, batch=2, device="cpu")
    pipe.submit_frames(steps[0])
    for t in range(4):
        if t + 1 < 4:
            pipe.submit_frames(steps[t + 1])
        got = pipe.collect_frames()
        want = seq.decode_frames(steps[t])
        assert np.array_equal(pipe.slice_damaged, seq.slice_damaged), t
        for b in range(2):
            host_planes, host_kf = hosts[b].decode_frame(steps[t][b])
            assert got[b][1] == want[b][1] == host_kf
            host = hosts[b]
            assert [bool(s.slice_damaged)
                     for s in host.slices[:host.slice_count]] == \
                list(seq.slice_damaged[b]), (t, b)
            for k in range(3):
                assert np.array_equal(got[b][0][k], want[b][0][k]), (t, b)
                assert np.array_equal(got[b][0][k],
                                      np.asarray(host_planes[k])), (t, b)
                if not damaged:
                    assert np.array_equal(got[b][0][k], streams[b][t][k])
    assert seq.slice_damaged.any() == damaged


@pytest.mark.parametrize("pix", ["yuv420p", "yuv444p16le"])
def test_transcode_chain_matches_host_encoder(pix):
    """Host packets -> TorchFFV1Decoder(device_out=True) -> the planes,
    on the device in the encoder's dtypes (uint8; int32 at 16 bits, the
    decoder's int16-wrapped samples masked to 0..65535) ->
    submit_device_frames of an encoder at GOP 2, both pipelined: the
    packets FFV1Encoder gives on the source frames, and the only bytes
    fetched per frame are the decoder's (low, range, pos) and the
    encoder's counts, overflow flags and byte slab."""
    w, h = (W, H) if pix == "yuv420p" else (16, 12)
    src = EncoderParams(width=w, height=h, pix_fmt=pix, level=3, coder=2,
                        slices=4)
    frames = synth_frames(pix, w, h, 3, seed=95)
    if pix == "yuv444p16le":
        frames[1][0][:4] |= 0x8000        # samples past the int16 wrap
    enc0 = FFV1Encoder(src)
    pkts = [enc0.encode_frame(f)[0] for f in frames]
    out = EncoderParams(**dict(vars(src), gop_size=2))
    host = FFV1Encoder(out)
    want = [host.encode_frame(f) for f in frames]
    dec = TorchFFV1Decoder(w, h, enc0.extradata, device="cpu",
                           device_out=True)
    enc = TorchFFV1Encoder(TorchEncoderParams(**vars(out)), device="cpu")
    got = []
    dec.submit_frames([pkts[0]])
    for t in range(len(pkts)):
        if t + 1 < len(pkts):
            dec.submit_frames([pkts[t + 1]])
        planes, keyframes = dec.collect_frames()
        assert keyframes == [t == 0]
        dt = torch.uint8 if pix == "yuv420p" else torch.int32
        assert all(p.dtype == dt and p.shape[0] == 1 for p in planes)
        assert all(np.array_equal(p[0].numpy(), f)
                   for p, f in zip(planes, frames[t]))
        enc.submit_device_frames(planes)
        if t:
            got.append(enc.collect_frames()[0])
    got.append(enc.collect_frames()[0])
    assert got == want
    assert dec.pipe.fetched_bytes == len(pkts) * 3 * dec.L * 4
    # out (at most out_cap per lane), counts, overflow
    assert enc.pipe.fetched_bytes <= len(pkts) * enc.L * (enc.out_cap + 5)


@pytest.mark.parametrize("label,kw", [
    ("golomb", dict(pix_fmt="yuv420p", coder=0, width=W)),
    ("rgb", dict(pix_fmt="bgr0", coder=2, width=W)),
    ("nonuniform", dict(pix_fmt="yuv420p", coder=2, width=30)),
])
def test_device_out_refusals_match_jax(label, kw):
    """device_out needs the planar range-coder path on a uniform grid:
    both decoders refuse Golomb-Rice, RGB and a non-uniform grid."""
    extradata = FFV1Encoder(EncoderParams(height=H, level=3, slices=4,
                                          **kw)).extradata
    for cls in (lambda *a, **k: TorchFFV1Decoder(*a, device="cpu", **k),
                TPUFFV1Decoder):
        with pytest.raises(NotImplementedError):
            cls(kw["width"], H, extradata, device_out=True)


def test_device_out_damage_raises_as_jax():
    """A damaged slice in device_out mode raises RuntimeError in the
    collect (no previous picture on the host to conceal from), in both
    decoders at depth 1; the port at depth 2 raises in the damaged
    frame's own collect, not in the one before (TPUFFV1Decoder raises
    there: ROADMAP.md queue C, R9)."""
    extradata, _streams, pkts = _encode("yuv420p", 2, 97)
    split = TorchFFV1Decoder(W, H, extradata, device="cpu")._split_slices
    bad = [pkts[0][0], _flip(pkts[0][1], split(pkts[0][1]), 1)]
    for dec in (TorchFFV1Decoder(W, H, extradata, device="cpu",
                                 device_out=True),
                TPUFFV1Decoder(W, H, extradata, device_out=True)):
        planes, keyframes = dec.decode_frames([bad[0]])
        assert keyframes == [True] and len(planes) == 3
        with pytest.raises(RuntimeError, match="damaged slice"):
            dec.decode_frames([bad[1]])
    dec = TorchFFV1Decoder(W, H, extradata, device="cpu", device_out=True)
    dec.submit_frames([bad[0]])
    dec.submit_frames([bad[1]])
    planes, keyframes = dec.collect_frames()
    assert keyframes == [True] and len(planes) == 3
    with pytest.raises(RuntimeError, match="damaged slice"):
        dec.collect_frames()
