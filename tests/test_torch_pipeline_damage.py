"""Damaged streams through TorchFFV1Decoder at depth 2 (two submits,
then a collect before each further submit) on device="cpu".

C3: a slice that only the sentinel check flags (no slice CRC) is known
to the collect, not to the submits that run before it; the two refusals
its flag decides (a slice whose planes name different quant tables;
intact RGB slices that name different tables) must decide as at depth
1.  The wait those refusals may take (``_in_flight_sentinel``) stays
off every stream that names one table, clean or damaged.  And the
damaged-stream check of five configurations: depth 2 equals
decode_frames, which equals FFV1Decoder(engine="spec"), planes and
flags alike, with and without slice CRCs."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import numpy as np
import pytest

from tpu_ffv1 import EncoderParams, FFV1Decoder, FFV1Encoder
from tpu_ffv1_torch import EncoderParams as TorchEncoderParams
from tpu_ffv1_torch import TorchFFV1Decoder, TorchFFV1Encoder
from tpu_ffv1_torch.tpu import encoder as tenc

from .test_torch_mixed_q import _mixed_header
from .test_torch_pframe_dec import _flip
from .util import synth_frames


def _planes(p):
    return [np.asarray(x) for x in (p if isinstance(p, (list, tuple))
                                    else [p])]


def _host_flags(host):
    return [bool(s.slice_damaged) for s in host.slices[:host.slice_count]]


def _depth2(dec, steps):
    """Depth 2: the results in frame order, and each collect's flags."""
    out, flags = [], []
    dec.submit_frames(steps[0])
    for t in range(len(steps)):
        if t + 1 < len(steps):
            dec.submit_frames(steps[t + 1])
        out.append(dec.collect_frames())
        flags.append(dec.slice_damaged.copy())
    return out, flags


def _no_in_flight_wait(monkeypatch):
    """Make ``_in_flight_sentinel``, a host wait inside a submit that
    only a refusal may take, fail the test wherever it is reached."""
    def refuse(self, bi):
        raise AssertionError("_in_flight_sentinel reached on a stream "
                             "that names one quant table")
    monkeypatch.setattr(TorchFFV1Decoder, "_in_flight_sentinel", refuse)


# ------------------------------------------------------------------- C3

W, H = 32, 24


def _planar_packets(mixed_slice):
    """4 frames of a yuv420p stream without slice CRCs, GOP 12: frame 1's
    slice 1 has a payload byte flipped (only the sentinel check sees it),
    and in frames 2 and 3 slice ``mixed_slice``'s header names quant
    tables 0 and 1 for its planes."""
    params = TorchEncoderParams(width=W, height=H, pix_fmt="yuv420p",
                                level=3, coder=2, slices=4, slicecrc=0)
    enc = TorchFFV1Encoder(params, device="cpu")
    target = enc.geoms[mixed_slice]
    write = tenc.write_slice_header
    frames = synth_frames("yuv420p", W, H, 4, seed=21)
    pkts = []
    for t, f in enumerate(frames):
        def header(rp, ss, c, *a, _t=t, **kw):
            if _t >= 2 and (ss.geom.x, ss.geom.y) == (target.x, target.y):
                return _mixed_header(rp, ss, c)
            return write(rp, ss, c, *a, **kw)
        enc._header_cache.clear()
        enc._prefix_cache.clear()
        tenc.write_slice_header = header
        try:
            pkts.append(enc.encode_frame(f)[0])
        finally:
            tenc.write_slice_header = write
    return enc.extradata, pkts


def _rgb_packets(mixed_slice):
    """4 frames of bgr0 without slice CRCs, GOP 12, through host encoders
    at context models 0 and 1 (equal extradata): frame 1's slice 1 has a
    payload byte flipped, and in frames 2 and 3 slice ``mixed_slice``
    comes from the context-model-1 stream (quant table 1), the others
    from the context-model-0 one (table 0)."""
    frames = synth_frames("bgr0", W, H, 4, seed=22)
    encs = [FFV1Encoder(EncoderParams(width=W, height=H, pix_fmt="bgr0",
                                      level=3, coder=2, slices=4,
                                      slicecrc=0, context_model=cm))
            for cm in (0, 1)]
    assert encs[0].extradata == encs[1].extradata
    pk = [[e.encode_frame(f)[0] for f in frames] for e in encs]
    split = TorchFFV1Decoder(W, H, encs[0].extradata,
                             device="cpu")._split_slices
    pkts = []
    for t in range(4):
        if t < 2:
            pkts.append(pk[0][t])
            continue
        out = bytearray()
        for si, (b0, b1) in enumerate(zip(split(pk[0][t]),
                                          split(pk[1][t]))):
            pkt, (start, end) = (pk[1][t], b1) if si == mixed_slice else \
                (pk[0][t], b0)
            out += pkt[:end] if si == 0 else pkt[start:end]
        pkts.append(bytes(out))
    return encs[0].extradata, pkts


@pytest.mark.parametrize("kind", ["planes", "rgb"])
@pytest.mark.parametrize("mixed_slice", [1, 2],
                         ids=["damaged_slice", "intact_slice"])
def test_sentinel_flag_decides_refusals_as_at_depth_1(kind, mixed_slice,
                                                      monkeypatch):
    """Mixed tables in slice 1, which frame 1's sentinel check flags: no
    refusal at depth 1, and none at depth 2, where frame 2 is submitted
    before frame 1's collect (the submit learns the sentinel checks of
    the frames in flight before it refuses; without that, depth 2
    refuses), planes and flags equal to depth 1's.  Mixed tables in
    slice 2, which nothing flags: both depths refuse."""
    extradata, pkts = (_planar_packets if kind == "planes" else
                       _rgb_packets)(mixed_slice)
    split = TorchFFV1Decoder(W, H, extradata, device="cpu")._split_slices
    pkts[1] = _flip(pkts[1], split(pkts[1]), 1)
    steps = [[p] for p in pkts]

    def new():
        return TorchFFV1Decoder(W, H, extradata, device="cpu")
    if mixed_slice == 2:
        seq = new()
        with pytest.raises(NotImplementedError):
            for step in steps:
                seq.decode_frames(step)
        with pytest.raises(NotImplementedError):
            _depth2(new(), steps)
        return
    seq = new()
    want = []
    for t, step in enumerate(steps):
        want.append((seq.decode_frames(step), seq.slice_damaged.copy()))
        if t == 1:
            # only the sentinel check flags the flipped slice
            assert not seq.crc_failed.any() and seq.slice_damaged[0, 1]
    got, flags = _depth2(new(), steps)
    for t, ((w, wf), g, f) in enumerate(zip(want, got, flags)):
        assert np.array_equal(f, wf), t
        assert g[0][1] == w[0][1]
        for a, b in zip(_planes(g[0][0]), _planes(w[0][0])):
            assert np.array_equal(a, b), t
    monkeypatch.setattr(TorchFFV1Decoder, "_in_flight_sentinel",
                        lambda self, bi: np.zeros(self.n_slices, bool))
    with pytest.raises(NotImplementedError):
        _depth2(new(), steps)


CLEAN = {"yuv420p-range": ("yuv420p", 2), "yuv420p-golomb": ("yuv420p", 0),
         "bgr0": ("bgr0", 2)}


@pytest.mark.parametrize("case", sorted(CLEAN))
def test_clean_stream_never_waits_in_a_submit(case, monkeypatch):
    """A clean stream at depth 2 (batch 2, 4 frames at GOP 3: the
    keyframe hand-over with a frame in flight): neither refusal's check
    runs, so no submit waits on the card; every frame equals
    FFV1Decoder(engine="spec")'s, no slice flagged."""
    pix_fmt, coder = CLEAN[case]
    params = EncoderParams(width=W, height=H, pix_fmt=pix_fmt, level=3,
                           coder=coder, slices=4, gop_size=3, slicecrc=0)
    encs = [FFV1Encoder(params) for _ in range(2)]
    pkts = [[e.encode_frame(f)[0]
             for f in synth_frames(pix_fmt, W, H, 4, seed=40 + b)]
            for b, e in enumerate(encs)]
    steps = [[s[t] for s in pkts] for t in range(4)]
    extradata = encs[0].extradata
    _no_in_flight_wait(monkeypatch)
    got, flags = _depth2(TorchFFV1Decoder(W, H, extradata, batch=2,
                                          device="cpu"), steps)
    hosts = [FFV1Decoder(W, H, extradata, engine="spec") for _ in range(2)]
    for t, step in enumerate(steps):
        assert not flags[t].any(), t
        for b in range(2):
            host_planes, host_kf = hosts[b].decode_frame(step[b])
            assert got[t][b][1] == host_kf == (t % 3 == 0)
            for g, x in zip(_planes(got[t][b][0]), _planes(host_planes)):
                assert np.array_equal(g, x), (t, b)


# ------------------------------------------------- damaged-stream check

CASES = {
    "yuv420p-range": dict(pix_fmt="yuv420p", coder=2),
    "yuv420p-golomb": dict(pix_fmt="yuv420p", coder=0),
    "bgr0": dict(pix_fmt="bgr0", coder=2),
    "yuv420p-nonuniform": dict(pix_fmt="yuv420p", coder=2, slices=6,
                               width=50, height=40),
    "gbrp10le-v4-context1": dict(pix_fmt="gbrp10le", coder=2, level=4,
                                 strict=-2, context_model=1),
}


@pytest.mark.parametrize("slicecrc", [1, 0], ids=["crc", "no_crc"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_damaged_streams_depth2_match_host(case, slicecrc, monkeypatch):
    """Batch 2, 6 frames at GOP 3, one payload byte flipped in frame 1
    (stream 0, slice 1) and in frame 4 (stream 1, slice 0): every
    frame's planes and flags at depth 2 equal decode_frames', and those
    equal the host decoder's.  One table throughout, so no submit takes
    the refusals' wait (``_no_in_flight_wait``)."""
    kw = dict(dict(width=W, height=H, level=3, slices=4), **CASES[case])
    w, h = kw["width"], kw["height"]
    params = EncoderParams(gop_size=3, slicecrc=slicecrc, **kw)
    streams = [synth_frames(kw["pix_fmt"], w, h, 6, seed=30 + b)
               for b in range(2)]
    encs = [FFV1Encoder(params) for _ in range(2)]
    pkts = [[e.encode_frame(f)[0] for f in s] for e, s in zip(encs, streams)]
    extradata = encs[0].extradata
    split = TorchFFV1Decoder(w, h, extradata, device="cpu")._split_slices
    for b, t, si in ((0, 1, 1), (1, 4, 0)):
        pkts[b][t] = _flip(pkts[b][t], split(pkts[b][t]), si)
    steps = [[s[t] for s in pkts] for t in range(6)]
    _no_in_flight_wait(monkeypatch)
    seq = TorchFFV1Decoder(w, h, extradata, batch=2, device="cpu")
    got, flags = _depth2(TorchFFV1Decoder(w, h, extradata, batch=2,
                                          device="cpu"), steps)
    hosts = [FFV1Decoder(w, h, extradata, engine="spec") for _ in range(2)]
    flagged = False
    for t, step in enumerate(steps):
        want = seq.decode_frames(step)
        flagged |= seq.slice_damaged.any()
        assert np.array_equal(flags[t], seq.slice_damaged), t
        for b in range(2):
            host_planes, host_kf = hosts[b].decode_frame(step[b])
            assert got[t][b][1] == want[b][1] == host_kf
            assert list(seq.slice_damaged[b]) == _host_flags(hosts[b]), \
                (t, b)
            for g, s, x in zip(_planes(got[t][b][0]), _planes(want[b][0]),
                               _planes(host_planes)):
                assert np.array_equal(g, s), (t, b)
                assert np.array_equal(s, x), (t, b)
    # the CRC flags every flip (the Golomb-Rice path has no sentinel
    # check, so without CRCs its slices decode what the bytes say)
    assert flagged or not slicecrc
