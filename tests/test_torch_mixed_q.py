"""Packets whose slices name different quant tables, in the port's
decoder on device="cpu", against FFV1Decoder(engine="spec").

Two host encoders at context models 0 and 1 write equal extradata, so a
packet of one's even slices and the other's odd ones
(chip_smoke.splice_packets) is a valid stream whose lanes decode in
groups by (plane geometry, quant table).  Also: a lane that switches
tables on a non-key frame (its states restart as the host's do), and the
refusals the port keeps: a slice whose planes name different tables
(R6), Golomb-Rice (R7) and RGB with mixed tables, Golomb-Rice and RGB on
non-uniform grids.  Every comparison is exact."""
import numpy as np
import pytest

import chip_smoke
from .util import synth_frames
from tpu_ffv1 import EncoderParams, FFV1Decoder, FFV1Encoder
from tpu_ffv1_torch import TorchFFV1Decoder, TorchFFV1Encoder
from tpu_ffv1_torch.bitstream.symbols import put_symbol
from tpu_ffv1_torch.tpu import decoder as port_decoder
from tpu_ffv1_torch.tpu import encoder as tenc


def _params(pix_fmt, w, h, slices, cm, gop=12, coder=2):
    return EncoderParams(width=w, height=h, pix_fmt=pix_fmt, level=3,
                         coder=coder, slices=slices, gop_size=gop,
                         context_model=cm)


def _two_models(pix_fmt, w, h, slices, n, seed, coder=2, gop=12):
    """The same frames through host encoders at context models 0 and 1:
    (frames, packets at model 0, packets at model 1, extradata)."""
    frames = synth_frames(pix_fmt, w, h, n, seed=seed)
    encs = [FFV1Encoder(_params(pix_fmt, w, h, slices, cm, gop, coder))
            for cm in (0, 1)]
    assert encs[0].extradata == encs[1].extradata
    pk = [[e.encode_frame(f)[0] for f in frames] for e in encs]
    return frames, pk[0], pk[1], encs[0].extradata


def _host_flags(host):
    return [bool(ss.slice_damaged) for ss in host.slices[:host.slice_count]]


@pytest.mark.parametrize("w,h,slices", [(48, 40, 4), (50, 40, 6)],
                         ids=["uniform", "nonuniform"])
def test_splice_matches_host(w, h, slices):
    """batch 2: stream 0 the spliced packets (even slices at table 0, odd
    at table 1), stream 1 context model 1's own; 4 frames of a GOP of
    12.  Planes and flags equal the host decoder's, and the decode is
    lossless."""
    frames, pk0, pk1, extradata = _two_models("yuv420p", w, h, slices, 4,
                                              seed=80)
    port = TorchFFV1Decoder(w, h, extradata, batch=2, device="cpu")
    spliced = [chip_smoke.splice_packets(port, a, b)
               for a, b in zip(pk0, pk1)]
    streams = [spliced, pk1]
    hosts = [FFV1Decoder(w, h, extradata, engine="spec") for _ in range(2)]
    for t in range(4):
        got = port.decode_frames([s[t] for s in streams])
        for b in range(2):
            want, kf = hosts[b].decode_frame(streams[b][t])
            assert got[b][1] == kf == (t == 0)
            assert list(port.slice_damaged[b]) == _host_flags(hosts[b])
            for a, wp, src in zip(got[b][0], want, frames[t]):
                assert np.array_equal(a, wp), f"stream {b} frame {t}"
                assert np.array_equal(a, src)
        assert not port.slice_damaged.any()
        assert {q for _l, _d, q in port.last_groups} == {0, 1}


def test_table_switch_on_non_key_frame_restarts_states(monkeypatch):
    """Slice 1 of a 6-slice 50x40 stream names table 0 in frame 0 (key),
    table 1 in frame 1 and table 0 again in frame 2 (non-key frames; its
    coder's states came from the other encoder).  The host starts such a
    plane from 128s, as the context count changes
    (codec/decoder.py:238-276 of the JAX package): so do the port's
    lane's states at each switch, and its planes and slice flags equal
    the host's in every frame, though the decode is not lossless
    there."""
    w, h, slices = 50, 40, 6
    _frames, pk0, pk1, extradata = _two_models("yuv420p", w, h, slices, 3,
                                               seed=81)
    port = TorchFFV1Decoder(w, h, extradata, device="cpu")
    bounds0 = [port._split_slices(p) for p in pk0]
    bounds1 = [port._split_slices(p) for p in pk1]

    def packet(t, odd_from_1):
        out = bytearray()
        for si in range(slices):
            use1 = si == 1 and odd_from_1
            pkt, (start, end) = (pk1[t], bounds1[t][si]) if use1 else \
                (pk0[t], bounds0[t][si])
            out += pkt[:end] if si == 0 else pkt[start:end]
        return bytes(out)

    starts = []
    groups = port_decoder.rc_decode_groups

    def spy(bufs, states, *args):
        starts.append(states[1].clone())
        return groups(bufs, states, *args)

    monkeypatch.setattr(port_decoder, "rc_decode_groups", spy)
    pkts = [packet(0, False), packet(1, True), packet(2, False)]
    host = FFV1Decoder(w, h, extradata, engine="spec")
    cc = port.g.context_counts
    for t, pkt in enumerate(pkts):
        got, _kf = port.decode_frame(pkt)
        want, _kf = host.decode_frame(pkt)
        assert list(port.slice_damaged[0]) == _host_flags(host), t
        for a, b in zip(got, want):
            assert np.array_equal(a, b), f"frame {t}"
        q = 1 if t == 1 else 0
        assert port.lane_rows[1] == 2 * cc[q]
        assert [ps.context_count for ps in host.slices[1].planes] == \
            [cc[q]] * 2
        if t:
            # the lane's rows at the switch: 128s, as the host's
            assert (starts[t][:2 * cc[q]] == 128).all(), f"frame {t}"
    assert port.slice_damaged[0, 1]


def test_placement_maps_stay_one_per_grid():
    """batch 2, every frame a keyframe, 8 frames of a 6-slice 50x40
    stream, each frame with its own pattern of tables (slice si from
    context model 1 where bit si of the pattern is set): the placement
    maps are built once, at the first frame, and serve every pattern, so
    the decoder holds no state per pattern; planes and flags equal the
    host decoder's, and the decode is lossless."""
    w, h, slices, n = 50, 40, 6, 8
    frames, pk0, pk1, extradata = _two_models("yuv420p", w, h, slices, n,
                                              seed=83, gop=1)
    port = TorchFFV1Decoder(w, h, extradata, batch=2, device="cpu")
    bounds = [[port._split_slices(p) for p in pk] for pk in (pk0, pk1)]

    def packet(t, pattern):
        out = bytearray()
        for si in range(slices):
            m = (pattern >> si) & 1
            pkt, (start, end) = (pk0, pk1)[m][t], bounds[m][t][si]
            out += pkt[:end] if si == 0 else pkt[start:end]
        return bytes(out)

    patterns = [0b000000, 0b101010, 0b010101, 0b111111, 0b000111,
                0b110000, 0b011011, 0b100101]
    hosts = [FFV1Decoder(w, h, extradata, engine="spec") for _ in range(2)]
    maps = None
    for t, pattern in enumerate(patterns):
        pkts = [packet(t, pattern), packet(t, pattern ^ 0b111111)]
        got = port.decode_frames(pkts)
        maps = maps or port._place_static
        assert port._place_static is maps, t
        for b in range(2):
            want, _kf = hosts[b].decode_frame(pkts[b])
            assert list(port.slice_damaged[b]) == _host_flags(hosts[b])
            for a, wp, src in zip(got[b][0], want, frames[t]):
                assert np.array_equal(a, wp), f"stream {b} frame {t}"
                assert np.array_equal(a, src)
        assert not port.slice_damaged.any()
    assert len(maps) == 3


def _mixed_header(rp, ss, c, *a, **kw):
    """A slice header (write_slice_header's fields) whose planes name
    tables 0 and 1."""
    states = np.full((32,), 128, np.uint8)
    g = ss.geom
    put_symbol(c, states, (g.x + 1) * rp.num_h_slices // rp.width, False)
    put_symbol(c, states, (g.y + 1) * rp.num_v_slices // rp.height, False)
    put_symbol(c, states,
               (g.width + 1) * rp.num_h_slices // rp.width - 1, False)
    put_symbol(c, states,
               (g.height + 1) * rp.num_v_slices // rp.height - 1, False)
    for i in range(rp.plane_count):
        put_symbol(c, states, i % 2, False)
    put_symbol(c, states, 3, False)
    put_symbol(c, states, rp.sar[0], False)
    put_symbol(c, states, rp.sar[1], False)


def test_mixed_tables_within_a_slice_raise(monkeypatch):
    """R6: the reference reads only a slice's first quant table index;
    the port refuses a slice whose planes name different ones."""
    params = _params("yuv420p", 48, 40, 4, 0)
    monkeypatch.setattr(tenc, "write_slice_header", _mixed_header)
    enc = TorchFFV1Encoder(params, device="cpu")
    pkt, _kf = enc.encode_frame(synth_frames("yuv420p", 48, 40, 1)[0])
    dec = TorchFFV1Decoder(48, 40, enc.extradata, device="cpu")
    with pytest.raises(NotImplementedError):
        dec.decode_frame(pkt)


@pytest.mark.parametrize("pix_fmt,coder", [("yuv420p", 0), ("bgr0", 2)],
                         ids=["golomb", "rgb"])
def test_mixed_tables_golomb_and_rgb_raise(pix_fmt, coder):
    """R7 (Golomb-Rice) and RGB: the reference's fallback has no branch
    for them (decoder.py:377-383 of the JAX package); the port raises on
    a spliced packet."""
    _f, pk0, pk1, extradata = _two_models(pix_fmt, 48, 40, 4, 1, seed=82,
                                          coder=coder)
    dec = TorchFFV1Decoder(48, 40, extradata, device="cpu")
    with pytest.raises(NotImplementedError):
        dec.decode_frame(chip_smoke.splice_packets(dec, pk0[0], pk1[0]))


@pytest.mark.parametrize("pix_fmt,coder", [("yuv420p", 0), ("bgr0", 2)],
                         ids=["golomb", "rgb"])
def test_nonuniform_golomb_and_rgb_decoders_raise(pix_fmt, coder):
    """Golomb-Rice and RGB on a non-uniform grid stay refused, as in the
    reference (decoder.py:160-163, 187-190 of the JAX package)."""
    extradata = FFV1Encoder(_params(pix_fmt, 50, 40, 6, 0,
                                    coder=coder)).extradata
    with pytest.raises(NotImplementedError):
        TorchFFV1Decoder(50, 40, extradata, device="cpu")
