"""Non-uniform slice grids and the grouped decode (B2) in the port, on
device="cpu": TorchFFV1Decoder against FFV1Decoder(engine="spec") on
test_torch_nonuniform.py's grids and formats, on a batch whose streams
are at different GOP phases and on damaged slice headers (C1, C2), and
``rc_decode_groups`` (one K2-family launch per plane geometry and quant
table) against the JAX package's per-slice scan
``dec_scan.rc_decode_plane``.  Every comparison is exact."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_codec import _host_decode
from .test_torch_nonuniform import CONFIGS, FRAMES, _params
from .util import synth_frames
from tpu_ffv1 import FFV1Decoder, FFV1Encoder
from tpu_ffv1.tpu.dec_scan import rc_decode_plane
from tpu_ffv1_torch import TorchFFV1Decoder
from tpu_ffv1_torch.tpu.rc_decode import rc_decode_groups


@pytest.fixture(scope="module", params=CONFIGS, ids=[c[0] for c in CONFIGS])
def streams(request):
    """Two streams of FRAMES frames, GOP 2, and the host encoder's
    packets of each."""
    _label, pix_fmt, w, h, slices, cm = request.param
    params = _params(pix_fmt, w, h, slices, cm)
    frames = [synth_frames(pix_fmt, w, h, FRAMES, seed=40 + b)
              for b in range(2)]
    pkts = []
    for fr in frames:
        host = FFV1Encoder(params)
        pkts.append([host.encode_frame(f) for f in fr])
    return params, frames, pkts, host.extradata


def test_decoder_matches_host(streams):
    """batch 2: the port's planes and slice flags equal the host spec
    decoder's, and the decode is lossless."""
    params, frames, pkts, extradata = streams
    port = TorchFFV1Decoder(params.width, params.height, extradata,
                            batch=2, device="cpu")
    hosts = [FFV1Decoder(params.width, params.height, extradata,
                         engine="spec") for _ in range(2)]
    assert not port.uniform
    for t in range(FRAMES):
        got = port.decode_frames([pkts[b][t][0] for b in range(2)])
        for b in range(2):
            want, kf = hosts[b].decode_frame(pkts[b][t][0])
            assert got[b][1] == kf == pkts[b][t][1]
            flags = [bool(ss.slice_damaged)
                     for ss in hosts[b].slices[:hosts[b].slice_count]]
            assert list(port.slice_damaged[b]) == flags
            for a, w, src in zip(got[b][0], want, frames[b][t]):
                assert a.dtype == w.dtype and np.array_equal(a, w), \
                    f"stream {b} frame {t}"
                assert np.array_equal(a, src)
    # one launch per slice size, every lane in one of them
    assert sorted(li for lanes, _d, _q in port.last_groups
                  for li in lanes) == list(range(port.L))


def test_batch_streams_at_different_gop_phases():
    """Two 50x40 yuv420p streams on a 6-slice grid at context model 1,
    GOP 3 beside GOP 2 (keyframes on different frames), decoded as one
    batch: each frame equal to the host decoder's and the source."""
    n = 4
    pkts, frames, extradata = [], [], None
    for b, gop in enumerate((3, 2)):
        enc = FFV1Encoder(_params("yuv420p", 50, 40, 6, 1, gop=gop))
        assert extradata in (None, enc.extradata)
        extradata = enc.extradata
        frames.append(synth_frames("yuv420p", 50, 40, n, seed=60 + b))
        pkts.append([enc.encode_frame(f) for f in frames[-1]])
    assert [kf for _p, kf in pkts[0]] == [True, False, False, True]
    assert [kf for _p, kf in pkts[1]] == [True, False, True, False]
    hosts = [FFV1Decoder(50, 40, extradata, engine="spec")
             for _ in range(2)]
    port = TorchFFV1Decoder(50, 40, extradata, batch=2, device="cpu")
    for t in range(n):
        got = port.decode_frames([pkts[b][t][0] for b in range(2)])
        for b in range(2):
            want, wkf = hosts[b].decode_frame(pkts[b][t][0])
            assert got[b][1] == wkf == pkts[b][t][1]
            for a, w, src in zip(got[b][0], want, frames[b][t]):
                assert np.array_equal(a, w), f"stream {b} frame {t}"
                assert np.array_equal(a, src)
        assert not port.slice_damaged.any()


# damaged slice headers (C1, C2) on a non-uniform grid: 50x40 yuv420p in
# 6 slices, packet 1's slice's first 3 bytes overwritten

DAMAGES = [("slice1_ctx1", 1, 1), ("slice0_ctx0", 0, 0),
           ("slice4_ctx0", 0, 4), ("every_slice_ctx0", 0, None)]


@pytest.fixture(scope="module")
def damaged_streams():
    out = {}
    for label, cm, si in DAMAGES:
        enc = FFV1Encoder(_params("yuv420p", 50, 40, 6, cm, gop=12))
        pkts = [enc.encode_frame(f)[0]
                for f in synth_frames("yuv420p", 50, 40, 4, seed=8)]
        port = TorchFFV1Decoder(50, 40, enc.extradata, device="cpu")
        port.decode_frame(pkts[0])
        out[label] = (enc.extradata, pkts, port, si)
    return out


@pytest.mark.parametrize("t", range(6))
@pytest.mark.parametrize("label", [d[0] for d in DAMAGES])
def test_damaged_slice_header_matches_host(damaged_streams, label, t):
    """test_torch_codec's C1 / C2 cases off uniform grids, and every
    slice's header damaged at once: the port flags the slices the host
    flags and gives the host's planes wherever the host wrote a value, in
    frames 0-3 (a concealed rect reaches into the chroma column a
    neighbour shares; a frame whose every header fails decodes no lane)."""
    extradata, pkts, port0, si = damaged_streams[label]
    assert not port0.uniform
    bad = bytearray(pkts[1])
    bounds = port0._split_slices(pkts[1])
    if si is None:
        # three bytes (0, 0, t) fail every header's geometry
        for start, _end in bounds:
            bad[start:start + 3] = bytes((0, 0, t))
    else:
        bad[bounds[si][0]:bounds[si][0] + 3] = np.random.RandomState(
            t).randint(0, 256, 3).astype(np.uint8).tobytes()
    pkts = [pkts[0], bytes(bad), *pkts[2:]]
    host = _host_decode(extradata, pkts, 50, 40)
    port = copy.deepcopy(port0)
    for k, (want, want_flags, unknown) in enumerate(host):
        planes = port.last_planes[0] if k == 0 else \
            port.decode_frame(pkts[k])[0]
        assert list(port.slice_damaged[0]) == want_flags, f"frame {k}"
        for j, (a, b, u) in enumerate(zip(planes, want, unknown)):
            assert np.array_equal(a[~u], b[~u]), f"frame {k} plane {j}"
        if k == 1 and si is None:
            assert port.last_groups == []          # no lane decoded


# B2 against the JAX package's per-slice scan

def _spliced_keyframe(w, h, slices, pix_fmt="yuv420p"):
    """A keyframe whose even slices name quant table 0 and odd ones 1."""
    import chip_smoke
    frame = synth_frames(pix_fmt, w, h, 1, seed=70)[0]
    pk = [FFV1Encoder(_params(pix_fmt, w, h, slices, cm)).encode_frame(
        frame)[0] for cm in (0, 1)]
    ex = FFV1Encoder(_params(pix_fmt, w, h, slices, 0)).extradata
    dec = TorchFFV1Decoder(w, h, ex, device="cpu")
    return dec, chip_smoke.splice_packets(dec, *pk), frame


@pytest.mark.parametrize("pix_fmt,w,h,slices", [
    ("yuv420p", 50, 40, 6), ("yuv444p16le", 26, 21, 4)],
    ids=["yuv420p", "yuv444p16le"])
def test_rc_decode_groups_matches_rc_decode_plane(pix_fmt, w, h, slices):
    """rc_decode_groups on a non-uniform grid with mixed quant tables
    (one launch per plane geometry and table) against the JAX package's
    dec_scan.rc_decode_plane run slice by slice and plane by plane from
    the same parsed coder states: planes, states, low, range and pos."""
    dec, pkt, _frame = _spliced_keyframe(w, h, slices, pix_fmt)
    parsed = [dec._parse_packet(0, pkt)]
    (bufs, lows, ranges, poss), _n = dec._lane_buffers(parsed)
    lane_q = [s[1] for s in parsed[0][1]]
    assert set(lane_q) == {0, 1}
    dec._prepare_states(lane_q, [True], np.zeros(dec.L, bool))
    states0 = dec.states.clone()
    groups = dec._lane_groups(lane_q)
    assert len(groups) >= 3
    planes_g, states, low, rng, pos = rc_decode_groups(
        bufs, states0, dec.one_tab, dec.zero_tab, dec.quant, lows, ranges,
        poss, groups, dec.bits)
    one = jnp.asarray(dec.one_tab.numpy())
    zero = jnp.asarray(dec.zero_tab.numpy())
    for (lanes, dims, q), planes in zip(groups, planes_g):
        qt, cc, five = dec.quant[q]
        rows = dec.n_state_planes * cc
        for k, lane in enumerate(lanes):
            buf, _q, lo, ra, po = parsed[0][1][lane]
            st = jnp.asarray(states0[lane, :rows].numpy())
            lo, ra, po = (jnp.int32(v) for v in (lo, ra, po))
            dbuf = jnp.asarray(np.frombuffer(buf, np.uint8))
            for j, (pw, ph, sp) in enumerate(dims):
                plane, st, lo, ra, po = rc_decode_plane(
                    dbuf, st, one, zero, jnp.asarray(qt.numpy()),
                    jnp.int32(sp * cc), lo, ra, po, pw, ph, dec.bits, five)
                # the port's rows hold 16-bit samples int16-wrapped
                assert np.array_equal(np.asarray(plane) & 0xFFFF,
                                      planes[j][k].numpy() & 0xFFFF), \
                    (lane, j)
            assert np.array_equal(np.asarray(st).reshape(rows, 32),
                                  states[lane, :rows].numpy()), lane
            assert (int(lo), int(ra), int(po)) == (
                int(low[lane]), int(rng[lane]), int(pos[lane])), lane


def test_rc_decode_groups_keeps_lanes_in_no_group():
    """A lane in no group (a failed header's) keeps its states and coder
    state; the others decode as in one launch of all lanes."""
    dec, pkt, _frame = _spliced_keyframe(48, 40, 4)
    parsed = [dec._parse_packet(0, pkt)]
    (bufs, lows, ranges, poss), _n = dec._lane_buffers(parsed)
    lane_q = [s[1] for s in parsed[0][1]]
    dec._prepare_states(lane_q, [True], np.zeros(dec.L, bool))
    dims = dec.slice_dims[0]
    states0 = dec.states.clone()
    full = rc_decode_groups(bufs, states0, dec.one_tab, dec.zero_tab,
                            dec.quant, lows, ranges, poss,
                            [([0, 2], dims, 0), ([1, 3], dims, 1)], dec.bits)
    part = rc_decode_groups(bufs, states0, dec.one_tab, dec.zero_tab,
                            dec.quant, lows, ranges, poss,
                            [([0, 2], dims, 0), ([1], dims, 1)], dec.bits)
    assert torch.equal(part[1][:3], full[1][:3])
    assert torch.equal(part[1][3], states0[3])
    for a, b, a0 in zip(part[2:], full[2:], (lows, ranges, poss)):
        assert torch.equal(a[:3], b[:3]) and a[3] == a0[3]
