"""TorchFFV1PDecoder on the CPU (K2's plain version at bits + 1) against
the JAX package's host FFV1PDecoder: lossless on the host encoder's
streams at batch 1 and 2 and at context model 1, and on a damaged P
packet the same slice flags and planes, frame after frame through the
GOP (a slice whose CRC fails keeps the previous picture; without CRCs a
flipped byte gives whatever the host's decode gives, flagged by the
sentinel).  The marker rejection and the refusals raise what the JAX
class raises."""
import numpy as np
import pytest

from tpu_ffv1.pframe.codec import FFV1PDecoder, FFV1PEncoder
from tpu_ffv1.pframe.codec import split_p_extradata
from tpu_ffv1_torch import TorchFFV1PDecoder

from .test_pframe_tpu import H, W, _moving_scene, _params


def _encode(params, frames):
    host = FFV1PEncoder(params, experimental=True)
    return host.extradata, [host.encode_frame(f)[0] for f in frames]


def _port(extradata, batch=1, w=W, h=H):
    return TorchFFV1PDecoder(w, h, extradata, batch=batch, device="cpu")


@pytest.mark.parametrize("kw", [{}, {"context_model": 1, "strict": -2}],
                         ids=["ctx0", "ctx1"])
def test_lossless_and_equal_to_host(kw):
    frames = _moving_scene(n=5)
    extra, pkts = _encode(_params(**kw), frames)
    port = _port(extra)
    host = FFV1PDecoder(W, H, extra)
    for t, pkt in enumerate(pkts):
        planes, key = port.decode_frame(pkt)
        assert key == (t % 3 == 0)
        want, _k = host.decode_frame(pkt)
        for a, b, c in zip(planes, frames[t], want):
            assert a.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert not port.slice_damaged.any()
    assert port.p_bits == 9


def _flip(pkt, slices, si, offset=-6):
    """``pkt`` with one byte of slice ``si``'s payload flipped (a flip in
    a size trailer breaks the slice walk, which raises as the reference
    does)."""
    bad = bytearray(pkt)
    start, end = slices[si]
    bad[(start + end) // 2 + offset] ^= 0x5A
    return bytes(bad)


@pytest.mark.parametrize("slicecrc", [1, 0])
def test_batch_damage_follows_host(slicecrc):
    """Two streams decoded as one batch; stream 0's frame 1 has a byte of
    slice 0 flipped.  With CRCs the slice keeps the previous picture and
    its states, and every later frame equals the host decoder's too (the
    slice decodes from the states it kept, as the host's).  Without CRCs
    it decodes what the bytes say and the sentinel flags it: that frame
    equals the host's; in the later frames of the GOP the slice decodes
    from states that no longer match the stream, where K2's schedule
    (at most ``bits`` exponent decisions) and the host's get_symbol
    (up to 31) read invalid symbols differently, so those frames are
    held outside the slice (ROADMAP.md queue C, R8).  The flags equal
    the host's in every frame, and the other stream stays exact."""
    streams = [_moving_scene(n=6, seed=5), _moving_scene(n=6, seed=11)]
    params = _params(slicecrc=slicecrc)
    coded = [_encode(params, s) for s in streams]
    extra = coded[0][0]
    port = _port(extra, batch=2)
    host = FFV1PDecoder(W, H, extra)
    bad = _flip(coded[0][1][1], port.base._split_slices(coded[0][1][1]), 0)
    pkts0 = [coded[0][1][0], bad] + coded[0][1][2:]
    flagged = []
    g0 = port.base.geoms[0]
    for t in range(6):
        # the slices decoding from states the damage left (none with CRCs)
        stale = port.slice_damaged[0] & (t % 3 != 0) & (slicecrc == 0)
        got = port.decode_frames([pkts0[t], coded[1][1][t]])
        want, _k = host.decode_frame(pkts0[t])
        for k, (a, b) in enumerate(zip(got[0][0], want)):
            b = np.array(b)
            sub = 1 if k else 0       # 4:2:0 chroma
            for si in np.nonzero(stale)[0]:
                g = port.base.geoms[si]
                rect = (slice(g.y >> sub, (g.y + g0.height) >> sub),
                        slice(g.x >> sub, (g.x + g0.width) >> sub))
                b[rect] = a[rect]
            np.testing.assert_array_equal(a, b, f"frame {t}")
        np.testing.assert_array_equal(port.slice_damaged[0],
                                      host.slice_damaged, f"frame {t}")
        flagged.append(bool(port.slice_damaged[0, 0]))
        assert not port.slice_damaged[1].any()
        for a, b in zip(got[1][0], streams[1][t]):
            np.testing.assert_array_equal(a, b)
    # flagged from the damaged frame to the next keyframe (frame 3)
    assert flagged == [False, True, True, False, False, False]


def test_marker_rejected():
    extra, _pkts = _encode(_params(), _moving_scene(n=1))
    with pytest.raises(ValueError, match="marker"):
        _port(split_p_extradata(extra))


def test_first_packet_must_be_a_keyframe():
    extra, pkts = _encode(_params(), _moving_scene(n=2))
    with pytest.raises(ValueError, match="keyframe"):
        _port(extra).decode_frame(pkts[1])
