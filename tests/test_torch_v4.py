"""Version 4 (level 4: the per-slice RCT search, slice_reset_contexts and
the row-budget PCM retry) in the port, on device="cpu".

The mirror of tests/test_tpu_v4.py for TorchFFV1Encoder and
TorchFFV1Decoder, held to TPUFFV1Encoder, TPUFFV1Decoder and the host
engines: the search's cost sums and picks (rct_search.py) against the
JAX package's and the host's on adversarial 16-bit crops; the PCM retry
on the reference test's content (1024x4 yuv444p16le noise, every slice
over its budget) and on a batch of two streams in which only one
stream's slices retry and a non-key frame continues from the reset
states; the decoder's lane reset, a damaged v4 slice header and a GOP
begun in the JAX classes.  The format matrix (bgr0, bgra, gbrp10le,
gbrp14le, yuv444p10le, yuv444p16le, yuv420p, gray, Golomb-Rice at 8
bits; context models 0 and 1; GOP 2 over 3 frames; batch 2) is in
test_torch_v4_rgb.py, _rgb_deep.py, _yuv.py and _yuv8.py, through
``check_encode`` here.  Every comparison is exact: the codec is
integer."""
import numpy as np
import pytest
import torch

from tpu_ffv1 import EncoderParams, FFV1Decoder, FFV1Encoder
from tpu_ffv1.codec.pixfmt import get_pix_fmt
from tpu_ffv1.codec.rct import choose_rct_params
from tpu_ffv1.io.rawvideo import frame_shape
from tpu_ffv1.tpu import rct_search as jax_rct
from tpu_ffv1.tpu.decoder import TPUFFV1Decoder
from tpu_ffv1.tpu.encoder import TPUFFV1Encoder
from tpu_ffv1_torch import TorchFFV1Decoder, TorchFFV1Encoder
from tpu_ffv1_torch.tpu import rct_search
from tpu_ffv1_torch.tpu.golomb_encode import fresh_vlc_states
from tpu_ffv1_torch.tpu.state import (decoder_state_from_numpy,
                                      encoder_state_from_numpy)

W, H = 64, 32
# the frame size of check_encode and the GOP hand-over: 16x8 slices
CW, CH = 32, 16


def textured(r, shape, hi, tilt):
    """A gradient of slope ``tilt`` and noise, below ``hi``: structure the
    search can rank without tripping the PCM budget."""
    span = hi - hi // 8
    grad = (np.add.outer(np.arange(shape[0]), np.arange(shape[1])) *
            tilt) % span
    return grad + r.randint(0, max(hi // 8, 2), shape)


def v4_frames(pix_fmt, n, seed, w=W, h=H):
    """n frames of ``pix_fmt`` in the host encoder's layout (bgr0/bgra one
    (h, w, 4) uint8 array, bgr0's pad byte 0; planar formats a list of
    planes), each plane textured with its own slope."""
    fmt = get_pix_fmt(pix_fmt)
    r = np.random.RandomState(seed)
    out = []
    for t in range(n):
        planes = []
        for k, (shape, dt) in enumerate(frame_shape(pix_fmt, w, h)):
            hi = 1 << (8 if dt == np.uint8 else fmt.bits)
            if len(shape) == 3:
                p = np.stack([textured(r, shape[:2], hi, 3 + t + 2 * c)
                              for c in range(shape[2])], axis=-1)
                if not fmt.transparency:
                    p[..., 3] = 0
            else:
                p = textured(r, shape, hi, 3 + t + k)
            planes.append(p.astype(dt))
        out.append(planes)
    return out


def v4_params(pix_fmt, context_model=0, coder=2, gop=2, w=W, h=H):
    return EncoderParams(width=w, height=h, pix_fmt=pix_fmt, level=4,
                         strict=-2, coder=coder, slices=4, gop_size=gop,
                         context_model=context_model)


def check_encode(pix_fmt, context_model, coder=2, decode=False):
    """Two streams (batch 2), GOP 2 over 3 frames: each port packet equal
    to the host encoder's and TPUFFV1Encoder's (batch 2 too); where the
    search runs, some slice picks a pair other than (1, 1).  With
    ``decode``, TorchFFV1Decoder(batch=2) decodes the port's packets to
    the host decoder's planes, in layout and values, and the source."""
    streams = [v4_frames(pix_fmt, 3, 10 + b, CW, CH) for b in range(2)]
    p = v4_params(pix_fmt, context_model, coder, w=CW, h=CH)
    hosts = [FFV1Encoder(p) for _ in range(2)]
    jaxe = TPUFFV1Encoder(p, batch=2)
    port = TorchFFV1Encoder(p, batch=2, device="cpu")
    assert port.rp.version == 4 and port.rct_search == jaxe.rct_search
    assert port.extradata == hosts[0].extradata == jaxe.extradata
    hdecs = [FFV1Decoder(CW, CH, port.extradata) for _ in range(2)]
    pdec = TorchFFV1Decoder(CW, CH, port.extradata, batch=2, device="cpu")
    picks = set()
    for t in range(3):
        frame = [streams[b][t] for b in range(2)]
        want = [hosts[b].encode_frame(frame[b]) for b in range(2)]
        picks |= {(s.slice_rct_by_coef, s.slice_rct_ry_coef)
                  for h in hosts for s in h.slices}
        assert jaxe.encode_frames(frame) == want, f"JAX frame {t}"
        got = port.encode_frames(frame)
        assert got == want, f"frame {t}"
        if not decode:
            continue
        out = pdec.decode_frames([g[0] for g in got])
        for b in range(2):
            planes, kf = out[b]
            wplanes, wkf = hdecs[b].decode_frame(got[b][0])
            assert kf == wkf == (t % 2 == 0)
            assert len(planes) == len(wplanes) == len(frame[b])
            for a, w_, src in zip(planes, wplanes, frame[b]):
                w_ = np.asarray(w_)
                assert a.dtype == w_.dtype == src.dtype and \
                    a.shape == w_.shape == src.shape
                assert np.array_equal(a, w_), f"stream {b} frame {t}"
                assert np.array_equal(a, src)
        assert not pdec.slice_damaged.any()
    if port.rct_search:
        assert picks - {(1, 1)}, "the fixture must exercise the search"
    else:
        assert picks == {(1, 1)}


# ------------------------------------------------------------ the search


def test_rct_search_matches_jax_and_host():
    """rct_cost_pairs + pick_rct_coefs against rct_cost_pairs_lanes +
    pick_rct_coefs and the host's choose_rct_params on the adversarial
    16-bit crops of tests/test_tpu_v4.py (large second differences push
    the costs toward their bound): the same sums and the same picks."""
    r = np.random.RandomState(3)
    crops = r.randint(0, 65536, (5, 3, 24, 40)).astype(np.int64)
    pairs = np.asarray(jax_rct.rct_cost_pairs_lanes(
        *(crops[:, k].astype(np.int32) for k in range(3))))
    want_tot = (pairs[..., 0].astype(np.int64) << 16) + pairs[..., 1]
    tot = rct_search.rct_cost_pairs(
        *(torch.from_numpy(crops[:, k].astype(np.int32)) for k in range(3)))
    assert tot.dtype == torch.int64 and tot.shape == (5, 15)
    assert np.array_equal(tot.numpy(), want_tot)
    got = rct_search.pick_rct_coefs(tot.numpy())
    assert got == jax_rct.pick_rct_coefs(pairs)
    for lane in range(5):
        assert got[lane] == choose_rct_params(list(crops[lane]), False)
    assert rct_search.RCT_Y_COEFF == list(jax_rct.RCT_Y_COEFF)


def test_rct_search_ties_take_the_first_candidate():
    """A flat crop costs 0 under every pair: the first candidate, (0, 0),
    wins, as the reference's strict-< scan keeps it."""
    flat = torch.full((1, 6, 6), 77, dtype=torch.int32)
    tot = rct_search.rct_cost_pairs(flat, flat, flat)
    assert not tot.any()
    assert rct_search.pick_rct_coefs(tot.numpy()) == [(0, 0)]


def test_v4_golomb_request_above_8_bits_matches_host():
    """test_v4_rct_search_golomb's configuration: yuv444p16le with
    coder=0 resolves to the range coder above 8 bits (codec/params.py),
    so the search's pairs ride range-coded headers; the host's bytes."""
    p = v4_params("yuv444p16le", coder=0, gop=0)
    port = TorchFFV1Encoder(p, device="cpu")
    assert not port.golomb and port.rct_search
    host = FFV1Encoder(p)
    for i, f in enumerate(v4_frames("yuv444p16le", 2, 12)):
        assert port.encode_frame(f) == host.encode_frame(f), i


# ------------------------------------------------------- the PCM retry


def pcm_noise(seed, w, h):
    r = np.random.RandomState(seed)
    return [r.randint(0, 65536, (h, w)).astype(np.uint16) for _ in range(3)]


def pcm_smooth(t, w, h):
    yy, xx = np.mgrid[0:h, 0:w]
    return [((xx * 16 + yy * 3 + 100 * t + 7 * k) % 65536).astype(np.uint16)
            for k in range(3)]


def coding_modes(extradata, pkt, w, h):
    """Each slice's slice_coding_mode, as the host decoder reads it."""
    host = FFV1Decoder(w, h, extradata)
    host.decode_frame(pkt)
    return [s.slice_coding_mode for s in host.slices[:host.slice_count]]


def test_pcm_retry_on_the_reference_content():
    """1024x4 yuv444p16le noise (test_v4_device_source_pcm_retry's
    content) through encode_frames: each slice's row budget is below
    w * 35 bytes, so every slice retries as PCM; the packets equal
    TPUFFV1Encoder's, the host decoder decodes them losslessly, and both
    device decoders refuse the PCM slices."""
    w, h = 1024, 4
    frames = [pcm_noise(s, w, h) for s in (2, 3)]
    p = v4_params("yuv444p16le", gop=3, w=w, h=h)
    jaxe = TPUFFV1Encoder(p)
    port = TorchFFV1Encoder(p, device="cpu")
    host = FFV1Decoder(w, h, port.extradata)
    pkts = []
    for t, f in enumerate(frames):
        pkt = port.encode_frame(f)
        pkts.append(pkt[0])
        assert pkt == jaxe.encode_frame(f), f"frame {t}"
        out, _ = host.decode_frame(pkt[0])
        assert all(np.array_equal(np.asarray(a), b) for a, b in zip(out, f))
        assert [s.slice_coding_mode for s in host.slices] == [1] * 4
        assert np.array_equal(port.states.numpy(), np.asarray(jaxe.states))
        assert (port.states == 128).all()
    with pytest.raises(NotImplementedError):
        TorchFFV1Decoder(w, h, port.extradata, device="cpu").decode_frame(
            pkts[0])
    with pytest.raises(NotImplementedError):
        TPUFFV1Decoder(w, h, port.extradata).decode_frame(pkts[0])


def test_pcm_retry_in_some_lanes_continues_the_gop():
    """Batch 2 at 512x4 (each slice's budget 10,240 bytes against 8,960
    at its line starts): stream 0 noise, smooth, noise; stream 1 smooth.
    GOP 3 over 3 frames: stream 0's slices retry as PCM in frames 0 and
    2, and frame 1 codes from the states the PCM reset left (128);
    stream 1 never retries.  Packets and states equal TPUFFV1Encoder's,
    every frame decodes losslessly on the host decoder."""
    w, h = 512, 4
    p = v4_params("yuv444p16le", gop=3, w=w, h=h)
    jaxe = TPUFFV1Encoder(p, batch=2)
    port = TorchFFV1Encoder(p, batch=2, device="cpu")
    hosts = [FFV1Decoder(w, h, port.extradata) for _ in range(2)]
    for t in range(3):
        frame = [pcm_noise(40 + t, w, h) if t != 1 else pcm_smooth(t, w, h),
                 pcm_smooth(t, w, h)]
        got = port.encode_frames(frame)
        assert got == jaxe.encode_frames(frame), f"frame {t}"
        assert [kf for _p, kf in got] == [t == 0] * 2
        assert np.array_equal(port.states.numpy(), np.asarray(jaxe.states))
        for b in range(2):
            out, _ = hosts[b].decode_frame(got[b][0])
            assert all(np.array_equal(np.asarray(x), y)
                       for x, y in zip(out, frame[b])), (t, b)
            mode = 1 if b == 0 and t != 1 else 0
            assert [s.slice_coding_mode for s in hosts[b].slices] == \
                [mode] * 4, (t, b)


# ---------------------------------------------------------- the decoder


def test_reset_contexts_lane_reset_matches_jax():
    """_prepare_states (the range coder's per-lane state rules, planar
    and RGB) with a keyframe stream and a reset_contexts mask equals
    TPUFFV1Decoder._reset_lane_states on the same states (and the VLC
    states of a Golomb-Rice stream reset on the same lanes)."""
    p = v4_params("yuv444p16le")
    extradata = FFV1Encoder(p).extradata
    jaxd = TPUFFV1Decoder(W, H, extradata, batch=3)
    port = TorchFFV1Decoder(W, H, extradata, batch=3, device="cpu")
    total_cc = jaxd._fresh_states(0).shape[0]
    r = np.random.RandomState(4)
    st = r.randint(0, 256, (port.L, total_cc, 32)).astype(np.uint8)
    resets = r.randint(0, 2, port.L).astype(bool)
    keyframes = [False, True, False]
    import jax.numpy as jnp
    jaxd.states = jnp.asarray(st)
    want = np.asarray(jaxd._reset_lane_states(keyframes, resets, 0,
                                              total_cc))
    decoder_state_from_numpy(port, st, [True] * 3)
    port._prepare_states([0] * port.L, keyframes, resets)
    assert np.array_equal(port.states.numpy(), want)
    assert list(port.lane_rows) == [total_cc] * port.L
    assert not np.array_equal(want, st)

    g = TorchFFV1Decoder(W, H, FFV1Encoder(v4_params(
        "yuv420p", coder=0)).extradata, batch=3, device="cpu")
    vlc = torch.from_numpy(r.randint(-50, 50, (g.L, 10, 4)).astype(np.int32))
    g.vlc_states = vlc.clone()
    out = g._reset_lane_vlc(keyframes, 10, resets)
    fresh = fresh_vlc_states(1, 10, "cpu")[0]
    lanes = resets | np.repeat(keyframes, g.n_slices)
    assert torch.equal(out[torch.from_numpy(~lanes)],
                       vlc[torch.from_numpy(~lanes)])
    assert (out[torch.from_numpy(lanes)] == fresh).all()


def test_pcm_slice_raises_before_any_decode():
    """A v4 packet whose slice 2 is PCM: NotImplementedError, as
    TPUFFV1Decoder raises (the host decoder reads it)."""
    w, h = 512, 4
    p = v4_params("yuv444p16le", gop=3, w=w, h=h)
    port = TorchFFV1Encoder(p, batch=2, device="cpu")
    pkts = port.encode_frames([pcm_noise(1, w, h), pcm_smooth(0, w, h)])
    assert coding_modes(port.extradata, pkts[0][0], w, h) == [1] * 4
    dec = TorchFFV1Decoder(w, h, port.extradata, batch=2, device="cpu")
    with pytest.raises(NotImplementedError):
        dec.decode_frames([pkts[0][0], pkts[1][0]])
    # the smooth stream alone decodes
    one = TorchFFV1Decoder(w, h, port.extradata, device="cpu")
    planes, kf = one.decode_frame(pkts[1][0])
    assert kf and all(np.array_equal(a, b) for a, b in
                      zip(planes, pcm_smooth(0, w, h)))


@pytest.fixture(scope="module")
def bgr0_v4_stream():
    """48x32 bgr0 at version 4 (GOP 12), packets 0-2 from the host
    encoder, in test_torch_rgb_damage's geometry."""
    from .test_torch_rgb import params, rgb_frames
    enc = FFV1Encoder(params("bgr0", gop=12, level=4, strict=-2))
    return enc.extradata, [enc.encode_frame(f)[0]
                           for f in rgb_frames("bgr0", 3, 8)]


@pytest.mark.parametrize("t", range(3))
def test_damaged_v4_slice_header_matches_host(bgr0_v4_stream, t):
    """Slice 1's first 3 bytes in packet 1 replaced by random bytes: the
    port flags what the host decoder (engine="spec") flags and gives its
    values in frames 0-2 (a failed header's slice decodes with (1, 1) and
    keeps its states)."""
    from .test_torch_rgb_damage import _check_against_host
    extradata, pkts = bgr0_v4_stream
    dec = TorchFFV1Decoder(48, 32, extradata, device="cpu")
    assert dec.version == 4
    start = dec._split_slices(pkts[1])[1][0]
    bad = bytearray(pkts[1])
    bad[start:start + 3] = np.random.RandomState(t).randint(
        0, 256, 3).astype(np.uint8).tobytes()
    flagged = _check_against_host(extradata, [pkts[0], bytes(bad), pkts[2]])
    assert flagged[0] == 0 and flagged[1] >= 1


def test_flipped_byte_in_v4_flags_and_conceals_as_host(bgr0_v4_stream):
    from .test_torch_rgb_damage import _check_against_host
    extradata, pkts = bgr0_v4_stream
    bad = bytearray(pkts[1])
    bad[len(bad) // 3] ^= 0x40
    assert _check_against_host(extradata,
                               [pkts[0], bytes(bad), pkts[2]]) == [0, 1, 1]


# ------------------------------------------------ a GOP begun in JAX


def test_v4_gop_begun_in_jax_continues_in_port():
    """bgr0 at version 4, frames 0-1 in TPUFFV1Encoder, frames 2-3 in the
    port after encoder_state_from_numpy: the host encoder's bytes; the
    decoder likewise from TPUFFV1Decoder after frame 0."""
    p = v4_params("bgr0", gop=4, w=CW, h=CH)
    frames = v4_frames("bgr0", 4, 7, CW, CH)
    host = FFV1Encoder(p)
    want = [host.encode_frame(f) for f in frames]
    jaxe = TPUFFV1Encoder(p)
    got = [jaxe.encode_frame(f) for f in frames[:2]]
    port = TorchFFV1Encoder(p, device="cpu")
    encoder_state_from_numpy(port, np.asarray(jaxe.states),
                             jaxe.picture_number)
    got += [port.encode_frame(f) for f in frames[2:]]
    assert got == want and not want[2][1]

    jaxd = TPUFFV1Decoder(CW, CH, host.extradata)
    jaxd.decode_frame(want[0][0])
    portd = TorchFFV1Decoder(CW, CH, host.extradata, device="cpu")
    decoder_state_from_numpy(portd, np.asarray(jaxd.states),
                             jaxd.key_frame_ok)
    for (pkt, _kf), f in zip(want[1:], frames[1:]):
        planes, _ = portd.decode_frame(pkt)
        assert len(planes) == 1 and np.array_equal(planes[0], f[0])


def test_compact_is_off_at_version_4():
    """compact=True at version 4 warns and runs the raw form (the row
    budget reads its emit flags): the same bytes as the host's."""
    p = v4_params("yuv420p")
    with pytest.warns(UserWarning, match="compact"):
        port = TorchFFV1Encoder(p, device="cpu", compact=True)
    assert not port.compact
    f = v4_frames("yuv420p", 1, 5)[0]
    assert port.encode_frame(f) == FFV1Encoder(p).encode_frame(f)
