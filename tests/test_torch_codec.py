"""The port's slice as a whole on device="cpu" (the plain PyTorch versions
of both kernels): packets byte-identical to TPUFFV1Encoder and the host
FFV1Encoder, lossless decode, GOP state handed over from the JAX
classes, damage concealment; at context models 0 and 1.  Every comparison is exact: the codec is
integer and lossless."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import copy
import dataclasses

import numpy as np
import pytest

from .util import synth_frames
from tpu_ffv1 import EncoderParams, FFV1Decoder, FFV1Encoder
from tpu_ffv1.codec import decoder as host_decoder
from tpu_ffv1.core.intmath import ceil_rshift
from tpu_ffv1.tpu.decoder import TPUFFV1Decoder
from tpu_ffv1.tpu.encoder import TPUFFV1Encoder
from tpu_ffv1_torch import EncoderParams as TorchEncoderParams
from tpu_ffv1_torch import TorchFFV1Decoder, TorchFFV1Encoder
from tpu_ffv1_torch.tpu import encoder as tenc
from tpu_ffv1_torch.tpu.state import (decoder_state_from_numpy,
                                      encoder_state_from_numpy)


def _frames(w, h, n, seed=3, noise=4):
    r = np.random.RandomState(seed)
    out = []
    for t in range(n):
        y = (np.add.outer(np.arange(h), np.arange(w)) * 4 + 7 * t +
             r.randint(0, noise, (h, w))) % 256
        u = (np.arange(w // 2)[None, :] * 3 + 2 * t +
             r.randint(0, noise, (h // 2, w // 2))) % 256
        v = np.full((h // 2, w // 2), 128) + r.randint(0, 2, (h // 2, w // 2))
        out.append([p.astype(np.uint8) for p in (y, u, v)])
    return out


def _params(w, h, slices, gop, context_model=0):
    return EncoderParams(width=w, height=h, pix_fmt="yuv420p", level=3,
                         coder=2, slices=slices, gop_size=gop,
                         context_model=context_model)


CONFIGS = [
    # (label, width, height, slices, gop_size, frames)
    ("48x40_4slices_gop2", 48, 40, 4, 2, 4),
    ("64x64_1slice_10frames", 64, 64, 1, 12, 10),   # BASELINE config 1
]


@pytest.mark.parametrize("label,w,h,slices,gop,n", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_encoder_matches_jax_and_host(label, w, h, slices, gop, n):
    params = _params(w, h, slices, gop)
    frames = _frames(w, h, n)
    host = FFV1Encoder(params)
    jaxe = TPUFFV1Encoder(params)
    port = TorchFFV1Encoder(params, device="cpu")
    assert port.extradata == host.extradata == jaxe.extradata
    for i, f in enumerate(frames):
        want = host.encode_frame(f)
        assert jaxe.encode_frame(f) == want
        assert port.encode_frame(f) == want, f"frame {i}"


def test_encoder_batch_streams_match_host():
    """batch=2: two independent streams in lockstep (8 lanes)."""
    params = _params(48, 40, 4, 2)
    streams = [_frames(48, 40, 3, seed=20 + b) for b in range(2)]
    port = TorchFFV1Encoder(params, batch=2, device="cpu")
    hosts = [FFV1Encoder(params) for _ in range(2)]
    for t in range(3):
        res = port.encode_frames([streams[b][t] for b in range(2)])
        for b in range(2):
            assert res[b] == hosts[b].encode_frame(streams[b][t])


def test_encoder_overflow_redo_is_byte_exact(monkeypatch):
    """Full-range noise emits > 24 bytes per 16-pixel group, so the
    compacted finalize overflows and the frame is redone at full slot
    width; the bytes must still equal the host encoder's."""
    calls = []
    full = tenc.finalize_packed_full

    def spy(*a):
        calls.append(1)
        return full(*a)

    monkeypatch.setattr(tenc, "finalize_packed_full", spy)
    r = np.random.RandomState(9)
    params = _params(48, 40, 4, 12)
    port = TorchFFV1Encoder(params, device="cpu")
    host = FFV1Encoder(params)
    for _ in range(2):
        f = [r.randint(0, 256, s).astype(np.uint8)
             for s in ((40, 48), (20, 24), (20, 24))]
        assert port.encode_frame(f) == host.encode_frame(f)
    assert calls, "the overflow redo path was not taken"


@pytest.fixture(scope="module")
def jax_ctx0():
    """A GOP of 4 frames through TPUFFV1Encoder (one instance, so one
    compile, shared by the hand-over tests of the raw and the compact
    form): params, frames, its packets (the bytes of JAX alone), and the
    state it carries on after frame 1 with that frame's picture number."""
    params = _params(48, 40, 4, 4)
    frames = _frames(48, 40, 4, seed=7)
    jaxe = TPUFFV1Encoder(params)
    pkts = []
    for t, f in enumerate(frames):
        pkts.append(jaxe.encode_frame(f))
        if t == 1:
            state = (np.asarray(jaxe.states), jaxe.picture_number)
    return params, frames, pkts, state, jaxe.extradata


def test_compact_gop_begun_in_jax_continues_in_port(jax_ctx0):
    """The compact form (compact=True) continues a GOP begun in
    TPUFFV1Encoder with the raw form's bytes: those of JAX alone."""
    params, frames, want, (states, pn), _extradata = jax_ctx0
    port = TorchFFV1Encoder(params, device="cpu", compact=True)
    encoder_state_from_numpy(port, states, pn)
    assert [port.encode_frame(f) for f in frames[2:]] == want[2:]


def test_decoder_lossless_on_own_and_host_packets():
    params = _params(48, 40, 4, 2)
    frames = _frames(48, 40, 4, seed=5)
    port = TorchFFV1Encoder(params, device="cpu")
    host = FFV1Encoder(params)
    dec_own = TorchFFV1Decoder(48, 40, port.extradata, device="cpu")
    dec_host = TorchFFV1Decoder(48, 40, host.extradata, device="cpu")
    for i, f in enumerate(frames):
        for enc, dec in ((port, dec_own), (host, dec_host)):
            pkt, kf = enc.encode_frame(f)
            planes, kf2 = dec.decode_frame(pkt)
            assert kf == kf2 == (i % 2 == 0)
            for a, b in zip(planes, f):
                assert np.array_equal(a, b), f"frame {i}"
        assert not dec_own.slice_damaged.any()


def test_host_decoder_reads_port_packets():
    params = _params(48, 40, 4, 3)
    frames = _frames(48, 40, 4, seed=6)
    port = TorchFFV1Encoder(params, device="cpu")
    dec = FFV1Decoder(48, 40, port.extradata)
    for f in frames:
        planes, _ = dec.decode_frame(port.encode_frame(f)[0])
        for a, b in zip(planes, f):
            assert np.array_equal(a, b)


def test_gop_begun_in_jax_continues_in_port(jax_ctx0):
    """Frames 0-1 in TPUFFV1Encoder, frames 2-3 in the port after
    encoder_state_from_numpy: the same bytes as JAX alone.  Likewise the
    decoder: frame 0 in TPUFFV1Decoder, the rest in the port."""
    params, frames, want, (states, pn), extradata = jax_ctx0
    port = TorchFFV1Encoder(params, device="cpu")
    encoder_state_from_numpy(port, states, pn)
    got = want[:2] + [port.encode_frame(f) for f in frames[2:]]
    assert got == want
    assert not want[2][1]                       # frame 2 is non-key

    jaxd = TPUFFV1Decoder(48, 40, extradata)
    jaxd.decode_frame(want[0][0])
    portd = TorchFFV1Decoder(48, 40, extradata, device="cpu")
    decoder_state_from_numpy(portd, np.asarray(jaxd.states),
                             jaxd.key_frame_ok)
    for (pkt, _kf), f in zip(want[1:], frames[1:]):
        planes, _ = portd.decode_frame(pkt)
        for a, b in zip(planes, f):
            assert np.array_equal(a, b)


def test_flipped_byte_flags_slice_and_conceals():
    params = _params(48, 40, 4, 12)
    frames = _frames(48, 40, 2, seed=8)
    enc = FFV1Encoder(params)
    pkts = [enc.encode_frame(f)[0] for f in frames]
    dec = TorchFFV1Decoder(48, 40, enc.extradata, device="cpu")
    dec.decode_frame(pkts[0])
    bad = bytearray(pkts[1])
    bad[len(bad) // 2] ^= 0x40
    planes, _ = dec.decode_frame(bytes(bad))
    assert dec.slice_damaged.sum() == 1
    si = int(np.nonzero(dec.slice_damaged[0])[0][0])
    g = dec.geoms[si]
    # the damaged slice shows the previous picture, the others frame 1
    y0 = planes[0]
    assert np.array_equal(y0[g.y:g.y + g.height, g.x:g.x + g.width],
                          frames[0][0][g.y:g.y + g.height, g.x:g.x + g.width])
    mask = np.ones(y0.shape, bool)
    mask[g.y:g.y + g.height, g.x:g.x + g.width] = False
    assert np.array_equal(y0[mask], frames[1][0][mask])


# damaged slice headers: the port against the host decoder (spec engine)

DAMAGES = [
    # (label, context model, damaged slice): the slice's first 3 bytes,
    # in packet 1, replaced by np.random.RandomState(t).randint(0, 256, 3)
    ("slice1_ctx1", 1, 1),
    ("slice0_ctx0", 0, 0),          # slice 0's header, after the key bit
]
DAMAGE_SEEDS = range(12)


def _plane_rect(g, j):
    """The (rows, cols) slices of slice geometry ``g`` in plane j of
    yuv420p (ffv1dec.c:1010-1017)."""
    s = 1 if j else 0
    return (slice(g.y >> s, ceil_rshift(g.y + g.height, s)),
            slice(g.x >> s, ceil_rshift(g.x + g.width, s)))


def _host_decode(extradata, pkts, w=48, h=40):
    """The host decoder's frames, slice flags and, per frame, the
    pixels it left without a value: those no slice header that parsed
    covers (a slice whose header fails writes nothing, ffv1dec.c:
    282-359), and, in the rect a damaged slice conceals, those without a
    value in the previous frame; a ``w`` x ``h`` yuv420p stream."""
    parsed = []                     # the geometry each parsed header gave
    parse = host_decoder.read_slice_header

    def recording(f, ss, c):
        out = parse(f, ss, c)
        parsed.append(dataclasses.replace(ss.geom))
        return out

    host = FFV1Decoder(w, h, extradata, engine="spec")
    res, unknown = [], None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(host_decoder, "read_slice_header", recording)
        for pkt in pkts:
            parsed.clear()
            planes, _kf = host.decode_frame(pkt)
            flags = [bool(ss.slice_damaged)
                     for ss in host.slices[:host.slice_count]]
            new = [np.ones(p.shape, bool) for p in planes]
            for g in parsed:
                for j, m in enumerate(new):
                    m[_plane_rect(g, j)] = False
            if unknown is not None:
                for si, flagged in enumerate(flags):
                    if flagged:
                        for j, m in enumerate(new):
                            r = _plane_rect(host.slices[si].geom, j)
                            m[r] = unknown[j][r]
            unknown = new
            res.append(([np.array(p) for p in planes], flags, unknown))
    return res


@pytest.fixture(scope="module")
def damaged_streams():
    """Per damage: the extradata, packets 0-3 (GOP 12) of 48x40 yuv420p
    with 4 slices, and a port decoder that has decoded packet 0."""
    out = {}
    for label, cm, si in DAMAGES:
        enc = FFV1Encoder(_params(48, 40, 4, 12, context_model=cm))
        pkts = [enc.encode_frame(f)[0] for f in _frames(48, 40, 4, seed=8)]
        port = TorchFFV1Decoder(48, 40, enc.extradata, device="cpu")
        port.decode_frame(pkts[0])
        out[label] = (enc.extradata, pkts, port, si)
    return out


@pytest.mark.parametrize("t", DAMAGE_SEEDS)
@pytest.mark.parametrize("label", [d[0] for d in DAMAGES])
def test_damaged_slice_header_matches_host(damaged_streams, label, t):
    """A damaged slice header in packet 1: the port decodes on, flags the
    slices the host flags, and gives the host's planes wherever the host
    wrote a value, in frames 0-3 (C1: a context-model-1 stream; C2: the
    geometry a damaged header parses to moves no lane, only the rect
    that slice conceals)."""
    extradata, pkts, port0, si = damaged_streams[label]
    start = port0._split_slices(pkts[1])[si][0]
    bad = bytearray(pkts[1])
    bad[start:start + 3] = np.random.RandomState(t).randint(
        0, 256, 3).astype(np.uint8).tobytes()
    pkts = [pkts[0], bytes(bad), *pkts[2:]]
    host = _host_decode(extradata, pkts)
    port = copy.deepcopy(port0)
    for k, (want, want_flags, unknown) in enumerate(host):
        planes = port.last_planes[0] if k == 0 else \
            port.decode_frame(pkts[k])[0]
        assert list(port.slice_damaged[0]) == want_flags, f"frame {k}"
        for j, (a, b, u) in enumerate(zip(planes, want, unknown)):
            assert np.array_equal(a[~u], b[~u]), f"frame {k} plane {j}"


def test_reset_starts_a_fresh_gop():
    params = _params(48, 40, 4, 12)
    frames = _frames(48, 40, 2, seed=10)
    port = TorchFFV1Encoder(params, device="cpu")
    first = port.encode_frame(frames[0])
    port.encode_frame(frames[1])
    port.reset()
    assert port.encode_frame(frames[0]) == first


def _params16(gop):
    return EncoderParams(width=32, height=24, pix_fmt="yuv444p16le",
                         level=3, coder=2, slices=4, gop_size=gop)


@pytest.fixture(scope="module")
def jax16():
    """Frames 0-1 of a 16-bit GOP through TPUFFV1Encoder (one instance,
    so one compile): its packets and the state it would carry on."""
    frames = synth_frames("yuv444p16le", 32, 24, 4, seed=7)
    jaxe = TPUFFV1Encoder(_params16(4))
    pkts = [jaxe.encode_frame(f) for f in frames[:2]]
    return frames, pkts, np.asarray(jaxe.states), jaxe.picture_number


def test_16bit_encoder_matches_jax_and_host(jax16):
    """yuv444p16le (the extended schedule, K1-ext's plain version), with
    the port's own EncoderParams: the host encoder's and TPUFFV1Encoder's
    bytes, and a lossless uint16 decode."""
    frames, jax_pkts, _states, _pn = jax16
    host = FFV1Encoder(_params16(4))
    port = TorchFFV1Encoder(TorchEncoderParams(**vars(_params16(4))),
                            device="cpu")
    assert port.bits == 16 and port.s2 == 6
    dec = TorchFFV1Decoder(32, 24, port.extradata, device="cpu")
    for i, f in enumerate(frames[:2]):
        want = host.encode_frame(f)
        assert jax_pkts[i] == want
        got = port.encode_frame(f)
        assert got == want, f"frame {i}"
        planes, kf = dec.decode_frame(got[0])
        assert kf == want[1] == (i == 0)
        for a, b in zip(planes, f):
            assert a.dtype == np.uint16 and np.array_equal(a, b)


def test_16bit_gop_begun_in_jax_continues_in_port(jax16):
    """Frames 0-1 of a 16-bit GOP in TPUFFV1Encoder, frames 2-3 in the
    port after encoder_state_from_numpy: the same bytes as the JAX
    package's encoders alone (host and TPUFFV1Encoder agree on them)."""
    frames, jax_pkts, states, pn = jax16
    host = FFV1Encoder(_params16(4))
    want = [host.encode_frame(f) for f in frames]
    assert jax_pkts == want[:2]
    port = TorchFFV1Encoder(_params16(4), device="cpu")
    encoder_state_from_numpy(port, states, pn)
    assert [port.encode_frame(f) for f in frames[2:]] == want[2:]
    assert not want[2][1]                       # frame 2 is non-key


def test_16bit_flipped_byte_flags_slice_and_conceals():
    frames = synth_frames("yuv444p16le", 32, 24, 2, seed=8)
    enc = FFV1Encoder(_params16(12))
    pkts = [enc.encode_frame(f)[0] for f in frames]
    dec = TorchFFV1Decoder(32, 24, enc.extradata, device="cpu")
    dec.decode_frame(pkts[0])
    bad = bytearray(pkts[1])
    bad[20] ^= 0x40                         # inside the first slice's data
    planes, _ = dec.decode_frame(bytes(bad))
    assert dec.slice_damaged.sum() == 1
    g = dec.geoms[int(np.nonzero(dec.slice_damaged[0])[0][0])]
    for k in range(3):
        p = planes[k]
        assert np.array_equal(p[g.y:g.y + g.height, g.x:g.x + g.width],
                              frames[0][k][g.y:g.y + g.height,
                                           g.x:g.x + g.width])
        mask = np.ones(p.shape, bool)
        mask[g.y:g.y + g.height, g.x:g.x + g.width] = False
        assert np.array_equal(p[mask], frames[1][k][mask])


@pytest.mark.parametrize("kw", [
    dict(pix_fmt="bgr0", coder=0),                       # Golomb-Rice, RGB
    dict(pix_fmt="yuv420p", coder=0, slices=6),          # Golomb, non-unif.
    dict(pix_fmt="yuv420p16le", coder=2, level=1),       # 16 bits, v1
    dict(pix_fmt="yuv420p", coder=2, level=2, strict=-2),  # version 2
], ids=["golomb_rgb", "golomb_nonuniform", "16bit", "v2"])
def test_outside_the_slice_raises(kw):
    params = EncoderParams(**{"width": 50, "height": 40, "level": 3, **kw})
    with pytest.raises(NotImplementedError):
        TorchFFV1Encoder(params, device="cpu")


# ---------------------------------------------------------------------------
# context model 1 (-context 1: the 5-input context, 2 x 7,563 contexts)


@pytest.fixture(scope="module")
def jax_ctx1():
    """A context-model-1 GOP of two streams through TPUFFV1Encoder (one
    instance, so one compile): frames, its packets per stream, and the
    state it carries after frame 1."""
    params = _params(48, 40, 4, 4, context_model=1)
    streams = [_frames(48, 40, 4, seed=30 + b) for b in range(2)]
    jaxe = TPUFFV1Encoder(params, batch=2)
    pkts = [[], []]
    states = None
    for t in range(4):
        for b, res in enumerate(jaxe.encode_frames([s[t] for s in streams])):
            pkts[b].append(res)
        if t == 1:
            states = (np.asarray(jaxe.states), jaxe.picture_number)
    return params, streams, pkts, states


def test_context1_encoder_matches_jax_and_host(jax_ctx1):
    """batch=2 at context model 1: the host encoder's bytes and
    TPUFFV1Encoder's, frame by frame."""
    params, streams, jax_pkts, _st = jax_ctx1
    port = TorchFFV1Encoder(params, batch=2, device="cpu")
    hosts = [FFV1Encoder(params) for _ in range(2)]
    assert port.total_cc == 2 * 7563 and port.five_input
    assert port.extradata == hosts[0].extradata
    for t in range(4):
        res = port.encode_frames([streams[b][t] for b in range(2)])
        for b in range(2):
            want = hosts[b].encode_frame(streams[b][t])
            assert jax_pkts[b][t] == want
            assert res[b] == want, f"stream {b} frame {t}"


def test_context1_decoder_lossless_on_own_and_host_packets():
    params = _params(48, 40, 4, 2, context_model=1)
    frames = _frames(48, 40, 3, seed=31)
    port = TorchFFV1Encoder(params, device="cpu")
    host = FFV1Encoder(params)
    dec_own = TorchFFV1Decoder(48, 40, port.extradata, device="cpu")
    dec_host = TorchFFV1Decoder(48, 40, host.extradata, device="cpu")
    assert dec_own.g.context_counts[1] == 7563
    for i, f in enumerate(frames):
        for enc, dec in ((port, dec_own), (host, dec_host)):
            pkt, kf = enc.encode_frame(f)
            planes, kf2 = dec.decode_frame(pkt)
            assert kf == kf2 == (i % 2 == 0)
            for a, b in zip(planes, f):
                assert np.array_equal(a, b), f"frame {i}"
        assert dec_own.states.shape == (4, 2 * 7563, 32)
        assert not dec_own.slice_damaged.any()


def test_context1_gop_begun_in_jax_continues_in_port(jax_ctx1):
    """Frames 0-1 in TPUFFV1Encoder, frames 2-3 in the port after
    encoder_state_from_numpy (uint8 (8, 15126, 32)); likewise the
    decoder, frame 0 in TPUFFV1Decoder and the rest in the port."""
    params, streams, jax_pkts, (states, pn) = jax_ctx1
    assert states.shape == (8, 2 * 7563, 32)
    port = TorchFFV1Encoder(params, batch=2, device="cpu")
    encoder_state_from_numpy(port, states, pn)
    for t in (2, 3):
        res = port.encode_frames([streams[b][t] for b in range(2)])
        assert [r for r in res] == [jax_pkts[b][t] for b in range(2)]
    assert not jax_pkts[0][2][1]                 # frame 2 is non-key

    jaxd = TPUFFV1Decoder(48, 40, port.extradata)
    jaxd.decode_frame(jax_pkts[0][0][0])
    portd = TorchFFV1Decoder(48, 40, port.extradata, device="cpu")
    decoder_state_from_numpy(portd, np.asarray(jaxd.states),
                             jaxd.key_frame_ok)
    for t in (1, 2, 3):
        planes, _ = portd.decode_frame(jax_pkts[0][t][0])
        for a, b in zip(planes, streams[0][t]):
            assert np.array_equal(a, b)


def test_context1_compact_gop_begun_in_jax_continues_in_port(jax_ctx1):
    """Context model 1 in the compact form (K1-compact's global-table
    instance on the card), continued from TPUFFV1Encoder's states after
    frame 1: the raw form's bytes."""
    params, streams, jax_pkts, (states, pn) = jax_ctx1
    port = TorchFFV1Encoder(params, batch=2, device="cpu", compact=True)
    encoder_state_from_numpy(port, states, pn)
    for t in (2, 3):
        res = port.encode_frames([streams[b][t] for b in range(2)])
        assert res == [jax_pkts[b][t] for b in range(2)]


def test_context1_16bit_encoder_matches_host():
    """yuv444p16le at context model 1 (K1-ext's and K2-ext's plain
    versions with the 5-input context; the encoder sizes its table by
    7,563 contexts per plane, the 16-bit extradata gives 5,063): the
    host encoder's bytes and a lossless uint16 decode."""
    params = EncoderParams(width=32, height=24, pix_fmt="yuv444p16le",
                           level=3, coder=2, slices=4, gop_size=2,
                           context_model=1)
    frames = synth_frames("yuv444p16le", 32, 24, 2, seed=11)
    host = FFV1Encoder(params)
    port = TorchFFV1Encoder(params, device="cpu")
    dec = TorchFFV1Decoder(32, 24, port.extradata, device="cpu")
    assert port.total_cc == 2 * 7563 and dec.g.context_counts[1] == 5063
    for i, f in enumerate(frames):
        want = host.encode_frame(f)
        got = port.encode_frame(f)
        assert got == want, f"frame {i}"
        planes, _kf = dec.decode_frame(got[0])
        for a, b in zip(planes, f):
            assert a.dtype == np.uint16 and np.array_equal(a, b)
