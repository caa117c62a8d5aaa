"""The RGB path (colorspace 1, version 3, range coder) of the port on
device="cpu": B1's and B1-ext's plain version (rc_decode_rgb_ref)
against the JAX package's XLA scan (rc_decode_rgb_lanes) on random bytes
and states, the RCT against JAX's, and the 8-bit packed formats (bgr0,
bgra) through TorchFFV1Encoder / TorchFFV1Decoder at context models 0
and 1, GOP 2, batch 2: packets equal to TPUFFV1Encoder's and the host
FFV1Encoder's (bgr0 also in the compact form), decodes equal to the
host FFV1Decoder's in layout and values; a GOP handed over from the JAX
classes (tpu/state.py), and the configurations the port refuses.  The
deeper gbrp formats, damage and concealment are in
test_torch_rgb_deep.py.  Every comparison is exact: the codec is
integer."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ffv1 import EncoderParams, FFV1Decoder, FFV1Encoder
from tpu_ffv1.tpu import residual as jax_residual
from tpu_ffv1.tpu.dec_scan_lanes import rc_decode_rgb_lanes
from tpu_ffv1.tpu.decoder import TPUFFV1Decoder
from tpu_ffv1.tpu.encoder import TPUFFV1Encoder
from tpu_ffv1_torch import TorchFFV1Decoder, TorchFFV1Encoder
from tpu_ffv1_torch.core import tables as T
from tpu_ffv1_torch.core.rac import custom_state_tables
from tpu_ffv1_torch.tpu import rc_decode as D
from tpu_ffv1_torch.tpu.residual import rct_transform
from tpu_ffv1_torch.tpu.state import (decoder_state_from_numpy,
                                      encoder_state_from_numpy)

W, H = 48, 32
# the frame size of check_encode, check_decode and the GOP hand-over: 16x8
# slices
CW, CH = 32, 16


def rgb_frames(pix_fmt, n, seed, w=W, h=H):
    """n frames of ``pix_fmt``: bgr0/bgra one (h, w, 4) uint8 array each
    (a gradient, noise, a moving ramp; bgr0's pad byte 0, bgra's alpha
    noise), gbrp<bits>le three uint16 planes (a ramp, noise)."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        if pix_fmt.startswith("gbrp"):
            bits = int(pix_fmt[4:-2])
            mx = (1 << bits) - 1
            out.append([(((xx + yy) * (257 + 37 * t + 101 * k) +
                          r.randint(0, 1 << (bits - 5), (h, w))) & mx)
                        .astype(np.uint16) for k in range(3)])
            continue
        f = np.zeros((h, w, 4), np.uint8)
        f[..., 0] = (xx + yy + 7 * t) % 256
        f[..., 1] = r.randint(0, 256, (h, w))
        f[..., 2] = (2 * yy + xx + t + r.randint(0, 4, (h, w))) % 256
        if pix_fmt == "bgra":
            f[..., 3] = r.randint(0, 256, (h, w))
        out.append([f])
    return out


def params(pix_fmt, context_model=0, gop=2, **kw):
    return EncoderParams(**{**dict(width=W, height=H, pix_fmt=pix_fmt,
                                   level=3, coder=2, slices=4, gop_size=gop,
                                   slicecrc=1, context_model=context_model),
                            **kw})


def check_encode(pix_fmt, context_model, compact=False):
    """Two streams (batch 2) through the port: each packet equal to the
    host encoder's and TPUFFV1Encoder's (batch 2 too)."""
    streams = [rgb_frames(pix_fmt, 3, 10 + b, CW, CH) for b in range(2)]
    p = params(pix_fmt, context_model, width=CW, height=CH)
    hosts = [FFV1Encoder(p) for _ in range(2)]
    jaxe = TPUFFV1Encoder(p, batch=2)
    port = TorchFFV1Encoder(p, batch=2, device="cpu", compact=compact)
    assert port.rgb and port.compact == compact
    assert port.extradata == hosts[0].extradata == jaxe.extradata
    for t in range(3):
        frame = [streams[b][t] for b in range(2)]
        want = [hosts[b].encode_frame(frame[b]) for b in range(2)]
        assert jaxe.encode_frames(frame) == want, f"JAX frame {t}"
        assert port.encode_frames(frame) == want, f"frame {t}"


def check_decode(pix_fmt, context_model):
    """The host encoder's packets of two streams through
    TorchFFV1Decoder(batch=2): every frame equal to the host decoder's,
    in layout (one B, G, R, A uint8 array at 8 bits, three uint16 planes
    above) and values, and to the source."""
    streams = [rgb_frames(pix_fmt, 3, 20 + b, CW, CH) for b in range(2)]
    p = params(pix_fmt, context_model, width=CW, height=CH)
    hosts = [FFV1Encoder(p) for _ in range(2)]
    hdecs = [FFV1Decoder(CW, CH, hosts[0].extradata) for _ in range(2)]
    port = TorchFFV1Decoder(CW, CH, hosts[0].extradata, batch=2,
                            device="cpu")
    assert port.rgb
    for t in range(3):
        pkts = [hosts[b].encode_frame(streams[b][t])[0] for b in range(2)]
        got = port.decode_frames(pkts)
        for b in range(2):
            want, wkf = hdecs[b].decode_frame(pkts[b])
            planes, kf = got[b]
            assert kf == wkf == (t % 2 == 0)
            assert len(planes) == len(want) == len(streams[b][t])
            for a, w, src in zip(planes, want, streams[b][t]):
                assert a.dtype == w.dtype == src.dtype and \
                    a.shape == w.shape == src.shape
                assert np.array_equal(a, w), f"stream {b} frame {t}"
                assert np.array_equal(a, src)
        assert not port.slice_damaged.any()


# ------------------------------------------------- B1's plain version


def random_rgb_args(bits, five, nplanes, seed, L=3, cap=512):
    """Random slice bytes for L lanes, states 16..240 for the RGB state
    planes (2 or 3 x the context model's count), the context's quant
    tables, and lane L - 1's coder started 8 bytes before cap."""
    r = np.random.RandomState(seed)
    cc = T.CONTEXT_COUNTS[int(five)]
    one, zero = custom_state_tables(T.VER2_STATE)
    bufs = r.randint(0, 256, (L, cap)).astype(np.uint8)
    pos0 = np.full(L, 2, np.int32)
    pos0[-1] = cap - 8
    low0 = np.minimum(bufs[np.arange(L), pos0 - 2].astype(np.int32) << 8 |
                      bufs[np.arange(L), pos0 - 1], 0xFEFF)
    CC = (2 + (nplanes == 4)) * cc
    return [np.ascontiguousarray(a) for a in (
        bufs, r.randint(16, 241, (L, CC, 32)).astype(np.uint8), one, zero,
        T.default_quant_tables(bits)[int(five)].astype(np.int32),
        low0.astype(np.int32), np.full(L, 0xFF00, np.int32), pos0)], cc


@pytest.mark.parametrize("bits,five,nplanes", [
    (9, False, 3), (10, True, 4), (11, False, 3), (13, True, 4),
    (15, False, 3)])
def test_rc_decode_rgb_ref_matches_jax(bits, five, nplanes):
    """rc_decode_rgb_ref against rc_decode_rgb_lanes at every RGB coded
    width (9: bgr0/bgra, 10: gbrp9, 11, 13, 15: gbrp10/12/14), the 3- and
    5-input contexts and 3 or 4 planes: garbage symbols (exponents past
    the width), a lane reading past its buffer."""
    args, cc = random_rgb_args(bits, five, nplanes, 70 + bits + 5 * five)
    w, h = 7, 3
    want = rc_decode_rgb_lanes(*[jnp.asarray(a) for a in args], w, h,
                               nplanes, cc, bits, five)
    got = D.rc_decode_rgb(*[torch.from_numpy(a) for a in args], w, h,
                          nplanes, cc, bits, five)
    assert got[0].shape == (nplanes, 3, h, w)
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert int(got[4][-1]) >= args[0].shape[1], "no read past the buffer"


def test_rc_decode_rgb_ref_resumes_at_a_row():
    """rows0: a decode of rows 2..4 from the coder and states rows 0..1
    ended in, and their two last rows, equals rows 2..4 of one decode
    (chip_smoke.py splits B1's main-path launches so)."""
    args, cc = random_rgb_args(9, False, 3, 5)
    targs = [torch.from_numpy(a) for a in args]
    full = D.rc_decode_rgb_ref(*targs, 9, 5, 3, cc, 9)
    head = D.rc_decode_rgb_ref(*targs, 9, 2, 3, cc, 9)
    assert torch.equal(head[0], full[0][:, :, :2])
    tail = D.rc_decode_rgb_ref(targs[0], head[1], *targs[2:5], *head[2:],
                               9, 3, 3, cc, 9, False, full[0][:, :, :2])
    assert torch.equal(tail[0], full[0][:, :, 2:])
    for a, b in zip(tail[1:], full[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bits", [8, 14])
def test_rct_transform_matches_jax(bits):
    r = np.random.RandomState(bits)
    g, b, rr = (r.randint(0, 1 << bits, (2, 5, 7)) for _ in range(3))
    want = jax_residual.rct_transform(jnp.asarray(g), jnp.asarray(b),
                                      jnp.asarray(rr), bits)
    got = rct_transform(*(torch.from_numpy(x) for x in (g, b, rr)), bits)
    for a, c in zip(want, got):
        assert c.dtype == torch.int32 and np.array_equal(np.asarray(a),
                                                         c.numpy())


# ------------------------------------------------------ 8-bit packed


@pytest.mark.parametrize("context_model", [0, 1])
@pytest.mark.parametrize("pix_fmt", ["bgr0", "bgra"])
def test_encoder_matches_jax_and_host(pix_fmt, context_model):
    check_encode(pix_fmt, context_model)


@pytest.mark.parametrize("context_model", [0, 1])
def test_bgr0_compact_encoder_matches_host(context_model):
    """bgr0 at coded width 9 in the compact form: the raw form's bytes."""
    check_encode("bgr0", context_model, compact=True)


@pytest.mark.parametrize("context_model", [0, 1])
@pytest.mark.parametrize("pix_fmt", ["bgr0", "bgra"])
def test_decoder_matches_host(pix_fmt, context_model):
    check_decode(pix_fmt, context_model)


def test_rgb_gop_begun_in_jax_continues_in_port():
    """bgr0 frames 0-1 in TPUFFV1Encoder, frames 2-3 in the port after
    encoder_state_from_numpy (RGB's 2 x 666 state rows): the bytes of the
    host encoder alone; the decoder likewise from TPUFFV1Decoder after
    frame 0."""
    p = params("bgr0", gop=4, width=CW, height=CH)
    frames = rgb_frames("bgr0", 4, 7, CW, CH)
    host = FFV1Encoder(p)
    want = [host.encode_frame(f) for f in frames]
    jaxe = TPUFFV1Encoder(p)
    got = [jaxe.encode_frame(f) for f in frames[:2]]
    port = TorchFFV1Encoder(p, device="cpu")
    assert port.total_cc == 2 * T.CONTEXT_COUNTS[0]
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


@pytest.mark.parametrize("kw", [
    dict(pix_fmt="bgr0", coder=0),                        # Golomb-Rice
    dict(pix_fmt="bgr0", coder=-1),                       # the default
    dict(pix_fmt="bgra", coder=2, slices=6),              # non-uniform
    dict(pix_fmt="gbrp10le", coder=2, level=4, strict=-2,
         slices=6),                                       # v4, non-uniform
    dict(pix_fmt="gbrp10le", coder=2, level=2, strict=-2),  # version 2
], ids=["golomb", "default_coder", "nonuniform", "version4", "version2"])
def test_outside_the_rgb_slice_raises(kw):
    p = EncoderParams(width=50, height=40, **{"level": 3, **kw})
    with pytest.raises(NotImplementedError):
        TorchFFV1Encoder(p, device="cpu")
    # the host encoder takes them; the port's decoder refuses the stream
    # as its encoder refuses the params
    extradata = FFV1Encoder(p).extradata
    with pytest.raises(NotImplementedError):
        TorchFFV1Decoder(50, 40, extradata, device="cpu")
