"""The codec state TorchFFV1PEncoder carries across the GOP against
TPUFFV1PEncoder's, the JAX package's device class, on the CPU; and the
refusals of both P classes against the JAX classes' (the same exception
type for each configuration they do not take)."""
import numpy as np
import pytest

from tpu_ffv1 import FFV1Encoder
from tpu_ffv1.pframe.codec import p_extradata
from tpu_ffv1_torch import EncoderParams as TorchEncoderParams
from tpu_ffv1_torch import TorchFFV1PDecoder, TorchFFV1PEncoder

from .test_pframe_tpu import _moving_scene, _params


def _port(params, **kw):
    return TorchFFV1PEncoder(TorchEncoderParams(**vars(params)),
                             experimental=True, device="cpu", **kw)


def test_state_carry_matches_tpu_encoder():
    """The codec state the port carries across the GOP (the adaptive
    states with the three MV rows, the MV predictors, the reference
    planes) equals TPUFFV1PEncoder's after every frame, over a GOP
    boundary (GOP 3 over 4 frames: two P frames carry, the keyframe
    resets), on 2 streams."""
    from tpu_ffv1.pframe.tpu import TPUFFV1PEncoder
    streams = [_moving_scene(n=4, seed=5), _moving_scene(n=4, seed=9)]
    jax_enc = TPUFFV1PEncoder(_params(), experimental=True, batch=2)
    port = _port(_params(), batch=2)
    for t in range(4):
        frame = [s[t] for s in streams]
        assert jax_enc.encode_frames(frame) == port.encode_frames(frame)
        np.testing.assert_array_equal(np.asarray(jax_enc.states),
                                      port.states.numpy())
        np.testing.assert_array_equal(np.asarray(jax_enc.prev_mvs),
                                      port.prev_mvs.numpy())
        for a, b in zip(jax_enc.ref_dev, port.ref_dev):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for name in ("mv_base", "total_cc", "p_bits", "mv_cap", "p_n_max",
                 "p_out_cap", "bh", "bw", "pad_h", "pad_w"):
        assert getattr(port, name) == getattr(jax_enc, name), name


REFUSALS = [
    ("not experimental", {}, {"experimental": False}),
    ("gop 1", {"gop_size": 1}, {}),
    ("me", {}, {"me": "diamond"}),
    ("rgb", {"pix_fmt": "bgr0"}, {}),
    ("16 bits", {"pix_fmt": "yuv420p16le"}, {}),
    ("golomb", {"coder": 0}, {}),
    ("version 4", {"level": 4, "strict": -2}, {}),
    ("non-uniform", {"width": 98}, {}),
]


@pytest.mark.parametrize("label,pkw,ekw", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_encoder_refusals_match_jax(label, pkw, ekw):
    from tpu_ffv1.pframe.tpu import TPUFFV1PEncoder
    params = _params(**pkw)
    kw = dict(dict(experimental=True), **ekw)
    with pytest.raises((ValueError, NotImplementedError)) as want:
        TPUFFV1PEncoder(params, **kw)
    with pytest.raises(want.type):
        TorchFFV1PEncoder(TorchEncoderParams(**vars(params)), device="cpu",
                          **kw)


DEC_REFUSALS = [
    ("10 bits", dict(pix_fmt="yuv422p10le"), True),
    ("non-uniform", dict(width=98), True),
    ("no marker", {}, False),
]


@pytest.mark.parametrize("label,pkw,marked", DEC_REFUSALS,
                         ids=[r[0] for r in DEC_REFUSALS])
def test_decoder_refusals_match_jax(label, pkw, marked):
    from tpu_ffv1.pframe.tpu import TPUFFV1PDecoder
    params = _params(**pkw)
    extra = FFV1Encoder(params).extradata
    if marked:
        extra = p_extradata(extra)
    with pytest.raises((ValueError, NotImplementedError)) as want:
        TPUFFV1PDecoder(params.width, params.height, extra)
    with pytest.raises(want.type):
        TorchFFV1PDecoder(params.width, params.height, extra, device="cpu")
