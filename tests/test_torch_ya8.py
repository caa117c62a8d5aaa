"""ya8 (interleaved gray + alpha) in the port on device="cpu", against
the JAX package's classes and the host encoder (tests/test_tpu_ext.py:
213): the encoder splits each (H, W, 2) frame into a luma and an alpha
plane and codes alpha on state plane 1, with the range coder and with
Golomb-Rice, at depth 1 and at depth 2; the decoder returns one
interleaved (h, w, 2) array; device_out gives the luma and alpha pair
that submit_device_frames takes, as the JAX classes do; a non-uniform
grid follows the JAX encoder.  Every comparison is exact."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import numpy as np
import pytest
import torch

from tpu_ffv1 import EncoderParams, FFV1Encoder
from tpu_ffv1.tpu.decoder import TPUFFV1Decoder
from tpu_ffv1.tpu.encoder import TPUFFV1Encoder
from tpu_ffv1_torch import EncoderParams as TorchEncoderParams
from tpu_ffv1_torch import TorchFFV1Decoder, TorchFFV1Encoder

W, H = 48, 32
CODERS = {"range": 2, "golomb": 0}


def _frames(seed, n=3, w=W, h=H):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, (h, w, 2)).astype(np.uint8)
            for _ in range(n)]


def _params(coder, w=W, h=H, slices=4, gop=2):
    return EncoderParams(width=w, height=h, pix_fmt="ya8", level=3,
                         coder=coder, slices=slices, gop_size=gop,
                         slicecrc=1)


def _port_params(params):
    return TorchEncoderParams(**vars(params))


@pytest.fixture(scope="module", params=sorted(CODERS))
def reference(request):
    """(coder, params, frames of two streams, the host encoder's packets
    of each, TPUFFV1Encoder's packets of stream 0, the extradata)."""
    coder = CODERS[request.param]
    params = _params(coder)
    streams = [_frames(9), _frames(10)]
    hosts = [FFV1Encoder(params, engine="spec") for _ in streams]
    want = [[e.encode_frame(f) for f in s] for e, s in zip(hosts, streams)]
    jax_enc = TPUFFV1Encoder(params)
    jax_pkts = [jax_enc.encode_frame(f) for f in streams[0]]
    return coder, params, streams, want, jax_pkts, hosts[0].extradata


def test_ya8_encoder_matches_jax_and_host(reference):
    """Depth 1 (encode_frame) and depth 2 (two streams, two submits, then
    a collect before each further submit): the host encoder's packets,
    and TPUFFV1Encoder's."""
    coder, params, streams, want, jax_pkts, extradata = reference
    assert jax_pkts == want[0]
    enc = TorchFFV1Encoder(_port_params(params), device="cpu")
    assert enc.ya and enc.extradata == extradata
    assert [enc.encode_frame(f) for f in streams[0]] == want[0]
    pipe = TorchFFV1Encoder(_port_params(params), batch=2, device="cpu")
    steps = [[s[t] for s in streams] for t in range(3)]
    got = []
    pipe.submit_frames(steps[0])
    for t in range(3):
        if t + 1 < 3:
            pipe.submit_frames(steps[t + 1])
        got.append(pipe.collect_frames())
    assert [[g[b] for g in got] for b in range(2)] == want


def test_ya8_decoder_returns_interleaved_source(reference):
    """decode_frame over stream 0's three frames, and depth 2 over both
    streams' key and non-key frame: one (h, w, 2) uint8 array per frame,
    equal to the source."""
    coder, params, streams, want, _jax, extradata = reference
    dec = TorchFFV1Decoder(W, H, extradata, device="cpu")
    assert dec.ya and dec.pix_fmt == "ya8"
    for f, (pkt, kf) in zip(streams[0], want[0]):
        planes, key = dec.decode_frame(pkt)
        assert key == kf and len(planes) == 1
        assert planes[0].dtype == np.uint8 and np.array_equal(planes[0], f)
    pipe = TorchFFV1Decoder(W, H, extradata, batch=2, device="cpu")
    steps = [[w[t][0] for w in want] for t in range(2)]
    pipe.submit_frames(steps[0])
    for t in range(2):
        if t + 1 < 2:
            pipe.submit_frames(steps[t + 1])
        for b, (planes, key) in enumerate(pipe.collect_frames()):
            assert key == want[b][t][1] and len(planes) == 1
            assert np.array_equal(planes[0], streams[b][t]), (b, t)
    assert not pipe.slice_damaged.any()


def test_ya8_device_paths_follow_jax(reference):
    """Range coder: device_out gives the luma and alpha pair, (1, H, W)
    uint8 each, which submit_device_frames takes; re-encoded (a key and a
    non-key frame), the packets equal the JAX classes' chain and the host
    encoder's.
    Golomb-Rice: both decoders refuse device_out and both encoders the
    device-source submit."""
    coder, params, streams, want, _jax, extradata = reference
    pkts = [p for p, _k in want[0][:2]]
    if coder == 0:
        for cls in (lambda *a, **k: TorchFFV1Decoder(*a, device="cpu", **k),
                    TPUFFV1Decoder):
            with pytest.raises(NotImplementedError):
                cls(W, H, extradata, device_out=True)
        planes = tuple(torch.from_numpy(np.ascontiguousarray(
            streams[0][0][None, ..., k])) for k in (0, 1))
        for enc in (TorchFFV1Encoder(_port_params(params), device="cpu"),
                    TPUFFV1Encoder(params)):
            with pytest.raises(NotImplementedError):
                enc.submit_device_frames(planes)
        return
    # the host encoder's packets of the same frames and parameters
    expect = want[0][:2]
    jdec = TPUFFV1Decoder(W, H, extradata, device_out=True)
    jenc = TPUFFV1Encoder(params)
    dec = TorchFFV1Decoder(W, H, extradata, device="cpu", device_out=True)
    enc = TorchFFV1Encoder(_port_params(params), device="cpu")
    for t, pkt in enumerate(pkts):
        planes, keys = dec.decode_frames([pkt])
        jplanes, jkeys = jdec.decode_frames([pkt])
        assert keys == jkeys == [t == 0]
        assert len(planes) == len(jplanes) == 2
        for k, (p, jp) in enumerate(zip(planes, jplanes)):
            assert p.dtype == torch.uint8 and tuple(p.shape) == (1, H, W)
            assert np.array_equal(p.numpy(), np.asarray(jp))
            assert np.array_equal(p[0].numpy(), streams[0][t][..., k])
        enc.submit_device_frames(planes)
        jenc.submit_device_frames(jplanes)
        got, jgot = enc.collect_frames()[0], jenc.collect_frames()[0]
        assert got == jgot == expect[t], t


def test_ya8_nonuniform_grid_follows_jax():
    """A 6-slice 50x40 grid (slices of two widths and two heights), a key
    and a non-key frame: the range coder's packets equal TPUFFV1Encoder's
    and the host's (the decoder's grouped path is
    test_torch_nonuniform_dec.py's); Golomb-Rice there is refused by both
    encoders."""
    params = _params(2, w=50, h=40, slices=6)
    frames = _frames(11, n=2, w=50, h=40)
    host = FFV1Encoder(params)
    want = [host.encode_frame(f) for f in frames]
    jax_enc = TPUFFV1Encoder(params)
    assert [jax_enc.encode_frame(f) for f in frames] == want
    enc = TorchFFV1Encoder(_port_params(params), device="cpu")
    assert not enc.uniform
    assert [enc.encode_frame(f) for f in frames] == want
    golomb = _params(0, w=50, h=40, slices=6)
    for cls in (lambda p: TorchFFV1Encoder(_port_params(p), device="cpu"),
                TPUFFV1Encoder):
        with pytest.raises(NotImplementedError):
            cls(golomb)


def test_ya8_p_encoder_stays_refused():
    """FFV1-P takes planar YUV/gray only, as the JAX package's P
    encoder."""
    from tpu_ffv1.pframe.tpu import TPUFFV1PEncoder
    from tpu_ffv1_torch import TorchFFV1PEncoder
    params = _params(2, gop=12)
    with pytest.raises(NotImplementedError):
        TorchFFV1PEncoder(_port_params(params), experimental=True,
                          device="cpu")
    with pytest.raises(NotImplementedError):
        TPUFFV1PEncoder(params, experimental=True)
