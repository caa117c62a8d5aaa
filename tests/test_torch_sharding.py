"""The port's multi-device layer (tpu_ffv1_torch/tpu/sharding.py and the
classes' ``devices=``) on the CPU, where a device list names the CPU more
than once (``["cpu"] * n``: the lanes split into n blocks run one after
another, the counterpart of the JAX tests' virtual devices).  The two
sharded functions equal the JAX package's on the same inputs; the
classes give the host encoders' packets (as tests/test_sharding.py holds
the JAX classes to them) and lossless decodes; a GOP carried over from
the JAX class; the refusals (the decoder's device counts and
``__graft_entry__.dryrun_multichip``'s legs: test_torch_sharding_dec.py).
Every comparison is exact."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import numpy as np
import pytest
import torch

from tpu_ffv1 import EncoderParams, FFV1Encoder
from tpu_ffv1.core import tables as T
from tpu_ffv1.core.rac import default_state_tables
from tpu_ffv1.tpu.encoder import TPUFFV1Encoder
from tpu_ffv1_torch import (TorchFFV1Decoder, TorchFFV1Encoder,
                            TorchFFV1PEncoder)
from tpu_ffv1_torch.tpu import sharding
from tpu_ffv1_torch.tpu.state import encoder_state_from_numpy

from .test_sharding import _frames
from .test_torch_codec import _frames as codec_frames
from .util import synth_frames


def cpus(n):
    return ["cpu"] * n


def _params(coder=-2, gop=2, **kw):
    d = dict(width=64, height=32, pix_fmt="yuv420p", level=3, coder=coder,
             slices=4, slicecrc=1, gop_size=gop)
    d.update(kw)
    return EncoderParams(**d)


def _host_packets(params, streams):
    """Each stream through its own host encoder (engine "spec")."""
    out = []
    for frames in streams:
        host = FFV1Encoder(params, engine="spec")
        out.append([host.encode_frame(f) for f in frames])
    return out


def _encode(enc, streams):
    """[stream][frame] (packet, keyframe) of ``streams`` through enc."""
    got = [enc.encode_frames([s[t] for s in streams])
           for t in range(len(streams[0]))]
    return [[got[t][b] for t in range(len(got))] for b in range(len(streams))]


# --------------------------------------------- the two sharded functions


def _encode_args(seed=0, L=4, N=64):
    one, zero = default_state_tables()
    r = np.random.RandomState(seed)
    CC = T.CONTEXT_COUNTS[0]
    return dict(
        ctx=r.randint(0, CC, (L, N)).astype(np.int32),
        diff=r.randint(-100, 100, (L, N)).astype(np.int32),
        active=r.rand(L, N) < 0.9,
        states0=r.randint(1, 256, (L, CC, 32)).astype(np.uint8),
        one_tab=one, zero_tab=zero,
        lows=np.zeros(L, np.int32), ranges=np.full(L, 0xFF00, np.int32),
        prefixes=r.randint(0, 256, (L, 8)).astype(np.int32),
        plens=r.randint(0, 9, L).astype(np.int32))


def test_encode_lanes_sharded_matches_jax():
    """L=4, N=64, 8 bits over 2 devices: the bytes up to each lane's
    count, the counts and the states equal the JAX function's (XLA scan
    on a 2-device CPU mesh)."""
    import jax.numpy as jnp
    from tpu_ffv1.tpu import sharding as jsh
    a = _encode_args()
    want = jsh.encode_lanes_sharded(
        jsh.make_mesh(2), *(jnp.asarray(v) for v in a.values()), 8,
        use_pallas=False)
    got = sharding.encode_lanes_sharded(
        cpus(2), *(torch.from_numpy(v) for v in a.values()), 8)
    out_w, cnt_w, st_w = (np.asarray(x) for x in want)
    out_g, cnt_g, st_g = (x.numpy() for x in got)
    assert np.array_equal(cnt_g, cnt_w)
    for li, n in enumerate(cnt_w):
        assert np.array_equal(out_g[li, :n], out_w[li, :n]), li
    assert np.array_equal(st_g, st_w)


def test_decode_lanes_sharded_matches_jax():
    """The lane buffers of host-encoded packets (48x32 yuv420p, 4 slices,
    batch 2, a keyframe) decoded over 2 devices: planes, states, low,
    range and pos equal the JAX function's."""
    import jax.numpy as jnp
    from tpu_ffv1.tpu import sharding as jsh
    params = _params(coder=2, width=48)
    frames = _frames(48, 32, 1, seed=4)
    pkts = [FFV1Encoder(params, engine="spec").encode_frame(f)[0]
            for f in (frames[0], [p[::-1].copy() for p in frames[0]])]
    dec = TorchFFV1Decoder(48, 32, FFV1Encoder(params).extradata, batch=2,
                           device="cpu")
    parsed = [dec._parse_packet(b, p) for b, p in enumerate(pkts)]
    (bufs, lows, ranges, poss), _lens = dec._lane_buffers(parsed)
    cc = dec.g.context_counts[0]
    specs = tuple((w, h, sp * cc) for (w, h, sp) in dec._plane_specs())
    states = torch.full((dec.L, dec.n_state_planes * cc, 32), 128,
                        dtype=torch.uint8)
    one, zero = default_state_tables()
    qt = dec.qts[0]
    args = (bufs, states, torch.from_numpy(one), torch.from_numpy(zero), qt,
            lows, ranges, poss)
    got = sharding.decode_lanes_sharded(cpus(2), *args, specs, 8, False)
    want = jsh.decode_lanes_sharded(
        jsh.make_mesh(2), *(jnp.asarray(a.numpy()) for a in args), specs,
        8, False, use_pallas=False)
    for g, w in zip(got[0], want[0]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------ the classes


@pytest.fixture(scope="module")
def yuv420():
    """64x32 yuv420p, 4 slices, batch 2 (8 lanes), GOP 2, 2 frames: the
    streams, the host encoders' packets and the unsharded port's."""
    params = _params()
    fr = _frames(64, 32, 2)
    streams = [fr, [[p[::-1].copy() for p in f] for f in fr]]
    want = _host_packets(params, streams)
    alone = _encode(TorchFFV1Encoder(params, batch=2, device="cpu"), streams)
    assert alone == want
    return params, streams, want


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_encoder_packets_invariant_to_device_count(yuv420, ndev):
    params, streams, want = yuv420
    enc = TorchFFV1Encoder(params, batch=2, devices=cpus(ndev))
    assert enc.device == torch.device("cpu")
    assert _encode(enc, streams) == want, f"ndev={ndev}"


def test_encoder_depth2_equals_depth1(yuv420):
    """Two submits, then a collect before each further submit, over 2
    devices: the same packets and, after the last collect, the same
    states as encode_frames."""
    params, streams, want = yuv420
    enc = TorchFFV1Encoder(params, batch=2, devices=cpus(2))
    steps = [[s[t] for s in streams] for t in range(2)]
    enc.submit_frames(steps[0])
    enc.submit_frames(steps[1])
    got = [enc.collect_frames(), enc.collect_frames()]
    assert [[got[t][b] for t in range(2)] for b in range(2)] == want
    seq = TorchFFV1Encoder(params, batch=2, device="cpu")
    _encode(seq, streams)
    assert torch.equal(enc.states, seq.states)


@pytest.mark.parametrize("ndev", [2, 8])
def test_golomb_packets_invariant_to_device_count(ndev):
    """Coder 0 (G1's plain version per lane block) over ndev devices."""
    params = _params(coder=0, gop=12)
    fr = _frames(64, 32, 2)
    streams = [fr, fr]
    want = _host_packets(params, streams)
    enc = TorchFFV1Encoder(params, batch=2, devices=cpus(ndev))
    assert _encode(enc, streams) == want


def test_16bit_encode_and_decode_over_two_devices():
    """yuv444p16le 32x16 (K1-ext's and K2-ext's plain versions per lane
    block), a key and a non-key frame of noise: the host's packets, a
    lossless decode."""
    params = _params(coder=2, width=32, height=16, pix_fmt="yuv444p16le")
    rng = np.random.RandomState(6)
    frames = [[rng.randint(0, 65536, (16, 32)).astype(np.uint16)
               for _ in range(3)] for _ in range(2)]
    want = _host_packets(params, [frames])[0]
    enc = TorchFFV1Encoder(params, devices=cpus(2))
    assert [enc.encode_frame(f) for f in frames] == want
    dec = TorchFFV1Decoder(32, 16, enc.extradata, devices=cpus(2))
    for (pkt, _k), f in zip(want, frames):
        planes, _ = dec.decode_frame(pkt)
        assert all(np.array_equal(a, b) for a, b in zip(planes, f))


def test_v4_rgb_over_two_devices():
    """bgr0 at version 4 (the RCT search, the row budget on the gathered
    raw slots) over 2 devices: the host's packets and a lossless
    decode."""
    params = EncoderParams(width=32, height=16, pix_fmt="bgr0", level=4,
                           strict=-2, coder=2, slices=4, gop_size=2)
    frames = synth_frames("bgr0", 32, 16, 2, seed=11)
    want = _host_packets(params, [frames])[0]
    enc = TorchFFV1Encoder(params, devices=cpus(2))
    assert [enc.encode_frame(f) for f in frames] == want
    dec = TorchFFV1Decoder(32, 16, enc.extradata, devices=cpus(2))
    for (pkt, _k), f in zip(want, frames):
        planes, _ = dec.decode_frame(pkt)
        assert np.array_equal(planes[0], f[0])


def test_gop_begun_in_jax_continues_in_sharded_port():
    """Frames 0-1 in the unsharded TPUFFV1Encoder, frames 2-3 in the port
    over 2 devices after encoder_state_from_numpy: JAX's bytes alone."""
    params = EncoderParams(width=48, height=40, pix_fmt="yuv420p", level=3,
                           coder=2, slices=4, gop_size=4)
    frames = codec_frames(48, 40, 4, seed=7)
    host = FFV1Encoder(params, engine="spec")
    want = [host.encode_frame(f) for f in frames]
    jaxe = TPUFFV1Encoder(params)
    got = [jaxe.encode_frame(f) for f in frames[:2]]
    port = TorchFFV1Encoder(params, devices=cpus(2))
    encoder_state_from_numpy(port, np.asarray(jaxe.states),
                             jaxe.picture_number)
    got += [port.encode_frame(f) for f in frames[2:]]
    assert got == want and not want[2][1]


# ------------------------------------------------------- the refusals


def test_refusals():
    """A lane count the device count does not divide raises ValueError in
    both classes and both functions, as in the JAX package; so does a
    device= that is not devices[0]; make_devices asks for CUDA devices
    and raises where there are too few (here: none)."""
    params = _params()                        # 4 slices x batch 2 = 8 lanes
    with pytest.raises(ValueError, match="not divisible"):
        TorchFFV1Encoder(params, batch=2, devices=cpus(3))
    with pytest.raises(ValueError, match="not divisible"):
        TorchFFV1PEncoder(params, batch=1, experimental=True,
                          devices=cpus(8))
    with pytest.raises(ValueError, match="not divisible"):
        TorchFFV1Decoder(64, 32, FFV1Encoder(params).extradata, batch=1,
                         devices=cpus(3))
    with pytest.raises(ValueError, match="devices\\[0\\]"):
        TorchFFV1Encoder(params, batch=2, device="cuda", devices=cpus(2))
    a = {k: torch.from_numpy(v) for k, v in _encode_args(L=6).items()}
    with pytest.raises(ValueError, match="not divisible"):
        sharding.encode_lanes_sharded(cpus(4), *a.values(), 8)
    with pytest.raises(ValueError, match="not divisible"):
        sharding.decode_lanes_sharded(
            cpus(4), torch.zeros((6, 64), dtype=torch.uint8),
            torch.full((6, 2 * 1332, 32), 128, dtype=torch.uint8),
            a["one_tab"], a["zero_tab"], torch.zeros((5, 256),
                                                     dtype=torch.int32),
            a["lows"], a["ranges"], torch.zeros(6, dtype=torch.int32),
            ((4, 4, 0),), 8, False)
    with pytest.raises(ValueError, match="need 1 CUDA devices"):
        sharding.make_devices(1)
    with pytest.raises(RuntimeError):
        TorchFFV1Encoder(params, batch=2, devices=["cuda"] * 2)
