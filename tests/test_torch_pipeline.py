"""Submit/collect pipelining and the device-source submit of
tpu_ffv1_torch's encoders on the CPU: depth 2 (two submits, then a
collect before each further submit) against TPUFFV1Encoder's
submit_frames / collect_frames and the port's own encode_frames, at
coders 0 and 2, at 16 bits and at version 4 RGB (tests/test_tpu.py:157);
submit_device_frames against the host source (:182); the PCM retry with
a frame in flight, which raises as the JAX class does; the compact
overflow redo, deferred to the collect; and TorchFFV1PEncoder at depth 2
against the host FFV1PEncoder (tests/test_pframe_tpu.py:96), its states
and MV predictors after each collect equal to its depth-1 path's.  The
decoder's half is in test_torch_pipeline_dec.py."""
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from tpu_ffv1 import EncoderParams
from tpu_ffv1.pframe.codec import FFV1PEncoder
from tpu_ffv1.tpu.encoder import TPUFFV1Encoder
from tpu_ffv1_torch import EncoderParams as TorchEncoderParams
from tpu_ffv1_torch import TorchFFV1Encoder, TorchFFV1PEncoder
from tpu_ffv1_torch.tpu import encoder as tenc
from tpu_ffv1_torch.tpu.state import encoder_state_from_numpy

from .test_pframe_tpu import _moving_scene, _params
from .util import synth_frames

W, H = 32, 24

CASES = {
    "rc8": dict(pix_fmt="yuv420p", level=3, coder=2),
    "golomb": dict(pix_fmt="yuv420p", level=3, coder=0),
    "rc16": dict(pix_fmt="yuv444p16le", level=3, coder=2),
    "v4_bgr0": dict(pix_fmt="bgr0", level=4, strict=-2, coder=2),
}


def depth2(enc, steps, submit="submit_frames"):
    """Two submits, then a collect before each further submit; returns
    the collected results in frame order."""
    getattr(enc, submit)(steps[0])
    got = []
    for step in steps[1:] + [None]:
        if step is not None:
            getattr(enc, submit)(step)
        got.append(enc.collect_frames())
    return got


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """One case's frames and the JAX class's depth-2 packets (one JAX
    run per case)."""
    name = request.param
    params = EncoderParams(width=W, height=H, slices=4, gop_size=2,
                           **CASES[name])
    frames = synth_frames(params.pix_fmt, W, H, 3, seed=70)
    want = depth2(TPUFFV1Encoder(params), [[f] for f in frames])
    return name, params, frames, want


def test_depth2_encode_matches_jax_and_encode_frames(case):
    """The port at depth 2 gives TPUFFV1Encoder's depth-2 packets across
    a GOP boundary, which equal the port's encode_frames, and after the
    last collect the same adaptive states as encode_frames leaves."""
    name, params, frames, want = case
    tp = TorchEncoderParams(**vars(params))
    port = TorchFFV1Encoder(tp, device="cpu")
    assert depth2(port, [[f] for f in frames]) == want, name
    seq = TorchFFV1Encoder(tp, device="cpu")
    assert [seq.encode_frames([f]) for f in frames] == want
    if port.golomb:
        assert torch.equal(port.vlc_states, seq.vlc_states)
    else:
        assert torch.equal(port.states, seq.states)
    assert not port.pipe.pending


@functools.lru_cache(maxsize=None)
def host_source(pix):
    """batch 2, 3 frames at GOP 2 (16-bit at 16x12): the parameters, the
    frames and the host-source path's packets (made once per format)."""
    w, h = (W, H) if pix == "yuv420p" else (16, 12)
    params = TorchEncoderParams(width=w, height=h, pix_fmt=pix, level=3,
                                coder=2, slices=4, gop_size=2)
    streams = [synth_frames(pix, w, h, 3, seed=80 + b) for b in range(2)]
    steps = [[s[t] for s in streams] for t in range(3)]
    host = TorchFFV1Encoder(params, batch=2, device="cpu")
    return params, steps, [host.encode_frames(step) for step in steps]


@pytest.mark.parametrize("pix,dtype", [("yuv420p", "uint8"),
                                       ("yuv444p16le", "uint16"),
                                       ("yuv444p16le", "int32")])
def test_device_frames_match_host_source(pix, dtype):
    """submit_device_frames at batch 2, depth 2, on planes already on the
    device (8-bit uint8; 16-bit samples as uint16, widened, or as int32):
    the packets of the host-source path across a GOP boundary."""
    params, steps, want = host_source(pix)
    torch_dtype = getattr(torch, dtype)
    dev_steps = [tuple(torch.from_numpy(np.stack([s[k] for s in step])
                                        .astype(np.int64)).to(torch_dtype)
                       for k in range(3)) for step in steps]
    dev = TorchFFV1Encoder(params, batch=2, device="cpu")
    assert depth2(dev, dev_steps, "submit_device_frames") == want
    with pytest.raises(ValueError):
        dev.submit_device_frames(dev_steps[0][:2])


def test_device_frames_refusals_match_jax():
    """Golomb-Rice, and a version-4 search off a uniform grid, refuse a
    device source, as TPUFFV1Encoder does."""
    for w, kw in ((W, dict(pix_fmt="yuv420p", level=3, coder=0)),
                  # 31 columns: slices 15 and 16 wide
                  (31, dict(pix_fmt="yuv444p16le", level=4, strict=-2,
                            coder=2))):
        params = EncoderParams(width=w, height=H, slices=4, **kw)
        planes = tuple(torch.zeros((1,) + p.shape, dtype=torch.int32)
                       for p in synth_frames(kw["pix_fmt"], params.width,
                                             H, 1)[0])
        port = TorchFFV1Encoder(TorchEncoderParams(**vars(params)),
                                device="cpu")
        with pytest.raises(NotImplementedError):
            port.submit_device_frames(planes)
        with pytest.raises(NotImplementedError):
            TPUFFV1Encoder(params).submit_device_frames(planes)


def test_pcm_with_a_frame_in_flight_raises_as_jax():
    """Version 4's PCM retry (chip_smoke's v4_pcm content, stream 0 at
    batch 1: its slices overflow the row budget in frame 0) with frame 1
    already submitted raises RuntimeError, as TPUFFV1Encoder does
    (test_torch_v4.py holds the retry at depth 1)."""
    frames = chip_smoke.synthetic_streams_pcm()[0][:2]
    params = EncoderParams(**chip_smoke.pcm_kw())
    jaxe = TPUFFV1Encoder(params)
    port = TorchFFV1Encoder(TorchEncoderParams(**vars(params)), device="cpu")
    for enc in (jaxe, port):
        enc.submit_frames([frames[0]])
        enc.submit_frames([frames[1]])
        with pytest.raises(RuntimeError, match="frames in flight"):
            enc.collect_frames()


def _spy(monkeypatch, name):
    calls = []
    fn = getattr(tenc, name)

    def spy(*a):
        calls.append(1)
        return fn(*a)

    monkeypatch.setattr(tenc, name, spy)
    return calls


def test_compact_overflow_redo_runs_in_collect(monkeypatch):
    """The compact form on adversarial states (every state 1: each
    decision emits a byte) overflows; at depth 2 its redo on the raw scan
    and the full-width finalize run in the collect, after the next frame
    was submitted, from the frame's kept planes and start states, and the
    packets and states equal the raw form's at depth 1."""
    raw = _spy(monkeypatch, "rc_encode_packed")
    full = _spy(monkeypatch, "finalize_packed_full")
    params = TorchEncoderParams(width=W, height=H, pix_fmt="yuv420p",
                                level=3, coder=2, slices=4, gop_size=12)
    r = np.random.RandomState(61)
    frames = [[r.randint(0, 256, s).astype(np.uint8)
               for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
              for _ in range(2)]
    encs = [TorchFFV1Encoder(params, device="cpu", compact=c)
            for c in (True, False)]
    adversarial = np.ones((4, encs[0].total_cc, 32), np.uint8)
    for enc in encs:
        encoder_state_from_numpy(enc, adversarial, 1)
    want = [encs[1].encode_frame(f) for f in frames]
    comp = encs[0]
    comp.submit_frames([frames[0]])
    comp.submit_frames([frames[1]])
    before = len(raw), len(full)
    got = [comp.collect_frames()[0]]
    assert (len(raw), len(full)) > before, "no redo in the collect"
    got.append(comp.collect_frames()[0])
    assert got == want
    assert torch.equal(comp.states, encs[1].states)


def test_pframe_depth2_matches_host_and_depth1():
    """TorchFFV1PEncoder at depth 2 (a keyframe, P frames, the next
    keyframe at GOP 3): the host FFV1PEncoder's packets; its states and
    MV predictors after each collect equal those the depth-1 path holds
    once it has encoded the same frames as were submitted."""
    frames = _moving_scene(n=4, w=48, h=32)
    params = _params(gop_size=3, width=48, height=32)
    host = FFV1PEncoder(params, experimental=True)
    want = [host.encode_frame(f) for f in frames]
    tp = TorchEncoderParams(**vars(params))
    seq = TorchFFV1PEncoder(tp, experimental=True, device="cpu")
    seq_state = []
    for f, w in zip(frames, want):
        assert seq.encode_frames([f])[0] == w
        seq_state.append((seq.states.clone(), seq.prev_mvs.clone()))
    pipe = TorchFFV1PEncoder(tp, experimental=True, device="cpu")
    pipe.submit_frames([frames[0]])
    got = []
    for t in range(len(frames)):
        if t + 1 < len(frames):
            pipe.submit_frames([frames[t + 1]])
        got.append(pipe.collect_frames()[0])
        st, mv = seq_state[min(t + 1, len(frames) - 1)]
        assert torch.equal(pipe.states, st) and \
            torch.equal(pipe.prev_mvs, mv), t
    assert got == want
