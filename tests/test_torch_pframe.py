"""TorchFFV1PEncoder on the CPU against the JAX package's FFV1-P
encoders: its packets equal the host FFV1PEncoder's (byte-identical to
the JAX device class by tests/test_pframe_tpu.py) for batch 1 and 2,
context model 1, the EPZS search and reset(), and through the overflow
redo; the committed P format golden is reproduced
(test_torch_pframe_formats.py holds 10-bit 4:2:2 and gray,
test_torch_pframe_state.py the carried state and the refusals)."""
import hashlib
import os

import numpy as np
import pytest

from tpu_ffv1 import EncoderParams
from tpu_ffv1.pframe.codec import FFV1PEncoder
from tpu_ffv1_torch import EncoderParams as TorchEncoderParams
from tpu_ffv1_torch import TorchFFV1PEncoder

from .test_pframe import _panning_texture
from .test_pframe_tpu import H, W, _moving_scene, _params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(params, **kw):
    return TorchFFV1PEncoder(TorchEncoderParams(**vars(params)),
                             experimental=True, device="cpu", **kw)


def _host_packets(params, streams, **kw):
    out = []
    for frames in streams:
        host = FFV1PEncoder(params, experimental=True, **kw)
        out.append([host.encode_frame(f) for f in frames])
    return out


def _assert_port_matches(params, streams, **kw):
    want = _host_packets(params, streams, **kw)
    port = _port(params, batch=len(streams), **kw)
    for t in range(len(streams[0])):
        got = port.encode_frames([s[t] for s in streams])
        for b, (pkt, key) in enumerate(got):
            assert key == want[b][t][1], (b, t)
            assert pkt == want[b][t][0], f"stream {b} frame {t} bytes"
    return port


def _smooth_pan(n=5, w=W, h=H):
    """The EPZS test's content (tests/test_pframe_tpu.py): box-blurred
    random texture panned by (1, 2) per frame."""
    rng = np.random.RandomState(8)
    field = rng.randint(0, 255, (h + 80, w + 80)).astype(np.float64)
    k = 7
    c = np.pad(np.cumsum(np.cumsum(field, 0), 1), ((k, 0), (k, 0)))
    smooth = ((c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k])
              / (k * k)).astype(np.uint8)
    return [[smooth[t:t + h, 2 * t:2 * t + w].copy(),
             (np.full((h // 2, w // 2), 100) + t).astype(np.uint8),
             np.full((h // 2, w // 2), 160, np.uint8)] for t in range(n)]


@pytest.mark.parametrize("batch", [1, 2])
def test_packets_match_host(batch):
    streams = [_moving_scene(seed=5), _moving_scene(seed=9)][:batch]
    port = _assert_port_matches(_params(), streams)
    assert port.p_bits == 9 and port.mv_base == port.total_cc - 3


def test_context_model_1_matches_host():
    _assert_port_matches(_params(context_model=1, strict=-2),
                         [_moving_scene(n=4)])


def test_epzs_matches_host():
    _assert_port_matches(_params(), [_smooth_pan()], me="epzs")


def test_reset_restarts_the_gop():
    frames = _moving_scene(n=4)
    host = FFV1PEncoder(_params(), experimental=True)
    port = _port(_params())
    for f in frames[:2]:
        assert port.encode_frames([f])[0] == host.encode_frame(f)
    host.reset()
    port.reset()
    assert port.ref_dev is None and not port.prev_mvs.any()
    for f in frames[2:]:
        assert port.encode_frames([f])[0] == host.encode_frame(f)


def test_format_golden_reproduced():
    """goldens/pframe_v3.sha256 (tests/test_pframe.py's fixture),
    read only."""
    params = EncoderParams(width=96, height=80, pix_fmt="yuv420p", level=3,
                           coder=2, slices=4, gop_size=8, slicecrc=1)
    port = _port(params)
    digest = hashlib.sha256()
    for f in _panning_texture(n=3):
        digest.update(port.encode_frames([f])[0][0])
    with open(os.path.join(REPO, "goldens", "pframe_v3.sha256")) as fh:
        assert digest.hexdigest() == fh.read().strip()


def test_overflow_redo_serves_p_frames(monkeypatch):
    """A frame whose finalize reports a pixel past its s2 slots is redone
    by finalize_packed_full from the raw scan, keyframes and P frames
    alike: the finalize below flags every frame and leaves its bytes
    zeroed, so every packet comes from the redo."""
    from tpu_ffv1_torch.tpu import encoder as tenc
    real = tenc.finalize_packed

    def flagged(*args):
        out, counts, overflow = real(*args)
        return out.zero_(), counts, overflow | True

    monkeypatch.setattr(tenc, "finalize_packed", flagged)
    _assert_port_matches(_params(), [_moving_scene(n=4)])
