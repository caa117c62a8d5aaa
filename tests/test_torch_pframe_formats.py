"""TorchFFV1PEncoder on the CPU against the host FFV1PEncoder beyond
8-bit 4:2:0: 10-bit 4:2:2 (residuals at 11 bits through K1-ext's plain
version; 48x36 slices whose blocks pad 12 rows, chroma blocks 16x8) and
gray with blocks padded in both directions."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import numpy as np

from tpu_ffv1 import EncoderParams

from .test_pframe import _panning_texture
from .test_torch_pframe import _assert_port_matches


def _frames_422p10(n=4, w=96, h=72, seed=4):
    """The 10-bit 4:2:2 P content of tests/test_pframe_tpu.py; at 96x72
    the 48x36 slices pad 12 rows to their 16-row blocks."""
    rng = np.random.RandomState(seed)
    base = (np.add.outer(np.arange(h + 32), np.arange(w + 32)) * 9
            % 1024).astype(np.uint16)
    frames = []
    for t in range(n):
        y = ((base[t:t + h, 2 * t:2 * t + w] +
              rng.randint(0, 24, (h, w))) & 1023).astype(np.uint16)
        u = (rng.randint(0, 40, (h, w // 2)) + 300).astype(np.uint16)
        v = (rng.randint(0, 40, (h, w // 2)) + 600).astype(np.uint16)
        frames.append([y, u, v])
    return frames



def test_422p10_padded_matches_host():
    params = EncoderParams(width=96, height=72, pix_fmt="yuv422p10le",
                           level=3, coder=2, slices=4, gop_size=3,
                           slicecrc=1)
    port = _assert_port_matches(params, [_frames_422p10()])
    assert port.p_bits == 11 and port.pad_h == 12 and port.pad_w == 0


def test_gray_padded_matches_host():
    frames = [[f[0][:60, :88]] for f in _panning_texture(n=4)]
    params = EncoderParams(width=88, height=60, pix_fmt="gray8", level=3,
                           coder=2, slices=4, gop_size=4)
    port = _assert_port_matches(params, [frames], radius=4)
    assert (port.pad_h, port.pad_w) == (2, 4)
