"""The port's slice over its other planar layouts, on device="cpu":
packets byte-identical to the host FFV1Encoder and a lossless decode by
TorchFFV1Decoder (exact: integer codec)."""
import numpy as np
import pytest

from .util import synth_frames
from tpu_ffv1 import EncoderParams, FFV1Encoder
from tpu_ffv1_torch import TorchFFV1Decoder, TorchFFV1Encoder


@pytest.mark.parametrize("pix", ["gray", "yuv422p", "yuv444p", "yuva420p",
                                 "yuv420p10le", "yuv420p16le", "gray16le",
                                 "yuva444p16le"])
def test_pixel_formats_roundtrip(pix):
    """The slice's other planar layouts: no chroma, other subsampling,
    an alpha plane (state plane 2), 10-bit samples, and 16-bit samples
    through the extended schedule (uint16 out, samples past 0x7FFF)."""
    params = EncoderParams(width=32, height=24, pix_fmt=pix, level=3,
                           coder=2, slices=4, gop_size=2)
    frames = synth_frames(pix, 32, 24, 2)
    host = FFV1Encoder(params)
    port = TorchFFV1Encoder(params, device="cpu")
    dec = TorchFFV1Decoder(32, 24, port.extradata, device="cpu")
    for i, f in enumerate(frames):
        pkt = port.encode_frame(f)
        assert pkt == host.encode_frame(f), f"frame {i}"
        planes, _ = dec.decode_frame(pkt[0])
        assert len(planes) == len(f)
        for a, b in zip(planes, f):
            assert a.dtype == b.dtype and np.array_equal(a, b)
