"""Version 4 4:4:4 YUV above 8 bits through TorchFFV1Encoder /
TorchFFV1Decoder on device="cpu": yuv444p10le (K1's plain version) and
yuv444p16le (K1-ext's, K2-ext's) at context models 0 and 1.  The
reference runs the RCT search on these planes too, and its pairs go
into the slice headers only; packets equal to TPUFFV1Encoder's and the
host FFV1Encoder's, and yuv444p16le's decode equal to the host
decoder's and the source (see test_torch_v4.check_encode).  Exact: the
codec is integer."""
import pytest

from .test_torch_v4 import check_encode


@pytest.mark.parametrize("context_model", [0, 1])
@pytest.mark.parametrize("pix_fmt", ["yuv444p10le", "yuv444p16le"])
def test_v4_yuv444_matches_jax_and_host(pix_fmt, context_model):
    check_encode(pix_fmt, context_model,
                 decode=pix_fmt == "yuv444p16le" and context_model == 0)
