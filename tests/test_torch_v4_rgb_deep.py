"""Version 4 planar RGB above 8 bits through TorchFFV1Encoder /
TorchFFV1Decoder on device="cpu": gbrp10le and gbrp14le (coded widths 11
and 15: K1-ext's and B1-ext's plain versions) at context models 0 and 1,
each slice's RCT coefficients searched and applied per lane; packets
equal to TPUFFV1Encoder's and the host FFV1Encoder's, and gbrp14le's
decode equal to the host decoder's and the source (see
test_torch_v4.check_encode).  Exact: the codec is integer."""
import pytest

from .test_torch_v4 import check_encode


@pytest.mark.parametrize("context_model", [0, 1])
@pytest.mark.parametrize("pix_fmt", ["gbrp10le", "gbrp14le"])
def test_v4_deep_rgb_matches_jax_and_host(pix_fmt, context_model):
    check_encode(pix_fmt, context_model,
                 decode=pix_fmt == "gbrp14le" and context_model == 0)
