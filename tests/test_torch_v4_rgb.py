"""Version 4 packed RGB through TorchFFV1Encoder / TorchFFV1Decoder on
device="cpu": bgr0 and bgra (coded width 9: K1's and B1's plain
versions) at context models 0 and 1, each slice's RCT coefficients
searched and applied per lane; packets equal to TPUFFV1Encoder's and the
host FFV1Encoder's, and bgr0's decode equal to the host decoder's and
the source (see test_torch_v4.check_encode).  Exact: the codec is
integer."""
import pytest

from .test_torch_v4 import check_encode


@pytest.mark.parametrize("context_model", [0, 1])
@pytest.mark.parametrize("pix_fmt", ["bgr0", "bgra"])
def test_v4_rgb_matches_jax_and_host(pix_fmt, context_model):
    check_encode(pix_fmt, context_model,
                 decode=pix_fmt == "bgr0" and context_model == 0)
