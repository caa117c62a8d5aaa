"""The port's RGB path at the planar deep formats gbrp9le, gbrp10le,
gbrp12le and gbrp14le (coded widths 10, 11, 13 and 15: K1 / B1 at 10,
K1-ext / B1-ext above) on device="cpu", at context models 0 and 1, GOP
2, batch 2: packets equal to TPUFFV1Encoder's and the host
FFV1Encoder's, decodes equal to the host FFV1Decoder's (three uint16
planes in the format's order).  Exact: the codec is integer."""
import pytest

from .test_torch_rgb import check_decode, check_encode

DEEP = ["gbrp9le", "gbrp10le", "gbrp12le", "gbrp14le"]


@pytest.mark.parametrize("context_model", [0, 1])
@pytest.mark.parametrize("pix_fmt", DEEP)
def test_encoder_matches_jax_and_host(pix_fmt, context_model):
    check_encode(pix_fmt, context_model)


@pytest.mark.parametrize("context_model", [0, 1])
@pytest.mark.parametrize("pix_fmt", DEEP)
def test_decoder_matches_host(pix_fmt, context_model):
    check_decode(pix_fmt, context_model)
