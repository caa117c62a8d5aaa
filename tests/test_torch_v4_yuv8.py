"""Version 4 at 8 bits without the RCT search through TorchFFV1Encoder
on device="cpu": yuv420p, gray (one plane fewer in the slice header at
version 4, codec/params.py) and Golomb-Rice on yuv420p (the v4 header
fields with (1, 1), no budget check), at context models 0 and 1; packets
equal to TPUFFV1Encoder's and the host FFV1Encoder's (see
test_torch_v4.check_encode).  Exact: the codec is integer."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import pytest

from .test_torch_v4 import check_encode


@pytest.mark.parametrize("context_model", [0, 1])
@pytest.mark.parametrize("pix_fmt,coder", [
    ("yuv420p", 2), ("gray", 2), ("yuv420p", 0)],
    ids=["yuv420p", "gray", "golomb"])
def test_v4_8bit_matches_jax_and_host(pix_fmt, coder, context_model):
    check_encode(pix_fmt, context_model, coder)
