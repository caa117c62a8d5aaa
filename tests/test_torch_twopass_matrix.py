"""Two-pass encoding, both passes, port against host on the CPU, 8-bit
planar YUV: coders 1, 2 and -2 (both state-transition tables), context
models 0 and 1, Golomb-Rice, a non-uniform grid (50x24, 4 slices) and
version 4 (tests/twopass_cases.py: pass 1's text and packets equal to
the host spec encoder's, pass 2's extradata and packets to the host
native encoder's from that text).  Exact: the codec is integer."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import pytest

from .twopass_cases import check_two_pass


@pytest.mark.parametrize("name", ["coder2", "coder1_ctx1", "default_table",
                                  "golomb", "nonuniform", "v4"])
def test_two_pass_matches_host(name):
    check_two_pass(name)
