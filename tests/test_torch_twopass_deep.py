"""Two-pass encoding, both passes, port against host on the CPU, at the
extended coded widths and on RGB: yuv444p16le (K1-ext's stats instance,
the running rows 10 and 31), yuv420p16le at context model 1 and bgr0
(coded width 9, state planes 0, 1, 1) (tests/twopass_cases.py: pass 1's
text and packets equal to the host spec encoder's, pass 2's extradata
and packets to the host native encoder's from that text).  Above 8 bits
the host's pass-2 extradata carries 666 and 7,563 rows of initial states
where its quant tables have 365 and 5,063 contexts, so no decoder reads
it; the port writes the same bytes.  Exact: the codec is integer."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import pytest

from .twopass_cases import check_two_pass


@pytest.mark.parametrize("name", ["16bit", "16bit_ctx1", "bgr0"])
def test_two_pass_matches_host(name):
    check_two_pass(name)
