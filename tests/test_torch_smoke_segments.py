"""chip_smoke.segments on the CPU: an encode launch's segments chain their
start states from the kernel relaunched on the prefix, and its tail
(the last segment alone, which holds the far end of config 5's lanes
against the plain version) is the last of those segments; a stats
instance's segments count their own pixels' decisions (K1's: its stats
scan's five outputs, beside its row counts held whole, as
``chip_smoke.stats_recs`` gives them to the plain checks).  On the CPU
the "kernel" is the plain version itself, so this checks the cutting
and the state chaining, not a kernel."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import pytest
import torch

import chip_smoke
from tpu_ffv1_torch.tpu import rc_encode


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("name,bits", [("rc_encode", 10),
                                       ("rc_encode_ext", 11),
                                       ("rc_encode_stats", 8),
                                       ("rc_encode_ext_stats", 16)])
def test_tail_segment_is_the_last_of_the_split(name, bits):
    args = tuple(chip_smoke.random_encode_args("cpu", bits, 4, 600, 48,
                                               seed=bits)) + (bits,)
    stats = name.endswith("_stats")
    out = (rc_encode.rc_encode_stats if stats else
           rc_encode.rc_encode_packed)(*args)
    if stats:
        recs = chip_smoke.stats_recs((args, out), True, "cpu",
                                     0.0 if bits > 10 else (0.0, 0.0))
        assert [r[0] for r in recs] == [name] + \
            ["rc_stats_rows"] * (bits <= 10)
        for rname, (r_args, r_out), _split, _label, _ms in recs[1:]:
            assert chip_smoke.output_digests(
                chip_smoke.plain_version(rname)(*r_args)) == \
                chip_smoke.output_digests(r_out)
        out = recs[0][1][1]
    full = chip_smoke.segments(name, args, out)
    tail = chip_smoke.segments(name, args, out, tail=True)
    cuts = chip_smoke.encode_cuts(600, bits)
    assert len(full) == len(cuts) - 1 == (3 if bits > 10 else 2)
    assert len(tail) == 1
    assert tail[0][0][0].shape[1] == cuts[-1] - cuts[-2]
    assert _same(tail[0][0], full[-1][0]) and _same(tail[0][1], full[-1][1])
    plain = chip_smoke.plain_version(name)
    for seg_args, want in full:
        assert chip_smoke.output_digests(plain(*seg_args)) == \
            chip_smoke.output_digests(want)
    if stats:
        # each segment counts decisions of its own
        assert all(int(seg[1][4].sum()) > 0 for seg in full)
