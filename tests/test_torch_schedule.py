"""Re-derived slot schedules equal tpu_ffv1.tpu.rc_scan_fast's (exact:
they are static integer lists)."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import pytest

from tpu_ffv1.tpu import rc_scan_fast as jax_sched
from tpu_ffv1_torch.tpu import schedule


@pytest.mark.parametrize("bits", range(1, 11))
def test_schedule_matches_jax(bits):
    assert schedule.chain_order(bits) == jax_sched.chain_order(bits)
    assert schedule.chain_order_nosign(bits) == \
        jax_sched.chain_order_nosign(bits)
    assert schedule.slot_count(bits) == jax_sched.slot_count(bits)
    # the kernels' slot count: distinct slots + one collapsed sign slot
    assert len(schedule.chain_order_nosign(bits)) + 1 == 2 * bits + 1


def test_fast_schedule_rejects_deep_widths():
    with pytest.raises(ValueError):
        schedule.chain_order(11)


@pytest.mark.parametrize("bits", range(11, 18))
def test_ext_slots_match_jax(bits):
    assert schedule.ext_slots(bits) == jax_sched.ext_slots(bits)
    # the ext kernels' slot count: 33 at 16 bits
    assert len(schedule.ext_slots(bits)) == 2 * bits + 1


@pytest.mark.parametrize("bits", [10, 18])
def test_ext_slots_reject_other_widths(bits):
    with pytest.raises(ValueError):
        schedule.ext_slots(bits)
