"""Static range-coder slot schedules (fast: coded widths <= 10 bits;
extended: 11..17).

Re-derived from ``tpu_ffv1/tpu/rc_scan_fast.py`` (which imports jax).
At bits <= 10 every binary decision of one pixel lands in a distinct
position of the pixel's 32-byte context row (state layout ffv1.h: [0]
zero flag, [1..10] exponent chain, [11..21] sign, [22..31] mantissa),
and the coding order is the static sequence

    [0, 1, .., e_max + 1, 22 + e_max - 1, .., 22, 11, .., 11 + e_max]

(zero flag, exponent ascending with its stop bit, mantissa MSB -> LSB,
sign candidates; put_symbol, ffv1enc.c:185-231).
"""
from __future__ import annotations


def chain_order(bits: int):
    """Static coding-order position list for bit depth <= 10."""
    e_max = bits - 1
    if e_max > 9:
        raise ValueError("the fast schedule requires bit depth <= 10")
    return ([0] + list(range(1, e_max + 2)) +
            list(range(22 + e_max - 1, 21, -1)) +
            list(range(11, 11 + e_max + 1)))


def slot_count(bits: int) -> int:
    return len(chain_order(bits))


def ext_slots(bits: int):
    """Static decision list for coded widths 11..17 bits (e_max 10..16).

    put_symbol caps the exponent row at 1 + min(j, 9) and the mantissa
    row at 22 + min(i, 9) (ffv1enc.c:185-231), so above 10 bits rows 10
    and 31 carry several decisions per pixel, each with the state the
    previous one left.  Slot descriptors in coding order:

      ("zero",)     row 0,             bit = (v == 0)
      ("exp", j)    row 1 + min(j, 9), j = 0..e_max, active j <= e,
                    bit = j < e (j >= 9 repeats row 10)
      ("man31", r)  row 31, r = 0..e_max - 10, active e >= 10 + r,
                    bit = (a >> (e - 1 - r)) & 1 (repeats row 31)
      ("man", i)    row 22 + i, i = 8..0, active i < e, bit = (a >> i) & 1
      ("sign",)     row 11 + min(e, 10), bit = v < 0

    33 slots at 16 bits, 2 * bits + 1 in general.
    """
    e_max = bits - 1
    if not 10 <= e_max <= 16:
        raise ValueError("the extended schedule covers bit depths 11..17")
    return ([("zero",)] + [("exp", j) for j in range(e_max + 1)] +
            [("man31", r) for r in range(e_max - 9)] +
            [("man", i) for i in range(8, -1, -1)] + [("sign",)])


def chain_order_nosign(bits: int):
    """chain_order without the sign candidates: exactly one sign
    position (11 + e) codes per nonzero pixel, so the kernels fold them
    into one trailing dynamic slot.  The kernels' slot count is
    ``len(chain_order_nosign(bits)) + 1`` (17 at 8 bits)."""
    return chain_order(bits)[:-bits]
