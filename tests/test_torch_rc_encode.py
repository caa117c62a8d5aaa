"""Encode lane scan: the plain PyTorch versions (which rc_encode_packed
runs for CPU tensors) equal the JAX kernels on the same numpy inputs.
Every comparison is exact: the codec is integer and lossless.

Against the Pallas kernel (interpret mode, as tests/test_pallas.py runs
it): emit flags and coder/state outputs everywhere, provisional values
where a slot emits (the port stores 0 in silent slots, the Pallas kernel
an unused value).  Against the XLA scan: the finalized bytes.
"""
from .torch_cpu import plain_inference_mode  # noqa: F401
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tpu_ffv1.core import tables as T
from tpu_ffv1.core.rac import custom_state_tables, default_state_tables
from tpu_ffv1.tpu.rc_pallas import rc_encode_pallas_packed
from tpu_ffv1.tpu.rc_scan_lanes import (finalize_packed_full,
                                        rc_encode_scan_lanes_ext,
                                        rc_encode_scan_lanes_unrolled)
from tpu_ffv1_torch.tpu import finalize as tfin
from tpu_ffv1_torch.tpu import rc_encode as tenc
from tpu_ffv1_torch.tpu.rc_encode import (rc_encode_packed,
                                          rc_encode_packed_ext_ref)


def _inputs(L, N, bits, seed, tables="default"):
    r = np.random.RandomState(seed)
    CC = T.CONTEXT_COUNTS[0]
    half = 1 << (bits - 1)
    ctx = r.randint(0, CC, (L, N)).astype(np.int32)
    diff = r.randint(-6, 7, (L, N))
    big = r.rand(L, N) < 0.08
    diff = np.where(big, r.randint(-half, half, (L, N)), diff)
    diff[:, :3] = [-half, half - 1, 0]           # the extremes of the fold
    act = r.rand(L, N) < 0.9
    states = r.randint(1, 256, (L, CC, 32)).astype(np.uint8)
    one, zero = (default_state_tables() if tables == "default"
                 else custom_state_tables(T.VER2_STATE))
    low = r.randint(0, 1 << 16, L).astype(np.int32)
    rng = r.randint(0x100, 0xFF01, L).astype(np.int32)
    return (ctx, diff.astype(np.int32), act, states, one, zero, low, rng)


def _torch(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def test_matches_pallas_kernel_interpret():
    args = _inputs(3, 512, 8, 0)
    with pltpu.force_tpu_interpret_mode():
        pk, l1, r1, s1 = rc_encode_pallas_packed(
            *[jnp.asarray(a) for a in args], 8, 128)
    pk = np.asarray(pk)
    tp, tl, tr, ts = rc_encode_packed(*_torch(args), 8)
    tp = tp.numpy()
    assert tp.shape == pk.shape == (512, 17, 3)
    emit = (pk >> 20) & 1
    assert emit.sum() > 0
    assert np.array_equal((tp >> 20) & 1, emit)
    assert np.array_equal(tp, np.where(emit == 1, pk, 0))
    assert np.array_equal(tl.numpy(), np.asarray(l1))
    assert np.array_equal(tr.numpy(), np.asarray(r1))
    assert np.array_equal(ts.numpy(), np.asarray(s1))


@pytest.mark.parametrize("bits,tables", [(8, "custom"), (10, "default")])
def test_matches_xla_scan_after_finalize(bits, tables):
    L, N = 4, 384
    args = _inputs(L, N, bits, 1 + bits, tables)
    p0, v0, l0, r0, s0 = rc_encode_scan_lanes_unrolled(
        *[jnp.asarray(a) for a in args], bits, 2)
    packed0 = jnp.moveaxis(p0 + (v0.astype(jnp.int32) << 20), 1, 2)
    prefix = np.random.RandomState(bits).randint(0, 0x100, (L, 8)) \
        .astype(np.int32)
    plen = np.array([0, 3, 8, 1], np.int32)
    o0, c0 = finalize_packed_full(packed0, l0, r0, jnp.asarray(prefix),
                                  jnp.asarray(plen))
    tp, tl, tr, ts = rc_encode_packed(*_torch(args), bits)
    o1, c1 = tfin.finalize_packed_full(tp, tl, tr, torch.from_numpy(prefix),
                                       torch.from_numpy(plen))
    assert np.array_equal(np.asarray(c0), c1.numpy())
    for lane in range(L):
        n = int(c0[lane])
        assert np.array_equal(np.asarray(o0)[lane, :n], o1.numpy()[lane, :n])
    assert np.array_equal(tl.numpy(), np.asarray(l0))
    assert np.array_equal(tr.numpy(), np.asarray(r0))
    assert np.array_equal(ts.numpy(), np.asarray(s0))


@pytest.mark.parametrize("bits", [11, 16, 17])
def test_ext_matches_xla_ext_scan(bits):
    """The extended schedule (rows 10/31 running) against
    rc_encode_scan_lanes_ext packed as the JAX encoder packs it
    (prov | valid << 20, (N, S, L)): emit flags everywhere, values where
    a slot emits, low, range and states.  The residuals span the whole
    folded range, with its extremes, so e reaches bits - 1."""
    L, N = 3, 512
    r = np.random.RandomState(30 + bits)
    args = list(_inputs(L, N, bits, bits))
    half = 1 << (bits - 1)
    diff = r.randint(-40, 41, (L, N))
    diff = np.where(r.rand(L, N) < 0.3, r.randint(-half, half, (L, N)), diff)
    diff[:, :4] = [-half, half - 1, -half + 1, 0]
    args[1] = diff.astype(np.int32)
    p0, v0, l0, r0, s0 = rc_encode_scan_lanes_ext(
        *[jnp.asarray(a) for a in args], bits)
    pk = np.moveaxis(np.asarray(p0) + (np.asarray(v0).astype(np.int32) << 20),
                     1, 2)
    tp, tl, tr, ts = rc_encode_packed(*_torch(args), bits)
    tp = tp.numpy()
    assert tp.shape == pk.shape == (N, 2 * bits + 1, L)
    emit = (pk >> 20) & 1
    assert emit.sum() > 0
    assert np.array_equal((tp >> 20) & 1, emit)
    assert np.array_equal(tp, np.where(emit == 1, pk, 0))
    assert np.array_equal(tl.numpy(), np.asarray(l0))
    assert np.array_equal(tr.numpy(), np.asarray(r0))
    assert np.array_equal(ts.numpy(), np.asarray(s0))
    # the chunked mask build does not change the result
    again = rc_encode_packed_ext_ref(*_torch(args), bits, _chunk=100)
    for a, b in zip(again, (tp, tl, tr, ts)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_cuda_wrapper_refuses_bad_bits():
    args = _torch(_inputs(1, 8, 8, 2))
    with pytest.raises(NotImplementedError):
        rc_encode_packed(*args, 18)


def _five_input_args(L, h, w, bits, seed):
    """Context-model-1 lane streams from the port's 5-input stencil on
    random planes (contexts past model 0's 666, into a 2 x 7,563-row
    table), random states and coder starts."""
    from tpu_ffv1_torch.tpu.residual import residuals_and_contexts
    r = np.random.RandomState(seed)
    hi = 1 << bits
    planes = ((np.add.outer(np.arange(h), np.arange(w)) * (hi // 64) +
               r.randint(0, hi // 8, (L, h, w))) % hi).astype(np.int32)
    qt = torch.from_numpy(T.default_quant_tables(bits)[1].astype(np.int32))
    ctx, diff = residuals_and_contexts(torch.from_numpy(planes), qt, bits,
                                       True)
    CC = 2 * T.CONTEXT_COUNTS[1]
    # the second state plane, as the encoder offsets chroma contexts
    ctx = ctx.reshape(L, -1) + torch.tensor([0, CC // 2] * L)[:L, None]
    assert int(ctx.max()) >= T.CONTEXT_COUNTS[0]
    one, zero = custom_state_tables(T.VER2_STATE)
    return (ctx.numpy().astype(np.int32), diff.reshape(L, -1).numpy(),
            r.rand(L, h * w) < 0.95,
            r.randint(1, 256, (L, CC, 32)).astype(np.uint8), one, zero,
            r.randint(0, 1 << 16, L).astype(np.int32),
            r.randint(0x100, 0xFF01, L).astype(np.int32))


def test_five_input_matches_xla_scan_after_finalize():
    """K1's plain version at context model 1's table size (15,126 rows,
    the one the kernel keeps in global memory) against the XLA scan,
    after finalize: bytes, low, range, states."""
    L = 3
    args = _five_input_args(L, 12, 20, 8, 51)
    p0, v0, l0, r0, s0 = rc_encode_scan_lanes_unrolled(
        *[jnp.asarray(a) for a in args], 8, 2)
    packed0 = jnp.moveaxis(p0 + (v0.astype(jnp.int32) << 20), 1, 2)
    prefix = np.zeros((L, 1), np.int32)
    plen = np.zeros(L, np.int32)
    o0, c0 = finalize_packed_full(packed0, l0, r0, jnp.asarray(prefix),
                                  jnp.asarray(plen))
    tp, tl, tr, ts = rc_encode_packed(*_torch(args), 8)
    o1, c1 = tfin.finalize_packed_full(tp, tl, tr, torch.from_numpy(prefix),
                                       torch.from_numpy(plen))
    assert np.array_equal(np.asarray(c0), c1.numpy())
    for lane in range(L):
        n = int(c0[lane])
        assert np.array_equal(np.asarray(o0)[lane, :n], o1.numpy()[lane, :n])
    assert np.array_equal(tl.numpy(), np.asarray(l0))
    assert np.array_equal(tr.numpy(), np.asarray(r0))
    assert np.array_equal(ts.numpy(), np.asarray(s0))


def test_five_input_ext_matches_xla_ext_scan():
    """K1-ext's plain version at 16 bits and context model 1's table size
    against rc_encode_scan_lanes_ext: emit flags, values where a slot
    emits, low, range, states."""
    args = _five_input_args(2, 12, 16, 16, 52)
    p0, v0, l0, r0, s0 = rc_encode_scan_lanes_ext(
        *[jnp.asarray(a) for a in args], 16)
    pk = np.moveaxis(np.asarray(p0) + (np.asarray(v0).astype(np.int32) << 20),
                     1, 2)
    tp, tl, tr, ts = rc_encode_packed(*_torch(args), 16)
    tp = tp.numpy()
    emit = (pk >> 20) & 1
    assert emit.sum() > 0
    assert np.array_equal((tp >> 20) & 1, emit)
    assert np.array_equal(tp, np.where(emit == 1, pk, 0))
    assert np.array_equal(tl.numpy(), np.asarray(l0))
    assert np.array_equal(tr.numpy(), np.asarray(r0))
    assert np.array_equal(ts.numpy(), np.asarray(s0))


def _uniform_exponent_args(L, N, bits, seed):
    """K1-ext inputs where the running rows carry: exponents drawn
    uniformly over 0..bits-1 (so e = 8, 9 and 10, where rows 10 and 31
    begin, are common), about 10% zero residuals, and four contexts per
    lane, so rows 10 and 31 carry from pixel to pixel."""
    r = np.random.RandomState(seed)
    args = list(_inputs(L, N, bits, seed, "custom"))
    e = r.randint(0, bits, (L, N))
    a = (1 << e) | (r.randint(0, 1 << 30, (L, N)) & ((1 << e) - 1))
    diff = np.where(r.rand(L, N) < 0.5, -a, a)
    diff = np.where(r.rand(L, N) < 0.1, 0, diff)
    pool = r.randint(0, T.CONTEXT_COUNTS[0], (L, 4))
    args[0] = pool[np.arange(L)[:, None], r.randint(0, 4, (L, N))] \
        .astype(np.int32)
    args[1] = diff.astype(np.int32)
    return args


@pytest.mark.parametrize("bits", [11, 16, 17])
def test_ext_plain_matches_xla_ext_scan_uniform_exponents(bits):
    """rc_encode_packed_ext_ref against rc_encode_scan_lanes_ext where
    the running rows carry across pixels (_uniform_exponent_args): emit
    flags everywhere, values where a slot emits, low, range, states."""
    L, N = 3, 384
    args = _uniform_exponent_args(L, N, bits, 60 + bits)
    e = np.floor(np.log2(np.maximum(np.abs(args[1]), 1)))
    assert all(((e == k) & (args[1] != 0)).sum() > L * N // (2 * bits)
               for k in (8, 9, 10))
    p0, v0, l0, r0, s0 = rc_encode_scan_lanes_ext(
        *[jnp.asarray(a) for a in args], bits)
    pk = np.moveaxis(np.asarray(p0) + (np.asarray(v0).astype(np.int32) << 20),
                     1, 2)
    tp, tl, tr, ts = rc_encode_packed_ext_ref(*_torch(args), bits)
    tp = tp.numpy()
    assert tp.shape == pk.shape == (N, 2 * bits + 1, L)
    emit = (pk >> 20) & 1
    assert emit.sum() > 0
    assert np.array_equal((tp >> 20) & 1, emit)
    assert np.array_equal(tp, np.where(emit == 1, pk, 0))
    assert np.array_equal(tl.numpy(), np.asarray(l0))
    assert np.array_equal(tr.numpy(), np.asarray(r0))
    assert np.array_equal(ts.numpy(), np.asarray(s0))


def test_ext_stage_probe_full_is_the_plain_version_on_cpu():
    """K1-ext's stage probes have a plain version only for ``full`` at
    16 bits (the production instance); the stubbed variants time the
    card, and the probes are built at 16 bits only."""
    args = _torch(_uniform_exponent_args(2, 96, 16, 7))
    got = tenc.rc_encode_ext_stages(*args, "full")
    want = rc_encode_packed_ext_ref(*args, 16)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for variant in tenc.EXT_STAGE_VARIANTS:
        if variant != "full":
            with pytest.raises(NotImplementedError):
                tenc.rc_encode_ext_stages(*args, variant)
    for bits in (8, 10, 11):
        with pytest.raises(NotImplementedError):
            tenc.rc_encode_ext_stages(*args, "full", bits)
