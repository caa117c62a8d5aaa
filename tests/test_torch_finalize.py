"""Finalize: the port's finalize_packed / finalize_packed_full (scatter
compaction) equal the JAX versions (sort compaction) on random packed
arrays, byte for byte up to each lane's count, with the same overflow
verdicts (exact: integer codec)."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ffv1.tpu import rc_scan_lanes as jfin
from tpu_ffv1_torch.tpu import finalize as tfin


def _packed(trial, N=64, L=5, S=13):
    r = np.random.RandomState(100 + trial)
    valid = r.rand(N, S, L) < (0.25 if trial % 2 else 0.6)
    if trial < 2:
        # within both compaction caps: <= 4 emissions per pixel and
        # <= 24 per 16-pixel group
        valid &= np.cumsum(valid, axis=1) <= 4
        g = valid.reshape(N // 16, 16 * S, L)
        valid = (g & (np.cumsum(g, axis=1) <= 24)).reshape(N, S, L)
    prov = r.randint(0, 1 << 17, (N, S, L)).astype(np.int32)
    # long 0xFF propagator runs stress the carry chain
    ff = r.rand(N, S, L) < 0.3
    prov = np.where(ff, (prov & ~0x1FF) | 0xFF | (1 << 16), prov)
    packed = np.where(valid, prov | (1 << 20), 0).astype(np.int32)
    low = (r.randint(0, 1 << 16, L) << 8).astype(np.int32) & 0xFFFFFF
    rng = r.randint(0x100, 0xFF00, L).astype(np.int32)
    pcap = 8
    plen = r.randint(0, pcap + 1, L).astype(np.int32)
    prefix = r.randint(0, 1 << 17, (L, pcap)).astype(np.int32)
    return packed, low, rng, prefix, plen


def _both(fn_j, fn_t, args):
    j = fn_j(*[jnp.asarray(a) for a in args])
    t = fn_t(*[torch.from_numpy(a) for a in args])
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


@pytest.mark.parametrize("trial", range(6))
def test_finalize_packed_matches_jax(trial):
    args = _packed(trial)
    (o0, c0, v0), (o1, c1, v1) = _both(jfin.finalize_packed,
                                       tfin.finalize_packed, args)
    assert np.array_equal(v0, v1)
    if trial < 2:
        assert not v1.any()
    else:
        assert v1.any()          # dense trials overflow the caps
    assert np.array_equal(c0, c1)
    for lane in range(o0.shape[0]):
        assert np.array_equal(o0[lane, :c0[lane]], o1[lane, :c1[lane]])
        # after the count only the never-flushed last value, then zeros
        assert not o1[lane, c1[lane] + 1:].any()


@pytest.mark.parametrize("trial", range(6))
def test_finalize_packed_full_matches_jax(trial):
    args = _packed(trial)
    (o0, c0), (o1, c1) = _both(jfin.finalize_packed_full,
                               tfin.finalize_packed_full, args)
    assert np.array_equal(c0, c1)
    for lane in range(o0.shape[0]):
        assert np.array_equal(o0[lane, :c0[lane]], o1[lane, :c1[lane]])


@pytest.mark.parametrize("trial", range(4))
def test_finalize_packed_s2_6_matches_jax(trial):
    """The extended widths' finalize (6 slots per pixel, no group level)
    on ext-shaped arrays (S = 33): two within the cap, two that overflow
    it, then their full-width redo."""
    N, L, S = 48, 4, 33
    r = np.random.RandomState(200 + trial)
    valid = r.rand(N, S, L) < (0.12 if trial < 2 else 0.3)
    if trial < 2:
        valid &= np.cumsum(valid, axis=1) <= 6
    prov = r.randint(0, 1 << 17, (N, S, L)).astype(np.int32)
    ff = r.rand(N, S, L) < 0.3
    prov = np.where(ff, (prov & ~0x1FF) | 0xFF | (1 << 16), prov)
    packed = np.where(valid, prov | (1 << 20), 0).astype(np.int32)
    rest = list(_packed(trial, N=N, L=L, S=S)[1:])
    args = [packed] + rest
    (o0, c0, v0), (o1, c1, v1) = _both(
        lambda *a: jfin.finalize_packed(*a, s2=6),
        lambda *a: tfin.finalize_packed(*a, s2=6), args)
    assert np.array_equal(v0, v1)
    assert v1.any() == (trial >= 2)
    assert np.array_equal(c0, c1)
    for lane in range(L):
        assert np.array_equal(o0[lane, :c0[lane]], o1[lane, :c1[lane]])
    (o0, c0), (o1, c1) = _both(jfin.finalize_packed_full,
                               tfin.finalize_packed_full, args)
    assert np.array_equal(c0, c1)
    for lane in range(L):
        assert np.array_equal(o0[lane, :c0[lane]], o1[lane, :c1[lane]])


def test_packed_from_strided_view():
    """The lane scan returns (N, S, L) as a view of (L, N, S) storage;
    finalize must read it like a contiguous array."""
    packed, low, rng, prefix, plen = _packed(0)
    view = torch.from_numpy(np.ascontiguousarray(
        packed.transpose(2, 0, 1))).permute(1, 2, 0)
    rest = [torch.from_numpy(a) for a in (low, rng, prefix, plen)]
    a = tfin.finalize_packed(torch.from_numpy(packed), *rest)
    b = tfin.finalize_packed(view, *rest)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
