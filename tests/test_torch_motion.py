"""The port's FFV1-P device pieces against the JAX package's on the CPU:
the motion searches (tpu_ffv1_torch.pframe.motion, batched over lanes,
against tpu_ffv1.pframe.motion under jax.vmap), the OBMC prediction
(obmc_predict_dev against the JAX function's gather and one-hot forms
and the host's numpy obmc_predict) and the edge padding.  Exact integer
equality throughout; the flat cases make every candidate tie, so they
hold the first-minimum rule the packets depend on."""
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_ffv1.pframe import codec as jcodec
from tpu_ffv1.pframe import motion as jm
from tpu_ffv1.pframe import tpu as jtpu
from tpu_ffv1_torch.pframe import motion as tm
from tpu_ffv1_torch.pframe import tpu as ttpu

L, H, W = 3, 48, 64


def _planes(kind, r):
    """(cur, ref) int32 (L, H, W) and a radius for a search case."""
    if kind == "random":
        return (r.randint(0, 256, (L, H, W)), r.randint(0, 256, (L, H, W)),
                7)
    if kind == "flat":
        return np.full((L, H, W), 77), np.full((L, H, W), 77), 7
    if kind == "flat_10bit":
        return np.full((L, H, W), 700), np.full((L, H, W), 700), 3
    # a smooth texture moved by exactly +-radius (and less) per lane
    rad = 5
    k = 5
    field = r.randint(0, 255, (H + 40, W + 40)).astype(np.float64)
    c = np.pad(np.cumsum(np.cumsum(field, 0), 1), ((k, 0), (k, 0)))
    tex = ((c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) /
           (k * k)).astype(np.int64)
    o = 12
    ref = np.stack([tex[o:o + H, o:o + W]] * L)
    shifts = [(rad, -rad), (-rad, rad), (2, -3)]
    cur = np.stack([tex[o + dy:o + dy + H, o + dx:o + dx + W]
                    for dy, dx in shifts])
    return cur, ref, rad


@pytest.mark.parametrize("me", sorted(tm.SEARCH_FNS))
@pytest.mark.parametrize("kind", ["random", "flat", "flat_10bit",
                                  "radius_edges"])
@pytest.mark.parametrize("prev", ["zero", "random"])
def test_search_matches_jax(me, kind, prev):
    r = np.random.RandomState(zlib.crc32(f"{me} {kind} {prev}".encode()))
    cur, ref, radius = _planes(kind, r)
    cur, ref = cur.astype(np.int32), ref.astype(np.int32)
    prev_mvs = np.zeros((L, H // 16, W // 16, 2), np.int32)
    if prev == "random":
        prev_mvs = r.randint(-radius, radius + 1,
                             prev_mvs.shape).astype(np.int32)
    want = jax.vmap(lambda c, f, p: jm.SEARCH_FNS[me](
        c, f, p, 16, radius, jcodec.LAMBDA))(cur, ref, prev_mvs)
    got = tm.SEARCH_FNS[me](torch.from_numpy(cur), torch.from_numpy(ref),
                            torch.from_numpy(prev_mvs), 16, radius,
                            jcodec.LAMBDA)
    for name, a, b in zip(("mvs", "sad", "cost"), want, got):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), name)
    if kind == "radius_edges" and me == "full" and prev == "zero":
        # the texture moved by exactly the radius is found there
        mv = got[0].numpy()
        assert (mv[0] == (5, -5)).all() and (mv[1] == (-5, 5)).all()


def test_candidate_grid_and_shift_match_jax():
    assert tm.candidate_grid(3) == jm.candidate_grid(3)
    a = np.random.RandomState(1).randint(0, 99, (5, 7)).astype(np.int32)
    for dy, dx in ((0, 0), (2, -3), (-6, 9), (4, 1)):
        np.testing.assert_array_equal(
            tm._shift2d(torch.from_numpy(a), dy, dx).numpy(),
            np.asarray(jm._shift2d(jnp.asarray(a), dy, dx)))


@pytest.mark.parametrize("blk,shape", [((16, 16), (40, 72)),
                                       ((8, 8), (20, 36)),
                                       ((16, 8), (36, 20))])
def test_obmc_matches_jax_and_host(blk, shape):
    """obmc_predict_dev on planes edge-padded to block multiples (as the
    P pipeline pads them) against both forms of the JAX function and
    the host's numpy obmc_predict, with vectors at and past the search
    radius and intra blocks."""
    by, bx = blk
    h, w = shape
    r = np.random.RandomState(by * 100 + h)
    ph, pw = (-h) % by, (-w) % bx
    ref = r.randint(0, 1024, (2, h, w)).astype(np.int32)
    ref_p = ttpu._pad_edge(torch.from_numpy(ref), ph, pw)
    np.testing.assert_array_equal(
        ref_p.numpy(), np.asarray(jtpu._pad_edge(jnp.asarray(ref), ph, pw)))
    for lane in range(2):
        np.testing.assert_array_equal(
            ref_p[lane].numpy(), jm.pad_to_block(ref[lane], blk))
    bh, bw = (h + ph) // by, (w + pw) // bx
    mvs = r.randint(-4, 5, (2, bh, bw, 2)).astype(np.int32)
    mvs[0, 0, 0] = (-7, 7)
    intra = r.rand(2, bh, bw) < 0.3
    mid = 512
    got = ttpu.obmc_predict_dev(ref_p, torch.from_numpy(mvs),
                                torch.from_numpy(intra), mid, by, bx)
    assert got.dtype == torch.int32
    rp = jnp.asarray(ref_p.numpy())
    gather = jtpu.obmc_predict_dev(rp, jnp.asarray(mvs), jnp.asarray(intra),
                                   mid, by, bx)
    onehot = jtpu.obmc_predict_dev(rp, jnp.asarray(mvs), jnp.asarray(intra),
                                   mid, by, bx, bounds=((-7, 7), (-7, 7)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(gather))
    np.testing.assert_array_equal(got.numpy(), np.asarray(onehot))
    for lane in range(2):
        np.testing.assert_array_equal(
            got[lane].numpy(),
            jcodec.obmc_predict(ref_p[lane].numpy(), mvs[lane], intra[lane],
                                mid, by, bx))


def test_tent_indices_match_jax():
    for args in ((48, 64, 16, 16), (36, 20, 16, 8), (8, 8, 2, 2)):
        for a, b in zip(ttpu._tent_indices(*args),
                        jtpu._tent_indices(*args)):
            np.testing.assert_array_equal(a, b)
