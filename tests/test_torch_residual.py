"""Encode stencil: the port's residual.py equals tpu_ffv1.tpu.residual
on the same numpy inputs (exact: integer arithmetic)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ffv1.core import tables as T
from tpu_ffv1.tpu import residual as jres
from tpu_ffv1_torch.tpu import residual as tres


def _plane(bits, h, w, seed):
    r = np.random.RandomState(seed)
    hi = 1 << bits
    base = np.add.outer(np.arange(h), np.arange(w)) * max(hi // 64, 1)
    return ((base + r.randint(0, max(hi // 16, 2), (h, w))) % hi) \
        .astype(np.int32)


@pytest.mark.parametrize("h,w", [(1, 1), (1, 7), (6, 1), (9, 13)])
def test_neighbors_match_jax(h, w):
    s = _plane(8, h, w, 1)
    nj = jres.neighbors(jnp.asarray(s))
    nt = tres.neighbors(torch.from_numpy(s))
    for k in nj:
        assert np.array_equal(np.asarray(nj[k]), nt[k].numpy()), k


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("jax_form", ["gather", "steps"])
@pytest.mark.parametrize("h,w", [(12, 20), (1, 5)])
def test_residuals_and_contexts_match_jax(bits, jax_form, h, w):
    """Context model 0 (3-input) on a stack of crops: the port takes
    (..., H, W), the JAX function one (H, W) plane.  The port has one
    form, the table gather; it equals both of the JAX function's forms
    (gather, and the compare/step form its encoder runs)."""
    qt = np.asarray(T.default_quant_tables(bits)[0], np.int32)
    five = bool(qt[3][127])
    assert not five
    crops = np.stack([_plane(bits, h, w, s) for s in range(3)])
    qspec_j = jres.quant_spec(qt) if jax_form == "steps" else None
    ct, dt = tres.residuals_and_contexts(
        torch.from_numpy(crops), torch.from_numpy(qt), bits, five)
    for i, s in enumerate(crops):
        cj, dj = jres.residuals_and_contexts(jnp.asarray(s), jnp.asarray(qt),
                                             bits, five, qspec=qspec_j)
        assert np.array_equal(np.asarray(cj), ct[i].numpy())
        assert np.array_equal(np.asarray(dj), dt[i].numpy())


@pytest.mark.parametrize("jax_form", ["gather", "steps"])
def test_residuals_and_contexts_16bit_match_jax(jax_form):
    """The 16-bit stencil: samples int16-wrapped as load_plane leaves
    them (values past 0x7FFF go negative), byte-wrapped gradients into
    the 10-bit quant tables, residuals folded to 16 bits."""
    bits = 16
    qt = np.asarray(T.default_quant_tables(bits)[0], np.int32)
    raw = np.stack([_plane(bits, 12, 20, s) for s in range(3)])
    crops = tres.load_plane(torch.from_numpy(raw), bits, False).numpy()
    assert (crops < 0).any()
    qspec_j = jres.quant_spec(qt) if jax_form == "steps" else None
    ct, dt = tres.residuals_and_contexts(
        torch.from_numpy(crops), torch.from_numpy(qt), bits, False)
    for i, s in enumerate(crops):
        sj = jres.load_plane(jnp.asarray(raw[i].astype(np.uint16)), bits,
                             False)
        assert np.array_equal(np.asarray(sj), s)
        cj, dj = jres.residuals_and_contexts(sj, jnp.asarray(qt), bits,
                                             False, qspec=qspec_j)
        assert np.array_equal(np.asarray(cj), ct[i].numpy())
        assert np.array_equal(np.asarray(dj), dt[i].numpy())


@pytest.mark.parametrize("bits,lsb", [(8, True), (10, True), (10, False),
                                      (16, False)])
def test_load_plane_matches_jax(bits, lsb):
    r = np.random.RandomState(bits)
    hi = 1 << (bits if lsb else 16)
    src = r.randint(0, hi, (5, 9)).astype(np.uint16 if bits > 8
                                          else np.uint8)
    a = jres.load_plane(jnp.asarray(src), bits, lsb)
    b = tres.load_plane(torch.from_numpy(src.astype(np.int32)), bits, lsb)
    assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("bits", [8, 10, 16])
@pytest.mark.parametrize("jax_form", ["gather", "steps"])
def test_five_input_residuals_and_contexts_match_jax(bits, jax_form):
    """Context model 1 (the 5-input context: quant tables 3 and 4 on
    LL - L and TT - T) on a stack of crops, against both forms of the JAX
    function; at 16 bits the samples are int16-wrapped by load_plane, so
    LL and TT wrap too."""
    qt = np.asarray(T.default_quant_tables(bits)[1], np.int32)
    assert qt[3][127] != 0
    raw = np.stack([_plane(bits, 12, 20, 10 + s) for s in range(3)])
    crops = tres.load_plane(torch.from_numpy(raw), bits, False).numpy() \
        if bits == 16 else raw
    if bits == 16:
        assert (crops < 0).any()
    qspec_j = jres.quant_spec(qt) if jax_form == "steps" else None
    ct, dt = tres.residuals_and_contexts(
        torch.from_numpy(crops), torch.from_numpy(qt), bits, True)
    assert int(ct.max()) > T.CONTEXT_COUNTS[0]       # past model 0's range
    for i, s in enumerate(crops):
        cj, dj = jres.residuals_and_contexts(jnp.asarray(s), jnp.asarray(qt),
                                             bits, True, qspec=qspec_j)
        assert np.array_equal(np.asarray(cj), ct[i].numpy())
        assert np.array_equal(np.asarray(dj), dt[i].numpy())
