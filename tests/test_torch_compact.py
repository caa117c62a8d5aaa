"""The compact encode form (``TorchFFV1Encoder(compact=True)``, the
counterpart of the JAX package's FFV1_PALLAS_COMPACT=1): K1-compact's
plain version against the Pallas kernel's compact branch (interpret
mode, as tests/test_pallas.py runs it), ``finalize_compact`` against the
JAX one, the encoder against the host encoder, and the overflow redo.
Every comparison is exact: the codec is integer and lossless."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tpu_ffv1 import EncoderParams, FFV1Encoder
from tpu_ffv1.core import tables as T
from tpu_ffv1.core.rac import custom_state_tables
from tpu_ffv1.tpu import rc_scan_lanes as jfin
from tpu_ffv1.tpu.rc_pallas import rc_encode_pallas_compact
from tpu_ffv1.tpu.rc_scan_lanes import rc_encode_scan_lanes_unrolled
from tpu_ffv1_torch import TorchFFV1Encoder
from tpu_ffv1_torch.kernels import probes
from tpu_ffv1_torch.tpu import encoder as tenc
from tpu_ffv1_torch.tpu import finalize as tfin
from tpu_ffv1_torch.tpu import rc_encode as K
from tpu_ffv1_torch.tpu.state import encoder_state_from_numpy


def _inputs(L, N, CC, seed, big=0.3):
    """K1 inputs at 8 bits: residuals full-range with probability
    ``big``, states from 1..255 (so that some pixels emit more than 4
    bytes), random coder starts."""
    r = np.random.RandomState(seed)
    ctx = r.randint(0, CC, (L, N)).astype(np.int32)
    diff = np.where(r.rand(L, N) < big, r.randint(-128, 128, (L, N)),
                    r.randint(-6, 7, (L, N))).astype(np.int32)
    diff[:, :3] = [-128, 127, 0]
    act = r.rand(L, N) < 0.9
    states = r.randint(1, 256, (L, CC, 32)).astype(np.uint8)
    one, zero = custom_state_tables(T.VER2_STATE)
    low = r.randint(0, 1 << 16, L).astype(np.int32)
    rng = r.randint(0x100, 0xFF01, L).astype(np.int32)
    return (ctx, diff, act, states, one, zero, low, rng)


def _torch(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


@pytest.fixture(scope="module")
def pallas_compact():
    """rc_encode_pallas_compact in interpret mode on two input sets at
    L = 3, N = 512, chunk 128, CC = 1,332 (one compile): small residuals
    (no pixel overflows) and 30% full-range ones (some do)."""
    res = {}
    for name, big in (("small", 0.0), ("overflowing", 0.3)):
        args = _inputs(3, 512, 2 * T.CONTEXT_COUNTS[0], 1, big)
        with pltpu.force_tpu_interpret_mode():
            out = rc_encode_pallas_compact(*[jnp.asarray(a) for a in args],
                                           8, 128)
        res[name] = args, [np.asarray(o) for o in out]
    return res


@pytest.mark.parametrize("case", ["small", "overflowing"])
def test_compact_matches_pallas_compact_interpret(pallas_compact, case):
    args, (cm, low, rng, st) = pallas_compact[case]
    assert cm.shape == (512, 8, 3)
    assert bool(cm[:, 5].any()) == (case == "overflowing")
    got = K.rc_encode_compact(*_torch(args), 8)
    assert np.array_equal(got[0].numpy(), cm)        # overflow rows too
    for a, b in zip(got[1:], (low, rng, st)):
        assert np.array_equal(a.numpy(), b)
    # compact_packed of the raw plain version is the same array
    raw = K.rc_encode_packed_ref(*_torch(args), 8)
    assert np.array_equal(tfin.compact_packed(raw[0]).numpy(), cm)


def test_compact_ref_at_context_model1_table():
    """At CC = 15,126 (context model 1's table, which the kernel keeps
    in global memory): the compact plain version equals compact_packed
    of the raw plain version and of the JAX XLA scan's packed output."""
    args = _inputs(3, 256, 2 * T.CONTEXT_COUNTS[1], 2)
    got = K.rc_encode_compact_ref(*_torch(args), 8)
    raw = K.rc_encode_packed_ref(*_torch(args), 8)
    assert torch.equal(got[0], tfin.compact_packed(raw[0]))
    p0, v0, l0, r0, s0 = rc_encode_scan_lanes_unrolled(
        *[jnp.asarray(a) for a in args], 8, 2)
    packed0 = np.moveaxis(np.asarray(p0) +
                          (np.asarray(v0).astype(np.int32) << 20), 1, 2)
    want = tfin.compact_packed(torch.from_numpy(packed0))
    assert torch.equal(got[0], want)
    assert int(want[:, 5].sum()) > 0
    for a, b in zip(got[1:], (l0, r0, s0)):
        assert np.array_equal(a.numpy(), np.asarray(b))


def _cm(trial, N=64, L=5):
    """Random compact rows: provisional values with long 0xFF propagator
    runs, counts 0..4 per pixel (0..6 with overflowing pixels in odd
    trials' lanes 1 and 3)."""
    r = np.random.RandomState(300 + trial)
    slots = r.randint(0, 1 << 17, (N, 4, L))
    ff = r.rand(N, 4, L) < 0.3
    slots = np.where(ff, (slots & ~0x1FF) | 0xFF | (1 << 16), slots)
    count = r.randint(0, 5, (N, L))
    if trial % 2:
        count[:, [1, 3]] = r.randint(0, 7, (N, 2))
    slots = np.where(np.arange(4)[None, :, None] < count[:, None, :],
                     slots, 0)
    cm = np.zeros((N, 8, L), np.int32)
    cm[:, :4] = slots
    cm[:, 4] = count
    cm[:, 5] = count > 4
    low = (r.randint(0, 1 << 16, L) << 8).astype(np.int32) & 0xFFFFFF
    rng = r.randint(0x100, 0xFF00, L).astype(np.int32)
    plen = r.randint(0, 9, L).astype(np.int32)
    prefix = r.randint(0, 1 << 17, (L, 8)).astype(np.int32)
    return cm, low, rng, prefix, plen


@pytest.mark.parametrize("trial", range(4))
def test_finalize_compact_matches_jax(trial):
    args = _cm(trial)
    o0, c0, v0 = [np.asarray(x) for x in
                  jfin.finalize_compact(*[jnp.asarray(a) for a in args])]
    o1, c1, v1 = [x.numpy() for x in
                  tfin.finalize_compact(*[torch.from_numpy(a)
                                          for a in args])]
    assert np.array_equal(v0, v1)
    assert v1.any() == bool(trial % 2)
    assert np.array_equal(c0, c1)
    for lane in range(o0.shape[0]):
        assert np.array_equal(o0[lane, :c0[lane]], o1[lane, :c1[lane]])


def _frames(w, h, n, seed, noise=16):
    r = np.random.RandomState(seed)
    return [[((np.add.outer(np.arange(s[0]), np.arange(s[1])) * 3 + 5 * t +
               r.randint(0, noise, s)) % 256).astype(np.uint8)
             for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
            for t in range(n)]


def _spy(monkeypatch, name):
    """Count the encoder's calls of its lane-scan wrapper ``name``."""
    calls = []
    fn = getattr(tenc, name)

    def spy(*a):
        calls.append(1)
        return fn(*a)

    monkeypatch.setattr(tenc, name, spy)
    return calls


@pytest.mark.parametrize("context_model", [0, 1])
def test_compact_encoder_matches_host(monkeypatch, context_model):
    """batch 2, 48x40, 4 slices: one compact scan per step, no raw one
    (nothing overflows), and the host encoder's bytes."""
    compact = _spy(monkeypatch, "rc_encode_compact")
    raw = _spy(monkeypatch, "rc_encode_packed")
    params = EncoderParams(width=48, height=40, pix_fmt="yuv420p", level=3,
                           coder=2, slices=4, gop_size=2,
                           context_model=context_model)
    streams = [_frames(48, 40, 3, 40 + b) for b in range(2)]
    port = TorchFFV1Encoder(params, batch=2, device="cpu", compact=True)
    assert port.compact
    hosts = [FFV1Encoder(params) for _ in range(2)]
    for t in range(3):
        res = port.encode_frames([streams[b][t] for b in range(2)])
        for b in range(2):
            assert res[b] == hosts[b].encode_frame(streams[b][t])
    assert len(compact) == 3 and not raw


def test_compact_16bit_takes_the_extended_scan(monkeypatch):
    """At 16 bits the compact option changes nothing: the extended raw
    scan runs (the reference's compact form is fast-path only) and the
    bytes are the host encoder's."""
    from .util import synth_frames
    compact = _spy(monkeypatch, "rc_encode_compact")
    raw = _spy(monkeypatch, "rc_encode_packed")
    params = EncoderParams(width=32, height=24, pix_fmt="yuv444p16le",
                           level=3, coder=2, slices=4, gop_size=2)
    frames = synth_frames("yuv444p16le", 32, 24, 2, seed=12)
    port = TorchFFV1Encoder(params, device="cpu", compact=True)
    assert not port.compact
    host = FFV1Encoder(params)
    for f in frames:
        assert port.encode_frame(f) == host.encode_frame(f)
    assert len(raw) == 2 and not compact


@pytest.mark.parametrize("context_model", [0, 1])
def test_compact_overflow_redo_is_byte_exact(monkeypatch, context_model):
    """A GOP continued from adversarial states (every state 1, so each
    1-bit decision emits a byte) on noise: pixels emit more than 4 bytes,
    the compact encoder redoes the frame on the raw scan, and its packets
    and carried states equal the raw form's from the same states."""
    raw = _spy(monkeypatch, "rc_encode_packed")
    full = _spy(monkeypatch, "finalize_packed_full")
    params = EncoderParams(width=48, height=40, pix_fmt="yuv420p", level=3,
                           coder=2, slices=4, gop_size=12,
                           context_model=context_model)
    r = np.random.RandomState(60 + context_model)
    frames = [[r.randint(0, 256, s).astype(np.uint8)
               for s in ((40, 48), (20, 24), (20, 24))] for _ in range(2)]
    encs = [TorchFFV1Encoder(params, device="cpu", compact=c)
            for c in (True, False)]
    adversarial = np.ones((4, encs[0].total_cc, 32), np.uint8)
    for enc in encs:
        encoder_state_from_numpy(enc, adversarial, 1)     # non-key next
    for f in frames:
        before = len(raw)
        got, want = [enc.encode_frame(f) for enc in encs]
        assert got == want and not got[1]
        assert len(raw) - before == 2, "the compact form did not overflow"
        assert torch.equal(encs[0].states, encs[1].states)
    assert full


def test_stage_probe_full_is_the_raw_scan_on_cpu():
    """The stage probes have a plain version only for ``full`` (the
    production instance); the stubbed variants time the card."""
    args = _torch(_inputs(2, 64, 2 * T.CONTEXT_COUNTS[0], 3))
    got = K.rc_encode_stages(*args, "full")
    for a, b in zip(got, K.rc_encode_packed_ref(*args, 8)):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError):
        K.rc_encode_stages(*args, "no_chain")


def test_lookup_probe_plain_loops():
    """The plain loops of the shared-memory probes: one lap of the row
    cycle visits every row once and ends at row 0; the byte walk is
    s = tab[s] per thread."""
    rows = 2 * T.CONTEXT_COUNTS[0]
    table = probes.cycle_table(rows, 5)
    out = probes.smem_probe(torch.from_numpy(table), rows, "row").numpy()
    assert (out[:, 0] == 0).all()
    assert np.array_equal(out[:, 1], table.sum(axis=0))
    one, _zero = custom_state_tables(T.VER2_STATE)
    out = probes.smem_probe(torch.from_numpy(one), 3, "byte").numpy()
    s1 = one[np.arange(32)]
    s2 = one[s1]
    s3 = one[s2]
    assert np.array_equal(out[:, 0], s3)
    assert np.array_equal(out[:, 1], s1.astype(int) + s2 + s3)
