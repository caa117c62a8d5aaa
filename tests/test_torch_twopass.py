"""Two-pass encoding in the port (tpu_ffv1_torch/codec/twopass.py) against
the JAX package's (tpu_ffv1/codec/twopass.py) and its host encoder.

The copies (parse_stats, sort_stt, build_initial_states, the stats text)
against their originals; find_best_state's plain version
(``find_best_state_ref``) against the host's native fold, bit for bit,
on the default state-transition table and on VER2_STATE sorted by
random counts (about 6 s each); the plain versions of the stats
instances of K1 and K1-ext (``rc_encode_stats_ref``,
``rc_encode_ext_stats_ref``) against the host's pass-1 hook on one lane
of random residuals; both passes at depth 2, at batch 2 (a text per
stream) and over ``devices=["cpu"] * 2``; version 4's PCM retry, whose
slices count none of their scan's decisions; and ``TorchFFV1Decoder(
device="cpu")`` on pass-2 streams, lossless and equal to
``FFV1Decoder``.  The configuration matrix is in
test_torch_twopass_matrix.py and test_torch_twopass_deep.py
(tests/twopass_cases.py).  Exact: the codec is integer, and
find_best_state's doubles follow the C fold's operations one by one."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import os
import sys

import numpy as np
import pytest
import torch

from tpu_ffv1 import FFV1Decoder
from tpu_ffv1.bitstream.symbols import put_symbol
from tpu_ffv1.codec import twopass as J
from tpu_ffv1.core import tables as JT
from tpu_ffv1.core.rac import RangeEncoder, build_rac_states, \
    custom_state_tables
from tpu_ffv1_torch import EncoderParams as TorchEncoderParams
from tpu_ffv1_torch import TorchFFV1Decoder, TorchFFV1Encoder
from tpu_ffv1_torch.codec import twopass as P
from tpu_ffv1_torch.tpu import rc_encode as K

from .twopass_cases import (N_FRAMES, config, host_pass1, host_pass2,
                            host_stats, port_pass1, port_pass2)
from .util import synth_frames

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (v4_pcm's content)

def _random_stats(seed, counts=(JT.CONTEXT_COUNTS[0], JT.CONTEXT_COUNTS[1])):
    r = np.random.RandomState(seed)
    rc_stat = r.randint(0, 1 << 20, (256, 2)).astype(np.uint64)
    # sparse contexts, some above the 200-count threshold, some not
    st2 = [np.where(r.rand(cc, 32, 2) < 0.3,
                    r.randint(0, 400, (cc, 32, 2)), 0).astype(np.uint64)
           for cc in counts]
    return rc_stat, st2, int(r.randint(1, 5))


def test_stats_text_and_parse_match():
    """serialize_stats writes Pass1Stats.serialize's text (the dropped
    newline after rc_stat included), and parse_stats reads it back as
    the original does."""
    rc_stat, st2, gob = _random_stats(1)
    ref = J.Pass1Stats(2, JT.CONTEXT_COUNTS)
    ref.rc_stat[:] = rc_stat
    for a, b in zip(ref.rc_stat2, st2):
        a[:] = b
    ref.gob_count = gob
    text = ref.serialize()
    assert P.serialize_stats(rc_stat, st2, gob) == text
    mine = P.parse_stats(text, 2, JT.CONTEXT_COUNTS)
    theirs = J.parse_stats(text, 2, JT.CONTEXT_COUNTS)
    assert np.array_equal(mine[0], theirs[0]) and mine[2] == theirs[2]
    assert all(np.array_equal(a, b) for a, b in zip(mine[1], theirs[1]))
    with pytest.raises(ValueError):
        P.parse_stats(text.rsplit(" ", 1)[0] + " 0\n", 2, JT.CONTEXT_COUNTS)


@pytest.mark.parametrize("seed", [2, 3])
def test_sort_stt_and_initial_states_match(seed):
    """sort_stt on random counts (the table and the counts it permutes),
    then build_initial_states on find_best_state's table of the sorted
    table, against the originals."""
    rc_stat, st2, gob = _random_stats(seed)
    stt_j, stt_p = JT.VER2_STATE.copy(), JT.VER2_STATE.copy()
    stt_j[0] = stt_p[0] = 0
    rc_j, rc_p = rc_stat.copy(), rc_stat.copy()
    assert P.sort_stt(rc_p, stt_p) == J.sort_stt(rc_j, stt_j)
    assert np.array_equal(stt_p, stt_j) and np.array_equal(rc_p, rc_j)
    best = J.find_best_state(stt_j)
    mine = P.build_initial_states(st2, gob, best, JT.CONTEXT_COUNTS)
    theirs = J.build_initial_states(st2, gob, best, JT.CONTEXT_COUNTS)
    assert all(np.array_equal(a, b) for a, b in zip(mine, theirs))


@pytest.mark.parametrize("table", ["default", "ver2_sorted"])
def test_find_best_state_ref_matches_native(table):
    """The plain version, vectorised across the (i, j) rows, against the
    host's scalar C fold (native/ffv1_native.c), bit for bit."""
    if table == "default":
        one = build_rac_states()[0].copy()
    else:
        one = JT.VER2_STATE.copy()
        J.sort_stt(_random_stats(4)[0], one)
    one[0] = 0
    want = J.find_best_state(one)
    assert np.array_equal(P.find_best_state_ref(one), want)
    # a subset of the probabilities gives those rows
    rows = [0, 1, 127, 128, 250, 255]
    assert np.array_equal(P.find_best_state_ref(one, rows), want[rows])


@pytest.mark.parametrize("bits", [8, 16])
def test_stats_twins_match_the_host_hook(bits):
    """The stats instances' plain versions count what the host's pass-1
    hook counts (symbols.put_symbol's stat_hook, the state before each
    put_rac), on one lane of random residuals (above 10 bits the running
    rows 10 and 31) and inactive pixels, from random start states; their
    other outputs are the production scan's."""
    CC = 2 * JT.CONTEXT_COUNTS[0]
    r = np.random.RandomState(bits)
    n = 600
    ctx = r.randint(0, CC, (1, n))
    ctx[0, 100:160] = ctx[0, 100]
    e = r.randint(0, bits, (1, n))
    a = (1 << e) | (r.randint(0, 1 << 30, (1, n)) & ((1 << e) - 1))
    diff = np.where(r.rand(1, n) < 0.5, -a, a)
    diff = np.where(r.rand(1, n) < 0.2, 0, diff)
    act = r.rand(1, n) < 0.9
    states = r.randint(1, 256, (1, CC, 32)).astype(np.uint8)
    stt = JT.VER2_STATE.copy()
    stt[0] = 0
    one, zero = custom_state_tables(stt)
    hook = J.Pass1Stats(1, [CC])
    rc = RangeEncoder(one, zero)
    host_states = states[0].copy()
    for c, d, on in zip(ctx[0], diff[0], act[0]):
        if on:
            put_symbol(rc, host_states[c], int(d), True, hook.hook(0, c))
    args = [torch.from_numpy(np.ascontiguousarray(x).astype(t)) for x, t in (
        (ctx, np.int32), (diff, np.int32), (act, np.bool_),
        (states, np.uint8), (one, np.uint8), (zero, np.uint8),
        (np.zeros(1), np.int32), (np.full(1, 0xFF00), np.int32))]
    twin = K.rc_encode_ext_stats_ref if bits > 10 else K.rc_encode_stats_ref
    plain = K.rc_encode_packed_ext_ref if bits > 10 else \
        K.rc_encode_packed_ref
    got = twin(*args, bits)
    assert np.array_equal(got[4][0].numpy(), hook.rc_stat)
    assert np.array_equal(got[5][0].numpy(), hook.rc_stat2[0])
    assert np.array_equal(got[3][0].numpy(), host_states)
    assert all(torch.equal(x, y) for x, y in zip(got[:4], plain(*args, bits)))


@pytest.mark.parametrize("model", [0, 1])
@pytest.mark.parametrize("bits", [8, 10])
def test_row_counts_twin_matches_the_host_hook(bits, model):
    """K1's row counts (``rc_stats_rows_ref``, the plain version of
    ``rc_stats_rows_kernel``) count what the host's pass-1 hook counts by
    (row, position, bit), at context models 0 and 1, on two lanes of
    random residuals up to +-2^(bits-1) with zero residuals, inactive
    pixels and contexts past the table's end (clamped, as the scan does);
    the same as the stats plain version's stat2, whose state counts are
    the hook's too."""
    CC = 2 * JT.CONTEXT_COUNTS[model]
    r = np.random.RandomState(100 * model + bits)
    L, n = 2, 500
    half = 1 << (bits - 1)
    ctx = r.randint(0, CC + 3, (L, n))
    ctx[:, 50:90] = ctx[:, 50:51]
    diff = np.where(r.rand(L, n) < 0.4, r.randint(-half, half, (L, n)),
                    r.randint(-2, 3, (L, n)))
    diff[:, :2] = [-half, half - 1]
    act = r.rand(L, n) < 0.85
    states = r.randint(1, 256, (L, CC, 32)).astype(np.uint8)
    one, zero = custom_state_tables(JT.VER2_STATE)
    hook = J.Pass1Stats(L, [CC] * L)
    for lane in range(L):
        rc = RangeEncoder(one, zero)
        st = states[lane].copy()
        for c, d, on in zip(ctx[lane], diff[lane], act[lane]):
            c = min(c, CC - 1)
            if on:
                put_symbol(rc, st[c], int(d), True, hook.hook(lane, c))
    args = [torch.from_numpy(np.ascontiguousarray(x).astype(t)) for x, t in (
        (ctx, np.int32), (diff, np.int32), (act, np.bool_),
        (states, np.uint8), (one, np.uint8), (zero, np.uint8),
        (np.zeros(L), np.int32), (np.full(L, 0xFF00), np.int32))]
    rows = K.rc_stats_rows_ref(*args[:3], bits, CC)
    want = np.stack([hook.rc_stat2[lane] for lane in range(L)])
    assert int(want.sum()) > 0
    assert np.array_equal(rows.numpy(), want)
    got = K.rc_encode_stats_ref(*args, bits)
    assert torch.equal(got[5], rows)
    assert np.array_equal(got[4].sum(0).numpy(), hook.rc_stat)


def _pcm8_streams():
    """640x4 yuv444p at version 4 in a 2 x 2 grid (slices 320 x 2): each
    slice's budget, 11,776 bytes, against w * 35 = 11,200 at its line
    starts, so 8-bit noise retries as PCM and a smooth ramp does not.
    Stream 0: noise, ramp, noise; stream 1: the ramp in every frame."""
    r = np.random.RandomState(8)
    w, h = 640, 4
    yy, xx = np.mgrid[0:h, 0:w]

    def ramp(t):
        return [((xx + yy + 3 * t + 7 * k) % 256).astype(np.uint8)
                for k in range(3)]

    def noise():
        return [r.randint(0, 256, (h, w)).astype(np.uint8) for _ in range(3)]

    kw = dict(width=w, height=h, pix_fmt="yuv444p", level=4, strict=-2,
              coder=2, slices=4, gop_size=3)
    return kw, [[noise() if t != 1 else ramp(t) for t in range(3)],
                [ramp(t) for t in range(3)]]


def test_pcm_slices_count_nothing_8bit():
    """The 8-bit form of test_pcm_slices_count_nothing, through K1's stats
    scan and row counts: stream 0's noise frames 0 and 2 retry every
    slice as PCM, whose lanes the encoder leaves out of both count
    tables, and frame 1 codes from the reset states, so stream 0's text
    is the host's pass 1 of frame 1 alone; stream 1's is the host's."""
    kw, streams = _pcm8_streams()
    texts, pkts, extradata = port_pass1(kw, streams)
    modes = []
    for stream_pkts in pkts:
        host = FFV1Decoder(kw["width"], kw["height"], extradata)
        modes.append([])
        for pkt, _key in stream_pkts:
            host.decode_frame(pkt)
            modes[-1].append([s.slice_coding_mode
                              for s in host.slices[:host.slice_count]])
    assert modes == [[[1] * 4, [0] * 4, [1] * 4], [[0] * 4] * 3]
    assert texts == [host_pass1(kw, streams[0][1:2])[0],
                     host_pass1(kw, streams[1])[0]]


@pytest.mark.parametrize("how", ["depth2", "batch2", "devices2"])
def test_two_pass_in_flight_batched_and_sharded(how):
    """Pass 1 at depth 2, at batch 2 (each stream its own text, the
    second stream of other frames) and over devices=["cpu"] * 2 (each
    lane block's counts gathered) gives the host's texts; pass 2 at depth
    2 writes the host's bytes."""
    kw, frames = config("coder2")
    if how == "depth2":
        assert port_pass1(kw, [frames], depth=2)[0] == [host_stats("coder2")]
        text = host_stats("coder2")
        assert port_pass2(kw, frames, text, depth=2) == \
            host_pass2(kw, frames, text)
        return
    other = synth_frames(kw["pix_fmt"], kw["width"], kw["height"], N_FRAMES,
                         seed=22)
    enc_kw = dict(devices=["cpu"] * 2) if how == "devices2" else {}
    texts, _pkts, _extradata = port_pass1(kw, [frames, other], **enc_kw)
    assert texts == [host_stats("coder2"), host_pass1(kw, other)[0]]


def test_reset_drops_the_counts_of_frames_in_flight():
    """Pass 1 at depth 2 with reset() while keyframe 2 is in flight: the
    dropped frame counts neither its decisions nor its keyframe, so
    get_stats is the host's text for the frames collected (0 and 1)."""
    kw, frames = config("coder2")
    enc = TorchFFV1Encoder(TorchEncoderParams(**kw, pass1=True),
                           device="cpu")
    enc.submit_frames([frames[0]])
    enc.submit_frames([frames[1]])
    enc.collect_frames()
    enc.submit_frames([frames[2]])
    enc.collect_frames()
    enc.reset()
    assert enc.get_stats() == host_pass1(kw, frames[:2])[0]


def test_pcm_slices_count_nothing():
    """Version 4 (chip_smoke.py's v4_pcm content, 512x4 yuv444p16le, batch
    2, GOP 3): stream 0's noise frames 0 and 2 retry every slice as PCM,
    whose packets code none of the scan's decisions, and frame 1 codes
    from the reset states, so stream 0's text is the host's pass 1 of
    frame 1 alone (fresh states, one keyframe); stream 1 never retries,
    and its text is the host's."""
    kw = chip_smoke.pcm_kw()
    streams = chip_smoke.synthetic_streams_pcm()
    texts, pkts, extradata = port_pass1(kw, streams)
    modes = []
    for stream_pkts in pkts:
        host = FFV1Decoder(kw["width"], kw["height"], extradata)
        modes.append([])
        for pkt, _key in stream_pkts:
            host.decode_frame(pkt)
            modes[-1].append([s.slice_coding_mode
                              for s in host.slices[:host.slice_count]])
    assert modes == [[[1] * 4, [0] * 4, [1] * 4], [[0] * 4] * 3]
    assert texts == [host_pass1(kw, streams[0][1:2])[0],
                     host_pass1(kw, streams[1])[0]]


@pytest.mark.parametrize("name", ["coder2", "coder1_ctx1"])
def test_decoder_on_pass2_streams(name):
    """TorchFFV1Decoder starts its lanes from the extradata's tuned
    initial states: lossless on the host's pass-2 stream (the same bytes
    as the port's, test_pass2_matches_host) and equal to the host
    decoder."""
    kw, frames = config(name)
    extradata, pkts = host_pass2(kw, frames, host_stats(name))
    dec = TorchFFV1Decoder(kw["width"], kw["height"], extradata,
                           device="cpu")
    ref = FFV1Decoder(kw["width"], kw["height"], extradata)
    for f, (pkt, _key) in zip(frames, pkts):
        got = dec.decode_frame(pkt)[0]
        want = ref.decode_frame(pkt)[0]
        for a, b, c in zip(got, want, f):
            assert np.array_equal(np.asarray(a), b)
            assert np.array_equal(b, c)
