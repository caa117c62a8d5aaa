"""The port's Golomb-Rice path (coder 0, FFV1's default coder) on the CPU,
against the JAX package: the flag stream, the Golomb parameter's closed
form, the plain versions of G1 and G2 against the JAX scans
(golomb_encode_scan_lanes + finalize_bytes, golomb_decode_planes_lanes)
on edge inputs, random bytes and host-encoded streams, and the slice as
a whole on device="cpu": packets byte-identical to TPUFFV1Encoder and
the host FFV1Encoder (yuv420p, gray, yuv444p, yuva420p; context models
0 and 1; coder 0 and -1; GOP 2 with batch 2), lossless decode of host
streams, a GOP handed over from the JAX classes, reset, and a CRC-damaged
slice concealed as the host conceals it.  Every comparison is exact: the
codec is integer and lossless."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .util import synth_frames
from tpu_ffv1 import EncoderParams, FFV1Decoder, FFV1Encoder
from tpu_ffv1.core import tables as JT
from tpu_ffv1.tpu import golomb_scan as JG
from tpu_ffv1.tpu.decoder import TPUFFV1Decoder
from tpu_ffv1.tpu.encoder import TPUFFV1Encoder
from tpu_ffv1.tpu.golomb_dec_lanes import golomb_decode_planes_lanes
from tpu_ffv1_torch import TorchFFV1Decoder, TorchFFV1Encoder
from tpu_ffv1_torch.tpu import golomb_decode as D
from tpu_ffv1_torch.tpu import golomb_encode as E
from tpu_ffv1_torch.tpu.state import (decoder_state_from_numpy,
                                      encoder_state_from_numpy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the edge-input generators)

LAYOUTS = [
    [(48, 40, 0)],
    [(24, 20, 0), (12, 10, 1), (12, 10, 1)],
    [(7, 3, 0), (4, 2, 1), (4, 2, 1), (7, 3, 2)],
    [(1, 5, 0), (1, 5, 1)],
]


@pytest.mark.parametrize("dims", LAYOUTS,
                         ids=["gray", "yuv420p", "yuva_odd", "one_column"])
def test_make_flags_matches_jax(dims):
    got = E.make_flags(dims)
    assert got.dtype == np.int32
    assert np.array_equal(got, JG.make_flags(dims))
    assert E.VLC_FRESH == JG.VLC_FRESH


def test_vlc_k_closed_form_matches_loop():
    """The closed form of G1, G2 and the plain versions against the
    17-step loop (golomb_scan.py:115-122), over every count 0..129 and
    error_sum 0..0xFFFF."""
    count = torch.arange(130).repeat_interleave(1 << 16)
    esum = torch.arange(1 << 16).repeat(130)
    k = torch.zeros_like(count)
    i = count.clone()
    for _ in range(17):
        go = i < esum
        k = k + go
        i = torch.where(go, i + i, i)
    assert torch.equal(E.vlc_k(count, esum), k)


@pytest.mark.parametrize("cc", [666, 7563])
def test_vlc_pixel_count_follows_the_run_machine(cc):
    """chip_smoke.golomb_vlc_pixels (the bounds' count of VLC-coded pixels,
    vectorised) against the run machine of ffv1enc.c:326-367 pixel by
    pixel, on G1's edge inputs (runs across line ends, breaks, inactive
    blocks)."""
    dims = ((40, 6, 0), (20, 3, 1), (20, 3, 1))
    ctx, diff, act, flags = chip_smoke.golomb_encode_edge_inputs(
        4, dims, cc, 17)[:4]
    want = []
    for c, d, a in zip(ctx, diff, act):
        run_mode, n = 0, 0
        for ci, di, ai, f in zip(c, d, a, flags):
            if f & E.FLAG_LINE_START:
                run_mode = 0
            if not ai:
                continue
            if ci == ((f & 0xFFFF) >> E.FLAG_SPLANE_SHIFT) * cc:
                run_mode = 1
            if run_mode and di != 0:
                run_mode = 0                  # the break's pixel: a symbol
            n += run_mode == 0
        want.append(n)
    got = chip_smoke.golomb_vlc_pixels(*[torch.from_numpy(x) for x in (
        ctx, diff, act, flags)], cc)
    assert got.tolist() == want
    assert 0 < min(want) and max(want) < ctx.shape[1]


@pytest.mark.parametrize("cc", [666, 7563])
def test_run_work_follows_the_run_machine(cc):
    """chip_smoke.golomb_run_work (the chain bound's run work: G1's run
    machine steps, G2's run pixels) against the run machine of
    ffv1enc.c:326-367 pixel by pixel, as G1 runs it: a step per completed
    run chunk, per break and per line-end flush; a run pixel per zero
    residual inside a run.  On G1's edge inputs, with long runs across
    lines and chunks in the last lanes (run_index past 16)."""
    dims = ((64, 8, 0), (32, 4, 1), (1, 6, 1), (2, 5, 0))
    ctx, diff, act, flags = chip_smoke.golomb_encode_edge_inputs(
        4, dims, cc, 23)[:4]
    base = ((flags & 0xFFFF) >> E.FLAG_SPLANE_SHIFT) * cc
    ctx[2:, :600] = base[:600]
    diff[2:, :600] = 0
    diff[3, 300] = 5
    act[3, 100:140] = True
    l2run = list(E.LOG2_RUN) + [0]
    want_steps, want_px, top = [], [], 0
    for c, d, a in zip(ctx, diff, act):
        run_index = run_mode = run_count = steps = px = 0
        for ci, di, ai, f in zip(c, d, a, flags):
            if f & E.FLAG_PLANE_START:
                run_index = 0
            if f & E.FLAG_LINE_START:
                run_mode = run_count = 0
            if ai and ci == ((f & 0xFFFF) >> E.FLAG_SPLANE_SHIFT) * cc:
                run_mode = 1
            if run_mode and ai:
                if di == 0:
                    px += 1
                    run_count += 1
                    if run_count == 1 << l2run[min(run_index, 41)]:
                        steps += 1
                        run_count = 0
                        run_index += 1
                else:
                    steps += 1
                    run_index = max(run_index - 1, 0)
                    run_mode = run_count = 0
            if run_mode and ai and f & E.FLAG_LINE_END and run_count:
                steps += 1                    # the line-end flush
            top = max(top, run_index)
        want_steps.append(steps)
        want_px.append(px)
    got = chip_smoke.golomb_run_work(*[torch.from_numpy(x) for x in (
        ctx, diff, act, flags)], cc)
    assert got[0].tolist() == want_steps and got[1].tolist() == want_px
    assert min(want_steps) > 0 and top > 16


@pytest.mark.parametrize("variant", ["full", "no_vlc"])
def test_stage_probes_on_the_cpu(variant):
    """G1's and G2's stage probes on CPU tensors: ``full`` is the plain
    version, a stubbed stage has none (it times the card)."""
    cc = 666
    dims = ((40, 6, 0), (20, 3, 1), (20, 3, 1))
    args = (*[torch.from_numpy(a) for a in
              chip_smoke.golomb_encode_edge_inputs(3, dims, cc, 5)],
            8, cc, None)
    dargs = (*[torch.from_numpy(a) for a in
               chip_smoke.golomb_decode_random_inputs(3, 256, cc, False,
                                                      6)],
             ((40, 2, 0), (20, 1, cc)), 8, False)
    if variant != "full":
        with pytest.raises(NotImplementedError):
            E.golomb_encode_stages(*args, variant)
        with pytest.raises(NotImplementedError):
            D.golomb_decode_stages(*dargs, variant)
        return
    for a, b in zip(E.golomb_encode_stages(*args, variant),
                    E.golomb_encode_lanes_ref(*args)):
        assert torch.equal(a, b)
    got = chip_smoke.flat_outputs(D.golomb_decode_stages(*dargs, variant))
    want = chip_smoke.flat_outputs(D.golomb_decode_planes_ref(*dargs))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


ENCODE_CASES = [
    # (label, lanes, planes (w, h, state_plane), contexts a plane, fresh)
    ("ctx0_yuv420p", 3, ((40, 6, 0), (20, 3, 1), (20, 3, 1)), 666, False),
    ("ctx1_yuv444p", 4, ((24, 12, 0), (24, 12, 1), (24, 12, 1)), 7563,
     False),
    ("ctx0_yuva420p", 5, ((32, 16, 0), (16, 8, 1), (16, 8, 1),
                          (32, 16, 2)), 666, False),
    ("ctx0_gray_fresh", 3, ((64, 30, 0),), 666, True),
]


@pytest.mark.parametrize("label,L,dims,cc,fresh", ENCODE_CASES,
                         ids=[c[0] for c in ENCODE_CASES])
def test_encode_plain_matches_jax(label, L, dims, cc, fresh):
    """golomb_encode_lanes_ref against finalize_bytes(
    golomb_encode_scan_lanes(...)) on chip_smoke's edge inputs: runs of
    the plane's context 0 (chunks, breaks, the line-end flush), zero
    residuals, escapes, inactive blocks, carried VLC states (or fresh
    ones), prefixes of 0..PREFIX_CAP bytes: bytes up to each count,
    counts, VLC states and run index."""
    arrs = chip_smoke.golomb_encode_edge_inputs(L, dims, cc, 30 + L)
    if fresh:
        arrs[4] = np.ascontiguousarray(np.broadcast_to(
            np.array(E.VLC_FRESH, np.int32), arrs[4].shape))
    ctx, diff, act, flags, vlc0, pre, plens = arrs
    packed, vlc_j, ri_j = JG.golomb_encode_scan_lanes(
        jnp.asarray(ctx), jnp.asarray(diff), jnp.asarray(act),
        jnp.asarray(flags), jnp.asarray(vlc0), jnp.zeros(L, jnp.int32), 8,
        cc)
    out_j, cnt_j = JG.finalize_bytes(packed, jnp.asarray(pre),
                                     jnp.asarray(plens))
    out_j, cnt_j = np.asarray(out_j), np.asarray(cnt_j)
    out, cnt, vlc, ri = E.golomb_encode_lanes(
        *[torch.from_numpy(a) for a in arrs], 8, cc)
    assert np.array_equal(cnt.numpy(), cnt_j)
    assert (cnt.numpy() > plens).all()
    for lane in range(L):
        n = cnt_j[lane]
        assert np.array_equal(out[lane, :n].numpy(), out_j[lane, :n])
        assert not out[lane, n:].any()
    assert np.array_equal(vlc.numpy(), np.asarray(vlc_j))
    assert np.array_equal(ri.numpy(), np.asarray(ri_j))


def test_encode_plain_output_cap():
    """Past ``out_cap`` no byte is written, and the counts stay true."""
    dims = ((40, 6, 0), (20, 3, 1), (20, 3, 1))
    arrs = [torch.from_numpy(a) for a in
            chip_smoke.golomb_encode_edge_inputs(3, dims, 666, 77)]
    full = E.golomb_encode_lanes(*arrs, 8, 666)
    cut = E.golomb_encode_lanes(*arrs, 8, 666, 40)
    assert int(full[1].max()) > 40 and cut[0].shape == (3, 40)
    assert torch.equal(cut[0], full[0][:, :40])
    for a, b in zip(cut[1:], full[1:]):
        assert torch.equal(a, b)


def _decode_check(bufs, vlc0, qt, pos0, specs, five):
    want = golomb_decode_planes_lanes(
        jnp.asarray(bufs), jnp.asarray(vlc0), jnp.asarray(qt),
        jnp.asarray(pos0), specs, 8, five)
    got = D.golomb_decode_planes(
        *[torch.from_numpy(np.ascontiguousarray(a))
          for a in (bufs, vlc0, qt, pos0)], specs, 8, five)
    for a, b in zip(got[0], want[0]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    return got


@pytest.mark.parametrize("five,model", [(False, 0), (True, 1), (False, 1)],
                         ids=["three_ctx0", "five_ctx1", "three_ctx1"])
def test_decode_plain_matches_jax_random_bytes(five, model):
    """golomb_decode_planes_ref against golomb_decode_planes_lanes on
    random bytes (long runs, escapes, reads past cap) with carried VLC
    states, planes 40, 33, 2 and 1 wide.  The quant tables' contexts fit
    the table (the 5-input context with context model 0's table size has
    contexts past it, which the port clamps into the lane's table and
    the JAX scan reads from the next lane's)."""
    cc = JT.CONTEXT_COUNTS[model]
    bufs, vlc0, qt, pos0 = chip_smoke.golomb_decode_random_inputs(
        4, 512, cc, five, 50 + 2 * model + five)
    specs = ((40, 3, 0), (33, 2, cc), (2, 2, cc), (1, 2, 0))
    got = _decode_check(bufs, vlc0, qt, pos0, specs, five)
    assert int(got[2][2]) >= 8 * 512, "lane 2 did not read past its buffer"


@pytest.mark.parametrize("model", [0, 1])
def test_decode_plain_matches_jax_host_stream(model):
    """Both scans on the host encoder's Golomb-Rice packets (48x40
    yuv420p, 4 slices), a key frame and the non-key frame after it from
    the key frame's VLC states: the same planes, states and positions,
    and the source pixels."""
    params = EncoderParams(width=48, height=40, pix_fmt="yuv420p", level=3,
                           coder=0, slices=4, gop_size=4,
                           context_model=model)
    frames = synth_frames("yuv420p", 48, 40, 2, seed=11)
    enc = FFV1Encoder(params)
    dec = TorchFFV1Decoder(48, 40, enc.extradata, device="cpu")
    cc = dec.g.context_counts[model]
    vlc0 = np.tile(np.array(E.VLC_FRESH, np.int32), (4, 2 * cc, 1))
    specs = tuple((w, h, sp * cc) for (w, h, sp) in dec._plane_specs())
    qt = np.asarray(dec.g.quant_tables[model], np.int32)
    for f in frames:
        parsed = [dec._parse_packet(0, enc.encode_frame(f)[0])]
        (bufs, _lo, _ra, poss), _lens, _q = dec._lane_inputs(parsed)
        planes, vlc, _bp = _decode_check(bufs.numpy(), vlc0, qt,
                                         poss.numpy(), specs, model == 1)
        vlc0 = vlc.numpy()
        g = dec.geoms[0]
        assert np.array_equal(planes[0][0].numpy(),
                              f[0][g.y:g.y + g.height, g.x:g.x + g.width])


# the slice as a whole on device="cpu"

def _params(pix_fmt, model, coder, gop=2):
    return EncoderParams(width=48, height=40, pix_fmt=pix_fmt, level=3,
                         coder=coder, slices=4, gop_size=gop,
                         context_model=model)


SLICE_CONFIGS = [
    # (label, pix_fmt, context model, coder)
    ("yuv420p_ctx0_coder0", "yuv420p", 0, 0),
    ("yuv420p_ctx1_default", "yuv420p", 1, -1),
    ("gray_ctx0_default", "gray", 0, -1),
    ("yuv444p_ctx1_coder0", "yuv444p", 1, 0),
    ("yuva420p_ctx0_coder0", "yuva420p", 0, 0),
]


@pytest.mark.parametrize("label,pix_fmt,model,coder", SLICE_CONFIGS,
                         ids=[c[0] for c in SLICE_CONFIGS])
def test_encoder_matches_jax_and_host(label, pix_fmt, model, coder):
    """batch=2, GOP 2, three frames: the port's packets equal
    TPUFFV1Encoder's and the host encoder's, stream by stream."""
    params = _params(pix_fmt, model, coder)
    streams = [synth_frames(pix_fmt, 48, 40, 3, seed=20 + b)
               for b in range(2)]
    port = TorchFFV1Encoder(params, batch=2, device="cpu")
    assert port.golomb
    jaxe = TPUFFV1Encoder(params, batch=2)
    hosts = [FFV1Encoder(params) for _ in range(2)]
    assert port.extradata == jaxe.extradata == hosts[0].extradata
    for t in range(3):
        frame = [streams[b][t] for b in range(2)]
        got = port.encode_frames(frame)
        assert got == jaxe.encode_frames(frame), f"frame {t}"
        for b in range(2):
            assert got[b] == hosts[b].encode_frame(frame[b]), \
                f"frame {t} stream {b}"


def test_decoder_lossless_on_host_streams_batch2():
    """Two host streams (GOP 2) decoded in lockstep across key and
    non-key frames."""
    params = _params("yuv420p", 0, 0)
    streams = [synth_frames("yuv420p", 48, 40, 4, seed=40 + b)
               for b in range(2)]
    hosts = [FFV1Encoder(params) for _ in range(2)]
    dec = TorchFFV1Decoder(48, 40, hosts[0].extradata, batch=2,
                           device="cpu")
    assert dec.golomb
    for t in range(4):
        pkts = [hosts[b].encode_frame(streams[b][t])[0] for b in range(2)]
        out = dec.decode_frames(pkts)
        for b in range(2):
            planes, kf = out[b]
            assert kf == (t % 2 == 0)
            for a, want in zip(planes, streams[b][t]):
                assert np.array_equal(a, want), f"frame {t} stream {b}"
        assert not dec.slice_damaged.any()


def test_gop_begun_in_jax_continues_in_port():
    """Frames 0-1 in TPUFFV1Encoder, frames 2-3 in the port after
    encoder_state_from_numpy with its VLC states: the host's bytes.
    Likewise the decoder: frames 0-1 in TPUFFV1Decoder, 2-3 in the port
    after decoder_state_from_numpy."""
    params = _params("yuv420p", 0, 0, gop=4)
    frames = synth_frames("yuv420p", 48, 40, 4, seed=7)
    host = FFV1Encoder(params)
    want = [host.encode_frame(f) for f in frames]
    jaxe = TPUFFV1Encoder(params)
    assert [jaxe.encode_frame(f) for f in frames[:2]] == want[:2]
    port = TorchFFV1Encoder(params, device="cpu")
    encoder_state_from_numpy(port, np.asarray(jaxe.states),
                             jaxe.picture_number,
                             vlc_states=np.asarray(jaxe.vlc_states))
    assert [port.encode_frame(f) for f in frames[2:]] == want[2:]
    assert not want[2][1]                       # frame 2 is non-key

    jaxd = TPUFFV1Decoder(48, 40, host.extradata)
    for pkt, _kf in want[:2]:
        jaxd.decode_frame(pkt)
    portd = TorchFFV1Decoder(48, 40, host.extradata, device="cpu")
    decoder_state_from_numpy(
        portd, None if jaxd.states is None else np.asarray(jaxd.states),
        jaxd.key_frame_ok, vlc_states=np.asarray(jaxd.vlc_states))
    for (pkt, _kf), f in zip(want[2:], frames[2:]):
        planes, _ = portd.decode_frame(pkt)
        for a, b in zip(planes, f):
            assert np.array_equal(a, b)


def test_reset_starts_a_fresh_gop():
    params = _params("yuv420p", 0, 0, gop=12)
    frames = synth_frames("yuv420p", 48, 40, 2, seed=10)
    port = TorchFFV1Encoder(params, device="cpu")
    first = port.encode_frame(frames[0])
    second = port.encode_frame(frames[1])
    port.reset()
    assert port.encode_frame(frames[0]) == first
    assert port.encode_frame(frames[1]) == second


def test_flipped_byte_flags_slice_and_conceals_as_host():
    """A byte flipped inside a slice of the non-key frame: the CRC flags
    that slice, which shows the previous picture; the host decoder gives
    the same flags and planes."""
    params = _params("yuv420p", 0, 0, gop=12)
    frames = synth_frames("yuv420p", 48, 40, 3, seed=8)
    enc = FFV1Encoder(params)
    pkts = [enc.encode_frame(f)[0] for f in frames]
    bad = bytearray(pkts[1])
    bad[len(bad) // 2] ^= 0x40
    pkts[1] = bytes(bad)
    host = FFV1Decoder(48, 40, enc.extradata, engine="spec")
    port = TorchFFV1Decoder(48, 40, enc.extradata, device="cpu")
    for k, pkt in enumerate(pkts):
        want, _ = host.decode_frame(pkt)
        got, _ = port.decode_frame(pkt)
        flags = [bool(ss.slice_damaged)
                 for ss in host.slices[:host.slice_count]]
        assert list(port.slice_damaged[0]) == flags, f"frame {k}"
        assert sum(flags) == (1 if k else 0)
        for a, b in zip(got, want):
            assert np.array_equal(a, b), f"frame {k}"
