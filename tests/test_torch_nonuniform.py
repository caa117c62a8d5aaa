"""Non-uniform slice grids in the port's encoder, on device="cpu": the
fused encode over lanes of unequal length (the per-size crop gathers,
K1 / K1-ext / K1-compact under the active mask, version 4's grouped RCT
search and its output-cap PCM trigger) against TPUFFV1Encoder and the
host FFV1Encoder; the decode of these grids is in
test_torch_nonuniform_dec.py.  Every comparison is exact: the codec is
integer and lossless."""
import numpy as np
import pytest

from .test_tpu_v4 import _textured
from .util import synth_frames
from tpu_ffv1 import EncoderParams, FFV1Decoder, FFV1Encoder
from tpu_ffv1.codec.rct import choose_rct_params
from tpu_ffv1.tpu.encoder import TPUFFV1Encoder
from tpu_ffv1_torch import TorchFFV1Decoder, TorchFFV1Encoder

# (label, pix_fmt, width, height, slices, context model): 4 slices of
# 50x40 are one size (25x20) whose 4:2:0 chroma tiles are not exact
# (neighbouring crops share a column); the other grids have slices of
# two or more sizes
CONFIGS = [
    ("yuv420p_ctx0_4", "yuv420p", 50, 40, 4, 0),
    ("yuv420p_ctx0_6", "yuv420p", 50, 40, 6, 0),
    ("yuv420p_ctx1_4", "yuv420p", 50, 40, 4, 1),
    ("yuv420p_ctx1_6", "yuv420p", 50, 40, 6, 1),
    ("yuv422p10le", "yuv422p10le", 50, 40, 6, 0),
    ("yuv444p16le", "yuv444p16le", 26, 21, 4, 0),   # K1-ext, K2-ext
    ("yuva420p", "yuva420p", 50, 40, 6, 0),
    ("gray16le", "gray16le", 26, 21, 6, 0),
]
FRAMES = 3


def _params(pix_fmt, w, h, slices, cm, gop=2, **kw):
    return EncoderParams(width=w, height=h, pix_fmt=pix_fmt, level=3,
                         coder=2, slices=slices, gop_size=gop,
                         context_model=cm, **kw)


@pytest.fixture(scope="module", params=CONFIGS, ids=[c[0] for c in CONFIGS])
def streams(request):
    """Two streams of FRAMES frames, GOP 2, and the host encoder's
    packets of each."""
    _label, pix_fmt, w, h, slices, cm = request.param
    params = _params(pix_fmt, w, h, slices, cm)
    frames = [synth_frames(pix_fmt, w, h, FRAMES, seed=40 + b)
              for b in range(2)]
    pkts = []
    for fr in frames:
        host = FFV1Encoder(params)
        pkts.append([host.encode_frame(f) for f in fr])
    return params, frames, pkts, host.extradata


def test_encoder_matches_jax_and_host(streams):
    """batch 2: the port's packets equal TPUFFV1Encoder's (its fused
    path, one lane per slice at its own length) and the host's."""
    params, frames, pkts, extradata = streams
    port = TorchFFV1Encoder(params, batch=2, device="cpu")
    jaxe = TPUFFV1Encoder(params, batch=2)
    assert not port.uniform and not jaxe.uniform
    assert port.stream_lens == jaxe.stream_lens
    assert port.n_max == max(jaxe.stream_lens)
    assert port.extradata == extradata
    for t in range(FRAMES):
        frame = [frames[b][t] for b in range(2)]
        got = port.encode_frames(frame)
        assert jaxe.encode_frames(frame) == got, f"frame {t}"
        assert got == [pkts[b][t] for b in range(2)], f"frame {t}"


@pytest.mark.parametrize("w,h,slices", [(1280, 720, 24), (720, 486, 24),
                                        (2048, 1080, 24)],
                         ids=["720p", "ntsc", "2k"])
def test_broadcast_sizes_are_taken(w, h, slices):
    """FFmpeg's -slices 24 (6 x 4) at 720p, NTSC SD and DCI 2K: grids
    the port refused before; both classes take them (planar YUV, range
    coder), with at most 4 lane lengths."""
    params = _params("yuv420p", w, h, slices, 0)
    enc = TorchFFV1Encoder(params, device="cpu")
    dec = TorchFFV1Decoder(w, h, enc.extradata, device="cpu")
    assert not enc.uniform and not dec.uniform
    assert 1 < len(enc.groups) <= 4
    assert enc.n_max == max(enc.stream_lens)


@pytest.mark.parametrize("cm", [0, 1])
def test_compact_form_lanes_of_unequal_length(cm):
    """compact=True on a non-uniform grid: K1-compact's plain version and
    finalize_compact over lanes of unequal length give the host's
    bytes."""
    params = _params("yuv420p", 50, 40, 6, cm)
    frames = [synth_frames("yuv420p", 50, 40, FRAMES, seed=50 + b)
              for b in range(2)]
    port = TorchFFV1Encoder(params, batch=2, device="cpu", compact=True)
    assert port.compact and len(set(port.stream_lens)) > 1
    hosts = [FFV1Encoder(params) for _ in range(2)]
    for t in range(FRAMES):
        got = port.encode_frames([frames[b][t] for b in range(2)])
        for b in range(2):
            assert got[b] == hosts[b].encode_frame(frames[b][t]), \
                f"stream {b} frame {t}"


def test_v4_rct_search_nonuniform_grid():
    """tests/test_tpu_v4.py:95 in the port: 101x34 yuv444p16le at
    version 4, 4 slices of two widths; the grouped search's picks equal
    the host's choose_rct_params per slice, and the packets equal
    TPUFFV1Encoder's (which searches on the host pixels there) and the
    host encoder's."""
    params = EncoderParams(width=101, height=34, pix_fmt="yuv444p16le",
                           level=4, strict=-2, coder=2, slices=4)
    rng = np.random.RandomState(13)
    frames = [[_textured(rng, (34, 101), 0, 65000, 7 + p)
               for p in range(3)] for _ in range(2)]
    host = FFV1Encoder(params)
    jaxe = TPUFFV1Encoder(params)
    port = TorchFFV1Encoder(params, device="cpu")
    assert not port.uniform and port.rct_search
    for i, f in enumerate(frames):
        want = host.encode_frame(f)
        assert jaxe.encode_frame(f) == want, i
        assert port.encode_frame(f) == want, i
        picks = [choose_rct_params([p[g.y:g.y + g.height, g.x:g.x + g.width]
                                    for p in f], False) for g in port.geoms]
        assert port.rct_coefs == picks
    assert set(port.rct_coefs) - {(1, 1)}


@pytest.mark.parametrize("batch", [1, 2])
def test_output_cap_between_the_caps(batch):
    """Off uniform grids version 4's only PCM trigger is the output cap,
    at the reference's length (n_max padded to its scan chunk).  A count
    between the unpadded cap and that one keeps its slice; one past it
    retries as PCM; at version 3 a count past it raises.  (Real content
    stays far below 3-4 bytes a sample, so the counts are given.)"""
    kw = dict(width=101, height=34, pix_fmt="yuv444p16le", coder=2,
              slices=4)
    params = EncoderParams(level=4, strict=-2, **kw)
    port = TorchFFV1Encoder(params, batch=batch, device="cpu")
    assert port.out_cap == TPUFFV1Encoder(params, batch=batch).out_cap
    unpadded = port.n_max * 4 + 4096
    assert unpadded < port.out_cap
    counts = np.full(port.L, 100, np.int64)
    counts[1] = unpadded + 1                 # between the two caps
    assert not port._pcm_lanes(counts).any()
    counts[2] = port.out_cap + 1
    assert list(np.nonzero(port._pcm_lanes(counts))[0]) == [2]
    v3 = TorchFFV1Encoder(EncoderParams(level=3, **kw), batch=batch,
                          device="cpu")
    assert v3.out_cap == port.out_cap
    with pytest.raises(RuntimeError):
        v3._pcm_lanes(counts)


CAP = 400


def test_pcm_retry_off_uniform_grids_matches_jax():
    """The retry off uniform grids end to end: both classes' caps set to
    CAP bytes, so that the noise stream's slices (not the ramp's)
    retry as PCM on the host in every frame; the packets are equal,
    frame 1 codes from the states the PCM reset left, and the host
    decoder reads them losslessly."""
    params = EncoderParams(width=26, height=21, pix_fmt="yuv444p16le",
                           level=4, strict=-2, coder=2, slices=4,
                           gop_size=2)
    r = np.random.RandomState(7)
    yy, xx = np.mgrid[0:21, 0:26]
    streams = [[[r.randint(0, 65536, (21, 26)).astype(np.uint16)
                 for _ in range(3)] for _t in range(FRAMES)],
               [[((xx * 16 + yy * 3 + 100 * t + 7 * k) % 65536)
                 .astype(np.uint16) for k in range(3)]
                for t in range(FRAMES)]]
    port = TorchFFV1Encoder(params, batch=2, device="cpu")
    jaxe = TPUFFV1Encoder(params, batch=2)
    port.out_cap = jaxe.out_cap = CAP
    parser = TorchFFV1Decoder(26, 21, port.extradata, batch=2,
                              device="cpu")
    hosts = [FFV1Decoder(26, 21, port.extradata) for _ in range(2)]
    for t in range(FRAMES):
        frame = [streams[b][t] for b in range(2)]
        got = port.encode_frames(frame)
        assert got == jaxe.encode_frames(frame), f"frame {t}"
        modes = [[e[2] for e in parser._parse_packet(b, got[b][0])[2]]
                 for b in range(2)]
        assert modes == [[1] * 4, [0] * 4], f"frame {t}"
        for b in range(2):
            planes, _kf = hosts[b].decode_frame(got[b][0])
            for a, src in zip(planes, frame[b]):
                assert np.array_equal(a, src)
