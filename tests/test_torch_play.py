"""The port's player (tpu_ffv1_torch/cli/play.py) at ``-device cpu``
against the JAX package's (tpu_ffv1/cli/play.py, whose decoder is the
host engine): keyframe-accurate seek through ``_decode_from`` (the same
frames and restart index), the terminal rendering byte for byte, the
display conversion for every storage convention, the refusals, and a
cuda player without a GPU exiting before it decodes."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import io

import numpy as np
import pytest
import torch

from tpu_ffv1.cli import play as jplay
from tpu_ffv1.codec.encoder import FFV1Encoder
from tpu_ffv1.codec.params import EncoderParams
from tpu_ffv1.io.avi import AviStream, write_avi
from tpu_ffv1_torch.cli import main as tmain
from tpu_ffv1_torch.cli import play as tplay

W, H = 64, 32
N = 5


def _frames(n, seed=0):
    r = np.random.RandomState(seed)
    return [[(np.add.outer(np.arange(H), np.arange(W)) * 3 + 40 * t +
              r.randint(0, 3, (H, W))).astype(np.uint8),
             np.full((H // 2, W // 2), 100 + t, np.uint8),
             r.randint(120, 136, (H // 2, W // 2)).astype(np.uint8)]
            for t in range(n)]


def _avi(path, frames, **kw):
    enc = FFV1Encoder(EncoderParams(width=W, height=H, pix_fmt="yuv420p",
                                    **kw))
    pkts = [enc.encode_frame(f) for f in frames]
    write_avi(path, AviStream(width=W, height=H,
                              extradata=enc.extradata or b"",
                              packets=[p for p, _ in pkts],
                              keyflags=[k for _, k in pkts]))
    return path


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """5 frames at GOP 3 (keyframes 0 and 3), range coder, 4 slices."""
    frames = _frames(N)
    path = str(tmp_path_factory.mktemp("play") / "clip.avi")
    return _avi(path, frames, level=3, coder=2, slices=4, gop_size=3), \
        frames


@pytest.mark.parametrize("ss", [0, 2, 4])
def test_decode_from_matches_jax(clip, ss):
    path, frames = clip
    got = tplay._decode_from(path, ss, "cpu")
    want = jplay._decode_from(path, ss)
    assert got[1:] == want[1:]
    assert got[5] == (3 if ss == 4 else 0)
    assert len(got[0]) == len(want[0]) == N - ss
    for fg, fw, src in zip(got[0], want[0], frames[ss:]):
        for a, b, c in zip(fg, fw, src):
            assert a.dtype == b.dtype and np.array_equal(a, b)
            assert np.array_equal(a, c)


def test_play_matches_jax(clip, capsys):
    """A seek to frame 4 (via keyframe 3), rendered at 40x12: the same
    terminal bytes and the same report, times aside."""
    path, _ = clip
    outs, errs = [], []
    for run, extra in ((jplay.play, []), (tplay.play, ["-device", "cpu"])):
        buf = io.StringIO()
        assert run([path, "-fs", "40x12", "-ss", "4"] + extra,
                   out=buf) == 0
        outs.append(buf.getvalue())
        errs.append(capsys.readouterr().err)
    assert outs[0] == outs[1]
    assert outs[1].count("\x1b[H") == 1 and "▀" in outs[1]
    for err in errs:
        assert err.startswith(f"1 frames {W}x{H} yuv420p in ")
        assert err.rstrip().endswith(", seek to 4 via keyframe 3)")
    assert tmain.seek_start is tplay.seek_start


def _planes(pix, seed):
    """A frame in the decoders' storage convention for ``pix``."""
    r = np.random.RandomState(seed)
    if pix == "yuv420p":
        return [r.randint(0, 256, s).astype(np.uint8)
                for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    if pix == "gray":
        return [r.randint(0, 256, (H, W)).astype(np.uint8)]
    if pix == "bgr0":
        a = r.randint(0, 256, (H, W, 4)).astype(np.uint8)
        a[..., 3] = 0
        return [a]
    return [r.randint(0, 256, (H, W, 2)).astype(np.uint8)]     # ya8


@pytest.mark.parametrize("pix", ["yuv420p", "gray", "bgr0", "ya8"])
def test_display_conversion_matches_jax(pix):
    planes = _planes(pix, 3)
    rgb = tplay._to_rgb(planes, pix, W, H)
    want = jplay._to_rgb(planes, pix, W, H)
    assert rgb.dtype == want.dtype and np.array_equal(rgb, want)
    got_s, want_s = io.StringIO(), io.StringIO()
    tplay._render_halfblocks(rgb, 33, 9, got_s)
    jplay._render_halfblocks(want, 33, 9, want_s)
    assert got_s.getvalue() == want_s.getvalue()


def test_in_band_headers_refused(tmp_path):
    """A version 1 stream (headers in band, no extradata) is refused with
    the command line's message; the JAX player decodes it."""
    path = _avi(str(tmp_path / "v1.avi"), _frames(1), level=1, coder=0,
                gop_size=1)
    assert jplay._decode_from(path, 0)[0]
    with pytest.raises(NotImplementedError, match="out-of-band headers"):
        tplay._decode_from(path, 0, "cpu")
    with pytest.raises(SystemExit) as e:
        tplay.play([path, "-nodisp", "-device", "cpu"])
    assert str(e.value.code) == f"error: {tmain.NO_EXTRADATA}"


def test_cuda_player_without_cuda_exits_before_decoding(clip, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here; nothing to refuse")

    def decode(*a, **kw):
        raise AssertionError("the player decoded")

    monkeypatch.setattr(tplay, "_decode_from", decode)
    with pytest.raises(SystemExit) as e:
        tplay.play([clip[0], "-nodisp", "-device", "cuda"])
    msg = str(e.value.code)
    assert msg.startswith("error: device 'cuda' requested")
    assert "torch.cuda.is_available() is False" in msg
