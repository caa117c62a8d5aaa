"""``python -m tpu_ffv1_torch`` (tpu_ffv1_torch/cli/main.py) with
``-device cpu`` against the JAX package's CLI (tpu_ffv1/cli/main.py) on
the same input: the files each writes, byte for byte, and the lines each
reports.  The JAX CLI runs ``-engine tpu`` in one module-scoped case (its
compiles are slow on the CPU); the other cases hold the port to
``-engine native``, whose packets the JAX package's tests show to equal
its device classes' (tests/test_tpu.py).  Also: the port's frames at
depth 2 write the same bytes as at depth 1; two-pass mode's files and
messages are the JAX CLI's; and the refusals (v0/v1 streams, the default
device without a GPU) end the run with their message."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_ffv1.cli.main import run as jax_run
from tpu_ffv1.io.rawvideo import write_frames
from tpu_ffv1.io.y4m import write_y4m
from tpu_ffv1_torch.cli import main as port_cli

from .util import REPO, synth_frames

W, H, N = 32, 16, 5
ENC = ["-c:v", "ffv1", "-level", "3", "-slices", "4", "-g", "3"]


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """Sources: 5 frames of 32x16 yuv420p as y4m and rawvideo, 4 of ya8 as
    rawvideo, and an avi the host encoder wrote from the y4m (range
    coder, GOP 3: keyframes 0 and 3)."""
    d = tmp_path_factory.mktemp("cli")
    frames = synth_frames("yuv420p", W, H, N, seed=12)
    paths = dict(y4m=str(d / "in.y4m"), raw=str(d / "in.yuv"),
                 ya8=str(d / "in_ya8.raw"), avi=str(d / "src.avi"))
    write_y4m(paths["y4m"], frames, "yuv420p", W, H, fps=(30, 1))
    write_frames(paths["raw"], frames)
    write_frames(paths["ya8"], synth_frames("ya8", W, H, 4, seed=13))
    assert jax_run(["-i", paths["y4m"], *ENC, "-coder", "2", "-engine",
                    "native", paths["avi"]]) == 0
    return d, paths, frames


def _both(tmp_path, capsys, args, ext, engine="native"):
    """Run both CLIs with ``args`` into files of extension ``ext``; assert
    equal bytes and equal report lines (the -benchmark line aside), and
    return the port's file."""
    out_t, out_j = str(tmp_path / f"t.{ext}"), str(tmp_path / f"j.{ext}")
    capsys.readouterr()
    assert port_cli.run([*args, "-device", "cpu", out_t]) == 0
    said_t = capsys.readouterr()
    assert jax_run([*args, "-engine", engine, out_j]) == 0
    said_j = capsys.readouterr()
    with open(out_t, "rb") as a, open(out_j, "rb") as b:
        assert a.read() == b.read()
    for t, j in ((said_t.out, said_j.out), (said_t.err, said_j.err)):
        lines = [[ln.replace(out_j, out_t) for ln in s.splitlines()
                  if not ln.startswith("bench:")] for s in (t, j)]
        assert lines[0] == lines[1]
    return out_t


@pytest.fixture(scope="module")
def jax_tpu_avi(media, tmp_path_factory):
    """The JAX CLI's file for y4m -> avi (range coder) on -engine tpu."""
    _d, paths, _frames = media
    out = str(tmp_path_factory.mktemp("tpu") / "j.avi")
    assert jax_run(["-i", paths["y4m"], *ENC, "-coder", "2", "-engine",
                    "tpu", out]) == 0
    with open(out, "rb") as f:
        return f.read()


@pytest.mark.parametrize("depth", [2, 1])
def test_encode_matches_jax_tpu_engine(media, jax_tpu_avi, tmp_path,
                                       monkeypatch, depth):
    """y4m -> avi: the port's file equals -engine tpu's, with two frames
    in flight (the CLI's default) and with one."""
    _d, paths, _frames = media
    monkeypatch.setattr(port_cli, "DEPTH", depth)
    out = str(tmp_path / "t.avi")
    assert port_cli.run(["-i", paths["y4m"], *ENC, "-coder", "2",
                         "-device", "cpu", out]) == 0
    with open(out, "rb") as f:
        assert f.read() == jax_tpu_avi


ENCODES = {
    "raw-avi": (["-f", "rawvideo", "-s", f"{W}x{H}", "-pix_fmt", "yuv420p",
                 "-i", "raw", "-coder", "2"], "avi"),
    "y4m-mkv-golomb": (["-i", "y4m", "-coder", "0"], "mkv"),
    "y4m-nut-context1": (["-i", "y4m", "-coder", "2", "-context", "1",
                          "-frames:v", "4"], "nut"),
    "raw-ya8-avi": (["-s", f"{W}x{H}", "-pix_fmt", "ya8", "-i", "ya8",
                     "-coder", "2", "-ss", "1"], "avi"),
}


@pytest.mark.parametrize("case", sorted(ENCODES))
def test_encode_matches(media, tmp_path, capsys, case):
    """Encodes from rawvideo and y4m into avi, mkv and nut."""
    _d, paths, _frames = media
    args, ext = ENCODES[case]
    args = [paths.get(a, a) if i and args[i - 1] == "-i" else a
            for i, a in enumerate(args)]
    _both(tmp_path, capsys, [*args, *ENC], ext)


DECODES = {
    "raw-seek": (["-ss", "4", "-f", "rawvideo"], "yuv"),
    "y4m-seek-frames": (["-ss", "1", "-frames:v", "2"], "y4m"),
}


@pytest.mark.parametrize("case", sorted(DECODES))
def test_decode_matches(media, tmp_path, capsys, case):
    """Decodes to rawvideo and y4m with -ss (the decode restarts at the
    keyframe before it) and -frames:v; the frames are the source's."""
    from tpu_ffv1.io.y4m import read_y4m
    from tpu_ffv1.io.rawvideo import read_frames
    _d, paths, frames = media
    args, ext = DECODES[case]
    out = _both(tmp_path, capsys, ["-i", paths["avi"], *args,
                                   "-benchmark"], ext)
    got = read_y4m(out)[0] if ext == "y4m" else \
        read_frames(out, "yuv420p", W, H)
    want = frames[4:] if case == "raw-seek" else frames[1:3]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_transcode_matches(media, tmp_path, capsys):
    """avi (range coder) -> mkv (Golomb-Rice), decoded and re-encoded."""
    _d, paths, _frames = media
    _both(tmp_path, capsys, ["-i", paths["avi"], *ENC, "-coder", "0"],
          "mkv")


def test_stream_copy_matches(media, tmp_path, capsys):
    """-c:v copy from the keyframe before -ss into nut: no codec runs."""
    _d, paths, _frames = media
    _both(tmp_path, capsys, ["-i", paths["avi"], "-c:v", "copy", "-ss",
                             "4"], "nut")


def test_probe_json_matches(media, capsys):
    _d, paths, _frames = media
    capsys.readouterr()
    assert port_cli.run(["-i", paths["avi"], "-probe", "-of", "json"]) == 0
    got = capsys.readouterr().out
    assert jax_run(["-i", paths["avi"], "-probe", "-of", "json"]) == 0
    assert got == capsys.readouterr().out
    doc = json.loads(got)
    assert [p["flags"] for p in doc["packets"]] == ["K", "_", "_", "K", "_"]


VF = {
    "encode-crop-hflip-444": (["-i", "y4m", "-vf", "crop=24:12:4:2,hflip",
                               "-pix_fmt", "yuv444p", *ENC, "-coder", "2"],
                              "avi"),
    "decode-scale-422": (["-i", "avi", "-vf", "scale=16:8", "-pix_fmt",
                          "yuv422p", "-f", "rawvideo"], "yuv"),
}


@pytest.mark.parametrize("case", sorted(VF))
def test_vf_and_pix_fmt_match(media, tmp_path, capsys, case):
    """-vf chains and -pix_fmt conversions, on encode and on decode."""
    _d, paths, _frames = media
    args, ext = VF[case]
    args = [paths.get(a, a) if i and args[i - 1] == "-i" else a
            for i, a in enumerate(args)]
    _both(tmp_path, capsys, args, ext)


def test_version4_runs_one_frame_in_flight(media, tmp_path, capsys,
                                           monkeypatch):
    """The encoder owns its limit on frames in flight: one at version 4
    with the range coder (its PCM retry refuses a frame in flight), none
    at version 3 or in Golomb-Rice; the CLI runs that depth, and its
    version-4 file equals -engine native's."""
    from tpu_ffv1_torch import EncoderParams, TorchFFV1Encoder
    for level, coder, want in ((4, 2, 1), (4, 0, None), (3, 2, None)):
        enc = TorchFFV1Encoder(EncoderParams(
            width=W, height=H, pix_fmt="yuv420p", level=level, coder=coder,
            slices=4, strict=-2), device="cpu")
        assert enc.max_in_flight == want, (level, coder)
    depths = []
    pipelined = port_cli._pipelined

    def spy(submit, collect, items, depth):
        depths.append(depth)
        return pipelined(submit, collect, items, depth)
    monkeypatch.setattr(port_cli, "_pipelined", spy)
    _d, paths, _frames = media
    v4 = [a if a != "3" else "4" for a in ENC]
    _both(tmp_path, capsys, ["-i", paths["y4m"], *v4, "-coder", "2",
                             "-strict", "-2", "-frames:v", "3"], "avi")
    assert depths == [1]


def test_pass2_writes_the_host_file(media, tmp_path, capsys):
    """-pass 2 reads <passlogfile>-0.log, here the JAX CLI's pass 1, and
    writes the same avi as python -m tpu_ffv1 -pass 2 -engine native."""
    _d, paths, _frames = media
    log = str(tmp_path / "stats")
    assert jax_run(["-i", paths["y4m"], *ENC, "-coder", "2", "-pass", "1",
                    "-passlogfile", log, "-engine", "native",
                    str(tmp_path / "p1.avi")]) == 0
    _both(tmp_path, capsys, ["-i", paths["y4m"], *ENC, "-coder", "2",
                             "-pass", "2", "-passlogfile", log], "avi")


@pytest.mark.parametrize("coder", ["2", "0"])
def test_two_pass_writes_the_host_files(media, tmp_path, capsys, coder):
    """-pass 1 counts its statistics (the range coder's on the device's
    stats scans; Golomb-Rice none) and writes the same <passlogfile>-0.log
    and avi as python -m tpu_ffv1 -pass 1 -engine native (whose pass 1
    counts on the spec engine); -pass 2 from the port's log then writes
    the JAX CLI's pass-2 avi."""
    _d, paths, _frames = media
    logs = {k: str(tmp_path / f"stats_{k}") for k in ("t", "j")}
    args = ["-i", paths["y4m"], *ENC, "-coder", coder, "-pass", "1"]
    assert port_cli.run([*args, "-passlogfile", logs["t"], "-device", "cpu",
                         str(tmp_path / "t1.avi")]) == 0
    assert jax_run([*args, "-passlogfile", logs["j"], "-engine", "native",
                    str(tmp_path / "j1.avi")]) == 0
    texts = {}
    for k, log in logs.items():
        with open(f"{log}-0.log") as f:
            texts[k] = f.read()
    assert texts["t"] == texts["j"]
    assert filecmp.cmp(tmp_path / "t1.avi", tmp_path / "j1.avi",
                       shallow=False)
    _both(tmp_path, capsys, ["-i", paths["y4m"], *ENC, "-coder", coder,
                             "-pass", "2", "-passlogfile", logs["t"]],
          "avi")


def test_pass2_without_stats_exits(media, tmp_path):
    """A missing log ends the run with the JAX CLI's message."""
    _d, paths, _frames = media
    log = str(tmp_path / "none")
    args = ["-i", paths["y4m"], *ENC, "-pass", "2", "-passlogfile", log]
    with pytest.raises(SystemExit) as e:
        port_cli.run([*args, "-device", "cpu", str(tmp_path / "t.avi")])
    with pytest.raises(SystemExit) as j:
        jax_run([*args, "-engine", "native", str(tmp_path / "j.avi")])
    assert str(e.value.code) == str(j.value.code) == \
        f"error: pass-2 needs stats at {log}-0.log (run -pass 1 first)"
    assert not os.path.exists(tmp_path / "t.avi")


def test_in_band_headers_are_refused(media, tmp_path):
    """A version-1 stream (no extradata) is refused, as by -engine tpu."""
    _d, paths, _frames = media
    v1 = str(tmp_path / "v1.avi")
    assert jax_run(["-i", paths["y4m"], "-c:v", "ffv1", "-level", "1",
                    "-engine", "native", v1]) == 0
    with pytest.raises(SystemExit) as e:
        port_cli.run(["-i", v1, "-device", "cpu", str(tmp_path / "o.yuv")])
    assert "needs out-of-band headers (version >= 2)" in str(e.value.code)


def test_default_device_without_gpu_fails(media, tmp_path):
    """python -m tpu_ffv1_torch without -device: cuda, which fails with
    resolve_device's message where CUDA is unavailable, and writes
    nothing."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here; nothing to refuse")
    _d, paths, _frames = media
    out = str(tmp_path / "t.avi")
    res = subprocess.run(
        [sys.executable, "-m", "tpu_ffv1_torch", "-i", paths["y4m"], *ENC,
         out], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "error: device 'cuda' requested but torch.cuda.is_available() " \
        "is False" in res.stderr
    assert not os.path.exists(out)
