"""The port's streaming server (tpu_ffv1_torch/cli/serve.py and
cli/ffserver_conf.py) at ``device="cpu"`` against the JAX package's
(tpu_ffv1/cli/serve.py, whose codec is the host engine): the same
configuration and the same POST give the same bytes on every endpoint
(``/live.nut``, ``/live.y4m``, a file stream's ``/<name>.y4m``); two
concurrent clients get the same packets; a cuda server without a GPU
exits before it binds; and the kernel build's lock (kernels/build.py
``load``) builds a library once when threads ask for it at the same
moment.  Every HTTP call and thread join has its own timeout."""
from . import torch_cpu  # noqa: F401  (one PyTorch thread; no inference mode)
import contextlib
import dataclasses
import http.client
import io
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from tpu_ffv1.cli import ffserver_conf as jconf
from tpu_ffv1.cli import serve as jserve
from tpu_ffv1.codec.encoder import FFV1Encoder
from tpu_ffv1.codec.params import EncoderParams
from tpu_ffv1.io.avi import AviStream, write_avi
from tpu_ffv1.io.nut import read_nut
from tpu_ffv1.io.y4m import read_y4m, write_y4m_stream
from tpu_ffv1_torch.cli import ffserver_conf as tconf
from tpu_ffv1_torch.cli import serve as tserve
from tpu_ffv1_torch.kernels import build

W, H = 64, 32
TIMEOUT = 30


def _frames(pix, n, seed=0):
    """Smooth seeded frames (a ramp with a little noise) of ``pix``."""
    r = np.random.RandomState(seed)
    deep = pix.endswith("10le")
    mx = 1023 if deep else 255
    dt = np.uint16 if deep else np.uint8
    ch = H // 2 if pix.startswith("yuv420") else H
    out = []
    for t in range(n):
        y = np.add.outer(np.arange(H) * 3, np.arange(W) * 2) + 7 * t + \
            r.randint(0, 4, (H, W))
        u = np.add.outer(np.arange(ch), np.arange(W // 2)) + 50 + t
        v = np.full((ch, W // 2), mx // 2 + t) + r.randint(0, 3,
                                                           (ch, W // 2))
        out.append([(p % (mx + 1)).astype(dt) for p in (y, u, v)])
    return out


def _y4m(frames, pix):
    buf = io.BytesIO()
    write_y4m_stream(buf, frames, pix, W, H, (25, 1))
    return buf.getvalue()


def _avi(path, frames, pix, **kw):
    """``frames`` through the host encoder at GOP 3 into an avi."""
    enc = FFV1Encoder(EncoderParams(width=W, height=H, pix_fmt=pix,
                                    gop_size=3, **kw))
    pkts = [enc.encode_frame(f) for f in frames]
    write_avi(path, AviStream(width=W, height=H, extradata=enc.extradata,
                              packets=[p for p, _ in pkts],
                              keyflags=[k for _, k in pkts]))
    return pkts


@contextlib.contextmanager
def _serving(make_server, text, **kw):
    srv = make_server(config=(jconf if make_server is jserve.make_server
                              else tconf).parse_config(text), port=0, **kw)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        yield srv
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(TIMEOUT)
        assert not th.is_alive()


def _post(port, feed, payload):
    """POST a y4m stream over a raw socket -> the whole response."""
    sk = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
    try:
        sk.sendall(f"POST /{feed} HTTP/1.1\r\nHost: t\r\n"
                   f"Content-Length: {len(payload)}\r\n\r\n".encode())
        sk.sendall(payload)
        resp = b""
        while True:
            b = sk.recv(65536)
            if not b:
                return resp
            resp += b
    finally:
        sk.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _status(resp):
    return int(resp.split(b" ", 2)[1])


def _conf(pix, coder, clip):
    return f"""
MaxClients 8
<Feed cam.ffm>
FileMaxSize 4M
ACL allow 127.0.0.1
</Feed>
<Stream live.nut>
Feed cam.ffm
AVOptionVideo slices 4
AVOptionVideo coder {coder}
VideoGopSize 3
</Stream>
<Stream all.nut>
Feed cam.ffm
Preroll 10
</Stream>
<Stream live.y4m>
Feed cam.ffm
Preroll 10
</Stream>
<Stream clip.avi>
File {clip}
</Stream>
"""


# ---------------------------------------------------------------------
# (a) the configuration parser against the JAX package's
# ---------------------------------------------------------------------

GOOD = """
# comment
HTTPPort 9090
MaxClients 7
MaxBandwidth 2000
CustomLog /tmp/srv.log

<Feed feed1.ffm>
FileMaxSize 2M
ACL allow 127.0.0.1
ACL deny 10.
</Feed>

<Stream live.nut>
Feed feed1.ffm
VideoCodec ffv1
AVOptionVideo slices 4
AVOptionVideo coder 2
AVOptionVideo context 1
VideoGopSize 6
VideoSize 640x480
PixelFormat yuv420p
StartSendOnKey
Preroll 2
MaxTime 3.5
NoAudio
Author me
Metadata title The Title
</Stream>

<Stream live.y4m>
Feed feed1.ffm
</Stream>

<Stream clip.avi>
File /tmp/clip.avi
Format avi
</Stream>

<Redirect index.html>
URL http://example.com/
</Redirect>
"""

CONFIGS = {
    "good": GOOD,
    "defaults": "<Feed f>\n</Feed>\n<Stream s.nut>\nFeed f\n</Stream>\n",
    "empty": "",
    "errors": ("Bogus 1\n<Stream x.nut>\nFeed nosuch\nNoVideo\n</Stream>\n"
               "<Feed a>\n</Feed>\n<Feed a>\n</Feed>\nMaxBandwidth 5\n"),
    "unclosed": "<Feed f>\n",
    "codec": ("<Stream s.nut>\nFile /tmp/x\nVideoCodec h264\n"
              "</Stream>"),
    "neither": "<Stream s.nut>\n</Stream>",
    "options": ("<Feed f>\nFileMaxSize 1.5k\nLaunch ffmpeg\nACL maybe x\n"
                "Bogus\n</Feed>\n<Stream s.mp4>\nFeed f\nFormat webm\n"
                "AVOptionVideo bogus 1\nAVOptionVideo slices\n"
                "Port 80\n</Stream>\n<Redirect r>\n</Redirect>\n"
                "<Redirect q>\nURL u\nFeed f\n</Redirect>\n"
                "Port 70000\nMaxClients x\n</Feed>\n"),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_parse_config_matches_jax(name):
    """The parsed dataclasses, or the ValueError's message, equal the JAX
    package's on the same text."""
    text = CONFIGS[name]
    try:
        want = dataclasses.asdict(jconf.parse_config(text))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tconf.parse_config(text)
        assert str(got.value) == str(e)
        return
    assert dataclasses.asdict(tconf.parse_config(text)) == want
    assert tconf._FFV1_AVOPTIONS == jconf._FFV1_AVOPTIONS


# ---------------------------------------------------------------------
# (b) the port's server against the JAX package's, byte for byte
# ---------------------------------------------------------------------

@pytest.mark.parametrize("coder", [2, 0])
@pytest.mark.parametrize("pix", ["yuv420p", "yuv422p10le"])
def test_server_bodies_match_jax(pix, coder, tmp_path):
    """One POST of 4 frames at GOP 3, then /live.nut (the newest
    keyframe on), /all.nut and /live.y4m (Preroll: every frame) and the
    file stream /clip.y4m (2 frames of the host encoder): every body of
    the port's server at device="cpu" equals the JAX server's, and the
    y4m bodies equal the source."""
    frames = _frames(pix, 4, seed=coder)
    payload = _y4m(frames, pix)
    clip = str(tmp_path / "clip.avi")
    _avi(clip, _frames(pix, 2, seed=9), pix, level=3, coder=coder,
         slices=4)
    text = _conf(pix, coder, clip)
    bodies = {}
    for label, make, kw in (("jax", jserve.make_server, {}),
                            ("port", tserve.make_server,
                             dict(device="cpu"))):
        with _serving(make, text, **kw) as srv:
            port = srv.server_address[1]
            resp = _post(port, "cam.ffm", payload)
            assert _status(resp) == 200, (label, resp)
            got = {"post": resp.split(b"\r\n\r\n", 1)[1]}
            for path in ("/live.nut", "/all.nut", "/live.y4m",
                         "/clip.y4m"):
                status, body = _get(port, path)
                assert status == 200, (label, path)
                got[path] = body
        bodies[label] = got
    assert bodies["port"]["post"] == b"ingested 4 frame(s)\n"
    for key, want in bodies["jax"].items():
        assert bodies["port"][key] == want, key
    for path, src in (("/live.y4m", frames),
                      ("/clip.y4m", _frames(pix, 2, seed=9))):
        y4m = tmp_path / "got.y4m"
        y4m.write_bytes(bodies["port"][path])
        out, fmt, w, h, _fps = read_y4m(str(y4m))
        assert (fmt, w, h, len(out)) == (pix, W, H, len(src))
        assert all(np.array_equal(a, b) for fa, fb in zip(out, src)
                   for a, b in zip(fa, fb)), path


def test_refused_stream_answers_400(tmp_path):
    """A stream the host engine codes and the port's encoder refuses
    (version 1: AVOptionVideo level 1, one slice) answers 400 with the
    class's message; the JAX server ingests it."""
    text = ("<Feed cam.ffm>\n</Feed>\n<Stream live.nut>\nFeed cam.ffm\n"
            "AVOptionVideo level 1\nAVOptionVideo slices 1\n</Stream>\n")
    payload = _y4m(_frames("yuv420p", 1), "yuv420p")
    with _serving(jserve.make_server, text) as srv:
        assert _status(_post(srv.server_address[1], "cam.ffm",
                             payload)) == 200
    with _serving(tserve.make_server, text, device="cpu") as srv:
        resp = _post(srv.server_address[1], "cam.ffm", payload)
        feed = srv.RequestHandlerClass.live_feeds["cam.ffm"]
        assert not feed.publishing and not feed.ring
    assert _status(resp) == 400
    assert b"cannot ingest stream: only versions 3 and 4 are ported" in resp


def test_in_band_file_stream_answers_501(tmp_path):
    """A file stream whose headers are in band (version 1, no extradata),
    which the JAX server decodes: the port's answers 501 with the command
    line's refusal before any status line."""
    clip = str(tmp_path / "v1.avi")
    enc = FFV1Encoder(EncoderParams(width=W, height=H, pix_fmt="yuv420p",
                                    level=1, coder=0, gop_size=1))
    pkt, key = enc.encode_frame(_frames("yuv420p", 1)[0])
    write_avi(clip, AviStream(width=W, height=H, extradata=b"",
                              packets=[pkt], keyflags=[key]))
    text = f"<Stream v1.avi>\nFile {clip}\n</Stream>\n"
    with _serving(jserve.make_server, text) as srv:
        assert _get(srv.server_address[1], "/v1.y4m")[0] == 200
    with _serving(tserve.make_server, text, device="cpu") as srv:
        status, body = _get(srv.server_address[1], "/v1.y4m")
    assert status == 501
    assert b"needs out-of-band headers" in body


# ---------------------------------------------------------------------
# (c) concurrent clients
# ---------------------------------------------------------------------

def test_two_concurrent_nut_clients_get_the_same_packets():
    """Two /live.nut clients join while the port's server ingests (GOP
    12: one keyframe, so both start at frame 0); their bodies are equal
    and their packets are the host encoder's."""
    frames = _frames("yuv420p", 4, seed=5)
    text = _conf("yuv420p", 2, "/nonexistent.avi").replace(
        "VideoGopSize 3", "VideoGopSize 12")
    got, joined = {}, {}
    with _serving(tserve.make_server, text, device="cpu") as srv:
        port = srv.server_address[1]
        feed = srv.RequestHandlerClass.live_feeds["cam.ffm"]
        pub = threading.Thread(target=lambda: got.update(
            post=_post(port, "cam.ffm", _y4m(frames, "yuv420p"))))
        pub.start()
        t_end = time.time() + TIMEOUT
        while not feed.ring and time.time() < t_end:
            time.sleep(0.01)
        assert feed.ring, "no packet landed"

        def client(name):
            joined[name] = feed.publishing
            got[name] = _get(port, "/live.nut")

        clients = [threading.Thread(target=client, args=(n,))
                   for n in ("a", "b")]
        for t in clients:
            t.start()
        for t in [pub] + clients:
            t.join(TIMEOUT)
            assert not t.is_alive()
    assert _status(got["post"]) == 200
    assert any(joined.values()), "no client joined during the ingest"
    assert got["a"][0] == got["b"][0] == 200
    assert got["a"][1] == got["b"][1]
    enc = FFV1Encoder(EncoderParams(width=W, height=H, pix_fmt="yuv420p",
                                    level=3, coder=2, slices=4,
                                    gop_size=12, slicecrc=1))
    want = [enc.encode_frame(f) for f in frames]
    with tempfile.NamedTemporaryFile(suffix=".nut") as f:
        f.write(got["a"][1])
        f.flush()
        st = read_nut(f.name)
    assert st.packets == [p for p, _ in want]
    assert list(map(bool, st.keyflags)) == [k for _, k in want]
    assert st.extradata == enc.extradata


# ---------------------------------------------------------------------
# (e) -device cuda without a GPU
# ---------------------------------------------------------------------

@pytest.mark.parametrize("how", ["serve", "make_server"])
def test_cuda_server_without_cuda_never_binds(how, monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here; nothing to refuse")

    def bind(*a, **kw):
        raise AssertionError("the server bound a socket")

    monkeypatch.setattr(tserve, "ThreadingHTTPServer", bind)
    clip = str(tmp_path / "clip.avi")
    _avi(clip, _frames("yuv420p", 1), "yuv420p", level=3, coder=2)
    if how == "serve":
        with pytest.raises(SystemExit) as e:
            tserve.serve(["-device", "cuda", "-port", "0", clip])
        msg = str(e.value.code)
        assert msg.startswith("error: device 'cuda' requested")
    else:
        with pytest.raises(RuntimeError) as e:
            tserve.make_server([clip], port=0)     # the default: cuda
        msg = str(e.value)
    assert "torch.cuda.is_available() is False" in msg


# ---------------------------------------------------------------------
# (f) the kernel build's lock
# ---------------------------------------------------------------------

def test_concurrent_load_builds_once(tmp_path, monkeypatch):
    """8 threads call ``load`` at once with a fake nvcc on PATH (it counts
    its runs and, after a sleep, copies a tiny shared library built with
    the system C compiler to its -o path): one build, one CDLL."""
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no system C compiler to build the stand-in library")
    lib = tmp_path / "stub.so"
    (tmp_path / "stub.c").write_text("int stub(void) { return 7; }\n")
    subprocess.run([cc, "-shared", "-fPIC", "-o", str(lib),
                    str(tmp_path / "stub.c")], check=True, timeout=TIMEOUT)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    runs = tmp_path / "runs"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo run >> '{runs}'\n"
        "sleep 0.3\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then out=\"$2\"; fi\n"
        "  shift\n"
        "done\n"
        f"cp '{lib}' \"$out\"\n")
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// stand-in source\n")
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}"
                       f"{os.environ.get('PATH', '')}")
    monkeypatch.setattr(build, "CSRC", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_LIBS", {})
    barrier = threading.Barrier(8)
    libs, errors = [], []

    def worker():
        try:
            barrier.wait(TIMEOUT)
            libs.append(build.load("fake"))
        except Exception as e:       # reported below, with the others
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()
    assert errors == []
    assert runs.read_text().split() == ["run"]
    assert len(libs) == 8 and all(x is libs[0] for x in libs)
    assert libs[0].stub() == 7
    assert os.listdir(tmp_path / "_build") == ["libfake.so"]


def test_count_launch_loses_no_update():
    """The wrappers' launch counts under threads that launch at once (the
    server's requests): 16 threads x 2,000 counts with a short switch
    interval, every one kept."""
    counts = {}
    barrier = threading.Barrier(16)

    def worker():
        barrier.wait(TIMEOUT)
        for _ in range(2000):
            build.count_launch(counts, "k")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert counts == {"k": 16 * 2000}
