"""HTTP streaming server — the ffserver analog (reference: ffserver.c) on
the port: the counterpart of ``tpu_ffv1/cli/serve.py`` whose codec runs
through ``TorchFFV1Encoder`` / ``TorchFFV1Decoder`` on the device the
caller names (``-device {cuda,cpu}``, ``make_server(device=...)``,
default cuda).  The device is resolved before the server binds: without
a GPU a cuda server exits with ``resolve_device``'s message and never
listens; nothing falls back to the CPU.  A publisher's frames go through
the encoder two in flight (the card codes frame t while the handler
reads frame t + 1 off the socket); each y4m client thread owns a
decoder.  The packets are the host encoder's, byte for byte.  Each
request runs on its own thread, which submits to and collects from its
own encoder or decoder only.

Two kinds of endpoints, like the reference's File streams and Feed
streams:

* **File streams** — media files registered at startup (CLI positional
  args, or ``<Stream>`` sections with ``File``):

    GET /                 status page (compute_status analog,
                          ffserver.c:1916)
    GET /<name>.y4m       the file live-decoded to a YUV4MPEG2 stream
    GET /<name>.<ext>     the original container bytes

* **Live feeds** — declared in an ffserver-style config file
  (``-f server.conf``, parsed by ffserver_conf.py).  A publisher POSTs
  a YUV4MPEG2 stream to the feed (the ffserver feeder loop,
  ffserver.c:2683 http_receive_data); the server encodes it to FFV1
  once and fans the packets out to any number of pull clients through
  a bounded in-memory ring (the .ffm ring-file analog —
  ffserver.c:2764 wraps feed_write_index at feed_max_size; here whole
  GOPs are evicted so every reachable cursor still starts on a
  keyframe):

    POST /<feed>          ingest (one publisher at a time, ACL-checked)
    GET /<stream>.nut     FFV1-in-NUT, streamable per frame
    GET /<stream>.y4m     decoded back to YUV4MPEG2

  Clients join at the newest buffered keyframe (StartSendOnKey,
  ffserver.c:2389 send_on_key — always on for FFV1, which can only
  enter a stream at a keyframe; ``Preroll`` rewinds further back in the
  ring).  A client that falls off the ring resynchronizes at the oldest
  buffered keyframe, like a reader lapped by the ring file.  MaxClients
  and MaxBandwidth reject new media clients with 503, mirroring
  ffserver.c:1564-1579.

Usage:
  python -m tpu_ffv1_torch.cli.serve -port 8090 clip.avi other.nut
  python -m tpu_ffv1_torch.cli.serve -f server.conf -device cuda
"""
from __future__ import annotations

import argparse
import html
import os
import sys
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .ffserver_conf import ServerConfig, StreamConfig, load_config

_CTYPES = {".avi": "video/x-msvideo", ".nut": "video/x-nut",
           ".mkv": "video/x-matroska", ".y4m": "video/x-yuv4mpeg",
           ".webm": "video/webm"}


class _Feed:
    """A media FILE registered as a feed (direct + y4m serving)."""

    def __init__(self, path, name=None, device="cuda"):
        self.path = path
        self.name = name or os.path.splitext(os.path.basename(path))[0]
        self.ext = os.path.splitext(path)[1].lower()
        self.device = device
        self._decoded = None

    def decoded(self):
        """(frames, pix_fmt, w, h, fps) — lazily decoded on the device,
        cached."""
        if self._decoded is None:
            from .play import _decode_from
            frames, fmt, w, h, fps, _ = _decode_from(self.path, 0,
                                                     self.device)
            self._decoded = (frames, fmt, w, h, fps)
        return self._decoded

    def info(self):
        from .main import _is_y4m, _read_container
        if _is_y4m(self.path):
            from ..io.y4m import read_y4m
            frames, fmt, w, h, fps = read_y4m(self.path)
            return dict(kind="yuv4mpegpipe", w=w, h=h, fps=fps,
                        n=len(frames), codec=fmt)
        st, kind = _read_container(self.path)
        return dict(kind=kind, w=st.width, h=st.height, fps=st.fps,
                    n=len(st.packets), codec="ffv1")


class FeedBusyError(RuntimeError):
    """A second publisher POSTed to a feed that has one (answered 409)."""


class LiveFeed:
    """Bounded in-memory FFV1 packet ring fed by one publisher, read by
    many clients — the .ffm ring-file analog (ffserver.c:2764)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.name = cfg.name
        self.cond = threading.Condition()
        self.ring = deque()        # (seq, pkt: bytes, keyflag: bool)
        self.nbytes = 0
        self.next_seq = 0
        self.generation = 0        # bumps per publisher session
        self.publishing = False
        self.width = self.height = 0
        self.pix_fmt = None
        self.fps = (25, 1)
        self.extradata = b""
        self.frames_in = 0

    # ---- ACL (ffserver_config.c ffserver_parse_acl_row: rules apply
    # in order, first match decides; no match -> allow unless the list
    # contains an allow rule, i.e. an allow-list denies by default) ----
    def acl_allows(self, addr: str) -> bool:
        has_allow = False
        for kind, prefix in self.cfg.acl:
            if addr == prefix or addr.startswith(prefix):
                return kind == "allow"
            has_allow |= kind == "allow"
        return not has_allow

    # ---- publisher side ------------------------------------------------
    def begin(self, width, height, pix_fmt, fps, extradata):
        with self.cond:
            if self.publishing:
                raise FeedBusyError("feed already has a publisher")
            self.ring.clear()
            self.nbytes = 0
            self.width, self.height = width, height
            self.pix_fmt, self.fps = pix_fmt, fps
            self.extradata = extradata
            self.generation += 1
            self.publishing = True
            self.frames_in = 0
            self.cond.notify_all()

    def push(self, pkt: bytes, key: bool):
        with self.cond:
            self.ring.append((self.next_seq, pkt, key))
            self.next_seq += 1
            self.nbytes += len(pkt)
            self.frames_in += 1
            # evict whole GOPs from the tail so the oldest reachable
            # entry is always a keyframe (a reader lapped by the ring
            # must be able to restart the decode chain)
            while self.nbytes > self.cfg.max_size:
                nk = next((i for i, e in enumerate(self.ring)
                           if i > 0 and e[2]), None)
                if nk is None:
                    break    # never evict the only (current) GOP
                for _ in range(nk):
                    _, p, _k = self.ring.popleft()
                    self.nbytes -= len(p)
            self.cond.notify_all()

    def end(self):
        with self.cond:
            self.publishing = False
            self.cond.notify_all()

    # ---- client side -----------------------------------------------
    def start_cursor(self, preroll_s: float = 0.0) -> int:
        """Newest buffered keyframe, or Preroll seconds earlier
        (still snapped to a keyframe)."""
        back = int(preroll_s * self.fps[0] / max(self.fps[1], 1))
        keys = [s for s, _p, k in self.ring if k]
        if not keys:
            return self.next_seq    # wait for the first GOP
        target = max(self.ring[-1][0] - back, self.ring[0][0])
        at_or_before = [s for s in keys if s <= target]
        return at_or_before[-1] if at_or_before else keys[0]

    def read_from(self, cursor: int, generation: int, timeout=30.0):
        """Block for entries at/after ``cursor`` -> (entries, cursor,
        resynced).  Empty entries + same cursor means the publisher is
        gone (end of stream) or the wait timed out."""
        with self.cond:
            t_end = time.time() + timeout
            while True:
                if self.generation != generation:
                    return [], cursor, False   # new publisher session
                if self.ring and self.ring[-1][0] >= cursor:
                    break
                if not self.publishing:
                    return [], cursor, False
                left = t_end - time.time()
                if left <= 0:
                    return [], cursor, False
                self.cond.wait(left)
            resync = False
            if self.ring[0][0] > cursor:
                # lapped: restart at the oldest buffered keyframe
                cursor = next(s for s, _p, k in self.ring if k)
                resync = True
            out = [e for e in self.ring if e[0] >= cursor]
            return out, out[-1][0] + 1, resync


class _LiveStream:
    """A <Stream> bound to a live feed: the wire format + limits.
    Streams are addressed by their FULL name — ``live.nut`` and
    ``live.y4m`` are two distinct streams of one feed, exactly as in
    the reference config."""

    def __init__(self, cfg: StreamConfig, feed: LiveFeed):
        self.cfg = cfg
        self.feed = feed
        self.name = cfg.name
        _stem, _, ext = cfg.name.rpartition(".")
        self.fmt = cfg.fmt or ext
        self.clients = 0


class _Bandwidth:
    """Sliding 1-second outbound byte meter (current_bandwidth analog,
    ffserver.c:259; used to 503 new clients past MaxBandwidth)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.window = deque()    # (t, nbytes)
        self.total = 0

    def add(self, n):
        now = time.time()
        with self.lock:
            self.window.append((now, n))
            self.total += n
            while self.window and self.window[0][0] < now - 1.0:
                _, old = self.window.popleft()
                self.total -= old

    def kbit_s(self):
        now = time.time()
        with self.lock:
            while self.window and self.window[0][0] < now - 1.0:
                _, old = self.window.popleft()
                self.total -= old
            return self.total * 8 / 1000


def _feed_params(stream_cfgs, width, height, pix_fmt):
    """EncoderParams for a feed from its streams' AVOptionVideo /
    VideoGopSize settings (first stream wins, like the reference's
    feeder picking the stream's codec settings)."""
    from ..codec.params import EncoderParams
    kw = dict(level=3, coder=2, slices=4, gop_size=12, slicecrc=1)
    for s in stream_cfgs:
        kw.update(s.options)
        if s.gop_size:
            kw["gop_size"] = s.gop_size
        break
    return EncoderParams(width=width, height=height, pix_fmt=pix_fmt,
                         **kw)


class FFV1ServerHandler(BaseHTTPRequestHandler):
    feeds: dict = {}          # file feeds: stem -> _Feed
    live_feeds: dict = {}     # feed name -> LiveFeed
    live_streams: dict = {}   # stem -> _LiveStream
    redirects: dict = {}      # name -> url
    config: ServerConfig = ServerConfig()
    bandwidth = None          # _Bandwidth (set by make_server)
    media_clients = [0]       # boxed counter shared across handler threads
    clients_lock = threading.Lock()
    quiet = True
    device = "cuda"           # where the codec runs (set by make_server)

    def log_message(self, fmt, *a):       # ffserver logs to its own file
        if self.quiet:
            return
        if self.config.custom_log:
            with open(self.config.custom_log, "a") as f:
                f.write("%s - - [%s] %s\n" % (
                    self.client_address[0], self.log_date_time_string(),
                    fmt % a))
        else:
            super().log_message(fmt, *a)

    # ---- status page (compute_status, ffserver.c:1916) -------------
    def _status_page(self):
        rows = []
        for f in self.feeds.values():
            try:
                i = f.info()
                name = html.escape(f.name, quote=True)
                ext = html.escape(f.ext, quote=True)
                rows.append(
                    f"<tr><td><a href='/{name}.y4m'>{name}.y4m</a> "
                    f"<a href='/{name}{ext}'>[{ext[1:]}]</a></td>"
                    f"<td>file</td>"
                    f"<td>{html.escape(str(i['codec']))}</td>"
                    f"<td>{i['w']}x{i['h']}</td>"
                    f"<td>{i['fps'][0]}/{i['fps'][1]}</td>"
                    f"<td>{i['n']}</td><td></td></tr>")
            except Exception as e:   # still list broken feeds
                rows.append(f"<tr><td>{html.escape(f.name)}</td>"
                            f"<td colspan=6>error: {html.escape(str(e))}"
                            "</td></tr>")
        for s in self.live_streams.values():
            fd = s.feed
            name = html.escape(s.name, quote=True)
            state = ("receiving" if fd.publishing else
                     "idle" if not fd.ring else "buffered")
            rows.append(
                f"<tr><td><a href='/{name}'>{name}</a>"
                f"</td><td>feed {html.escape(fd.name)} ({state})</td>"
                f"<td>ffv1</td><td>{fd.width}x{fd.height}</td>"
                f"<td>{fd.fps[0]}/{fd.fps[1]}</td>"
                f"<td>{len(fd.ring)} buffered / {fd.frames_in} in</td>"
                f"<td>{s.clients} client(s)</td></tr>")
        kbps = self.bandwidth.kbit_s() if self.bandwidth else 0
        body = ("<html><head><title>tpu_ffv1 server status</title></head>"
                "<body><h1>tpu_ffv1 streaming server</h1>"
                f"<p>connections: {self.media_clients[0]} / "
                f"{self.config.max_clients} &mdash; bandwidth: "
                f"{kbps:.0f} / {self.config.max_bandwidth} kbit/s</p>"
                "<table border=1><tr><th>stream</th><th>source</th>"
                "<th>codec</th><th>size</th><th>fps</th>"
                "<th>frames</th><th>clients</th></tr>"
                + "".join(rows) + "</table></body></html>").encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # ---- limits ------------------------------------------------------
    def _admit_media_client(self):
        """MaxClients / MaxBandwidth gate (ffserver.c:1557-1579)."""
        with self.clients_lock:
            if self.media_clients[0] + 1 > self.config.max_clients:
                self.send_error(503, "too many clients")
                return False
            if self.bandwidth is not None and \
                    self.bandwidth.kbit_s() > self.config.max_bandwidth:
                self.send_error(503, "bandwidth limit reached")
                return False
            self.media_clients[0] += 1
            return True

    def _release_media_client(self):
        with self.clients_lock:
            self.media_clients[0] -= 1

    def _send(self, data: bytes):
        self.wfile.write(data)
        if self.bandwidth is not None:
            self.bandwidth.add(len(data))

    # ---- live GET ----------------------------------------------------
    def _serve_live(self, s: _LiveStream):
        feed = s.feed
        with feed.cond:
            generation = feed.generation
            if not feed.ring and not feed.publishing:
                self.send_error(404, f"feed {feed.name} has no data "
                                     "(no publisher yet)")
                return
            cursor = feed.start_cursor(s.cfg.preroll)
        if not self._admit_media_client():
            return
        with self.clients_lock:
            s.clients += 1
        try:
            self.send_response(200)
            self.send_header("Content-Type", _CTYPES.get(
                "." + s.fmt, "application/octet-stream"))
            self.end_headers()
            if s.fmt == "nut":
                self._stream_nut(s, feed, cursor, generation)
            else:
                self._stream_y4m(s, feed, cursor, generation)
        except (BrokenPipeError, ConnectionResetError):
            pass   # client hung up mid-stream; ffserver ignores too
        finally:
            with self.clients_lock:
                s.clients -= 1
            self._release_media_client()

    def _frame_budget(self, s, feed):
        if s.cfg.max_time <= 0:
            return None
        return max(1, int(s.cfg.max_time * feed.fps[0] /
                          max(feed.fps[1], 1)))

    def _stream_nut(self, s, feed, cursor, generation):
        from ..io.nut import NutStream, nut_frame_bytes, nut_header_bytes
        self._send(nut_header_bytes(NutStream(
            width=feed.width, height=feed.height, fps=feed.fps,
            extradata=feed.extradata)))
        budget = self._frame_budget(s, feed)
        i = 0
        while True:
            entries, cursor, _resync = feed.read_from(cursor, generation)
            if not entries:
                return
            for _seq, pkt, key in entries:
                # NUT ptses restart per client; the per-frame syncpoint
                # makes the resync join seamless for the demuxer
                self._send(nut_frame_bytes(i, pkt, key))
                i += 1
                if budget is not None and i >= budget:
                    return

    def _stream_y4m(self, s, feed, cursor, generation):
        """This thread's own decoder on the device, one frame at a time
        (a new one on a resync)."""
        import io as _io
        from ..tpu.decoder import TorchFFV1Decoder
        from ..io.y4m import _WRITE_TAGS, write_y4m_stream
        from ..codec.pixfmt import get_pix_fmt
        pf = get_pix_fmt(feed.pix_fmt)
        if _WRITE_TAGS.get(pf.name) is None or pf.transparency:
            # header already sent; nothing better than closing
            return
        dec = TorchFFV1Decoder(feed.width, feed.height, feed.extradata,
                               device=self.device)
        first = True
        budget = self._frame_budget(s, feed)
        i = 0
        while True:
            entries, cursor, resync = feed.read_from(cursor, generation)
            if not entries:
                return
            if resync:
                # decode chain restarts at the keyframe we jumped to
                dec = TorchFFV1Decoder(feed.width, feed.height,
                                       feed.extradata, device=self.device)
            for _seq, pkt, _key in entries:
                planes, _ = dec.decode_frame(pkt)
                buf = _io.BytesIO()
                write_y4m_stream(buf, [planes], feed.pix_fmt,
                                 feed.width, feed.height, feed.fps)
                data = buf.getvalue()
                if not first:     # strip the repeated stream header
                    data = data[data.find(b"FRAME"):]
                first = False
                self._send(data)
                i += 1
                if budget is not None and i >= budget:
                    return

    # ---- live POST (http_receive_data, ffserver.c:2683) ----------------
    def do_POST(self):
        """Ingest: frames go into this thread's own encoder on the device,
        up to two in flight, and each packet into the ring in frame
        order.  An error of the device or a kernel ends the request (the
        server logs it); the feed is ended all the same."""
        path = self.path.split("?")[0].lstrip("/")
        feed = self.live_feeds.get(path)
        if feed is None:
            self.send_error(404, "no such feed")
            return
        if not feed.acl_allows(self.client_address[0]):
            self.send_error(403, "ACL denies this address")
            return
        try:
            from ..io.y4m import (read_y4m_stream_frame,
                                  read_y4m_stream_header)
            length = self.headers.get("Content-Length")
            src = _BoundedReader(self.rfile, int(length)) if length \
                else self.rfile
            hdr = read_y4m_stream_header(src)
            if hdr is None:
                self.send_error(400, "empty y4m stream")
                return
            pix_fmt, w, h, fps = hdr
            from ..tpu.encoder import TorchFFV1Encoder
            streams = [t.cfg for t in self.live_streams.values()
                       if t.feed is feed]
            enc = TorchFFV1Encoder(_feed_params(streams, w, h, pix_fmt),
                                   device=self.device)
            feed.begin(w, h, pix_fmt, fps, enc.extradata)
        except (ValueError, NotImplementedError) as e:
            self.send_error(400, f"cannot ingest stream: {e}")
            return
        except FeedBusyError as e:
            self.send_error(409, str(e))
            return
        depth = min(2, enc.max_in_flight or 2)
        n = in_flight = 0
        try:
            while True:
                try:
                    planes = read_y4m_stream_frame(src, pix_fmt, w, h)
                except ValueError:
                    break   # publisher died mid-frame: keep what we got
                if planes is None:
                    break
                enc.submit_frames([planes])
                in_flight += 1
                if in_flight == depth:
                    feed.push(*enc.collect_frames()[0])
                    in_flight -= 1
                    n += 1
            for _ in range(in_flight):
                feed.push(*enc.collect_frames()[0])
                n += 1
        finally:
            feed.end()
        body = f"ingested {n} frame(s)\n".encode()
        try:
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def do_GET(self):
        path = self.path.split("?")[0]
        if path in ("/", "/status", "/status.html"):
            return self._status_page()
        name = path.lstrip("/")
        if name in self.redirects:     # <Redirect> (ffserver.c:1669)
            self.send_response(302)
            self.send_header("Location", self.redirects[name])
            self.end_headers()
            return
        live = self.live_streams.get(name)
        if live is not None:
            return self._serve_live(live)
        stem, ext = os.path.splitext(name)
        feed = self.feeds.get(stem)
        if feed is None:
            self.send_error(404, "no such feed")
            return
        try:
            if ext == ".y4m" and feed.ext != ".y4m":
                # decode + validate representability BEFORE the status
                # line — a late failure would corrupt a 200 body with
                # an embedded 500
                frames, fmt, w, h, fps = feed.decoded()
                from ..codec.pixfmt import get_pix_fmt
                from ..io.y4m import _WRITE_TAGS, write_y4m_stream
                pf = get_pix_fmt(fmt)
                if _WRITE_TAGS.get(pf.name) is None or pf.transparency:
                    self.send_error(
                        415, f"pix_fmt {fmt} not representable in "
                             "yuv4mpegpipe")
                    return
                if not self._admit_media_client():
                    return
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", _CTYPES[".y4m"])
                    self.end_headers()
                    write_y4m_stream(self.wfile, frames, fmt, w, h, fps)
                finally:
                    self._release_media_client()
            elif ext == feed.ext or ext == "":
                with open(feed.path, "rb") as f:
                    data = f.read()
                if not self._admit_media_client():
                    return
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", _CTYPES.get(
                        feed.ext, "application/octet-stream"))
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self._send(data)
                finally:
                    self._release_media_client()
            else:
                self.send_error(404, f"feed {stem} has no {ext} form")
        except BrokenPipeError:
            pass   # client hung up mid-stream; ffserver ignores too
        except ValueError as e:
            self.send_error(500, str(e))
        except NotImplementedError as e:
            self.send_error(501, str(e))    # a stream the port refuses


class _BoundedReader:
    """Content-Length-bounded view of the request body."""

    def __init__(self, f, n):
        self.f, self.left = f, n

    def read(self, n):
        if self.left <= 0:
            return b""
        b = self.f.read(min(n, self.left))
        self.left -= len(b)
        return b


def make_server(files=(), bind=None, port=None, quiet=True, config=None,
                device="cuda"):
    """Build (not start) the server; port 0 picks a free port (tests).

    ``files`` become file streams; ``config`` (a ServerConfig) adds
    live feeds, config-declared file streams, and redirects.  Every
    codec step runs on ``device``, resolved here before the server
    binds (RuntimeError on cuda without a GPU)."""
    from ..device import resolve_device
    resolve_device(device)
    cfg = config or ServerConfig()
    feeds = {f.name: f for f in (_Feed(p, device=device) for p in files)}
    live_feeds = {}
    live_streams = {}
    redirects = {name: r.url for name, r in cfg.redirects.items()}
    for name, fc in cfg.feeds.items():
        live_feeds[name] = LiveFeed(fc)
    for name, sc in cfg.streams.items():
        if sc.file:
            stem = name.rpartition(".")[0] or name
            feeds[stem] = _Feed(sc.file, name=stem, device=device)
        elif sc.feed:
            ls = _LiveStream(sc, live_feeds[sc.feed])
            live_streams[ls.name] = ls
    handler = type("Handler", (FFV1ServerHandler,), {
        "feeds": feeds,
        "live_feeds": live_feeds,
        "live_streams": live_streams,
        "redirects": redirects,
        "config": cfg,
        "bandwidth": _Bandwidth(),
        "media_clients": [0],
        "clients_lock": threading.Lock(),
        "quiet": quiet,
        "device": device,
    })
    return ThreadingHTTPServer(
        (cfg.bind if bind is None else bind,
         cfg.port if port is None else port), handler)


def serve(argv=None):
    p = argparse.ArgumentParser(
        prog="tpu_ffv1_torch.serve",
        description="HTTP FFV1 streaming server on PyTorch and CUDA")
    p.add_argument("inputs", nargs="*")
    p.add_argument("-f", "--config", help="ffserver-style config file "
                   "(<Feed>/<Stream>/<Redirect> sections)")
    p.add_argument("-port", type=int, default=None)
    # loopback by default: publishing the listed files on every
    # interface should be an explicit opt-in (-bind 0.0.0.0)
    p.add_argument("-bind", default=None)
    p.add_argument("-v", action="store_true", help="log requests")
    p.add_argument("-device", default="cuda", choices=["cuda", "cpu"],
                   help="where the codec runs: cuda (the CUDA kernels; "
                        "fails without a GPU) or cpu (the kernels' plain "
                        "PyTorch versions)")
    args = p.parse_args(argv)
    cfg = None
    if args.config:
        try:
            cfg = load_config(args.config)
        except (OSError, ValueError) as e:
            sys.exit(f"error: {e}")
    elif not args.inputs:
        sys.exit("error: need input files or -f <config>")
    for f in args.inputs:
        if not os.path.exists(f):
            sys.exit(f"error: no such file: {f}")
    port = args.port if args.port is not None else \
        (None if cfg else 8090)
    bind = args.bind if args.bind is not None else \
        (None if cfg else "127.0.0.1")
    try:
        srv = make_server(args.inputs, bind, port, quiet=not args.v,
                          config=cfg, device=args.device)
    except RuntimeError as e:
        sys.exit(f"error: {e}")
    host, port = srv.server_address[:2]
    nfeeds = len(args.inputs) + len(cfg.feeds if cfg else ())
    print(f"serving {nfeeds} feed(s) on http://{host}:{port}/ "
          "(status page at /)", file=sys.stderr)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(serve())
