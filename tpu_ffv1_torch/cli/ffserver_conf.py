"""ffserver-style configuration file parser (the port's copy of
``tpu_ffv1/cli/ffserver_conf.py``, unchanged: host code only).

The reference server reads an Apache-style config
(ffserver_config.c ffserver_parse_ffconfig): global directives plus
``<Feed name>`` / ``<Stream name>`` / ``<Redirect name>`` sections with
case-insensitive keywords and ``#`` comments.  This parser covers the
subset that is meaningful for an FFV1-only server:

  global   HTTPPort/Port, HTTPBindAddress/BindAddress, MaxClients,
           MaxHTTPConnections, MaxBandwidth, CustomLog, NoDefaults
  <Feed>   FileMaxSize (ring capacity; k/m/g suffixes as
           ffserver_config.c:763-778), ACL allow|deny <prefix>
  <Stream> Feed, Format, File, VideoSize, PixelFormat, VideoGopSize,
           VideoCodec, StartSendOnKey, Preroll, MaxTime, NoAudio,
           AVOptionVideo <name> <val> (FFV1 options -> EncoderParams
           fields), Author/Comment/Copyright/Title metadata
  <Redirect> URL

Like the reference (ffserver_config.c ERROR macro: report, keep
parsing, fail at the end with the error count), errors accumulate and
parsing the whole file raises one ValueError naming every bad line.
Unknown keywords are errors, exactly as ffserver treats them — a typo
silently changing server behavior is worse than a startup failure.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# AVOptionVideo names an FFV1 AVOption (ffv1enc.c options[]); these map
# onto EncoderParams fields.  Values go through int() because every
# FFV1 option is integer-valued.
_FFV1_AVOPTIONS = {
    "coder": "coder",
    "context": "context_model",
    "slicecrc": "slicecrc",
    "slices": "slices",
    "g": "gop_size",
    "level": "level",
    "qtable": "qtable",
}


@dataclass
class FeedConfig:
    name: str
    max_size: int = 5 * 1024 * 1024   # ffserver_config.c:718
    acl: list = field(default_factory=list)   # [("allow"|"deny", prefix)]


@dataclass
class StreamConfig:
    name: str                 # "live.nut" — ext selects the wire format
    feed: str | None = None
    file: str | None = None
    fmt: str | None = None
    video_size: tuple | None = None
    pix_fmt: str | None = None
    gop_size: int | None = None
    send_on_key: bool = False  # ffserver.c:2389 send_on_key gate
    preroll: float = 0.0
    max_time: float = 0.0
    options: dict = field(default_factory=dict)   # EncoderParams kwargs
    metadata: dict = field(default_factory=dict)

    @property
    def ext(self) -> str:
        i = self.name.rfind(".")
        return self.name[i:].lower() if i >= 0 else ""


@dataclass
class RedirectConfig:
    name: str
    url: str = ""


@dataclass
class ServerConfig:
    port: int = 8090
    # the reference binds 0.0.0.0; loopback here is a deliberate
    # hardening default — publishing feeds on every interface is opt-in
    bind: str = "127.0.0.1"
    max_clients: int = 5          # ffserver_config.h nb_max_connections
    max_http_connections: int = 2000
    max_bandwidth: int = 1000     # kbit/s, ffserver_config.h default
    custom_log: str | None = None
    feeds: dict = field(default_factory=dict)
    streams: dict = field(default_factory=dict)
    redirects: dict = field(default_factory=dict)


def _parse_size(arg: str) -> int:
    """FileMaxSize with the reference's K/M/G suffixes
    (ffserver_config.c:763-778 av_strtod-based scaling)."""
    a = arg.strip().lower()
    mult = 1
    if a and a[-1] in "kmg":
        mult = {"k": 1024, "m": 1024 ** 2, "g": 1024 ** 3}[a[-1]]
        a = a[:-1]
    return int(float(a) * mult)


def _int_in(val: str, lo: int, hi: int) -> int:
    v = int(val)
    if not lo <= v <= hi:
        raise ValueError(f"{v} out of range [{lo}, {hi}]")
    return v


def _section_name(cmd: str, arg: str, tag: str) -> str:
    """Name from '<Tag name>' (the reference strips at '>',
    ffserver_config.c:702-705)."""
    rest = (cmd + " " + arg)[len(tag) + 1:]
    return rest.split(">", 1)[0].strip()


def parse_config(text: str) -> ServerConfig:
    cfg = ServerConfig()
    errors = []
    section = None          # None | FeedConfig | StreamConfig | Redirect

    def err(lineno, msg):
        errors.append(f"line {lineno}: {msg}")

    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split(None, 1)
        cmd = parts[0]
        arg = parts[1].strip() if len(parts) > 1 else ""
        lcmd = cmd.lower()

        # ---- section opens/closes -------------------------------------
        if lcmd.startswith("<feed"):
            if section is not None:
                err(lineno, "<Feed> inside another section")
                continue
            name = _section_name(cmd, arg, "<feed")
            if not name:
                err(lineno, "<Feed> needs a name")
                continue
            if name in cfg.feeds:
                # ffserver_config.c:706 "Feed already registered"
                err(lineno, f"feed {name!r} already registered")
                continue
            section = FeedConfig(name=name)
            continue
        if lcmd == "</feed>":
            if not isinstance(section, FeedConfig):
                err(lineno, "</Feed> without <Feed>")
                continue
            cfg.feeds[section.name] = section
            section = None
            continue
        if lcmd.startswith("<stream"):
            if section is not None:
                err(lineno, "<Stream> inside another section")
                continue
            name = _section_name(cmd, arg, "<stream")
            if not name:
                err(lineno, "<Stream> needs a name")
                continue
            if name in cfg.streams or name in cfg.redirects:
                err(lineno, f"stream {name!r} already registered")
                continue
            section = StreamConfig(name=name)
            continue
        if lcmd == "</stream>":
            if not isinstance(section, StreamConfig):
                err(lineno, "</Stream> without <Stream>")
                continue
            if section.feed and section.file:
                err(lineno, f"stream {section.name!r}: Feed and File "
                            "are mutually exclusive")
            cfg.streams[section.name] = section
            section = None
            continue
        if lcmd.startswith("<redirect"):
            if section is not None:
                err(lineno, "<Redirect> inside another section")
                continue
            name = _section_name(cmd, arg, "<redirect")
            if not name:
                err(lineno, "<Redirect> needs a name")
                continue
            section = RedirectConfig(name=name)
            continue
        if lcmd == "</redirect>":
            if not isinstance(section, RedirectConfig):
                err(lineno, "</Redirect> without <Redirect>")
                continue
            if not section.url:
                err(lineno, "<Redirect> needs a URL")   # config.c:1229
            else:
                cfg.redirects[section.name] = section
            section = None
            continue

        # ---- directives ------------------------------------------------
        try:
            if section is None:
                if lcmd in ("port", "httpport"):
                    cfg.port = _int_in(arg, 1, 65535)
                elif lcmd in ("bindaddress", "httpbindaddress"):
                    cfg.bind = arg
                elif lcmd == "maxclients":
                    cfg.max_clients = _int_in(arg, 1, 65535)
                elif lcmd == "maxhttpconnections":
                    cfg.max_http_connections = _int_in(arg, 1, 65535)
                elif lcmd == "maxbandwidth":
                    v = int(arg)
                    if not 10 <= v <= 10_000_000:   # config.c:668
                        raise ValueError(f"invalid MaxBandwidth {v}")
                    cfg.max_bandwidth = v
                elif lcmd == "customlog":
                    cfg.custom_log = arg
                elif lcmd in ("nodefaults", "usedefaults", "nodaemon"):
                    pass
                else:
                    err(lineno, f"incorrect keyword {cmd!r}")
            elif isinstance(section, FeedConfig):
                if lcmd == "filemaxsize":
                    section.max_size = _parse_size(arg)
                elif lcmd == "acl":
                    aparts = arg.split()
                    if len(aparts) < 2 or \
                            aparts[0].lower() not in ("allow", "deny"):
                        raise ValueError("ACL wants: allow|deny <addr>")
                    section.acl.append((aparts[0].lower(), aparts[1]))
                elif lcmd in ("file", "readonlyfile", "truncate"):
                    pass    # ring lives in memory, not a spool file
                elif lcmd == "launch":
                    err(lineno, "Launch is not supported; start the "
                                "publisher yourself and POST to the feed")
                else:
                    err(lineno, f"invalid entry {cmd!r} inside <Feed>")
            elif isinstance(section, StreamConfig):
                if lcmd == "feed":
                    section.feed = arg
                elif lcmd == "file":
                    section.file = arg
                elif lcmd == "format":
                    section.fmt = arg.lower()
                elif lcmd == "videosize":
                    w, h = arg.lower().split("x")
                    section.video_size = (int(w), int(h))
                elif lcmd == "pixelformat":
                    section.pix_fmt = arg
                elif lcmd == "videogopsize":
                    section.gop_size = int(arg)
                elif lcmd == "videocodec":
                    if arg.lower() != "ffv1":
                        raise ValueError(
                            f"unknown video codec {arg!r} (this server "
                            "codes FFV1)")
                elif lcmd == "startsendonkey":
                    section.send_on_key = True
                elif lcmd == "preroll":
                    section.preroll = float(arg)
                elif lcmd == "maxtime":
                    section.max_time = float(arg)
                elif lcmd in ("noaudio", "novideo"):
                    if lcmd == "novideo":
                        raise ValueError("NoVideo makes an FFV1 stream "
                                         "empty")
                elif lcmd == "avoptionvideo":
                    oparts = arg.split()
                    if len(oparts) != 2:
                        raise ValueError(
                            "AVOptionVideo wants: <name> <value>")
                    oname, oval = oparts
                    if oname not in _FFV1_AVOPTIONS:
                        raise ValueError(
                            f"unknown FFV1 option {oname!r} (have: "
                            f"{', '.join(sorted(_FFV1_AVOPTIONS))})")
                    section.options[_FFV1_AVOPTIONS[oname]] = int(oval)
                elif lcmd in ("author", "comment", "copyright", "title"):
                    section.metadata[lcmd] = arg
                elif lcmd == "metadata":
                    k, _, v = arg.partition(" ")
                    section.metadata[k.lower()] = v.strip()
                else:
                    err(lineno, f"invalid entry {cmd!r} inside <Stream>")
            elif isinstance(section, RedirectConfig):
                if lcmd == "url":
                    section.url = arg
                else:
                    err(lineno, f"invalid entry {cmd!r} inside "
                                "<Redirect>")
        except (ValueError, IndexError) as e:
            err(lineno, f"{cmd}: {e}")

    if section is not None:
        errors.append(f"unclosed <{type(section).__name__}> "
                      f"({section.name!r})")

    # cross-section validation (ffserver_config.c tail: every stream's
    # feed must exist)
    for s in cfg.streams.values():
        if s.feed and s.feed not in cfg.feeds:
            errors.append(f"stream {s.name!r} references undeclared "
                          f"feed {s.feed!r}")
        if not s.feed and not s.file and (s.fmt or "") != "status":
            errors.append(f"stream {s.name!r} has neither Feed nor "
                          "File")
        if s.fmt is None and s.ext:
            s.fmt = s.ext[1:]
        if s.fmt not in ("y4m", "yuv4mpegpipe", "nut", "avi", "mkv",
                        "matroska", "status", None):
            errors.append(f"stream {s.name!r}: unknown Format "
                          f"{s.fmt!r}")
    if errors:
        raise ValueError("config errors:\n  " + "\n  ".join(errors))
    return cfg


def load_config(path: str) -> ServerConfig:
    with open(path, encoding="utf-8", errors="replace") as f:
        return parse_config(f.read())
