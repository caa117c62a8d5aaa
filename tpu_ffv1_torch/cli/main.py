"""ffmpeg-compatible thin CLI of the PyTorch/CUDA port (the counterpart of
``python -m tpu_ffv1 ... -engine tpu``, ``tpu_ffv1/cli/main.py``).

The same options and messages as the JAX package's CLI, through
``TorchFFV1Encoder`` and ``TorchFFV1Decoder``: -i, -f, -pix_fmt,
-in_pix_fmt, -s, -c:v (ffv1 | copy), -level, -coder, -context, -slices,
-slicecrc, -g, -strict, -frames:v, -ss (keyframe-accurate seek), -vf,
-probe [-of json], -benchmark, -pass 1 / -pass 2 with -passlogfile (pass
1 counts its statistics on the device and writes
``<passlogfile>-0.log``, pass 2 reads it); ``-engine`` becomes
``-device {cuda,cpu}`` (default cuda: without a GPU the run fails, it
never falls back to the CPU).  Frames run two in flight
(``submit_frames`` / ``collect_frames``), or as few as the encoder's
``max_in_flight`` allows, which writes the same bytes as one at a time.

Inputs: rawvideo (-s required), .y4m (self-describing), .avi/.mkv/.nut.
Outputs: rawvideo, .y4m, or a container -- container->container
re-encodes (transcode) or remuxes untouched with -c:v copy.

Examples:
  python -m tpu_ffv1_torch -f rawvideo -pix_fmt yuv420p -s 352x288 \\
      -i in.yuv -c:v ffv1 -level 3 -slices 4 out.avi
  python -m tpu_ffv1_torch -i in.avi -f rawvideo -pix_fmt yuv420p out.yuv
  python -m tpu_ffv1_torch -i in.y4m -c:v ffv1 -coder 0 out.mkv
  python -m tpu_ffv1_torch -i in.avi -c:v copy out.nut
  python -m tpu_ffv1_torch -i in.y4m -c:v ffv1 -level 3 -device cpu out.avi
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .play import seek_start

# frames in flight in the encoder and the decoder (1: one at a time)
DEPTH = 2
# the refusal of a stream whose headers are in band (versions 0 and 1)
NO_EXTRADATA = ("tpu_ffv1_torch needs out-of-band headers (version >= 2); "
                "use the host decoder for v0/v1 streams")


def build_parser():
    p = argparse.ArgumentParser(
        prog="tpu_ffv1_torch",
        description="FFV1 encoder/decoder on PyTorch and CUDA")
    p.add_argument("-i", dest="input", required=True)
    p.add_argument("-f", dest="fmt", default=None,
                   help="input/output format (rawvideo|avi); inferred "
                        "from extension otherwise")
    p.add_argument("-pix_fmt", default=None,
                   help="coded format on encode / output raw format on "
                        "decode; DEFAULT: preserve the source format "
                        "(no silent conversion — lossless semantics). "
                        "Conversions run through the swscale analog "
                        "(neighbor+bitexact); rawvideo input with no "
                        "format flags assumes yuv420p")
    p.add_argument("-in_pix_fmt", default=None,
                   help="raw INPUT format when it differs from -pix_fmt "
                        "(the in-pipeline conversion the FATE harness "
                        "does with -pix_fmt + -sws_flags, "
                        "tests/fate/vcodec.mak:119-121)")
    p.add_argument("-s", dest="size", default=None,
                   help="WxH (required for rawvideo input)")
    p.add_argument("-c:v", "-vcodec", dest="codec", default=None)
    p.add_argument("-level", type=int, default=-99)
    p.add_argument("-coder", type=int, default=-1)
    p.add_argument("-context", type=int, default=0)
    p.add_argument("-slices", type=int, default=0)
    p.add_argument("-slicecrc", type=int, default=-1)
    p.add_argument("-g", dest="gop", type=int, default=12)
    p.add_argument("-strict", type=int, default=0)
    p.add_argument("-frames:v", dest="frames", type=int, default=None)
    p.add_argument("-ss", dest="seek", type=int, default=0,
                   help="start at frame N; on container input the "
                        "decode restarts at the nearest preceding "
                        "keyframe (seek.mak semantics)")
    p.add_argument("-pass", dest="rc_pass", type=int, default=0,
                   choices=[0, 1, 2],
                   help="two-pass mode (1 = gather stats on the device "
                        "into <passlogfile>-0.log, 2 = encode with them)")
    p.add_argument("-passlogfile", default="ffv1_2pass",
                   help="stats file prefix (two-pass mode)")
    p.add_argument("-vf", dest="vf", default=None,
                   help="linear filter chain (ffmpeg -vf analog): "
                        "null,copy,format,scale,crop,hflip,vflip,"
                        "transpose,trim — see tpu_ffv1_torch/filtergraph.py")
    p.add_argument("-device", default="cuda", choices=["cuda", "cpu"],
                   help="where the codec runs: cuda (the CUDA kernels; "
                        "fails without a GPU) or cpu (the kernels' plain "
                        "PyTorch versions)")
    p.add_argument("-benchmark", action="store_true")
    p.add_argument("-probe", action="store_true",
                   help="inspect a stream (the ffprobe analog) and exit")
    p.add_argument("-of", dest="ofmt", default="default",
                   choices=["default", "json"],
                   help="probe output format (ffprobe -print_format)")
    p.add_argument("-y", action="store_true", help="overwrite (always on)")
    p.add_argument("output", nargs="?")
    return p


def probe(path: str, ofmt: str = "default"):
    """Stream inspection (ffprobe analog; dumps the global-header fields
    of ffv1dec.c:620-634 plus packet stats).  ofmt="json" mirrors
    ffprobe's -print_format json machine-readable form."""
    from ..bitstream.headers import read_extra_header

    st, kind = _read_container(path)
    g = read_extra_header(st.extradata) if st.extradata else None
    sizes = [len(p) for p in st.packets]
    nkey = sum(st.keyflags)
    if ofmt == "json":
        import json
        doc = {
            "format": {"format_name": kind, "nb_streams": 1},
            "streams": [{
                "codec_name": "ffv1", "width": st.width,
                "height": st.height,
                "r_frame_rate": f"{st.fps[0]}/{st.fps[1]}",
                "nb_frames": len(sizes),
                **({"ffv1_version":
                        f"{g.version}.{g.micro_version}",
                    "coder": g.ac, "colorspace": g.colorspace,
                    "bits_per_raw_sample": g.bits_per_raw_sample,
                    "chroma_planes": int(g.chroma_planes),
                    "chroma_shift":
                        [g.chroma_h_shift, g.chroma_v_shift],
                    "transparency": int(g.transparency),
                    "slices":
                        [g.num_h_slices, g.num_v_slices],
                    "quant_table_count": g.quant_table_count,
                    "ec": g.ec, "intra": g.intra} if g else {}),
            }],
            "packets": [
                {"size": s, "flags": "K" if k else "_"}
                for s, k in zip(sizes, st.keyflags)],
        }
        print(json.dumps(doc, indent=2))
        return 0
    print(f"container: {kind}, {st.width}x{st.height}, "
          f"fps {st.fps[0]}/{st.fps[1]}")
    if g is not None:
        print(f"ffv1: ver:{g.version}.{g.micro_version} coder:{g.ac} "
              f"colorspace:{g.colorspace} bpr:{g.bits_per_raw_sample} "
              f"chroma:{int(g.chroma_planes)}({g.chroma_h_shift}:"
              f"{g.chroma_v_shift}) alpha:{int(g.transparency)} "
              f"slices:{g.num_h_slices}x{g.num_v_slices} "
              f"qtabs:{g.quant_table_count} ec:{g.ec} intra:{g.intra}")
    else:
        print("ffv1: version < 2 (in-band headers)")
    if sizes:
        print(f"packets: {len(sizes)} ({nkey} key), bytes total "
              f"{sum(sizes)} min {min(sizes)} avg "
              f"{sum(sizes) // len(sizes)} max {max(sizes)}")
    for i, (s, k) in enumerate(zip(sizes, st.keyflags)):
        print(f"  frame {i}: {'K' if k else 'P'} {s} bytes")
    return 0


def _is_avi(path):
    return path.lower().endswith(".avi")


def _is_mkv(path):
    return path.lower().endswith((".mkv", ".webm"))


def _is_nut(path):
    return path.lower().endswith(".nut")


def _is_y4m(path):
    return path.lower().endswith(".y4m")


def _read_container(path):
    if _is_mkv(path):
        from ..io.mkv import read_mkv
        return read_mkv(path), "matroska"
    if _is_nut(path):
        from ..io.nut import read_nut
        return read_nut(path), "nut"
    from ..io.avi import read_avi
    return read_avi(path), "avi"


def _is_container(path):
    return _is_avi(path) or _is_mkv(path) or _is_nut(path)


def _mux(path, w, h, extradata, pkts, keys, fps=(25, 1)):
    """Write packets to the container selected by extension
    (av_interleaved_write_frame analog over the io writers)."""
    if _is_mkv(path):
        from ..io import mkv as mkv_io
        mkv_io.write_mkv(path, mkv_io.MkvStream(
            width=w, height=h, extradata=extradata,
            packets=pkts, keyflags=keys, fps=fps))
    elif _is_nut(path):
        from ..io import nut as nut_io
        nut_io.write_nut(path, nut_io.NutStream(
            width=w, height=h, extradata=extradata,
            packets=pkts, keyflags=keys, fps=fps))
    elif _is_avi(path):
        from ..io import avi as avi_io
        avi_io.write_avi(path, avi_io.AviStream(
            width=w, height=h, extradata=extradata,
            packets=pkts, keyflags=keys, fps=fps))
    else:
        sys.exit("error: only .avi/.mkv/.nut output is supported")


def _codec(cls, *args, **kw):
    """One of the port's classes; a missing GPU (``resolve_device``) and
    the classes' refusals end the run with their message."""
    try:
        return cls(*args, **kw)
    except (NotImplementedError, RuntimeError) as e:
        sys.exit(f"error: {e}")


def _pipelined(submit, collect, items, depth):
    """One item per call through ``submit`` / ``collect`` with up to
    ``depth`` in flight; the results in order."""
    out, in_flight = [], 0
    for item in items:
        submit([item])
        in_flight += 1
        if in_flight == depth:
            out.append(collect()[0])
            in_flight -= 1
    out += [collect()[0] for _ in range(in_flight)]
    return out


def _encode_frames_to(args, frames, w, h, pix_fmt, fps=(25, 1)):
    """Shared encode+mux tail (ffmpeg.c do_video_out + muxer): frames
    are already in ``pix_fmt`` at (w, h).  Returns the report line."""
    from ..codec.params import EncoderParams
    from ..tpu.encoder import TorchFFV1Encoder
    stats_in = None
    logf = args.passlogfile + "-0.log"
    if args.rc_pass == 2:
        if not os.path.exists(logf):
            sys.exit(f"error: pass-2 needs stats at {logf} "
                     "(run -pass 1 first)")
        with open(logf) as f:
            stats_in = f.read()
    params = EncoderParams(
        width=w, height=h, pix_fmt=pix_fmt, level=args.level,
        coder=args.coder, context_model=args.context,
        slices=args.slices, slicecrc=args.slicecrc, gop_size=args.gop,
        strict=args.strict, pass1=args.rc_pass == 1, stats_in=stats_in)
    enc = _codec(TorchFFV1Encoder, params, device=args.device)
    depth = min(DEPTH, enc.max_in_flight or DEPTH)
    res = _pipelined(enc.submit_frames, enc.collect_frames, frames, depth)
    pkts = [pkt for pkt, _key in res]
    keys = [key for _pkt, key in res]
    if args.rc_pass == 1:
        with open(logf, "w") as f:
            f.write(enc.get_stats())
    _mux(args.output, w, h, enc.extradata or b"", pkts, keys, fps=fps)
    total = sum(len(p) for p in pkts)
    return (f"encoded {len(pkts)} frames {w}x{h} -> {total} bytes "
            f"(v{enc.rp.version}, coder {enc.rp.ac})")


def run(argv=None):
    args = build_parser().parse_args(argv)
    if args.probe:
        try:
            return probe(args.input, args.ofmt)
        except BrokenPipeError:
            return 0
        except (ValueError, OSError) as e:
            sys.exit(f"error: {e}")
    if not args.output:
        sys.exit("error: output path required")
    if not os.path.exists(args.input):
        sys.exit(f"error: no such file: {args.input}")
    try:
        return _run(args)
    except NotImplementedError as e:
        sys.exit(f"error: {e}")


def _run(args):
    from ..io import rawvideo as raw_io

    t0 = time.time()
    npix = 0

    if _is_container(args.input):
        # ---- decode path ----
        st, _kind = _read_container(args.input)
        if args.codec == "copy":
            # stream copy (ffmpeg -c:v copy): remux packets untouched;
            # -ss cuts at the nearest preceding keyframe like ffmpeg
            if not _is_container(args.output):
                sys.exit("error: -c:v copy needs a container output")
            start = seek_start(st.keyflags, args.seek) \
                if args.seek else 0
            end = None if args.frames is None else start + args.frames
            pkts = st.packets[start:end]
            keys = list(st.keyflags)[start:end]
            _mux(args.output, st.width, st.height, st.extradata or b"",
                 pkts, keys)
            print(f"copied {len(pkts)} packets {st.width}x{st.height}"
                  + (f" (cut at keyframe {start})" if start else "")
                  + f" -> {args.output}", file=sys.stderr)
            return 0
        if not st.extradata:
            sys.exit(f"error: {NO_EXTRADATA}")
        from ..tpu.decoder import TorchFFV1Decoder
        dec = _codec(TorchFFV1Decoder, st.width, st.height, st.extradata,
                     device=args.device)
        start = seek_start(st.keyflags, args.seek) if args.seek else 0
        stop = None if args.frames is None else args.seek + args.frames
        decoded = _pipelined(dec.submit_frames, dec.collect_frames,
                             st.packets[start:stop], DEPTH)
        frames = []
        for i, (planes, _key) in enumerate(decoded, start):
            npix += st.width * st.height   # roll-in frames cost too
            if i < args.seek:
                continue           # keyframe roll-in, not emitted
            frames.append([np.asarray(p) for p in planes])
        conv = ""
        cur_fmt, cur_w, cur_h = dec.pix_fmt, st.width, st.height
        if args.vf:
            from ..filtergraph import FilterGraph
            g = FilterGraph(args.vf, cur_fmt, cur_w, cur_h,
                            dst_fmt=args.pix_fmt or None)
            frames = g.run(frames)
            cur_fmt, cur_w, cur_h = g.out_fmt, g.out_w, g.out_h
            conv = f" [vf: {args.vf}]"
        if args.pix_fmt and cur_fmt and args.pix_fmt != cur_fmt:
            from ..swscale import convert
            frames = [convert(f, cur_fmt, args.pix_fmt, cur_w, cur_h)
                      for f in frames]
            conv += f" ({cur_fmt} -> {args.pix_fmt})"
            cur_fmt = args.pix_fmt
        if _is_container(args.output):
            # transcode: decoded frames re-encode through the shared
            # tail (ffmpeg.c decode -> filter -> encode chain); the
            # source format is preserved unless -pix_fmt asked
            npix += len(frames) * cur_w * cur_h
            line = _encode_frames_to(args, frames, cur_w, cur_h,
                                     cur_fmt)
            what = "trans" + line.removeprefix("en") + conv
        elif _is_y4m(args.output):
            from ..io.y4m import write_y4m
            write_y4m(args.output, frames, cur_fmt, cur_w, cur_h,
                      fps=st.fps)
            what = f"decoded {len(frames)} frames {cur_w}x{cur_h}{conv}"
        else:
            raw_io.write_frames(args.output, frames)
            what = f"decoded {len(frames)} frames {cur_w}x{cur_h}{conv}"
    else:
        # ---- encode path ----
        if _is_y4m(args.input):
            # self-describing input: geometry + pix_fmt from the header
            from ..io.y4m import read_y4m
            frames, in_fmt, w, h, fps = read_y4m(args.input)
            if args.in_pix_fmt and args.in_pix_fmt != in_fmt:
                sys.exit(f"error: -in_pix_fmt {args.in_pix_fmt} != y4m "
                         f"stream format {in_fmt}")
        else:
            if not args.size:
                sys.exit("error: -s WxH is required for rawvideo input")
            w, h = (int(v) for v in args.size.split("x"))
            in_fmt = args.in_pix_fmt or args.pix_fmt or "yuv420p"
            frames = raw_io.read_frames(args.input, in_fmt, w, h)
            fps = (25, 1)     # rawvideo carries no rate metadata
        if args.seek:
            frames = frames[args.seek:]
        if args.frames is not None:
            frames = frames[:args.frames]
        if args.vf:
            from ..filtergraph import FilterGraph
            g = FilterGraph(args.vf, in_fmt, w, h,
                            dst_fmt=args.pix_fmt or None)
            frames = g.run(frames)
            in_fmt, w, h = g.out_fmt, g.out_w, g.out_h
        enc_fmt = args.pix_fmt or in_fmt     # preserve source format
        if in_fmt != enc_fmt:
            from ..swscale import convert
            frames = [convert(f, in_fmt, enc_fmt, w, h)
                      for f in frames]
        npix += len(frames) * w * h
        if _is_container(args.output):
            what = _encode_frames_to(args, frames, w, h, enc_fmt,
                                     fps=fps)
        elif _is_y4m(args.output):
            # conversion-only chain (no codec): y4m/raw in -> y4m out
            from ..io.y4m import write_y4m
            write_y4m(args.output, frames, enc_fmt, w, h, fps=fps)
            what = f"wrote {len(frames)} frames {w}x{h} ({enc_fmt})"
        else:
            raw_io.write_frames(args.output, frames)
            what = f"wrote {len(frames)} frames {w}x{h} ({enc_fmt})"

    dt = time.time() - t0
    print(what, file=sys.stderr)
    if args.benchmark:
        print(f"bench: {dt:.3f}s  {npix / dt / 1e6:.2f} Mpixel/s",
              file=sys.stderr)
    return 0
