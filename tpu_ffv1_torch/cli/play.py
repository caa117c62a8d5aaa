"""Terminal media player — the ffplay analog (reference: ffplay.c) on the
port: the counterpart of ``tpu_ffv1/cli/play.py`` whose decode runs
through ``TorchFFV1Decoder`` on the device the caller names (``-device
{cuda,cpu}``, default cuda: without a GPU the player exits before it
decodes; it never falls back to the CPU).

Decodes an FFV1 container (.avi/.nut/.mkv) or a raw .y4m stream and
renders frames in the terminal as 24-bit-color half-blocks (two pixels
per character cell), paced to the stream's frame rate.  The reference
player's SDL window becomes the ANSI terminal; everything else keeps
ffplay's shape: demux -> decode -> (optional start seek) -> paced
display, `-nodisp` decode-only mode (ffplay.c `-nodisp`), `-loop`,
autoexit-at-EOF semantics, `-ss` start seek resolved through keyframe
random access exactly like the seek harness (tests/fate/seek.mak):
decoding restarts at the nearest preceding keyframe and rolls forward
to the target frame (ffv1dec.c:931 cannot-decode-P-without-I).  The
frames decode two in flight (``submit_frames`` / ``collect_frames``).

Display conversion (YUV -> RGB, BT.601) is display-only and NOT part of
the bit-exact surface (that is tpu_ffv1_torch/swscale.py's job).

Usage:
  python -m tpu_ffv1_torch.cli.play clip.avi
  python -m tpu_ffv1_torch.cli.play -nodisp -ss 5 clip.avi -device cuda
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _to_rgb(planes, pix_fmt, w, h):
    """Display-only planar -> interleaved (H, W, 3) RGB uint8."""
    from ..codec.pixfmt import get_pix_fmt
    fmt = get_pix_fmt(pix_fmt)
    mx = float((1 << fmt.bits) - 1)

    def norm(p):
        return np.asarray(p).astype(np.float32) * (255.0 / mx)

    if fmt.colorspace == 1:
        if isinstance(planes, np.ndarray) or len(planes) == 1:
            arr = np.asarray(planes if isinstance(planes, np.ndarray)
                             else planes[0])
            b, g, r = arr[..., 0], arr[..., 1], arr[..., 2]
            return np.stack([r, g, b], -1).astype(np.uint8)
        g, b, r = (norm(planes[i]) for i in range(3))   # GBR plane order
        return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)
    if fmt.interleaved:         # ya8: luma channel, alpha over black
        arr = np.asarray(planes if isinstance(planes, np.ndarray)
                         else planes[0]).astype(np.float32)
        y = arr[..., 0] * (arr[..., 1] / 255.0)
        return np.repeat(np.clip(y, 0, 255)[..., None],
                         3, -1).astype(np.uint8)
    y = norm(planes[0])
    if not fmt.chroma_planes:   # gray
        return np.repeat(np.clip(y, 0, 255)[..., None],
                         3, -1).astype(np.uint8)
    u, v = norm(planes[1]), norm(planes[2])
    # nearest-neighbor chroma upsample to luma geometry (display only)
    u = u.repeat(1 << fmt.chroma_v_shift, 0).repeat(
        1 << fmt.chroma_h_shift, 1)[:h, :w]
    v = v.repeat(1 << fmt.chroma_v_shift, 0).repeat(
        1 << fmt.chroma_h_shift, 1)[:h, :w]
    yf = (y - 16.0) * (255.0 / 219.0)
    uf, vf = u - 128.0, v - 128.0
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _render_halfblocks(rgb, cols, rows, out):
    """One frame as ANSI truecolor half-blocks (2 pixels per cell)."""
    h, w = rgb.shape[:2]
    # fit, preserving aspect (a terminal cell is ~2x taller than wide)
    scale = min(cols / w, 2 * (rows - 1) / h)
    tw = max(1, int(w * scale))
    th = max(2, int(h * scale)) & ~1
    ys = np.arange(th) * h // th
    xs = np.arange(tw) * w // tw
    img = rgb[ys][:, xs]
    top, bot = img[0::2], img[1::2]
    lines = ["\x1b[H"]
    for r in range(top.shape[0]):
        cells = []
        for c in range(tw):
            tr, tg, tb = top[r, c]
            br, bg, bb = bot[r, c]
            cells.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                         f"\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(cells) + "\x1b[0m\n")
    out.write("".join(lines))
    out.flush()


def seek_start(keyflags, target):
    """Keyframe random access: index of the keyframe decode must restart
    from to show `target` (seek.mak behavior; ffv1dec.c:931 guard)."""
    for i in range(min(target, len(keyflags) - 1), -1, -1):
        if keyflags[i]:
            return i
    return 0


def _decode_from(path, ss, device="cuda"):
    """Demux + decode honoring keyframe random access: only packets from
    the seek keyframe onward are decoded, through ``TorchFFV1Decoder`` on
    ``device``, two frames in flight; the roll-in frames before ``ss``
    are decoded and not returned.  -> (frames-from-ss, pix_fmt, w, h,
    fps, restart_index).  A stream without out-of-band headers (version
    0/1) raises NotImplementedError with the command line's message.

    NOTE: cli/main.py's decode path implements the same roll-in
    semantics with -frames/-benchmark accounting; if seek semantics
    change, update both."""
    from .main import (DEPTH, NO_EXTRADATA, _is_y4m, _pipelined,
                       _read_container)
    if _is_y4m(path):
        from ..io.y4m import read_y4m
        frames, fmtname, w, h, fps = read_y4m(path)
        return frames[ss:], fmtname, w, h, fps, ss   # all-intra stream
    st, _kind = _read_container(path)
    if not st.extradata:
        raise NotImplementedError(NO_EXTRADATA)
    from ..tpu.decoder import TorchFFV1Decoder
    start = seek_start(st.keyflags, ss) if ss else 0
    dec = TorchFFV1Decoder(st.width, st.height, st.extradata, device=device)
    decoded = _pipelined(dec.submit_frames, dec.collect_frames,
                         st.packets[start:], DEPTH)
    frames = []
    for i, (planes, _key) in enumerate(decoded, start):
        if i >= ss:
            frames.append([np.asarray(p) for p in planes]
                          if isinstance(planes, (list, tuple))
                          else np.asarray(planes))
    return frames, dec.pix_fmt, st.width, st.height, st.fps, start


def play(argv=None, out=None):
    p = argparse.ArgumentParser(
        prog="tpu_ffv1_torch.play",
        description="terminal FFV1 player on PyTorch and CUDA")
    p.add_argument("input")
    p.add_argument("-nodisp", action="store_true",
                   help="decode only, report timing (ffplay -nodisp)")
    p.add_argument("-loop", type=int, default=1,
                   help="play N times (0 = forever)")
    p.add_argument("-ss", type=int, default=0,
                   help="start at frame N (keyframe-accurate seek)")
    p.add_argument("-vframes", type=int, default=None)
    p.add_argument("-fs", type=str, default=None,
                   help="force terminal size COLSxROWS (for tests)")
    p.add_argument("-device", default="cuda", choices=["cuda", "cpu"],
                   help="where the decoder runs: cuda (the CUDA kernels; "
                        "fails without a GPU) or cpu (the kernels' plain "
                        "PyTorch versions)")
    args = p.parse_args(argv)
    out = out or sys.stdout
    from ..device import resolve_device
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"error: {e}")

    t0 = time.time()
    try:
        seq, pix_fmt, w, h, fps, start = _decode_from(args.input, args.ss,
                                                      args.device)
    except NotImplementedError as e:
        sys.exit(f"error: {e}")
    load_s = time.time() - t0
    if not seq:
        sys.exit("error: no frames at/after the seek point")
    if args.vframes is not None:
        seq = seq[:args.vframes]
    frame_s = fps[1] / fps[0] if fps[0] else 0.04

    if args.fs:
        cols, rows = (int(v) for v in args.fs.split("x"))
    else:
        try:
            sz = os.get_terminal_size()
            cols, rows = sz.columns, sz.lines
        except OSError:
            cols, rows = 80, 24

    shown = 0
    loops = args.loop if args.loop else sys.maxsize
    if not args.nodisp:
        out.write("\x1b[2J")   # clear once; each frame homes the cursor
    t0 = time.time()
    for _ in range(loops):
        for planes in seq:
            if not args.nodisp:
                rgb = _to_rgb(planes, pix_fmt, w, h)
                _render_halfblocks(rgb, cols, rows, out)
            shown += 1
            if not args.nodisp:
                # pace to the stream rate (ffplay.c compute_target_delay
                # analog — simple wall-clock pacing)
                delay = t0 + shown * frame_s - time.time()
                if delay > 0:
                    time.sleep(delay)
        if args.loop == 1:
            break
    dt = time.time() - t0
    print(f"{shown} frames {w}x{h} {pix_fmt} in {dt:.2f}s "
          f"(demux+decode {load_s:.2f}s"
          + (f", seek to {args.ss} via keyframe {start}" if args.ss
             else "") + ")", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(play())
