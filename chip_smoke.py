#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_ffv1_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing progress lines; any failure raises and the script
exits non-zero without the final result line:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; fails when torch.cuda.is_available() is False;
2. build: the lane-scan kernels (every instance of the six sources:
   K1, K2, K1-ext, K2-ext, each with its state table in shared memory
   and in global memory, the decoders also with the 5-input context and
   in their line-interleaved RGB form, B1 and B1-ext,
   K1 also in its compact form, K1 and K1-ext also as the stats
   instances of two-pass encoding's pass 1 (K1's with its row-count
   kernel, rc_stats_rows_kernel), K1, K1-ext, K2, K2-ext, G1
   and G2 as stage probes; G1 and G2, the Golomb-Rice scans, with the
   VLC table in shared and in global memory, G2 also with the 5-input
   context), find_best_state.cu (pass 2's table of tuned initial
   states) and the probes (chain_probe.cu, golomb_probe.cu) from
   tpu_ffv1_torch/csrc, one nvcc per source, all
   started together; the registers, spills and SASS instructions of
   every instance;
3. probes: the latency of one dependent range-coder decision on a
   single warp (encode and decode form), the yardstick of the kernels'
   chain bound, the SASS instructions of one decision (cuobjdump of the
   probe), the operations term of their roofline bound, the latency
   of one dependent 32-byte row read from L2 on one warp, which the
   global-table decoders add to their chain per pixel, and the
   shared-memory lookups of the lane scans (a 32-byte row read from
   context model 0's table, a transition-table byte), and the dependent
   steps of the Golomb-Rice scans (a VLC-coded pixel, encode form, G1's,
   and decode form, G2's; a run step: a completed run chunk of G1's run
   machine, a pixel inside a run of G2's) with the SASS instructions of
   each loop, the yardstick of their chain bound and the operations term
   of their roofline bound, each held against its plain loop;
4. kernel launches on random codec-like inputs, each instance timed
   and held against its plain PyTorch version in phase 6: K1 (8 bits)
   and its global-table form (8 bits, context model 1's 15,126 rows);
   K2 and K2-five (8-bit streams of the port's own encoder at context
   models 0 and 1); all four instances of K2's source (K2, K2-five,
   and the 5-input context with the table in shared memory, the 3-input
   one with it in global memory) on random bytes at 8 and 10 bits
   (planes 40, 33, 2 and 1 wide, every third lane started 8 bytes
   before its buffer's end); K1-ext and its global-table form at 11, 16 and 17
   bits (random residuals); K2-ext and K2-ext-five on 16-bit streams of
   the port's own encoder and on random bytes at 11, 16 and 17 bits
   (the damaged-stream paths), and K2-ext's two other instances (the
   5-input context with the table in shared memory, the 3-input one
   with it in global memory) on random bytes at 11, 16 and 17 bits as
   K2's; K1-compact in both placements at 8 bits
   with states from 1..255, so that some pixels overflow its 4 slots;
   and K1's edges at 8, 9 and 10 bits in all four instances (raw and
   compact, each placement) and K1-ext's at 11, 16 and 17 bits in both
   placements: runs of 2-64 equal contexts, also across a 32-pixel
   chunk boundary (the global-table instances forward the next row's
   byte past the adaptation store; K1-ext's running rows carry from
   pixel to pixel), blocks of inactive pixels and of zero residuals,
   residuals at +-2^(bits-1), K1-ext's exponents drawn uniformly;
   G1 in both placements (context models 0 and 1) on its edge inputs:
   runs of the plane's context 0 (run chunks, breaks, the line-end
   flush), zero residuals, escapes, inactive blocks, carried VLC states,
   once more with an output cap below the counts; G2's four instances
   (the 3- or 5-input context, each placement) on random bytes, planes
   40, 33, 2 and 1 wide, every third lane started 8 bytes before its
   buffer's end; B1's four instances at coded widths 9 and 10 and
   B1-ext's at 11, 13 and 15 on random bytes, 3 and 4 planes 40, 33, 2
   and 1 wide, every third lane started 4 bytes before its buffer's
   end, and both on the port's own RGB encode (bgr0, gbrp14le) at
   context model 1 (the 5-input global-table instances);
5. five main paths through TorchFFV1Encoder / TorchFFV1Decoder
   (batch=2), 24 slices, 2 streams x (one key frame, one
   non-key warm-up frame, then timed non-key frames): at 1080p with six
   timed frames the 8-bit path (yuv420p; K1, K2), the 16-bit archival
   path (yuv444p16le, the extended schedule; K1-ext, K2-ext) and the
   8-bit path's configuration and content at context model 1
   (8bit_ctx1; K1's global-table form, K2-five); and the 16-bit path at
   context model 1 cut to 960x540 with two timed frames to stay inside
   the script's time (16bit_ctx1_540p; K1-ext's global-table form,
   K2-ext-five), all four with the range coder; the 8-bit path's
   configuration and content with FFV1's default coder, Golomb-Rice
   (8bit_golomb; G1, G2); RGB: 1080p bgr0, six timed frames (rgb8;
   K1 at coded width 9, B1) and 960x540 gbrp14le, two timed frames
   (rgb14_540p; K1-ext at 15, B1-ext); version 4 (level 4: each slice's
   RCT coefficients searched on the card, the row budget read from the
   raw slots): 1080p bgr0, the rgb8 path's content, six timed frames
   (rgb8_v4; K1 at coded width 9, B1, the inverse RCT per lane) and
   960x540 yuv444p16le, two timed frames (16bit_v4_540p; K1-ext,
   K2-ext), each printing its lanes' (by, ry) histogram and failing if
   every lane kept (1, 1); then the 8-bit and 8bit_ctx1 paths again,
   encode only,
   in the compact form (TorchFFV1Encoder(compact=True): K1-compact and
   finalize_compact; 8bit_compact, 8bit_ctx1_compact).  Each path runs
   with the launch counters set to 0 just before it and read just
   after, and must launch each of its kernels once per frame and no
   other; its packets must match the golden SHA-256 digests of the
   reference host encoder (tpu_ffv1_torch/goldens/chip_smoke.json; the
   compact paths those of their raw paths), its decode must be
   lossless; per-step times, a stage breakdown (the host CRC-32 of the
   step's slices timed alone too) and peak device memory.  Each compact
   path's warm-up launch is held to its raw path's K1 launch: the same
   inputs (SHA-256), cm equal to compact_packed of K1's slots, the same
   low, range and states; the version-4 paths also time the search, the
   slice headers' build (cold and cached) and the row-byte reduction;
   then v4_pcm: 512x4 yuv444p16le at version 4, batch 2, GOP 3 over
   three frames, one stream of 16-bit noise (its slices overflow the
   row budget and retry as PCM in frames 0 and 2; frame 1 codes from the
   reset states) beside a smooth one that never retries: its packets
   must equal the JAX package's TPUFFV1Encoder's on the CPU (the host
   encoder has no PCM retry), its slices' coding modes that pattern, and
   each frame's row bytes the plain computation on a host copy of the
   same raw slots; then twopass (twopass_phase), two-pass encoding: pass
   1 on two small cuts (256x144 yuv420p and 128x72 yuv444p16le, 2
   streams x 2 frames, 24 slices: the stats instances of K1 and K1-ext,
   K1's as its stats scan and its row counts on a side stream; at depth
   2, every submit strict) whose get_stats texts and packets must equal
   the host spec encoder's golden digests, pass 1 on the 8bit path's
   first 4 frames at 1080p (packets 8bit's goldens, every lane's counts
   its decisions, the pair, the scan alone and the row counts alone
   timed beside the production K1 on the same inputs, the scan equal to
   it in every other output), and pass 2 of those frames from
   the 8-bit cut's text (find_best_state on the card; extradata and
   packets equal to the host native encoder's goldens, the decode through
   K2 from the tuned initial states lossless), find_best_state's table
   equal to the host's digest and 14 of its rows to the plain version's
   (its terms counted by the fold's counting instance), and the stats
   instances in both placements (and K1's row counts) on random inputs
   at small N; the cuts' launches, 1080p pass 1's frame-1 launch and the
   random ones are held to their plain versions in phase 6; then two
   main paths on
   non-uniform grids, each
   at FFmpeg's -slices 24 (6 x 4) with six timed frames: 720p
   (1280x720 yuv420p, context model 0: slices 213 and 214 wide, so K1
   over lanes of two lengths and two K2 launches of 24 lanes per step)
   and ntsc10_ctx1 (720x486 yuv422p10le at context model 1, the SD tape
   transfer recipe: slices 121 and 122 high, K1's global form at 10
   bits, two K2-five launches per step), each decode launch timed
   alone; mixed_q: the 8bit and 8bit_ctx1 paths' packets spliced (even
   slices from the first, odd ones from the second:
   splice_packets) and decoded, K2 and K2-five in one group of 24
   lanes each per step, lossless to their source with no slice
   flagged; nonuniform_ext: 203x69 yuv444p16le at version 4 on a 2 x 2
   grid of four slice sizes, batch 2, GOP 2, three frames (the RCT
   search per slice size, K1-ext over four lane lengths, four K2-ext
   launches per step), its packets equal to TPUFFV1Encoder's digests on
   the CPU and its decode lossless; then three FFV1-P paths through
   TorchFFV1PEncoder / TorchFFV1PDecoder (12 slices, GOP 12, batch 2:
   BASELINE config 4's configuration, bench.py:660-717; a keyframe, a
   warm-up P frame, then timed P frames, the streams in bench's frame
   order): pframe_720p (1280x720 yuv420p, bench's pan, full search,
   six timed frames: K1 at 9 bits, K2 at 9 bits, the MV sections
   parsed on the host), pframe_720p_epzs (the same with the EPZS
   search, two timed frames, encode only) and pframe_422p10_540p
   (960x540
   yuv422p10le, 240x180 slices padded to 192 rows of blocks, two timed
   frames, encode only: K1-ext at 11 bits), each held to the host
   FFV1PEncoder's golden digests, its decode lossless, each lane scan
   launched once per frame, with stage times (search, OBMC + residual
   + stencil, scan, finalize; parse, MV parse, scan, OBMC); then the
   pipelined phases (pipeline_phase): 8bit_pipe and 16bit_pipe, those
   cells' frames encoded and decoded at depth 1 and at depth 2 (two
   submits, then a collect before each further submit), every submit
   under torch.cuda.set_sync_debug_mode("error"), the packets equal to
   the goldens, the decodes lossless, each kernel launched once per
   frame; transcode_8bit and transcode_16bit, their packets through
   TorchFFV1Decoder(device_out=True) into submit_device_frames of an
   encoder with the same parameters, the packets again the goldens and
   only (low, range, pos) and the byte slab copied to the host; and
   pframe_720p_pipe, the P cell at depth 2; each with its median step at
   depth 1 and at depth 2; then ya8 and ya8_golomb (ya8_phase): 1080p
   gray + alpha, batch 2, 3 frames at GOP 2, range coder and
   Golomb-Rice, each (H, W, 2) frame split into a luma and an alpha
   plane that ride K1 / K2 (G1 / G2) at the 8bit (8bit_golomb) path's
   shapes (N = 172,800), at depth 1 and at depth 2, the packets equal to
   the host C encoder's golden digests, the decodes one (H, W, 2) array
   equal to the source, each kernel once per frame, the depth-1 warm-up
   frame's launches kept for phase 6; and cli
   (cli_phase): the port's command line, python -m tpu_ffv1_torch, run
   in this process on the card: 8bit's stream 0 from a y4m in a
   temporary directory to an avi whose packets equal the 8bit golden
   digests of stream 0, then back to a y4m equal to the source, with
   its wall time and -benchmark Mpix/s, each run's frame-1 launch (24
   lanes) kept for phase 6; then serve (serve_phase): the port's
   streaming server (cli/serve.py) on a thread of this process on the
   card, the same 8 frames POSTed as y4m to a live feed (K1 once a
   frame) while two /live.nut clients, a /live.y4m client and a GET of
   cli's avi as a file stream's /clip.y4m (K2 once a frame each) pull,
   every NUT packet equal to the 8bit golden digests of stream 0, every
   y4m frame equal to its source, then the player's -nodisp -ss 5 on
   the avi, with the ingest's frames/s, each client's MB/s and the
   phase's seconds; then the sharded phase (sharded_phase): it
   prints torch.cuda.device_count() and splits the lanes into groups
   over make_devices(k), the largest k of 2, 4 and 8 that the card count
   allows, or over cuda:0 twice on a machine with one card (the groups
   then run one after the other, and it says so); sharded_8bit and
   sharded_16bit: the first 4 frames of those cells through
   TorchFFV1Encoder / TorchFFV1Decoder(devices=...) at depth 1 and at
   depth 2 (every submit strict), the packets equal to the goldens, the
   decodes lossless in one lane group, each kernel once per frame and
   group, the steps beside the unsharded pipelined ones of this run, the
   stencil, each group's scan and finalize (decode: K2) and the gather
   timed alone; config5_4k: BASELINE config 5 at its real geometry,
   3840x2160 yuv422p10le, 16 slices, EPZS, the JAX package's 4K dry-run
   content, a key and a P frame through TorchFFV1PEncoder(devices=...),
   equal to the golden config5_4k (the host FFV1PEncoder's), with each
   frame's stages (search, OBMC + residual + stencil, each group's scan
   and finalize, the gather), the last lane group's launches kept for
   phase 6; then K1's, K1-ext's, K2's, K2-ext's, G1's and G2's stage
   split: each stage probe of K1 and of its global form, and of K2 and
   K2-five, on the 8bit and 8bit_ctx1 warm-up inputs, of K1-ext and
   K2-ext on the 16bit ones and of their global forms (K2-ext-five) on
   16bit_ctx1_540p's, of G1 and G2 on 8bit_golomb's, the median of 5
   launches;
6. plain checks: every launch of phase 4, and each kernel's launch on
   its path's warm-up frame (all 48 lanes at full shape; a grouped
   decode's every launch on its own lanes, nonuniform_ext's too;
   K1-compact's through its raw path's K1 launch, phase 5; mixed_q's
   two launches on their own 24 lanes each; each P path's warm-up P
   frame's, 24 lanes; ya8's and ya8_golomb's at two planes a lane,
   48 lanes; cli's frame-1 launches, 24 lanes; config5_4k's last lane
   group's K1 and K1-ext launches, 8 lanes of about 1M slots, on their
   last segment only; twopass's stats launches, the small cuts' each
   whole and 1080p pass 1's frame 1 in segments: K1-ext's six outputs
   with both count tables, K1's stats scan's five and its row counts'
   table, whole), held exactly
   (integer codec) against its plain version, run on CPU copies of the
   same inputs (the plain versions are per-pixel loops of small tensor
   ops, faster on the host than as per-op card launches).  Each
   range-coder main-path launch is split into segments whose start
   states come from the kernel relaunched on the prefix (the scans are
   causal; B1's at rows, with the two rows above each segment from the
   launch's output), each Golomb-Rice one whole; launches of one
   range-coder instance that differ only in their lanes (8bit's,
   mixed_q's and cli's K2; 8bit's and cli's K1; the rgb8 paths'; the
   full and EPZS P paths' K1) share one plain run over their lanes side
   by side (``merge_launches``), each launch's outputs held exactly; all
   segments run in parallel worker processes, one per core, the
   longest launches first, each launch's segments submitted as soon as
   they are cut (the cutting overlaps the workers); the workers return
   digests of their outputs, which must equal the digests of the
   kernel's outputs;
7. JSON lines: the probes' latencies ("probes"), each path's step and
   stage times ("steps"), mixed_q's and nonuniform_ext's steps, the P
   paths' steps and stages ("pframe"), the pipelined phases' steps at
   depth 1 and 2 ("pipeline"), the ya8, cli and serve phases' steps and
   times ("ya8", "cli", "serve"), the sharded phase ("sharded"), the stage splits
   ("stages") and
   the twopass phase's numbers ("twopass"), the
   per-kernel numbers ("kernels": time, launches, roofline and chain
   bounds, plain version's time, max abs error; a grouped decode's row
   sums its launches and lists each under "groups"; the sharded paths'
   launches of an instance under "sharded" in its first row); then the
   nvidia-smi
   line, and the result line {"ok": true, "device": {...}} last.

Imports nothing of JAX and nothing of the JAX package (tpu_ffv1);
tests/test_torch_import.py checks the import set, and
tests/test_torch_goldens.py regenerates the golden digests from the
content generators below with the JAX package's host C encoder.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import ctypes
import filecmp
import hashlib
import http.client
import io
import json
import multiprocessing
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

import tpu_ffv1_torch
from tpu_ffv1_torch import (EncoderParams, TorchFFV1Decoder, TorchFFV1Encoder,
                            TorchFFV1PDecoder, TorchFFV1PEncoder)
from tpu_ffv1_torch.cli import main as port_cli
from tpu_ffv1_torch.cli import play as port_play
from tpu_ffv1_torch.cli import serve as port_serve
from tpu_ffv1_torch.cli.ffserver_conf import parse_config
from tpu_ffv1_torch.codec import twopass
from tpu_ffv1_torch.core import tables as T
from tpu_ffv1_torch.core.crc import crc32_ieee
from tpu_ffv1_torch.core.rac import custom_state_tables
from tpu_ffv1_torch.io.avi import read_avi
from tpu_ffv1_torch.io.nut import read_nut
from tpu_ffv1_torch.io.y4m import read_y4m, write_y4m, write_y4m_stream
from tpu_ffv1_torch.kernels import build, probes
from tpu_ffv1_torch.tpu import decoder as port_decoder
from tpu_ffv1_torch.tpu import encoder as port_encoder
from tpu_ffv1_torch.tpu import (golomb_decode, golomb_encode, rc_decode,
                                 rc_encode, sharding)
from tpu_ffv1_torch.tpu.encoder import PREFIX_CAP, row_bytes
from tpu_ffv1_torch.tpu.finalize import (compact_packed, finalize_compact,
                                         finalize_packed)
from tpu_ffv1_torch.tpu.residual import rct_transform
from tpu_ffv1_torch.tpu.sharding import make_devices

W, H, SLICES, BATCH = 1920, 1080, 24, 2
WARM, TIMED = 1, 6                  # non-key frames after the key frame
SEED = 20261016
GOLDENS = os.path.join(os.path.dirname(tpu_ffv1_torch.__file__), "goldens",
                       "chip_smoke.json")
# H100 SXM peaks (published data-sheet figures): HBM bytes/s, and int32
# instructions/s on the CUDA cores (64 INT32 lanes per SM per clock,
# half the FP32 lanes behind the 67 TFLOP/s figure, at 132 SMs and
# 1.98 GHz)
PEAK_BYTES_S = 3.35e12
PEAK_INT_OPS_S = 132 * 64 * 1.98e9


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- content


def synthetic_streams(n_streams, n_frames, width, height, seed):
    """yuv420p frames: a gradient, noise and a pattern moving 5 px/frame."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    cy, cx = yy[::2, ::2] // 2, xx[::2, ::2] // 2
    out = []
    for s in range(n_streams):
        frames = []
        for t in range(n_frames):
            sh = 5 * t + 17 * s
            pat = ((((xx + sh) // 24) + (yy // 24)) % 2) * 60
            y = (xx * 160 // width + yy * 40 // height + pat +
                 r.randint(0, 12, (height, width)))
            u = 96 + (cx + sh) % 64 + r.randint(0, 4, cx.shape)
            v = 160 - (cy + sh // 2) % 48 + r.randint(0, 4, cy.shape)
            frames.append([np.clip(p, 0, 255).astype(np.uint8)
                           for p in (y, u, v)])
        out.append(frames)
    return out


def synthetic_streams16(n_streams, n_frames, width, height, seed):
    """yuv444p16le frames: the 16-bit archival leg's steep gradient and
    8-bit noise (bench.py bench_16bit_archival) at full size, plus a
    checker pattern of 4096 moving 5 px/frame, whose edges give
    residuals past 2^10 (put_symbol's repeated rows 10 and 31)."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    base = (xx + yy) * 257
    out = []
    for s in range(n_streams):
        frames = []
        for t in range(n_frames):
            sh = 5 * t + 17 * s
            pat = ((((xx + sh) // 24) + (yy // 24)) % 2) * 4096
            frames.append([
                ((base + t * 1031 + k * 7919 + pat +
                  r.randint(0, 255, (height, width))) % 65536)
                .astype(np.uint16) for k in range(3)])
        out.append(frames)
    return out


def synthetic_streams_422p10(n_streams, n_frames, width, height, seed):
    """yuv422p10le frames: the 8-bit path's gradient, noise and a checker
    moving 5 px/frame, at 10 bits (a tape transfer's range), the chroma
    planes half width."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    cw = (width + 1) // 2
    cy, cx = yy[:, :cw], xx[:, :cw]
    out = []
    for s in range(n_streams):
        frames = []
        for t in range(n_frames):
            sh = 5 * t + 17 * s
            pat = ((((xx + sh) // 24) + (yy // 24)) % 2) * 240
            y = (xx * 640 // width + yy * 160 // height + pat +
                 r.randint(0, 48, (height, width)))
            u = 384 + (cx + sh) % 256 + r.randint(0, 16, cx.shape)
            v = 640 - (cy + sh // 2) % 192 + r.randint(0, 16, cy.shape)
            frames.append([np.clip(p, 0, 1023).astype(np.uint16)
                           for p in (y, u, v)])
        out.append(frames)
    return out


def synthetic_streams_bgr0(n_streams, n_frames, width, height, seed):
    """bgr0 frames, each [one (H, W, 4) uint8 array]: in B, G and R the
    8-bit path's gradient, noise and a checker moving 5 px/frame (each
    channel's shifted), the pad byte 0."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    grad = xx * 160 // width + yy * 40 // height
    out = []
    for s in range(n_streams):
        frames = []
        for t in range(n_frames):
            f = np.zeros((height, width, 4), np.uint8)
            for c in range(3):
                sh = 5 * t + 17 * s + 8 * c
                pat = ((((xx + sh) // 24) + (yy // 24)) % 2) * 60
                f[..., c] = np.clip(grad + 20 * c + pat +
                                    r.randint(0, 12, (height, width)),
                                    0, 255)
            frames.append([f])
        out.append(frames)
    return out


def synthetic_streams_gbrp14(n_streams, n_frames, width, height, seed):
    """gbrp14le frames: the RGB archival leg's content (bench.py
    bench_rgb14_archival: a diagonal ramp of step 129 mod 2^14, offset
    per frame and plane, plus 6-bit noise, masked to 14 bits), each
    stream's frames from frame 3 * stream on."""
    r = np.random.RandomState(seed)
    base = np.add.outer(np.arange(height), np.arange(width)) * 129 % 16384
    out = []
    for s in range(n_streams):
        frames = []
        for t in range(n_frames):
            frames.append([
                ((((base + (t + 3 * s) * 1031 + k * 4099) % 16384) +
                  r.randint(0, 63, (height, width))) & 0x3FFF)
                .astype(np.uint16) for k in range(3)])
        out.append(frames)
    return out


def splice_packets(dec, pkt_a, pkt_b):
    """A packet of the same frame's slices from two streams of one
    extradata: the even slices from ``pkt_a``, the odd ones from
    ``pkt_b`` (each slice with its size trailer and CRC; slice 0 from the
    packet's start, with its keyframe bit).  Two encoders at context
    models 0 and 1 write equal extradata, so the result is a valid
    stream whose slices name different quant tables.  ``dec``: a
    TorchFFV1Decoder of that extradata (its slice-trailer walk)."""
    out = bytearray()
    for si, bounds in enumerate(zip(dec._split_slices(pkt_a),
                                    dec._split_slices(pkt_b))):
        pkt = pkt_a if si % 2 == 0 else pkt_b
        start, end = bounds[si % 2]
        out += pkt[:end] if si == 0 else pkt[start:end]
    return bytes(out)


class MainPath(NamedTuple):
    pix_fmt: str
    gen: Callable          # content generator
    seed: int
    context_model: int
    width: int
    height: int
    timed: int             # timed non-key frames after the warm-up
    kernels: tuple         # (encode instance, decode instance or None)
    compact: bool = False  # the compact encode form, encode only
    golden: str = ""       # the path whose golden digests it must match
    coder: int = 2         # 2: range coder (custom table), 0: Golomb-Rice
    bits: int = 8          # the coded width (RGB: one above the samples)
    level: int = 3         # the FFV1 version (4: strict -2)
    dec_groups: int = 1    # decode launches per step (non-uniform grids:
    #                        one per slice size)

    @property
    def frames(self):
        return 1 + WARM + self.timed


# the main paths (BASELINE configs 2 and 3, and both at context model 1;
# the 16-bit one at context model 1 cut to quarter size for time)
PATHS = {
    "8bit": MainPath("yuv420p", synthetic_streams, SEED, 0, W, H, TIMED,
                     ("rc_encode", "rc_decode")),
    "16bit": MainPath("yuv444p16le", synthetic_streams16, SEED + 16, 0, W,
                      H, TIMED, ("rc_encode_ext", "rc_decode_ext"),
                      bits=16),
    "8bit_ctx1": MainPath("yuv420p", synthetic_streams, SEED, 1, W, H,
                          TIMED, ("rc_encode_global",
                                  "rc_decode_five_global")),
    "16bit_ctx1_540p": MainPath("yuv444p16le", synthetic_streams16,
                                SEED + 16, 1, W // 2, H // 2, 2,
                                ("rc_encode_ext_global",
                                 "rc_decode_ext_five_global"), bits=16),
    # the compact encode form of 8bit and 8bit_ctx1 (the same frames and
    # bytes), after them: their warm-up launches are held to those paths'
    "8bit_compact": MainPath("yuv420p", synthetic_streams, SEED, 0, W, H,
                             TIMED, ("rc_encode_compact", None), True,
                             "8bit"),
    "8bit_ctx1_compact": MainPath("yuv420p", synthetic_streams, SEED, 1, W,
                                  H, TIMED, ("rc_encode_compact_global",
                                             None), True, "8bit_ctx1"),
    # BASELINE config 2 with the reference's default coder, Golomb-Rice
    # (ffmpeg -c:v ffv1 -level 3 -slices 24 -slicecrc 1)
    "8bit_golomb": MainPath("yuv420p", synthetic_streams, SEED, 0, W, H,
                            TIMED, ("golomb_encode", "golomb_decode"),
                            coder=0),
    # RGB (colorspace 1): FATE's ffv1-v3-bgr0 configuration at BASELINE
    # config 2's size (coded width 9: K1, B1), and the RGB archival
    # config (bench.py:538-563, 960x540 gbrp14le; coded width 15:
    # K1-ext, B1-ext) with chip_smoke's slices and batch, two timed
    # frames as 16bit_ctx1_540p
    "rgb8": MainPath("bgr0", synthetic_streams_bgr0, SEED + 8, 0, W, H,
                     TIMED, ("rc_encode", "rc_decode_rgb"), bits=9),
    "rgb14_540p": MainPath("gbrp14le", synthetic_streams_gbrp14, SEED + 14,
                           0, W // 2, H // 2, 2,
                           ("rc_encode_ext", "rc_decode_ext_rgb"), bits=15),
    # version 4 (the per-slice RCT search, the row budget): bench.py:806's
    # bgr0_v4 leg at BASELINE config 2's size with rgb8's content, and
    # the 16-bit archival content at 540p as 16bit_ctx1_540p, for time
    "rgb8_v4": MainPath("bgr0", synthetic_streams_bgr0, SEED + 8, 0, W, H,
                        TIMED, ("rc_encode", "rc_decode_rgb"), bits=9,
                        level=4),
    "16bit_v4_540p": MainPath("yuv444p16le", synthetic_streams16, SEED + 16,
                              0, W // 2, H // 2, 2,
                              ("rc_encode_ext", "rc_decode_ext"), bits=16,
                              level=4),
    # non-uniform grids at FFmpeg's -slices 24 (6 x 4): 720p masters
    # (1280 = 6 x 213.3: slices 213 and 214 wide, two lane lengths, two
    # K2 launches per step), and the archival recipe for SD tape
    # transfers (-c:v ffv1 -level 3 -context 1 -slices 24 -slicecrc 1)
    # at NTSC's 720x486 in 10-bit 4:2:2 (486 = 4 x 121.5: slices 121
    # and 122 high; two K2-five launches per step)
    "720p": MainPath("yuv420p", synthetic_streams, SEED + 72, 0, 1280, 720,
                     TIMED, ("rc_encode", "rc_decode"), dec_groups=2),
    "ntsc10_ctx1": MainPath("yuv422p10le", synthetic_streams_422p10,
                            SEED + 10, 1, 720, 486, TIMED,
                            ("rc_encode_global", "rc_decode_five_global"),
                            bits=10, dec_groups=2),
}
# mixed_q: the packets of these two paths spliced (splice_packets), a
# decode-only phase (see mixed_q_phase)
MIXED_Q = ("8bit", "8bit_ctx1")
# nonuniform_ext: version 4 on a grid of four slice sizes (see
# nonuniform_phase)
NU_W, NU_H, NU_FRAMES, NU_SEED = 203, 69, 3, SEED + 203


def nonuniform_kw():
    """EncoderParams fields of nonuniform_ext: 203x69 yuv444p16le at
    version 4 in a 2 x 2 grid (widths 101 and 102, heights 34 and 35:
    four lane lengths), GOP 2."""
    return dict(width=NU_W, height=NU_H, pix_fmt="yuv444p16le", level=4,
                strict=-2, coder=2, slices=4, gop_size=2)


def synthetic_streams_nonuniform():
    """nonuniform_ext's content, 2 streams x 3 frames: the 16-bit
    archival content at its size."""
    return synthetic_streams16(BATCH, NU_FRAMES, NU_W, NU_H, NU_SEED)


# FFV1-P, the fork's inter codec (see pframe_phase): BASELINE config 4's
# configuration (bench.py:660-717: 12 slices, GOP 12), batch 2
P_SLICES, P_GOP = 12, 12


def pan_order(frames, n_streams, n_frames):
    """bench.py bench_pframe_720p's frame order over its eight frames:
    stream s keys on frames[s % 8], then takes frames[1 + (s + k) % 7]
    at P step k, so the streams' lanes see different motion."""
    return [[frames[s % 8]] + [frames[1 + (s + k) % 7]
                               for k in range(n_frames - 1)]
            for s in range(n_streams)]


def synthetic_streams_pan(n_streams, n_frames, width, height, seed):
    """yuv420p: bench_pframe_720p's pan, a diagonal ramp mod 256 moving
    by (2t, 3t) per frame plus noise 0-7, chroma 100 and 160 plus noise
    0-7, in bench's order (``pan_order``)."""
    r = np.random.RandomState(seed)
    base = np.add.outer(np.arange(height + 64), np.arange(width + 64)) % 256
    frames = []
    for t in range(8):
        y = base[2 * t:2 * t + height, 3 * t:3 * t + width] + \
            r.randint(0, 8, (height, width))
        u = r.randint(0, 8, (height // 2, width // 2)) + 100
        v = r.randint(0, 8, (height // 2, width // 2)) + 160
        frames.append([p.astype(np.uint8) for p in (y, u, v)])
    return pan_order(frames, n_streams, n_frames)


def synthetic_streams_pan10(n_streams, n_frames, width, height, seed):
    """yuv422p10le: the 10-bit 4:2:2 P content of tests/test_pframe_tpu.py
    (test_tpu_pframe_10bit_422) at size, a ramp of step 9 mod 1024
    moving by (t, 2t) per frame plus noise 0-23, chroma noise 0-39 over
    300 and 600 at half width, in bench's order (``pan_order``)."""
    r = np.random.RandomState(seed)
    base = np.add.outer(np.arange(height + 32), np.arange(width + 32)) * 9 \
        % 1024
    frames = []
    for t in range(8):
        y = (base[t:t + height, 2 * t:2 * t + width] +
             r.randint(0, 24, (height, width))) & 1023
        u = r.randint(0, 40, (height, width // 2)) + 300
        v = r.randint(0, 40, (height, width // 2)) + 600
        frames.append([p.astype(np.uint16) for p in (y, u, v)])
    return pan_order(frames, n_streams, n_frames)


class PPath(NamedTuple):
    pix_fmt: str
    gen: Callable          # content generator
    seed: int
    width: int
    height: int
    timed: int             # timed P frames after the warm-up
    me: str                # the motion search
    kernels: tuple         # (P encode instance, P decode instance or None)
    key_kernel: str        # the keyframe's encode instance
    p_bits: int            # the residuals' coded width

    @property
    def frames(self):
        return 1 + WARM + self.timed


P_PATHS = {
    # BASELINE config 4: 720p P frames (bench.py:660-717), full search
    "pframe_720p": PPath("yuv420p", synthetic_streams_pan, SEED + 41, 1280,
                         720, TIMED, "full", ("rc_encode", "rc_decode"),
                         "rc_encode", 9),
    # the same with the predictor-seeded search (FFV1_BENCH_ME=epzs),
    # encode only: the decoder does not see the search, and its K2 launch
    # is pframe_720p's at the same shape (a plain check of 173 s saved)
    "pframe_720p_epzs": PPath("yuv420p", synthetic_streams_pan, SEED + 41,
                              1280, 720, 2, "epzs", ("rc_encode", None),
                              "rc_encode", 9),
    # config 5's codec shape on one card (tests/test_pframe_tpu.py:170-200):
    # 240x180 slices (pad_h 12); encode only, as the P decoder refuses
    # more than 8 bits
    "pframe_422p10_540p": PPath("yuv422p10le", synthetic_streams_pan10,
                                SEED + 42, 960, 540, 2, "full",
                                ("rc_encode_ext", None), "rc_encode", 11),
}


def p_params_kw(name):
    """EncoderParams fields of a P path."""
    p = P_PATHS[name]
    return dict(width=p.width, height=p.height, pix_fmt=p.pix_fmt, level=3,
                coder=2, slices=P_SLICES, gop_size=P_GOP)


def p_streams(name):
    """A P path's content, made once per generator, seed and size."""
    p = P_PATHS[name]
    key = (p.gen, p.seed, p.width, p.height, p.frames)
    if key not in _STREAMS:
        _STREAMS[key] = p.gen(BATCH, p.frames, p.width, p.height, p.seed)
    return _STREAMS[key]


_STREAMS: dict = {}


def params_kw(name):
    """EncoderParams fields of a main path."""
    p = PATHS[name]
    return dict(width=p.width, height=p.height, pix_fmt=p.pix_fmt,
                level=p.level, coder=p.coder, slices=SLICES,
                context_model=p.context_model,
                **({"strict": -2} if p.level > 3 else {}))


# v4_pcm: version 4's PCM retry on the card (see pcm_phase)
PCM_W, PCM_H, PCM_FRAMES, PCM_SEED = 512, 4, 3, SEED + 4


def pcm_kw():
    """EncoderParams fields of v4_pcm: 512x4 yuv444p16le in a 2 x 2 grid,
    each slice's budget 10,240 bytes against w * 35 = 8,960 at its line
    starts."""
    return dict(width=PCM_W, height=PCM_H, pix_fmt="yuv444p16le", level=4,
                strict=-2, coder=2, slices=4, gop_size=3)


def synthetic_streams_pcm():
    """v4_pcm's content, 2 streams x 3 frames: stream 0 16-bit noise, a
    smooth ramp, noise (its slices overflow the row budget in frames 0
    and 2); stream 1 the ramp in every frame."""
    r = np.random.RandomState(PCM_SEED)
    yy, xx = np.mgrid[0:PCM_H, 0:PCM_W]

    def ramp(t):
        return [((xx * 16 + yy * 3 + 100 * t + 7 * k) % 65536)
                .astype(np.uint16) for k in range(3)]

    def noise():
        return [r.randint(0, 65536, (PCM_H, PCM_W)).astype(np.uint16)
                for _ in range(3)]

    return [[noise() if t != 1 else ramp(t) for t in range(PCM_FRAMES)],
            [ramp(t) for t in range(PCM_FRAMES)]]


# twopass: two-pass encoding (see twopass_phase).  Its small cuts (pass
# 1's statistics held to the host spec encoder's digests): name ->
# (pix_fmt, width, height, seed); 2 streams x 2 frames, 24 slices, coder
# 2, context model 0
TWOPASS_CUTS = {"8bit": ("yuv420p", 256, 144, SEED + 21),
                "16bit": ("yuv444p16le", 128, 72, SEED + 22)}
TWOPASS_CUT_FRAMES = 2
# the 8bit path's first frames, through pass 1 and pass 2 at 1080p
TWOPASS_FRAMES = 4
# the probabilities i whose find_best_state rows the plain version checks:
# the edges (candidates i - 10 below 1, i + 10 past 255) and the middle
TWOPASS_FBS_ROWS = (0, 1, 5, 10, 11, 64, 127, 128, 129, 200, 245, 246,
                    254, 255)
# the stats instances, each checked on random inputs
STATS_INSTANCES = ("rc_encode_stats", "rc_encode_stats_global",
                   "rc_encode_ext_stats", "rc_encode_ext_stats_global")
# H100 SXM FP64 rate outside the tensor cores (data sheet): the
# operations term of find_best_state's bound
PEAK_FP64_S = 34e12


def twopass_cut_kw(name):
    """EncoderParams fields of a twopass small cut."""
    pix_fmt, w, h, _seed = TWOPASS_CUTS[name]
    return dict(width=w, height=h, pix_fmt=pix_fmt, level=3, coder=2,
                slices=SLICES, context_model=0)


def twopass_cut_streams(name):
    """A twopass small cut's content: 8bit's and 16bit's generators at the
    cut's size."""
    _pix, w, h, seed = TWOPASS_CUTS[name]
    gen = synthetic_streams if name == "8bit" else synthetic_streams16
    return gen(BATCH, TWOPASS_CUT_FRAMES, w, h, seed)


# ya8: gray + alpha at 1080p, both coders (see ya8_phase)
YA8_FRAMES, YA8_GOP, YA8_SEED = 3, 2, SEED + 88
# path -> (coder, (encode instance, decode instance))
YA8 = {"ya8": (2, ("rc_encode", "rc_decode")),
       "ya8_golomb": (0, ("golomb_encode", "golomb_decode"))}


def ya8_kw(name):
    """EncoderParams fields of a ya8 path: 1080p ya8, 24 slices, GOP 2."""
    return dict(width=W, height=H, pix_fmt="ya8", level=3,
                coder=YA8[name][0], slices=SLICES, gop_size=YA8_GOP)


def synthetic_streams_ya8(n_streams, n_frames, width, height, seed):
    """ya8 frames, each [one (H, W, 2) uint8 array]: in luma the 8-bit
    path's gradient, noise and checker moving 5 px/frame; in alpha a
    key's matte, a disc moving 7 px/frame (opaque inside, clear outside)
    with a soft, noisy edge 24 px wide."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    out = []
    for s in range(n_streams):
        frames = []
        for t in range(n_frames):
            sh = 5 * t + 17 * s
            pat = ((((xx + sh) // 24) + (yy // 24)) % 2) * 60
            f = np.empty((height, width, 2), np.uint8)
            f[..., 0] = np.clip(xx * 160 // width + yy * 40 // height + pat +
                                r.randint(0, 12, (height, width)), 0, 255)
            dist = np.hypot(xx - width // 2 - 7 * t - 31 * s,
                            yy - height // 2)
            edge = (height // 3 + 12 - dist) * (255 / 24)
            f[..., 1] = np.clip(edge + r.randint(-6, 7, (height, width)),
                                0, 255)
            frames.append([f])
        out.append(frames)
    return out


def ya8_streams():
    """The ya8 paths' content, made once."""
    key = ("ya8", YA8_SEED)
    if key not in _STREAMS:
        _STREAMS[key] = synthetic_streams_ya8(BATCH, YA8_FRAMES, W, H,
                                              YA8_SEED)
    return _STREAMS[key]


def path_streams(name):
    """A path's content, made once per generator, seed and size."""
    p = PATHS[name]
    key = (p.gen, p.seed, p.width, p.height, p.frames)
    if key not in _STREAMS:
        _STREAMS[key] = p.gen(BATCH, p.frames, p.width, p.height, p.seed)
    return _STREAMS[key]


def digest(data: bytes) -> dict:
    return {"sha256": hashlib.sha256(data).hexdigest(), "len": len(data)}


def load_goldens() -> dict:
    with open(GOLDENS) as f:
        return json.load(f)


# ------------------------------------------------------------- timing


def cuda_time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def launch_ms(fn):
    """CUDA-event time of one call of fn, alone on the stream."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def host_time_ms(fn):
    """Host clock around fn, synchronised on both sides; (ms, result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def flat_outputs(out):
    """Kernel outputs as a flat list of tensors (planes tuple unpacked; a
    kernel with one output, rc_stats_rows, may give it bare)."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in (o if isinstance(o, tuple) else (o,))]


def roofline_ms(nbytes, nops):
    """(bound ms, "bytes" or "operations"): the larger of bytes over the
    HBM rate and integer operations over the CUDA cores' int32 rate."""
    tb = nbytes / PEAK_BYTES_S * 1e3
    to = nops / PEAK_INT_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def decisions_per_lane(diff, active):
    """Binary decisions each lane codes (its serial chain): per active
    pixel the zero flag, and for a nonzero residual e + 1 exponent
    decisions, e mantissa bits and the sign."""
    a = diff.long().abs()
    e = torch.frexp(a.clamp(min=1).double())[1].long() - 1
    per_px = 1 + (a != 0).long() * (2 * e + 2)
    return (per_px * active.long()).sum(dim=1)


class LastLaunch:
    """Stands in for a kernel wrapper where a port module calls it, and
    keeps the inputs (cloned before the call) and outputs of the calls
    made while ``armed``.  The wrapper itself still counts launches."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.armed = False
        self.calls = []
        setattr(module, name, self)

    def __call__(self, *args):
        if self.armed:
            args_kept = tuple(a.clone() if isinstance(a, torch.Tensor)
                              else a for a in args)
        out = self.fn(*args)
        if self.armed:
            self.calls.append((args_kept, out))
        return out

    def take(self):
        """(args, out) of the last recorded call, (None, None) if none;
        forgets every recorded call."""
        calls = self.take_all()
        return calls[-1] if calls else (None, None)

    def take_all(self):
        """[(args, out)] of the recorded calls in order; forgets them."""
        calls, self.calls = self.calls, []
        return calls


# ------------------------------------------------------- chain probe


def chain_probe_ns(dev, mode, n=1 << 20):
    """ns per dependent decision of one warp (mode 0 encode, 1 decode),
    csrc/chain_probe.cu timed with CUDA events."""
    r = np.random.RandomState(SEED + mode)
    states = torch.from_numpy(r.randint(1, 256, 32).astype(np.uint8)).to(dev)
    data = torch.from_numpy(r.randint(0, 256, 32).astype(np.uint8)).to(dev)
    out = torch.zeros(3, dtype=torch.int32, device=dev)
    fn = build.load("chain_probe").chain_probe_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]

    def run(k):
        err = fn(states.data_ptr(), data.data_ptr(), k, mode,
                 out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"chain probe launch failed: CUDA error {err}")

    run(1024)
    ms = cuda_time_ms(lambda: run(n), 3)
    return ms * 1e6 / n


def row_probe_ns(dev, rows=2 * T.CONTEXT_COUNTS[1], n=1 << 16):
    """ns per dependent 32-byte row read from L2 on one warp
    (csrc/chain_probe.cu row_probe_kernel, CUDA events), over a table of
    one lane's context-model-1 size whose rows form one random cycle:
    bytes 0 and 1 of a row hold the next row's index.  Its first lap is
    held against the plain loop (probes.row_walk_ref, thread 0)."""
    host = probes.cycle_table(rows, SEED + 2)
    table = torch.from_numpy(host).to(dev)
    out = torch.zeros(2, dtype=torch.int32, device=dev)
    fn = build.load("chain_probe").row_probe_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]

    def run(k):
        err = fn(table.data_ptr(), k, out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"row probe launch failed: CUDA error {err}")

    run(rows)                       # one lap: the table is in L2
    check(torch.equal(out.cpu(), probes.row_walk_ref(host, rows)[0]),
          "row probe differs from its plain loop")
    ms = cuda_time_ms(lambda: run(n), 3)
    check(0 <= int(out[0]) < rows, "row probe left the table")
    return ms * 1e6 / n


def smem_probe_ns(dev, mode, n=1 << 20):
    """ns per dependent shared-memory lookup on one warp
    (probes.smem_probe, CUDA events): ``row`` a 32-byte row of context
    model 0's table (1,332 rows as one random cycle), ``byte`` K1's
    transition lookup in the custom state table.  A launch of 4,096
    lookups is held against the plain loop first."""
    if mode == "row":
        host = probes.cycle_table(2 * T.CONTEXT_COUNTS[0], SEED + 3)
    else:
        host = custom_state_tables(T.VER2_STATE)[0]
    table = torch.from_numpy(host).to(dev)
    got = probes.smem_probe(table, 4096, mode)
    check(torch.equal(got.cpu(), probes.smem_probe(torch.from_numpy(host),
                                                   4096, mode)),
          f"shared-memory {mode} probe differs from its plain loop")
    return cuda_time_ms(lambda: probes.smem_probe(table, n, mode), 3) * \
        1e6 / n


def golomb_step_ns(dev, mode, n=1 << 20):
    """ns per dependent step on one warp of probes.golomb_step
    (csrc/golomb_probe.cu) in ``mode``: a VLC-coded pixel ("encode", G1's;
    "decode", G2's), a run step ("run_encode": a completed run chunk of
    G1's run machine; "run_decode": a pixel inside a run, G2's), on
    context model 0's table (1,332 rows), timed with CUDA events.  A
    launch of 4,096 steps is held against the plain loop first."""
    host = probes.golomb_step_inputs(2 * T.CONTEXT_COUNTS[0], mode,
                                     SEED + 4 + (mode == "decode"))
    args = [torch.from_numpy(a).to(dev) for a in host]
    got = probes.golomb_step(*args, 4096, mode)
    check(torch.equal(got.cpu(), probes.golomb_step_ref(*host, 4096, mode)),
          f"Golomb-Rice {mode} step probe differs from its plain loop")
    return cuda_time_ms(lambda: probes.golomb_step(*args, n, mode), 3) * \
        1e6 / n


def golomb_vlc_pixels(ctx, diff, active, flags, cc):
    """int64 (L,): the VLC-coded pixels of each lane of a G1 launch, and of
    the G2 launch that decodes its bytes (the same decisions).  A pixel is
    in a run when the last pixel of its line up to it (itself included)
    whose context is its plane's context 0 lies after the last one before
    it with a nonzero residual (csrc/golomb_encode.cu's run machine:
    inactive pixels change nothing, a line start ends the run); a run
    pixel with a zero residual costs the run's count, any other active
    pixel (the break's pixel too) a VLC symbol."""
    c, d = ctx.cpu().numpy(), diff.cpu().numpy()
    a, f = active.cpu().numpy().astype(bool), flags.cpu().numpy()
    pos = np.arange(c.shape[1])

    def last(mask):                # the last position <= i where mask
        return np.maximum.accumulate(np.where(mask, pos, -1), axis=-1)

    start = last((f & golomb_encode.FLAG_LINE_START) != 0)
    base = ((f & 0xFFFF) >> golomb_encode.FLAG_SPLANE_SHIFT) * cc
    enter = last(a & (c == base))
    brk = last(a & (d != 0))
    brk_before = np.concatenate([np.full((c.shape[0], 1), -1),
                                 brk[:, :-1]], axis=1)
    in_run = (enter >= 0) & (enter >= start) & (enter > brk_before)
    return torch.from_numpy((a & ~(in_run & (d == 0))).sum(1))


def golomb_run_work(ctx, diff, active, flags, cc):
    """(run_steps, run_px), int64 numpy (L,) each: the run work of each
    lane of a G1 launch, and of the G2 launch that decodes its bytes.
    run_steps: the steps of G1's run machine, one per completed run chunk
    (2^log2_run[run_index] zero residuals), per break and per line-end
    flush; run_px: the zero-residual pixels inside runs, each one step of
    G2's median recurrence.  For flags as make_flags gives them (lines
    from line start to line end, plane starts on line starts); each run
    is walked once, from its entry (an active pixel of the plane's
    context 0) to its break (the next active nonzero residual) or the
    line's end, with run_index carried through the plane."""
    c, d = ctx.cpu().numpy(), diff.cpu().numpy()
    a, f = active.cpu().numpy().astype(bool), flags.cpu().numpy()
    starts = np.flatnonzero(f & golomb_encode.FLAG_LINE_START)
    ends = np.append(starts[1:], len(f))
    plane = (f & golomb_encode.FLAG_PLANE_START) != 0
    base = ((f & 0xFFFF) >> golomb_encode.FLAG_SPLANE_SHIFT) * cc
    l2run = np.append(T.LOG2_RUN, 0)
    steps = np.zeros(c.shape[0], np.int64)
    run_px = np.zeros(c.shape[0], np.int64)
    for lane in range(c.shape[0]):
        enter = np.flatnonzero(a[lane] & (c[lane] == base))
        brk = np.flatnonzero(a[lane] & (d[lane] != 0))
        acc = np.concatenate([[0], np.cumsum(a[lane])])
        ri = 0
        for s, e in zip(starts, ends):
            ri = 0 if plane[s] else ri
            i = s
            while True:
                k = np.searchsorted(enter, i)
                if k == len(enter) or enter[k] >= e:
                    break
                j = enter[k]
                kb = np.searchsorted(brk, j)
                b = brk[kb] if kb < len(brk) and brk[kb] < e else e
                z = int(acc[b] - acc[j])            # the run's zeros
                run_px[lane] += z
                rc = 0
                while z:
                    size = 1 << int(l2run[min(ri, 41)])
                    if rc + z < size:
                        rc += z
                        break
                    z -= size - rc
                    rc = 0
                    ri += 1
                    steps[lane] += 1
                if b < e:                           # the break
                    steps[lane] += 1
                    ri = max(ri - 1, 0)
                    i = b + 1
                else:                               # the line-end flush
                    steps[lane] += int(rc > 0 and a[lane, e - 1])
                    break
    return steps, run_px


def sass_functions(name, build_dir=None):
    """{kernel instance: [(address, SASS instruction)]} of lib<name>.so,
    from ``cuobjdump -sass``; an instance is named by its function and
    template arguments, e.g. ``rc_encode_kernel<8,0,0,15>`` (BITS, GTAB,
    COMPACT, STAGES)."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    lib = os.path.join(build_dir or build.BUILD_DIR, f"lib{name}.so")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    res = {}
    for func in re.split(r"Function : ", sass)[1:]:
        m = re.match(r"_Z(\d+)", func)
        fname = func[m.end():m.end() + int(m.group(1))]
        rest = func[m.end() + int(m.group(1)):].split(None, 1)[0]
        targs = re.findall(r"L[a-z](\d+)E", rest.split("Ev", 1)[0]) \
            if rest.startswith("I") else []
        label = fname + (f"<{','.join(targs)}>" if targs else "")
        res[label] = [(int(a, 16), t.strip()) for a, t in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
    return res


def pixel_loop_count(ins, marker="SHFL"):
    """SASS instructions (branches and NOPs left out) of a lane scan's
    per-pixel loop: of the spans from a backward branch's target to the
    branch, the innermost of those with the most instructions named
    ``marker`` (shuffles in the range-coder scans, whose pixels take
    their bytes by shuffle; the empty marker, every instruction, in the
    Golomb-Rice step probe, whose step loop is its largest)."""
    best = (0, 0, 0)                  # (markers, -span, instructions)
    for addr, text in ins:
        m = re.search(r"\bBRA\S*\s+0x([0-9a-f]+)", text)
        if not m or int(m.group(1), 16) >= addr:
            continue
        body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
        best = max(best, (sum(marker in t for t in body), -len(body),
                          sum(1 for t in body
                              if not re.search(r"\b(BRA|NOP)\b", t))))
    return best[2]


def probe_sass_ops():
    """(encode, decode) SASS instructions of one decision, from
    ``cuobjdump -sass`` of csrc/chain_probe.cu's two kernel instances:
    the instructions of each instance's main loop (the span from a
    backward branch's target to the branch with the most shuffles in
    it), less the branch, over the decisions it unrolls: one shuffle per
    decision in the encode form, two in the decode form."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    lib = os.path.join(build.BUILD_DIR, "libchain_probe.so")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    res = {}
    for func in re.split(r"Function : ", sass)[1:]:
        mode = re.match(r"_Z\d+chain_probe_kernelILi(\d)E", func)
        if not mode:
            continue
        ins = [(int(a, 16), t.strip()) for a, t in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
        best = (0, 0)                      # (shuffles, instructions)
        for addr, text in ins:
            m = re.search(r"\bBRA\S*\s+0x([0-9a-f]+)", text)
            if not m or int(m.group(1), 16) >= addr:
                continue
            body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
            best = max(best, (sum("SHFL" in t for t in body),
                              sum(1 for t in body
                                  if not re.search(r"\b(BRA|NOP)\b", t))))
        per = 1 + int(mode.group(1))       # shuffles per decision
        check(best[0] > 0 and best[0] % per == 0,
              f"chain probe SASS, mode {mode.group(1)}: no loop of whole "
              f"decisions found (shuffles, instructions) = {best}")
        res[int(mode.group(1))] = best[1] / (best[0] // per)
    check(sorted(res) == [0, 1], "chain probe SASS: a kernel instance is "
          "missing")
    return res[0], res[1]


# -------------------------------------------- kernel checks, random


def random_encode_args(dev, bits, L, N, CC, seed, states_lo=16):
    """Codec-like K1 / K1-ext inputs: mostly small residuals, 5% over the
    whole folded range, the fold's extremes, 3% inactive pixels; states
    from states_lo..256 - states_lo."""
    r = np.random.RandomState(seed)
    half = 1 << (bits - 1)
    one, zero = custom_state_tables(T.VER2_STATE)
    ctx = r.randint(0, CC, (L, N))
    diff = r.randint(-4, 5, (L, N))
    big = r.rand(L, N) < 0.05
    diff = np.where(big, r.randint(-half, half, (L, N)), diff)
    diff[:, :3] = [-half, half - 1, 0]
    act = r.rand(L, N) < 0.97
    states = r.randint(states_lo, 257 - states_lo, (L, CC, 32))
    return [torch.from_numpy(np.ascontiguousarray(a).astype(t)).to(dev)
            for a, t in ((ctx, np.int32), (diff, np.int32), (act, np.bool_),
                         (states, np.uint8), (one, np.uint8),
                         (zero, np.uint8), (np.zeros(L), np.int32),
                         (np.full(L, 0xFF00), np.int32))]


def uniform_exponent_residuals(r, bits, shape):
    """Residuals whose exponent e = floor(log2 |v|) is drawn uniformly
    from 0..bits-1 (random lower bits and sign), 10% of them zero: above
    10 bits e = 8, 9 and 10, where the running rows 10 and 31 begin, are
    as common as any other."""
    e = r.randint(0, bits, shape)
    a = (1 << e) | (r.randint(0, 1 << 30, shape) & ((1 << e) - 1))
    v = np.where(r.rand(*shape) < 0.5, -a, a)
    return np.where(r.rand(*shape) < 0.1, 0, v)


def edge_encode_args(dev, bits, L, N, CC, seed):
    """K1 / K1-ext inputs that reach the edges of their design: runs of
    2-64 equal contexts (the global-table read-ahead's forwarding; above
    10 bits the running rows 10 and 31 carried from pixel to pixel), one
    across the chunk boundary at pixel 32 in every lane, blocks of
    inactive pixels, blocks of zero residuals (the zero flag alone),
    residuals at +-2^(bits-1) (the longest exponent run and mantissa)
    alone and in runs of one context; between them codec-like residuals
    (above 10 bits exponents drawn uniformly, uniform_exponent_residuals);
    states from 1..255."""
    r = np.random.RandomState(seed)
    half = 1 << (bits - 1)
    one, zero = custom_state_tables(T.VER2_STATE)
    ctx = r.randint(0, CC, (L, N))
    if bits > 10:
        diff = uniform_exponent_residuals(r, bits, (L, N))
    else:
        diff = np.where(r.rand(L, N) < 0.1,
                        r.randint(-half, half + 1, (L, N)),
                        r.randint(-4, 5, (L, N)))
    act = r.rand(L, N) < 0.97
    for lane in range(L):
        p = 0
        while p < N:
            q = min(N, p + r.randint(2, 65))
            kind = r.randint(6)
            if kind in (0, 4):                 # a run of one context
                ctx[lane, p:q] = ctx[lane, p]
            if kind == 1:
                act[lane, p:q] = False
            elif kind == 2:
                diff[lane, p:q] = 0
            elif kind in (3, 4):
                diff[lane, p:q] = r.choice([-half, half], q - p)
            p = q
    ctx[:, 20:80] = ctx[:, 20:21]              # across the chunk boundary
    states = r.randint(1, 256, (L, CC, 32))
    return [torch.from_numpy(np.ascontiguousarray(a).astype(t)).to(dev)
            for a, t in ((ctx, np.int32), (diff, np.int32), (act, np.bool_),
                         (states, np.uint8), (one, np.uint8),
                         (zero, np.uint8), (r.randint(0, 1 << 16, L), np.int32),
                         (r.randint(0x100, 0x10000, L), np.int32))]


def check_encode_kernel(dev, bits, N, context_model, compact=False,
                        edges=False):
    """K1 / K1-ext (or, with ``compact``, K1-compact, its states drawn
    from 1..255 so that some pixels emit more than 4 bytes) on random
    codec-like inputs at L=48 and the two state planes of the context
    model (CC = 1,332 or 15,126: the table in shared or in global
    memory), timed; with ``edges``, on ``edge_encode_args`` instead (K1
    at 8-10 bits, K1-ext at 11, 16 and 17).
    Returns (instance, its numbers, the launch's (args, outputs)) for
    the plain check (``plain_checks``)."""
    L = BATCH * SLICES
    CC = 2 * T.CONTEXT_COUNTS[context_model]
    seed = SEED + bits + 100 * context_model + 1000 * compact
    args = (*(edge_encode_args(dev, bits, L, N, CC, seed + 5000) if edges
              else random_encode_args(dev, bits, L, N, CC, seed,
                                      1 if compact else 16)), bits)
    name = rc_encode.instance(bits, CC, compact)
    fn = rc_encode.rc_encode_compact if compact else \
        rc_encode.rc_encode_packed
    got = fn(*args)
    label = "edge inputs" if edges else "random residuals"
    if compact:
        check(bool((got[0][:, 4] > 0).any()), "kernel emitted nothing")
        over = int(got[0][:, 5].sum())
        check(edges or over > 0, "no pixel overflowed the compact form")
        label += f", states 1..255, {over} overflowing pixels"
    else:
        check(bool(((got[0] >> 20) & 1).sum() > 0), "kernel emitted nothing")
    ms = cuda_time_ms(lambda: fn(*args), 5)
    shape = f"bits={bits} L={L} N={N} CC={CC} S={got[0].shape[1]}"
    log(f"[kernels] {name} {shape} {label}: kernel {ms:.3f} ms")
    return name, dict(check_ms=ms, check_shape=shape, label=label), \
        (args, got)


def check_stats_kernel(dev, bits, N, context_model):
    """The stats instance of K1 (8 bits) or K1-ext (16 bits) on random
    codec-like inputs (states from 1..255) at L = 8 and the two state
    planes of the context model (the table in shared or in global
    memory), timed.  Returns [(instance, its numbers, the launch's (args,
    outputs))] for the plain check (``plain_checks``): K1's as its two
    kernels, the stats scan and the row counts (``stats_recs``)."""
    L = 8
    CC = 2 * T.CONTEXT_COUNTS[context_model]
    args = (*random_encode_args(dev, bits, L, N, CC,
                                SEED + 7000 + bits + 100 * context_model, 1),
            bits)
    got = rc_encode.rc_encode_stats(*args)
    name = rc_encode.instance(bits, CC, stats=True)
    decisions = decisions_per_lane(args[1], args[2])
    check(torch.equal(got[4].sum((1, 2)).long(), decisions) and
          torch.equal(got[5].sum((1, 2, 3)).long(), decisions),
          f"{name}: the counts do not add up to the decisions")
    label = "random residuals, states 1..255"
    res = []
    for kname, rec, _split, _label, ms in stats_recs((args, got), False,
                                                     label):
        shape = f"bits={bits} L={L} N={N} CC={CC} S={got[0].shape[1]}"
        log(f"[kernels] {kname} {shape} {label}: kernel {ms:.3f} ms")
        res.append((kname, dict(check_ms=ms, check_shape=shape, label=label),
                    rec))
    return res


def decode_args_from_packets(dec, pkts, bits):
    parsed = [dec._parse_packet(bi, p) for bi, p in enumerate(pkts)]
    (bufs, lows, ranges, poss), _lens, q = dec._lane_inputs(parsed)
    cc = dec.g.context_counts[q]
    specs = tuple((pw, ph, sp * cc) for (pw, ph, sp) in dec._plane_specs())
    states = dec._fresh(q)[None].repeat(dec.L, 1, 1)
    five = bool(dec.g.quant_tables[q][3][127])
    return (bufs, states, dec.one_tab, dec.zero_tab, dec.qts[q], lows,
            ranges, poss, specs, bits, five)


def decode_instance(args):
    """The kernel instance rc_decode_planes launches on ``args``."""
    specs, bits, five = args[8:11]
    return rc_decode.instance(bits, five, args[1].shape[1],
                              max(w for (w, _h, _b) in specs))


def check_decode_args(args, label, lossless=None):
    """K2 / K2-ext (with or without the 5-input context) on ``args``,
    timed, lane 0 held to ``lossless`` where given; returns (instance,
    its numbers, the launch's (args, outputs)) for the plain check."""
    name = decode_instance(args)
    got = rc_decode.rc_decode_planes(*args)
    if lossless is not None:
        check(np.array_equal(got[0][0][0].cpu().numpy(), lossless),
              f"{name} decode of lane 0 is not lossless ({label})")
    ms = cuda_time_ms(lambda: rc_decode.rc_decode_planes(*args), 5)
    shape = (f"bits={args[9]} L={args[0].shape[0]} CC={args[1].shape[1]} "
             f"planes={args[8]}")
    log(f"[kernels] {name} {shape} {label}: kernel {ms:.3f} ms")
    return name, dict(check_ms=ms, check_shape=shape, label=label), \
        (args, got)


def check_decode_kernel(dev, context_model):
    """K2 / K2-five on the port's own 8-bit encode of 384x256 yuv420p, 24
    slices, 2 streams (48 lanes of 64x64 + 2 x 32x32)."""
    w, h = 384, 256
    params = EncoderParams(width=w, height=h, pix_fmt="yuv420p", level=3,
                           coder=2, slices=SLICES,
                           context_model=context_model)
    streams = synthetic_streams(BATCH, 1, w, h, SEED + 1)
    enc = TorchFFV1Encoder(params, batch=BATCH, device=dev)
    pkts = [p for p, _kf in enc.encode_frames([s[0] for s in streams])]
    dec = TorchFFV1Decoder(w, h, enc.extradata, batch=BATCH, device=dev)
    args = decode_args_from_packets(dec, pkts, 8)
    return [check_decode_args(args, f"port-encoded stream, context model "
                              f"{context_model}",
                              streams[0][0][0][:64, :64])]


def check_decode_random_bytes(dev, bits, five, context_model):
    """One of K2's (bits <= 10) or K2-ext's four instances (``five``: the
    5-input context; the
    context model's table size: 2 x 666 rows in shared memory, or 2 x
    7,563 in global memory) on random bytes at L=48: garbage symbols
    (exponents up to the width with no stop decision, clamped contexts),
    planes 40, 33, 2 and 1 wide (the row borders, the context computed a
    warp's 32 columns at a time and its edge), and every third lane's
    coder started 8 bytes before its buffer's end (reads at pos >= cap
    give 0)."""
    L, cap = BATCH * SLICES, 4096
    CC = T.CONTEXT_COUNTS[context_model]
    r = np.random.RandomState(SEED + 300 + bits + 20 * five +
                              50 * context_model)
    one, zero = custom_state_tables(T.VER2_STATE)
    bufs = r.randint(0, 256, (L, cap)).astype(np.uint8)
    pos0 = np.where(np.arange(L) % 3 == 2, cap - 8, 2).astype(np.int32)
    low0 = np.minimum(bufs[np.arange(L), pos0 - 2].astype(np.int32) << 8 |
                      bufs[np.arange(L), pos0 - 1], 0xFEFF)
    qt = T.default_quant_tables(bits)[int(five)].astype(np.int32)
    rnd = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        bufs, r.randint(16, 241, (L, 2 * CC, 32)).astype(np.uint8), one,
        zero, qt, low0.astype(np.int32), np.full(L, 0xFF00, np.int32),
        pos0)]
    specs = ((40, 16, 0), (33, 8, CC), (2, 8, CC), (1, 8, 0))
    res = check_decode_args((*rnd, specs, bits, five), "random bytes")
    pos = res[2][1][4].cpu().numpy()
    check(bool((pos[2::3] >= cap).all()), "the reads near cap did not pass "
          "the buffer")
    return res


def check_decode_ext_kernel(dev, context_model):
    """K2-ext / K2-ext-five on the port's own 16-bit encode (96x64
    yuv444p16le, 24 slices, 2 streams: 48 lanes of 3 x 16x16), and on
    random bytes at 11, 16 and 17 bits (garbage symbols: exponents past
    the width, reads past the buffer, clamped contexts), with the
    context model's quant tables and table size (context model 1: the
    16-bit extradata's 2 x 5,063 rows, in global memory)."""
    w, h = 96, 64
    params = EncoderParams(width=w, height=h, pix_fmt="yuv444p16le",
                           level=3, coder=2, slices=SLICES,
                           context_model=context_model)
    streams = synthetic_streams16(BATCH, 1, w, h, SEED + 2)
    enc = TorchFFV1Encoder(params, batch=BATCH, device=dev)
    pkts = [p for p, _kf in enc.encode_frames([s[0] for s in streams])]
    dec = TorchFFV1Decoder(w, h, enc.extradata, batch=BATCH, device=dev)
    args = decode_args_from_packets(dec, pkts, 16)
    lossless = streams[0][0][0][:16, :16].astype(np.int32)
    lossless = ((lossless + 0x8000) & 0xFFFF) - 0x8000     # int16 rows
    res = [check_decode_args(args, f"port-encoded stream, context model "
                             f"{context_model}", lossless)]
    L, cap = BATCH * SLICES, 4096
    CC = T.CONTEXT_COUNTS[0] if context_model == 0 else \
        dec.g.context_counts[1]
    five = context_model == 1
    one, zero = custom_state_tables(T.VER2_STATE)
    for bits in (11, 16, 17):
        r = np.random.RandomState(SEED + 100 + bits + 50 * context_model)
        bufs = r.randint(0, 256, (L, cap)).astype(np.uint8)
        low0 = np.minimum(bufs[:, 0].astype(np.int32) << 8 | bufs[:, 1],
                          0xFEFF)
        qt = T.default_quant_tables(bits)[context_model].astype(np.int32)
        rnd = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            bufs, r.randint(16, 241, (L, 2 * CC, 32)).astype(np.uint8),
            one, zero, qt, low0.astype(np.int32),
            np.full(L, 0xFF00, np.int32), np.full(L, 2, np.int32))]
        specs = ((16, 16, 0), (16, 16, CC), (16, 16, CC))
        res.append(check_decode_args((*rnd, specs, bits, five),
                                     "random bytes"))
    return res


# ----------------------------------------- RGB decode checks, random

# (plane width, planes) of B1's random-bytes launches
RGB_RANDOM_SHAPES = ((40, 3), (33, 4), (2, 3), (1, 4))


def rgb_decode_random_inputs(L, cap, bits, five, cc, nplanes, seed):
    """B1 / B1-ext inputs (numpy: bufs, states, one, zero, qt, low0,
    range0, pos0) on random bytes: garbage symbols (exponents up to the
    width with no stop decision, clamped contexts), states 16..240 for
    RGB's state planes (2, with alpha 3, x ``cc``), the quant tables of
    the context (context model 1's with ``five``), every third lane's
    coder started 4 bytes before its buffer's end (reads at pos >= cap
    give 0)."""
    r = np.random.RandomState(seed)
    one, zero = custom_state_tables(T.VER2_STATE)
    bufs = r.randint(0, 256, (L, cap)).astype(np.uint8)
    pos0 = np.where(np.arange(L) % 3 == 2, cap - 4, 2).astype(np.int32)
    low0 = np.minimum(bufs[np.arange(L), pos0 - 2].astype(np.int32) << 8 |
                      bufs[np.arange(L), pos0 - 1], 0xFEFF)
    CC = (2 + (nplanes == 4)) * cc
    return [np.ascontiguousarray(a) for a in (
        bufs, r.randint(16, 241, (L, CC, 32)).astype(np.uint8), one, zero,
        T.default_quant_tables(bits)[int(five)].astype(np.int32),
        low0.astype(np.int32), np.full(L, 0xFF00, np.int32), pos0)]


def check_rgb_args(args, label, lossless=None):
    """B1 / B1-ext on ``args`` (rc_decode_rgb's), timed, lane 0's
    RCT-domain planes held to ``lossless`` where given; returns
    (instance, its numbers, the launch's (args, outputs)) for the plain
    check."""
    states = args[1]
    w, h, P, cc, bits, five = args[8:]
    name = rc_decode.instance(bits, five, states.shape[1], w, P)
    got = rc_decode.rc_decode_rgb(*args)
    if lossless is not None:
        check(np.array_equal(got[0][:, 0].cpu().numpy(), lossless),
              f"{name} decode of lane 0 is not lossless ({label})")
    ms = cuda_time_ms(lambda: rc_decode.rc_decode_rgb(*args), 5)
    shape = (f"bits={bits} L={states.shape[0]} CC={states.shape[1]} {P} "
             f"planes of {w}x{h}")
    log(f"[kernels] {name} {shape} {label}: kernel {ms:.3f} ms")
    return name, dict(check_ms=ms, check_shape=shape, label=label), \
        (args, got)


def check_rgb_decode_random_bytes(dev, bits, five, context_model):
    """One of B1's (bits 9, 10) or B1-ext's (11, 13, 15) four instances
    (``five``: the 5-input context; the context model's table size:
    shared or global memory) on rgb_decode_random_inputs at L=48, once
    per RGB_RANDOM_SHAPES entry: planes 40, 33, 2 and 1 wide (the row
    borders, the context a warp's 32 columns at a time and its edge), 3
    and 4 planes (alpha on the third state plane).  Returns [(instance,
    its numbers, the launch's (args, outputs))]."""
    L, cap = BATCH * SLICES, 4096
    cc = T.CONTEXT_COUNTS[context_model]
    res = []
    for k, (w, P) in enumerate(RGB_RANDOM_SHAPES):
        arrs = rgb_decode_random_inputs(
            L, cap, bits, five, cc, P,
            SEED + 900 + 10 * bits + 4 * k + 2 * five + context_model)
        args = (*[torch.from_numpy(a).to(dev) for a in arrs], w,
                6 if w > 2 else 96, P, cc, bits, five)
        r = check_rgb_args(args, "random bytes")
        pos = r[2][1][4].cpu().numpy()
        check(bool((pos[2::3] >= cap).all()), "the reads near cap did not "
              "pass the buffer")
        res.append(r)
    return res


def check_rgb_decode_kernel(dev, pix_fmt, context_model):
    """B1 (bgr0, coded width 9) or B1-ext (gbrp14le, 15) on the port's own
    encode of 384x256, 24 slices, 2 streams (48 lanes of 3 x 64x64), at
    ``context_model`` (1: the 5-input context, the table in global
    memory); lane 0 held to its source crop through the forward RCT."""
    w, h = 384, 256
    params = EncoderParams(width=w, height=h, pix_fmt=pix_fmt, level=3,
                           coder=2, slices=SLICES,
                           context_model=context_model)
    gen = synthetic_streams_bgr0 if pix_fmt == "bgr0" else \
        synthetic_streams_gbrp14
    streams = gen(BATCH, 1, w, h, SEED + 3)
    enc = TorchFFV1Encoder(params, batch=BATCH, device=dev)
    pkts = [p for p, _kf in enc.encode_frames([s[0] for s in streams])]
    dec = TorchFFV1Decoder(w, h, enc.extradata, batch=BATCH, device=dev)
    parsed = [dec._parse_packet(bi, p) for bi, p in enumerate(pkts)]
    (bufs, lows, ranges, poss), _lens, q = dec._lane_inputs(parsed)
    specs = dec._plane_specs()
    sw, sh = specs[0][0], specs[0][1]
    args = (bufs, dec._fresh(q)[None].repeat(dec.L, 1, 1),
            dec.one_tab, dec.zero_tab, dec.qts[q], lows, ranges, poss, sw,
            sh, len(specs), dec.g.context_counts[q], dec.coded_bits,
            bool(dec.g.quant_tables[q][3][127]))
    src = streams[0][0]
    bgr = [src[0][:sh, :sw, c] for c in range(3)] if pix_fmt == "bgr0" \
        else [p[:sh, :sw] for p in src]
    g, b, r = rct_transform(*(torch.from_numpy(x.astype(np.int32))
                              for x in (bgr[1], bgr[0], bgr[2])),
                            dec.bits)
    return check_rgb_args(args, f"port-encoded {pix_fmt}, context model "
                          f"{context_model}", torch.stack([g, b, r]).numpy())


# ------------------------------------- Golomb-Rice kernel checks, random


def random_vlc_states(r, L, rows):
    """VlcStates a running stream can hold: counts 1..128 (5% at 128, where
    the next update halves), error sums up to 0xFFFF (30% below 8: a small
    k, under which large residuals escape), drifts in (-count, 0], biases
    -128..127."""
    count = np.where(r.rand(L, rows) < 0.05, 128, r.randint(1, 129, (L, rows)))
    esum = np.where(r.rand(L, rows) < 0.3, r.randint(0, 8, (L, rows)),
                    r.randint(0, 0x10000, (L, rows)))
    drift = -(r.rand(L, rows) * count).astype(np.int64)
    return np.ascontiguousarray(np.stack(
        [drift, esum, r.randint(-128, 128, (L, rows)), count],
        -1).astype(np.int32))


def golomb_encode_edge_inputs(L, dims, cc, seed):
    """G1 inputs (numpy: ctx, diff, active, flags, vlc0, prefixes, plens)
    that reach the edges of its design, for planes ``dims`` ((w, h,
    state_plane), ...) and ``cc`` contexts a state plane: runs of the
    plane's context 0 with zero residuals of 2-80 pixels (run chunks
    completing, runs across line ends: the line-end flush), breaks,
    blocks of zero residuals, of inactive pixels and of large residuals
    (+-96..128: escapes under the states' small k), codec-like residuals
    between them, carried VLC states (random_vlc_states) and prefixes of
    0..PREFIX_CAP bytes."""
    r = np.random.RandomState(seed)
    flags = golomb_encode.make_flags(dims)
    N = flags.shape[0]
    rows = (max(sp for (_w, _h, sp) in dims) + 1) * cc
    pbase = (flags >> golomb_encode.FLAG_SPLANE_SHIFT) * cc
    ctx = pbase + np.where(r.rand(L, N) < 0.3, 0, r.randint(1, cc, (L, N)))
    diff = np.where(r.rand(L, N) < 0.3, 0, r.randint(-4, 5, (L, N)))
    act = r.rand(L, N) < 0.98
    for lane in range(L):
        p = 0
        while p < N:
            q = min(N, p + r.randint(2, 81))
            kind = r.randint(6)
            if kind in (0, 1):
                ctx[lane, p:q] = pbase[p:q]
                diff[lane, p:q] = 0
            elif kind == 2:
                act[lane, p:q] = False
            elif kind == 3:
                diff[lane, p:q] = 0
            elif kind == 4:
                diff[lane, p:q] = r.choice([-1, 1], q - p) * \
                    r.randint(96, 129, q - p)
            p = q
    return [np.ascontiguousarray(a) for a in (
        ctx.astype(np.int32), diff.astype(np.int32), act, flags,
        random_vlc_states(r, L, rows),
        r.randint(0, 256, (L, PREFIX_CAP)).astype(np.int32),
        r.randint(0, PREFIX_CAP + 1, L).astype(np.int32))]


def golomb_decode_random_inputs(L, cap, cc, five, seed):
    """G2 inputs (numpy: bufs, vlc0, qt, pos0) on random bytes: garbage
    symbols; every fourth lane from lane 1 mostly 0xFF bytes (long runs:
    refill bits of 1), from lane 3 mostly zero bytes (escapes, and reads
    of zeros); carried VLC states (random_vlc_states) for two state
    planes of ``cc`` contexts; the quant tables of the context (context
    model 1's with ``five``); every third lane's reader started 8 bytes
    before its buffer's end (reads at bytes >= cap give 0)."""
    r = np.random.RandomState(seed)
    bufs = r.randint(0, 256, (L, cap))
    bufs[1::4] = np.where(r.rand(*bufs[1::4].shape) < 0.8, 0xFF,
                          bufs[1::4])
    bufs[3::4] = np.where(r.rand(*bufs[3::4].shape) < 0.8, 0, bufs[3::4])
    pos0 = np.where(np.arange(L) % 3 == 2, cap - 8, 2)
    qt = T.default_quant_tables(8)[int(five)]
    return [np.ascontiguousarray(a) for a in (
        bufs.astype(np.uint8), random_vlc_states(r, L, 2 * cc),
        qt.astype(np.int32), pos0.astype(np.int32))]


def check_golomb_encode_kernel(dev, context_model):
    """G1 on golomb_encode_edge_inputs at L=48, 64x32 luma and two 32x16
    chroma planes, the context model's two state planes (CC = 1,332 or
    15,126 rows: the table in shared or in global memory), timed; twice,
    the second with an output cap below the lanes' counts (the bytes past
    it are not written).  Returns [(instance, its numbers, the launch's
    (args, outputs))] for the plain check."""
    L = BATCH * SLICES
    cc = T.CONTEXT_COUNTS[context_model]
    dims = ((64, 32, 0), (32, 16, 1), (32, 16, 1))
    arrs = golomb_encode_edge_inputs(L, dims, cc, SEED + 700 +
                                     context_model)
    t = [torch.from_numpy(a).to(dev) for a in arrs]
    name = golomb_encode.instance(2 * cc)
    res = []
    for cap in (None, 600):
        args = (*t, 8, cc, cap)
        got = golomb_encode.golomb_encode_lanes(*args)
        counts = got[1].cpu().numpy()
        check(int((counts - arrs[6]).min()) > 0, "G1 emitted nothing")
        check(cap is None or int(counts.max()) > cap,
              "no lane passed the output cap")
        ms = cuda_time_ms(lambda: golomb_encode.golomb_encode_lanes(*args), 5)
        shape = (f"L={L} N={arrs[0].shape[1]} CC={2 * cc} "
                 f"T={got[0].shape[1]}")
        label = ("edge inputs" + ("" if cap is None else
                                  ", output cap below the counts"))
        log(f"[kernels] {name} {shape} {label}: kernel {ms:.3f} ms")
        res.append((name, dict(check_ms=ms, check_shape=shape,
                               label=label), (args, got)))
    return res


def check_golomb_decode_kernel(dev, five, context_model):
    """One of G2's four instances (``five``: the 5-input context; the
    context model's table size: 2 x 666 rows in shared memory, or 2 x
    7,563 in global memory) on golomb_decode_random_inputs at L=48, planes
    40, 33, 2 and 1 wide (the row borders, the context computed a warp's
    32 columns at a time and its edge), timed.  Returns (instance, its
    numbers, the launch's (args, outputs))."""
    L, cap = BATCH * SLICES, 4096
    cc = T.CONTEXT_COUNTS[context_model]
    arrs = golomb_decode_random_inputs(L, cap, cc, five, SEED + 800 +
                                       10 * five + context_model)
    specs = ((40, 16, 0), (33, 8, cc), (2, 8, cc), (1, 8, 0))
    args = (*[torch.from_numpy(a).to(dev) for a in arrs], specs, 8, five)
    name = golomb_decode.instance(five, 2 * cc, 40)
    got = golomb_decode.golomb_decode_planes(*args)
    bitpos = got[2].cpu().numpy()
    check(bool((bitpos[2::3] >= 8 * cap).all()), "the reads near cap did "
          "not pass the buffer")
    ms = cuda_time_ms(lambda: golomb_decode.golomb_decode_planes(*args), 5)
    shape = f"L={L} CC={2 * cc} planes={specs}"
    log(f"[kernels] {name} {shape} random bytes: kernel {ms:.3f} ms")
    return name, dict(check_ms=ms, check_shape=shape,
                      label="random bytes"), (args, got)


# ---------------------------------------------------------- main path


def step_stats(tag, name, steps_s, mpix, gpu):
    ms = sorted(1e3 * s for s in steps_s)
    med = ms[len(ms) // 2] if len(ms) % 2 else \
        (ms[len(ms) // 2 - 1] + ms[len(ms) // 2]) / 2
    log(f"[{tag}] {name} over {len(ms)} timed non-key steps (batch "
        f"{BATCH}, {gpu}): median {med:.2f} ms/step = "
        f"{mpix / med * 1e3:.2f} Mpix/s; min {ms[0]:.2f}, max {ms[-1]:.2f}; "
        f"steps {', '.join(f'{1e3 * s:.2f}' for s in steps_s)} ms")
    return med


def reset_counts():
    for mod in (rc_encode, rc_decode, golomb_encode, golomb_decode,
                twopass):
        mod.LAUNCHES.clear()


def all_launches():
    return {**rc_encode.LAUNCHES, **rc_decode.LAUNCHES,
            **golomb_encode.LAUNCHES, **golomb_decode.LAUNCHES,
            **twopass.LAUNCHES}


def main_path(dev, gpu, name, recorders):
    """One main path: 24 slices, 2 streams x its frames through the port,
    held against the golden digests.  ``recorders``: the LastLaunch of
    each lane-scan wrapper the encoder and decoder call ("packed",
    "compact", "decode", "golomb_encode", "golomb_decode").  Returns the
    launch counts of its kernels, their main-path times and the recorded
    warm-up launches."""
    path = PATHS[name]
    pix_fmt, w, h, frames = path.pix_fmt, path.width, path.height, \
        path.frames
    tag = f"main {name}"
    k_enc, k_dec = path.kernels
    golomb = path.coder == 0
    rec_enc = recorders["golomb_encode" if golomb else
                        "compact" if path.compact else "packed"]
    rgb = pix_fmt.startswith(("bgr", "gbrp"))
    rec_dec = recorders["golomb_decode" if golomb else
                        "decode_rgb" if rgb else "decode"]
    t0 = time.perf_counter()
    streams = path_streams(name)
    golden = load_goldens()[path.golden or name]
    log(f"[{tag}] {w}x{h} {pix_fmt}, context model {path.context_model}, "
        f"{'Golomb-Rice' if golomb else 'range coder'}"
        f"{', compact encode form, encode only' if path.compact else ''} "
        f"content: {BATCH}x{frames} frames in "
        f"{time.perf_counter() - t0:.1f} s")
    enc = TorchFFV1Encoder(EncoderParams(**params_kw(name)), batch=BATCH,
                           device=dev, compact=path.compact)
    check(digest(enc.extradata) == golden["extradata"],
          f"{name}: extradata differs from the golden")
    dec = TorchFFV1Decoder(w, h, enc.extradata, batch=BATCH, device=dev)
    check(enc.L == SLICES * BATCH and enc.n_slices == SLICES,
          "expected 48 lanes")
    check(enc.bits == path.bits, "coded width")
    check(enc.compact == path.compact, "compact form")
    check(enc.golomb == dec.golomb == golomb, "coder")
    check(enc.rct_search == (path.level > 3), "the version-4 RCT search")

    enc_s, dec_s, peak, packets = [], [], [], []
    hist = collections.Counter()          # (by, ry) over lanes and frames
    groups = None                         # the warm-up decode's lane groups
    reset_counts()
    for t in range(frames):
        # keep the kernels' inputs and outputs of the warm-up frame
        rec_enc.armed = rec_dec.armed = (t == 1)
        frame = [streams[b][t] for b in range(BATCH)]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = enc.encode_frames(frame)
        enc_s.append(time.perf_counter() - t0)
        peak.append((torch.cuda.max_memory_allocated() - base) / 2**30)
        if enc.rct_search:
            hist.update(enc.rct_coefs)
        if name in MIXED_Q:
            packets.append([r[0] for r in res])
        for b in range(BATCH):
            want = golden["packets"][b][t]
            check(digest(res[b][0]) == {"sha256": want["sha256"],
                                        "len": want["len"]} and
                  res[b][1] == want["key"],
                  f"{name} stream {b} frame {t}: packet differs from the "
                  f"golden ({len(res[b][0])} vs {want['len']} B)")
        decoded = ""
        if k_dec is not None:
            t0 = time.perf_counter()
            out = dec.decode_frames([res[b][0] for b in range(BATCH)])
            dec_s.append(time.perf_counter() - t0)
            for b in range(BATCH):
                planes, kf = out[b]
                check(kf == (t == 0), "keyframe flag")
                check(len(planes) == len(frame[b]), "plane count")
                for k in range(len(frame[b])):
                    check(planes[k].dtype == frame[b][k].dtype and
                          np.array_equal(planes[k], frame[b][k]),
                          f"{name} stream {b} frame {t} plane {k}: decode "
                          f"not lossless")
            check(not dec.slice_damaged.any(), "slice flagged damaged")
            if t == 1 and not golomb and not rgb:
                groups = [lanes for lanes, _d, _q in dec.last_groups]
            decoded = (f"decode lossless; decode {dec_s[-1] * 1e3:.2f} ms, "
                       f"")
        kind = "key" if t == 0 else "non-key, warm-up" if t <= WARM \
            else "non-key"
        log(f"[{tag}] frame {t} ({kind}): "
            f"{sum(len(r[0]) for r in res)} B, equal to the golden digests; "
            f"{decoded}encode {enc_s[-1] * 1e3:.2f} ms; encode peak device "
            f"memory {peak[-1]:.2f} GiB over the {base / 2**30:.2f} GiB held "
            f"({gpu})")
    rec_enc.armed = rec_dec.armed = False
    launches = all_launches()
    log(f"[{tag}] kernel launches in this path's {frames} steps: "
        f"{launches}")
    want = {k: frames for k in path.kernels if k is not None}
    if k_dec is not None:
        want[k_dec] = frames * path.dec_groups
    check(launches == want,
          f"expected {want} launches ({path.dec_groups} decode launches "
          f"per step), and no other kernel: {launches}")
    if enc.rct_search:
        log(f"[{tag}] searched (by, ry) over {frames} frames x {enc.L} "
            f"lanes: " + ", ".join(f"{k}: {v}"
                                   for k, v in sorted(hist.items())))
        check(set(hist) - {(1, 1)}, "every lane kept (1, 1): the search "
              "picked no other pair")
    enc_rec = rec_enc.take()
    dec_recs = rec_dec.take_all() if k_dec is not None else []
    check(enc_rec[1] is not None and
          (k_dec is None or len(dec_recs) == path.dec_groups),
          "the warm-up frame's kernel calls were not recorded")
    if len(set(enc.stream_lens)) > 1:
        log(f"[{tag}] lanes of unequal length: stream lengths "
            f"{sorted(set(enc.stream_lens))} px (n_max {enc.n_max}); decode "
            f"groups of the warm-up frame: "
            f"{[len(g) for g in groups]} lanes")

    mpix = BATCH * w * h / 1e6
    enc_ms = step_stats(tag, "encode", enc_s[1 + WARM:], mpix, gpu)

    # stage times at the main path's shapes (launches not counted above)
    frame = [streams[b][frames - 1] for b in range(BATCH)]
    up_ms, planes = host_time_ms(lambda: enc._upload(frame))
    rct, v4 = None, {}
    if enc.rct_search:
        # the search (with the fetch of its (L, 15) sums and the pick),
        # the slice headers built cold and from the cache
        v4["rct_search"], coefs = host_time_ms(lambda: enc._rct_coefs(planes))
        enc._header_cache.clear()
        v4["header_cold"], _x = host_time_ms(
            lambda: enc._prefix_arrays_rct(False, coefs))
        v4["header"], _x = host_time_ms(
            lambda: enc._prefix_arrays_rct(False, coefs))
        if enc.rgb:
            c = torch.tensor(coefs, dtype=torch.int32, device=dev)
            rct = (c[:, 0], c[:, 1])
    st_ms = cuda_time_ms(lambda: enc._streams(planes, rct), 3)
    k1_args = enc_rec[0]
    scan = golomb_encode.golomb_encode_lanes if golomb else \
        rc_encode.rc_encode_compact if path.compact else \
        rc_encode.rc_encode_packed
    k1_ms = cuda_time_ms(lambda: scan(*k1_args), 3)
    slots = enc_rec[1][0]
    if golomb:
        # G1 writes the final bytes: there is no finalize
        fin_name, fin_ms, fin_peak = None, 0.0, 0.0
    else:
        slots, low, rng, _st = enc_rec[1]
        _l, _r, prefixes, plens = enc._prefix_arrays(False)
        torch.cuda.synchronize()
        fbase = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if path.compact:
            fin_name = "finalize_compact"
            fin_ms = cuda_time_ms(lambda: finalize_compact(
                slots, low, rng, prefixes, plens), 3)
        else:
            fin_name = f"finalize s2={enc.s2}"
            fin_ms = cuda_time_ms(lambda: finalize_packed(
                slots, low, rng, prefixes, plens, enc.s2), 3)
        fin_peak = (torch.cuda.max_memory_allocated() - fbase) / 2**30
    if path.level > 3:
        v4["rowbytes"] = cuda_time_ms(lambda: row_bytes(slots, enc.row_offs),
                                      3)
    pkts = [r[0] for r in res]                  # the last frame's packets
    # the host CRC-32 alone over the step's slices: the encoder's over
    # each slice up to its CRC, the decoder's over each whole slice
    spans = [(p, a, b) for p in pkts for a, b in dec._split_slices(p)]
    crc_enc_ms, _x = host_time_ms(
        lambda: [crc32_ieee(p[a:b - 4]) for p, a, b in spans])
    L, n = k1_args[0].shape
    rest = enc_ms - up_ms - st_ms - k1_ms - fin_ms - sum(
        v4.get(k, 0.0) for k in ("rct_search", "header", "rowbytes"))
    slots_gib = slots.numel() * slots.element_size() / 2**30
    fin_text = (f"no finalize (G1's byte rows {slots_gib:.3f} GiB)"
                if golomb else
                f"{fin_name} {fin_ms:.2f} (peak {fin_peak:.2f} GiB over its "
                f"{slots_gib:.2f} GiB input)")
    v4_text = "" if not v4 else (
        (f"RCT search {v4['rct_search']:.2f} (its sums' fetch and the pick "
         f"included), slice headers {v4['header']:.2f} (cached; "
         f"{v4['header_cold']:.2f} cold), " if "rct_search" in v4 else "") +
        f"row bytes {v4['rowbytes']:.2f}, ")
    log(f"[{tag}] encode stages (ms, L={L}, {n} px/lane, each timed alone, "
        f"{gpu}): upload {up_ms:.2f}, {v4_text}stencil {st_ms:.2f}, {k_enc} "
        f"{k1_ms:.2f}, {fin_text}; the median step minus these "
        f"{rest:.2f}, of which the "
        f"slices' CRC-32 alone takes {crc_enc_ms:.2f} ({len(spans)} slices, "
        f"{sum(b - a for _p, a, b in spans)} B); encode step peak "
        f"{max(peak[1 + WARM:]):.2f} GiB")
    res = dict(launches=launches, ms={k_enc: k1_ms},
               recs={k_enc: enc_rec}, group_recs=dec_recs, groups=groups,
               group_ms=None, packets=packets, steps=frames, enc_ms=enc_ms,
               dec_ms=None, stages=dict(
                   upload=up_ms, stencil=st_ms, scan=k1_ms, finalize=fin_ms,
                   rest=rest, crc=crc_enc_ms,
                   step_peak_gib=max(peak[1 + WARM:]),
                   finalize_peak_gib=fin_peak, slots_gib=slots_gib, **v4))
    if k_dec is None:
        return res
    dec_ms = step_stats(tag, "decode", dec_s[1 + WARM:], mpix, gpu)
    parse_ms, _x = host_time_ms(lambda: dec._lane_buffers(
        [dec._parse_packet(b, p) for b, p in enumerate(pkts)]))
    crc_dec_ms, _x = host_time_ms(
        lambda: [crc32_ieee(p[a:b]) for p, a, b in spans])
    dscan = golomb_decode.golomb_decode_planes if golomb else \
        rc_decode.rc_decode_rgb if rgb else rc_decode.rc_decode_planes
    # each decode launch of the step (one per lane group on a
    # non-uniform grid), timed alone; their sum is the step's scan time
    group_ms = [cuda_time_ms(lambda a=a: dscan(*a), 3) for a, _o in dec_recs]
    k2_ms = sum(group_ms)
    groups_text = "" if len(group_ms) == 1 else (
        f" in {len(group_ms)} launches of " + " + ".join(
            f"{ms:.2f} ({len(g)} lanes)" for ms, g in zip(group_ms, groups)))
    log(f"[{tag}] decode stages (ms, each timed alone, {gpu}): parse+upload "
        f"{parse_ms:.2f}, of which the slices' CRC-32 alone takes "
        f"{crc_dec_ms:.2f}; {k_dec} {k2_ms:.2f}{groups_text}; the median "
        f"step minus these {dec_ms - parse_ms - k2_ms:.2f}")
    res["ms"][k_dec] = k2_ms
    res["group_ms"] = group_ms
    res["recs"][k_dec] = dec_recs[0]
    res["dec_ms"] = dec_ms
    res["stages"].update(parse=parse_ms, crc_dec=crc_dec_ms, dscan=k2_ms)
    return res


def pcm_phase(dev, gpu, rec):
    """v4_pcm: version 4's PCM retry on the card (``pcm_kw``,
    ``synthetic_streams_pcm``), batch 2, GOP 3 over three frames.  Its
    packets must equal the golden digests of the JAX package's
    TPUFFV1Encoder on the CPU (tests/test_torch_goldens.py; the host
    encoder has no PCM retry), stream 0's slices be PCM in frames 0 and 2
    and no other slice, K1-ext launch once per frame and no other kernel,
    and each frame's row bytes (``row_bytes`` on the card) equal the
    plain computation on a host copy of the same raw slots.  ``rec``:
    the LastLaunch of rc_encode_packed.  Returns its numbers."""
    tag = "v4_pcm"
    golden = load_goldens()["v4_pcm"]
    streams = synthetic_streams_pcm()
    enc = TorchFFV1Encoder(EncoderParams(**pcm_kw()), batch=BATCH,
                           device=dev)
    check(digest(enc.extradata) == golden["extradata"],
          "v4_pcm: extradata differs from the golden")
    # parses the slice headers on the host (no decode: the port's decoder
    # refuses PCM slices, as the JAX package's does)
    parser = TorchFFV1Decoder(PCM_W, PCM_H, enc.extradata, batch=BATCH,
                              device="cpu")
    enc_ms, rb_ms, modes = [], [], []
    reset_counts()
    for t in range(PCM_FRAMES):
        frame = [streams[b][t] for b in range(BATCH)]
        rec.armed = True
        ms, res = host_time_ms(lambda: enc.encode_frames(frame))
        rec.armed = False
        enc_ms.append(ms)
        for b in range(BATCH):
            want = golden["packets"][b][t]
            check(digest(res[b][0]) == {"sha256": want["sha256"],
                                        "len": want["len"]} and
                  res[b][1] == want["key"],
                  f"v4_pcm stream {b} frame {t}: packet differs from the "
                  f"golden ({len(res[b][0])} vs {want['len']} B)")
        packed = rec.take()[1][0]
        rb_ms.append(cuda_time_ms(lambda: row_bytes(packed, enc.row_offs),
                                  3))
        got = row_bytes(packed, enc.row_offs).cpu().numpy()
        offs = enc.row_offs.cpu().numpy()
        cum = np.cumsum(((packed.cpu().numpy() >> 20) & 1).sum(axis=1),
                        axis=0)
        plain = np.where(offs[:, None] == 0, 0, cum[np.maximum(offs - 1, 0)])
        check(np.array_equal(got, plain),
              f"v4_pcm frame {t}: row bytes differ from the plain "
              f"computation")
        modes.append([[e[2] for e in parser._parse_packet(b, res[b][0])[2]]
                      for b in range(BATCH)])
    launches = all_launches()
    check(launches == {"rc_encode_ext": PCM_FRAMES},
          f"expected rc_encode_ext launched once per step, and no other "
          f"kernel: {launches}")
    want_modes = [[[int(t != 1)] * 4, [0] * 4] for t in range(PCM_FRAMES)]
    check(modes == want_modes, f"v4_pcm: slice coding modes {modes}, "
          f"expected {want_modes}")
    log(f"[{tag}] {PCM_W}x{PCM_H} yuv444p16le, version 4, {BATCH} streams x "
        f"{PCM_FRAMES} frames (GOP 3): packets equal to the golden digests "
        f"(TPUFFV1Encoder); slice coding modes per frame and stream "
        f"{modes} (1: PCM); row bytes equal to the plain computation in "
        f"every frame ({enc.row_offs.numel()} line starts x {enc.L} lanes, "
        f"{', '.join(f'{x:.3f}' for x in rb_ms)} ms); encode steps "
        f"{', '.join(f'{x:.2f}' for x in enc_ms)} ms, the PCM slices coded "
        f"on the host ({gpu}); launches {launches}")
    return dict(encode_ms=enc_ms, rowbytes_ms=rb_ms, modes=modes,
                launches=launches)


def stats_rows_args(args):
    """rc_stats_rows' arguments for a stats launch's ``args``."""
    return (*args[:3], args[8], args[3].shape[1])


def stats_recs(launch, split, label, ms=None):
    """A stats launch (args, its six outputs) as phase 6 holds it:
    [(instance, (args, outputs), split, label, kernel ms)].  K1-ext's
    stats kernel computes all six; K1's are two kernels, its stats scan
    (slots, low, range, states, stat; in segments with ``split``) and its
    row counts (stat2, always whole: one bincount).  ``ms``: the kernels'
    times, else timed here."""
    args, out = launch
    name = rc_encode.instance(args[8], args[3].shape[1], stats=True)
    if args[8] > 10:
        return [(name, launch, split, label, ms if ms is not None else
                 cuda_time_ms(lambda: rc_encode.rc_encode_stats(*args), 3))]
    rows_args = stats_rows_args(args)
    scan_ms, rows_ms = ms if ms is not None else (
        cuda_time_ms(lambda: rc_encode.rc_encode_stats_scan(*args), 3),
        cuda_time_ms(lambda: rc_encode.rc_stats_rows(*rows_args), 3))
    return [(name, (args, out[:5]), split, label, scan_ms),
            ("rc_stats_rows", (rows_args, (out[5],)), False, label, rows_ms)]


def twopass_phase(dev, gpu, rec):
    """twopass: pass 1 and pass 2 of two-pass encoding through
    TorchFFV1Encoder on the card.

    - The small cuts (TWOPASS_CUTS: 256x144 yuv420p and 128x72
      yuv444p16le, 2 streams x 2 frames, 24 slices, coder 2): pass 1 on
      the stats instances of K1 and K1-ext at depth 2, every submit
      under set_sync_debug_mode("error") (``pipelined``: K1's row counts
      run on a side stream joined by events), each stream's get_stats
      text and its packets equal to the host spec
      FFV1Encoder(pass1=True)'s golden digests.
    - 1080p pass 1: the 8bit path's first 4 frames, batch 2, on K1's
      stats instance: the packets 8bit's goldens (pass 1 does not change
      the bytes), every lane's counts adding up to its decisions
      (decisions_per_lane) in every frame, the warm-up launch's slots,
      low, range and states equal to the production K1's on the same
      inputs, and both timed there.
    - 1080p pass 2: the same frames with the 8-bit cut's stream-0 text
      as stats_in (find_best_state on the card): extradata and packets
      equal to the host native FFV1Encoder(stats_in=...)'s goldens, the
      decode through TorchFFV1Decoder (K2 from the tuned initial states)
      lossless; the constructor, encode and decode steps timed.
    - find_best_state: its table of the pass-2 encoder's sorted
      state-transition table equal to the host native table's digest,
      TWOPASS_FBS_ROWS of it equal to the plain version's, timed; its
      fold terms counted by the fold's counting instance
      (find_best_state_terms), for the bound.
    - The stats instances, both placements, on random inputs at small N
      (check_stats_kernel).

    The launch counts are set to 0 before each part and read after it.
    ``rec``: the LastLaunch of rc_encode_stats.  Returns its numbers, the
    random checks, and ``main_recs``, the stats launches phase 6 holds to
    their plain versions (``stats_recs``): the small cuts' four, each
    whole, and 1080p pass 1's frame 1, K1's as its scan (in segments at
    1080p) and its row counts (whole)."""
    tag = "twopass"
    t_phase = time.perf_counter()
    golden = load_goldens()["twopass"]
    texts, cut_recs = {}, {}
    reset_counts()
    rec.armed = True
    for name in TWOPASS_CUTS:
        kw = twopass_cut_kw(name)
        enc = TorchFFV1Encoder(EncoderParams(**kw, pass1=True), batch=BATCH,
                               device=dev)
        streams = twopass_cut_streams(name)

        def on_result(t, res, name=name):
            for b in range(BATCH):
                want = golden[name]["packets"][b][t]
                check(digest(res[b][0]) == {"sha256": want["sha256"],
                                            "len": want["len"]} and
                      res[b][1] == want["key"],
                      f"twopass {name} stream {b} frame {t}: packet differs "
                      f"from the golden")

        # at depth 2, every submit strict: K1's row counts join the scan's
        # stream by events
        pipelined(enc.submit_frames, enc.collect_frames,
                  [[s[t] for s in streams]
                   for t in range(TWOPASS_CUT_FRAMES)], on_result)
        texts[name] = [enc.get_stats(b) for b in range(BATCH)]
        check([digest(x.encode()) for x in texts[name]] ==
              golden[name]["stats"],
              f"twopass {name}: pass-1 statistics differ from the host's")
        cut_recs[name] = rec.take_all()
        log(f"[{tag}] {name} cut: {kw['width']}x{kw['height']} "
            f"{kw['pix_fmt']}, {BATCH} x {TWOPASS_CUT_FRAMES} frames, pass 1 "
            f"on the card at depth 2 (every submit under "
            f"set_sync_debug_mode(\"error\")): each stream's statistics text "
            f"({', '.join(str(len(x)) for x in texts[name])} B) and packets "
            f"equal to the host spec encoder's golden digests")
    rec.armed = False
    cut_launches = all_launches()
    check(cut_launches == {"rc_encode_stats": TWOPASS_CUT_FRAMES,
                           "rc_stats_rows": TWOPASS_CUT_FRAMES,
                           "rc_encode_ext_stats": TWOPASS_CUT_FRAMES},
          f"twopass cuts: expected each stats instance (K1's: its scan "
          f"and its row counts) once per step: {cut_launches}")
    # the cuts' launches, each timed, for phase 6: (instance, launch,
    # split, label, kernel ms); K1's as its two kernels
    main_recs = [
        rec for name in TWOPASS_CUTS
        for t, launch in enumerate(cut_recs[name])
        for rec in stats_recs(launch, False, f"twopass {name} cut frame {t}")]

    # 1080p pass 1
    g8 = load_goldens()["8bit"]
    frames = [s[:TWOPASS_FRAMES] for s in path_streams("8bit")]
    enc = TorchFFV1Encoder(EncoderParams(**params_kw("8bit"), pass1=True),
                           batch=BATCH, device=dev)
    check(digest(enc.extradata) == g8["extradata"],
          "twopass pass 1: extradata differs from 8bit's golden")
    p1_ms = []
    reset_counts()
    rec.armed = True
    for t in range(TWOPASS_FRAMES):
        ms, res = host_time_ms(
            lambda: enc.encode_frames([f[t] for f in frames]))
        p1_ms.append(ms)
        for b in range(BATCH):
            want = g8["packets"][b][t]
            check(digest(res[b][0]) == {"sha256": want["sha256"],
                                        "len": want["len"]},
                  f"twopass pass 1 stream {b} frame {t}: packet differs from "
                  f"8bit's golden")
    rec.armed = False
    p1_launches = all_launches()
    check(p1_launches == {"rc_encode_stats": TWOPASS_FRAMES,
                          "rc_stats_rows": TWOPASS_FRAMES},
          f"twopass pass 1: expected K1's stats scan and its row counts "
          f"once per step: {p1_launches}")
    calls = rec.take_all()
    for t, (args, out) in enumerate(calls):
        decisions = decisions_per_lane(args[1], args[2])
        check(torch.equal(out[4].sum((1, 2)).long(), decisions) and
              torch.equal(out[5].sum((1, 2, 3)).long(), decisions),
              f"twopass pass 1 frame {t}: a lane's counts differ from its "
              f"decisions")
    p1_rec = calls[1]
    args = p1_rec[0]
    prod = rc_encode.rc_encode_packed(*args)
    check(all(torch.equal(a, b) for a, b in zip(p1_rec[1][:4], prod)),
          "twopass: the stats instance's slots, low, range or states differ "
          "from K1's on the same inputs")
    # the pair as pass 1 runs it (the row counts on the side stream),
    # each kernel alone, and production K1, all on the same inputs
    stats_ms = cuda_time_ms(lambda: rc_encode.rc_encode_stats(*args), 3)
    scan_ms = cuda_time_ms(lambda: rc_encode.rc_encode_stats_scan(*args), 3)
    rows_args = stats_rows_args(args)
    rows_ms = cuda_time_ms(lambda: rc_encode.rc_stats_rows(*rows_args), 3)
    main_recs += stats_recs(p1_rec, True, "twopass 1080p pass 1 frame 1",
                            (scan_ms, rows_ms))
    k1_ms = cuda_time_ms(lambda: rc_encode.rc_encode_packed(*args), 3)
    ext_args = cut_recs["16bit"][1][0]
    ext_stats_ms = cuda_time_ms(
        lambda: rc_encode.rc_encode_stats(*ext_args), 3)
    ext_ms = cuda_time_ms(lambda: rc_encode.rc_encode_packed(*ext_args), 3)
    total = int(sum(int(o[4].sum()) for _a, o in calls))
    log(f"[{tag}] 1080p pass 1 (8bit's first {TWOPASS_FRAMES} frames, "
        f"batch {BATCH}): packets equal to 8bit's golden digests; every "
        f"lane's counts add up to its decisions in every frame ({total} "
        f"decisions); encode steps {', '.join(f'{x:.2f}' for x in p1_ms)} "
        f"ms; on the warm-up frame's inputs (L={args[0].shape[0]} "
        f"N={args[0].shape[1]}) K1's stats instance {stats_ms:.2f} ms "
        f"(its scan alone {scan_ms:.2f} ms, its row counts alone "
        f"{rows_ms:.3f} ms, on a side stream in the pair), production K1 "
        f"{k1_ms:.2f} ms, the same slots, low, range and states; K1-ext's stats instance on the 16bit cut's frame 1 "
        f"(L={ext_args[0].shape[0]} N={ext_args[0].shape[1]}) "
        f"{ext_stats_ms:.3f} ms, production K1-ext {ext_ms:.3f} ms ({gpu})")

    # 1080p pass 2, from the 8-bit cut's stream-0 statistics
    gp = golden["pass2"]
    twopass._BEST_STATE.clear()
    reset_counts()
    ctor_ms, enc2 = host_time_ms(lambda: TorchFFV1Encoder(
        EncoderParams(**params_kw("8bit"), stats_in=texts["8bit"][0]),
        batch=BATCH, device=dev))
    check(digest(enc2.extradata) == gp["extradata"],
          "twopass pass 2: extradata differs from the host's golden")
    dec = TorchFFV1Decoder(W, H, enc2.extradata, batch=BATCH, device=dev)
    p2_ms, p2_dec_ms = [], []
    for t in range(TWOPASS_FRAMES):
        frame = [f[t] for f in frames]
        ms, res = host_time_ms(lambda: enc2.encode_frames(frame))
        p2_ms.append(ms)
        for b in range(BATCH):
            want = gp["packets"][b][t]
            check(digest(res[b][0]) == {"sha256": want["sha256"],
                                        "len": want["len"]} and
                  res[b][1] == want["key"],
                  f"twopass pass 2 stream {b} frame {t}: packet differs from "
                  f"the host's golden ({len(res[b][0])} vs {want['len']} B)")
        ms, out = host_time_ms(
            lambda: dec.decode_frames([r[0] for r in res]))
        p2_dec_ms.append(ms)
        for b in range(BATCH):
            check(all(np.array_equal(a, c) for a, c in
                      zip(out[b][0], frame[b])),
                  f"twopass pass 2 stream {b} frame {t}: decode not "
                  f"lossless")
    check(not dec.slice_damaged.any(), "twopass pass 2: slice flagged")
    p2_launches = all_launches()
    check(p2_launches == {"find_best_state": 1,
                          "rc_encode": TWOPASS_FRAMES,
                          "rc_decode": TWOPASS_FRAMES},
          f"twopass pass 2: expected find_best_state once, K1 and K2 once "
          f"per step: {p2_launches}")
    sizes = [sum(golden_pkt["len"] for golden_pkt in g8["packets"][b][
        :TWOPASS_FRAMES]) for b in range(BATCH)]
    sizes2 = [sum(p["len"] for p in gp["packets"][b])
              for b in range(BATCH)]
    log(f"[{tag}] 1080p pass 2 from the 8bit cut's stream-0 statistics: "
        f"extradata ({len(enc2.extradata)} B) and packets equal to the host "
        f"native encoder's golden digests, decode lossless; constructor "
        f"{ctor_ms:.1f} ms (the sorted table, find_best_state on the card, "
        f"the initial states); encode steps "
        f"{', '.join(f'{x:.2f}' for x in p2_ms)} ms, decode steps "
        f"{', '.join(f'{x:.2f}' for x in p2_dec_ms)} ms; bytes per stream "
        f"{sizes2} against one-pass {sizes} ({gpu})")

    # find_best_state on the pass-2 encoder's sorted table
    one = enc2.rp.state_transition.copy()
    one_t = torch.from_numpy(one).to(dev)
    best = twopass.find_best_state_kernel(one_t).cpu().numpy()
    check(digest(best.tobytes()) == golden["find_best_state"],
          "find_best_state differs from the host's table")
    t0 = time.perf_counter()
    plain = twopass.find_best_state_ref(one, TWOPASS_FBS_ROWS)
    fbs_plain_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(best[list(TWOPASS_FBS_ROWS)], plain),
          "find_best_state differs from its plain version")
    fbs_ms = cuda_time_ms(lambda: twopass.find_best_state_kernel(one_t), 3)
    counted, terms = twopass.find_best_state_terms(one_t)
    check(np.array_equal(counted.cpu().numpy(), best),
          "find_best_state's counting instance differs from its table")
    n_rows = sum(1 for i in range(256)
                 for j in range(max(i - 10, 1), min(i + 11, 256)) if one[j])
    log(f"[{tag}] find_best_state: the table equal to the host native "
        f"table's digest, rows {list(TWOPASS_FBS_ROWS)} equal to the plain "
        f"version's ({fbs_plain_ms:.0f} ms on the host CPU); kernel "
        f"{fbs_ms:.2f} ms for {n_rows} (i, j) rows, {terms} fold terms (the "
        f"fold's count) ({gpu})")
    random = [r for b, n in ((8, 2048), (16, 1024)) for m in (0, 1)
              for r in check_stats_kernel(dev, b, n, m)]
    check(sorted(r[0] for r in random) ==
          sorted(STATS_INSTANCES + ("rc_stats_rows",) * 2),
          "the stats checks do not cover every stats instance and K1's row "
          "counts at both context models")
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] the phase in {seconds:.1f} s")
    return dict(
        random=random, main_recs=main_recs, p1_rec=p1_rec,
        ext_rec=cut_recs["16bit"][1],
        fbs=dict(ms=fbs_ms, plain_ms=fbs_plain_ms, terms=terms,
                 rows=n_rows),
        launches=dict(cuts=cut_launches, pass1=p1_launches,
                      pass2=p2_launches),
        numbers=dict(
            pass1_encode_ms=p1_ms, pass2_constructor_ms=ctor_ms,
            pass2_encode_ms=p2_ms, pass2_decode_ms=p2_dec_ms,
            stats_ms=stats_ms, stats_scan_ms=scan_ms, stats_rows_ms=rows_ms,
            k1_ms=k1_ms, ext_stats_ms=ext_stats_ms,
            k1_ext_ms=ext_ms, pass2_bytes=sizes2, one_pass_bytes=sizes,
            find_best_state_ms=fbs_ms, seconds=seconds))


def mixed_q_phase(dev, gpu, rec, paths):
    """mixed_q: the 8bit path's and the 8bit_ctx1 path's packets spliced
    (``splice_packets``: even slices at quant table 0, odd at table 1)
    through one TorchFFV1Decoder (batch 2), every frame: two lane groups
    of 24 per step, K2 and K2-five-global.  Each frame must decode
    losslessly to the paths' source (the host decoder reads a valid
    stream losslessly; tests/test_torch_mixed_q.py holds the splice to
    FFV1Decoder on the CPU), with no slice flagged, and each kernel
    launch once per step.  ``rec``: the LastLaunch of rc_decode_planes.
    Returns its numbers and the warm-up frame's launches."""
    tag = "mixed_q"
    a, b = MIXED_Q
    goldens = load_goldens()
    check(goldens[a]["extradata"] == goldens[b]["extradata"],
          "mixed_q: the two paths' extradata differ")
    streams = path_streams(a)
    frames = PATHS[a].frames
    enc = TorchFFV1Encoder(EncoderParams(**params_kw(a)), batch=BATCH,
                           device=dev)
    dec = TorchFFV1Decoder(W, H, enc.extradata, batch=BATCH, device=dev)
    pkts = [[splice_packets(dec, pa, pb) for pa, pb in zip(fa, fb)]
            for fa, fb in zip(paths[a]["packets"], paths[b]["packets"])]
    dec_s, groups = [], None
    reset_counts()
    for t in range(frames):
        rec.armed = t == 1
        t0 = time.perf_counter()
        out = dec.decode_frames(pkts[t])
        dec_s.append(time.perf_counter() - t0)
        rec.armed = False
        for bi in range(BATCH):
            planes, kf = out[bi]
            check(kf == (t == 0), "keyframe flag")
            for k, p in enumerate(planes):
                check(np.array_equal(p, streams[bi][t][k]),
                      f"mixed_q stream {bi} frame {t} plane {k}: decode "
                      f"not lossless")
        check(not dec.slice_damaged.any(), "mixed_q: slice flagged damaged")
        if t == 1:
            groups = [(lanes, q) for lanes, _d, q in dec.last_groups]
    launches = all_launches()
    want = {"rc_decode": frames, "rc_decode_five_global": frames}
    check(launches == want, f"mixed_q: expected {want}, got {launches}")
    recs = rec.take_all()
    check([decode_instance(a) for a, _o in recs] ==
          ["rc_decode", "rc_decode_five_global"] and
          [q for _l, q in groups] == [0, 1],
          f"mixed_q: the warm-up frame's groups {groups}")
    group_ms = [cuda_time_ms(lambda a=a: rc_decode.rc_decode_planes(*a), 3)
                for a, _o in recs]
    dec_ms = step_stats(tag, "decode", dec_s[1 + WARM:], BATCH * W * H / 1e6,
                        gpu)
    log(f"[{tag}] {W}x{H} yuv420p, {BATCH} streams x {frames} frames, the "
        f"even slices of {a}'s packets and the odd ones of {b}'s: decode "
        f"lossless, no slice flagged; per step rc_decode "
        f"{group_ms[0]:.2f} ms ({len(groups[0][0])} lanes, table 0) + "
        f"rc_decode_five_global {group_ms[1]:.2f} ({len(groups[1][0])} "
        f"lanes, table 1), each timed alone ({gpu}); launches {launches}")
    return dict(launches=launches, dec_ms=dec_ms, group_ms=group_ms,
                steps=frames, groups=[lanes for lanes, _q in groups],
                recs=recs)


def nonuniform_phase(dev, gpu, rec_enc, rec_dec):
    """nonuniform_ext: version 4 on a grid of four slice sizes
    (``nonuniform_kw``, ``synthetic_streams_nonuniform``), batch 2, GOP 2
    over three frames: the RCT search per slice size, K1-ext over lanes
    of four lengths, and four K2-ext launches per step.  Its packets
    must equal the golden digests of the JAX package's TPUFFV1Encoder on
    the CPU (tests/test_torch_goldens.py), its decode be lossless, and
    each kernel launch as many times as that.  ``rec_enc`` and
    ``rec_dec``: the LastLaunch of rc_encode_packed and rc_decode_planes.
    Returns its numbers and the warm-up frame's launches."""
    tag = "nonuniform_ext"
    golden = load_goldens()[tag]
    streams = synthetic_streams_nonuniform()
    enc = TorchFFV1Encoder(EncoderParams(**nonuniform_kw()), batch=BATCH,
                           device=dev)
    check(digest(enc.extradata) == golden["extradata"],
          "nonuniform_ext: extradata differs from the golden")
    dec = TorchFFV1Decoder(NU_W, NU_H, enc.extradata, batch=BATCH,
                           device=dev)
    check(not enc.uniform and len(set(enc.stream_lens)) == 4,
          f"nonuniform_ext: lane lengths {sorted(set(enc.stream_lens))}")
    enc_ms, dec_ms, coefs = [], [], collections.Counter()
    reset_counts()
    for t in range(NU_FRAMES):
        frame = [streams[b][t] for b in range(BATCH)]
        rec_enc.armed = rec_dec.armed = t == 1
        ms, res = host_time_ms(lambda: enc.encode_frames(frame))
        enc_ms.append(ms)
        coefs.update(enc.rct_coefs)
        for b in range(BATCH):
            want = golden["packets"][b][t]
            check(digest(res[b][0]) == {"sha256": want["sha256"],
                                        "len": want["len"]} and
                  res[b][1] == want["key"],
                  f"nonuniform_ext stream {b} frame {t}: packet differs "
                  f"from the golden ({len(res[b][0])} vs {want['len']} B)")
        ms, out = host_time_ms(
            lambda: dec.decode_frames([r[0] for r in res]))
        dec_ms.append(ms)
        rec_enc.armed = rec_dec.armed = False
        for b in range(BATCH):
            for k, p in enumerate(out[b][0]):
                check(np.array_equal(p, frame[b][k]),
                      f"nonuniform_ext stream {b} frame {t} plane {k}: "
                      f"decode not lossless")
        check(not dec.slice_damaged.any(),
              "nonuniform_ext: slice flagged damaged")
    launches = all_launches()
    want = {"rc_encode_ext": NU_FRAMES, "rc_decode_ext": 4 * NU_FRAMES}
    check(launches == want, f"nonuniform_ext: expected {want}, got "
          f"{launches}")
    enc_rec = rec_enc.take()
    dec_recs = rec_dec.take_all()
    check(len(dec_recs) == 4, "nonuniform_ext: the warm-up decode's four "
          "launches were not recorded")
    log(f"[{tag}] {NU_W}x{NU_H} yuv444p16le, version 4, 2 x 2 slices of "
        f"four sizes, {BATCH} streams x {NU_FRAMES} frames (GOP 2): packets "
        f"equal to the golden digests (TPUFFV1Encoder), decode lossless; "
        f"searched (by, ry) {dict(sorted(coefs.items()))}; encode steps "
        f"{', '.join(f'{x:.2f}' for x in enc_ms)} ms, decode steps "
        f"{', '.join(f'{x:.2f}' for x in dec_ms)} ms ({gpu}); launches "
        f"{launches}")
    return dict(launches=launches, encode_ms=enc_ms, decode_ms=dec_ms,
                steps=NU_FRAMES, enc_rec=enc_rec, recs=dec_recs,
                groups=[lanes for lanes, _d, _q in dec.last_groups])


def median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2


def keep_args(obj, meth, kept):
    """Wrap ``obj.meth`` so that each call leaves its arguments in
    ``kept[meth]``; returns the unwrapped method."""
    fn = getattr(obj, meth)

    def wrapped(*args):
        kept[meth] = args
        return fn(*args)

    setattr(obj, meth, wrapped)
    return fn


def pframe_phase(dev, gpu, name, recorders):
    """One P path (``P_PATHS``): 12 slices, 2 streams x (a keyframe, a
    warm-up P frame, timed P frames) through TorchFFV1PEncoder and, where
    the path decodes, TorchFFV1PDecoder.  Each packet must equal the
    golden digests of the JAX package's host FFV1PEncoder
    (tests/test_torch_goldens.py),
    the decode be lossless with no slice flagged, and the lane scans
    launch once per frame: the keyframe's at its coded width, each P
    frame's at bits + 1, no other kernel.  Stage times (each alone, on
    the last frame's inputs): upload, search, OBMC + residual + stencil
    (with the MV section), lane scan, finalize and the rest (encode);
    the packet parse and the MV sections' parse on the host (the
    decoder's own clock in each step), lane scan, OBMC reconstruction
    and the rest (decode).  ``recorders``: the LastLaunch of
    rc_encode_packed and rc_decode_planes.  Returns its numbers and the
    warm-up P frame's launches."""
    path = P_PATHS[name]
    w, h, frames = path.width, path.height, path.frames
    tag = f"main {name}"
    k_enc, k_dec = path.kernels
    streams = p_streams(name)
    golden = load_goldens()[name]
    enc = TorchFFV1PEncoder(EncoderParams(**p_params_kw(name)), batch=BATCH,
                            me=path.me, experimental=True, device=dev)
    check(digest(enc.extradata) == golden["extradata"],
          f"{name}: extradata differs from the golden")
    check(enc.L == P_SLICES * BATCH and enc.p_bits == path.p_bits,
          f"{name}: lanes {enc.L}, residual width {enc.p_bits}")
    dec = TorchFFV1PDecoder(w, h, enc.extradata, batch=BATCH, device=dev) \
        if k_dec else None
    rec_enc, rec_dec = recorders["packed"], recorders["decode"]
    kept = {}
    search = keep_args(enc, "_search", kept)
    residual = keep_args(enc, "_residual_streams", kept)
    recon = keep_args(dec, "_reconstruct", kept) if dec else None
    log(f"[{tag}] {w}x{h} {path.pix_fmt}, {P_SLICES} slices of "
        f"{enc.geoms[0].width}x{enc.geoms[0].height} ({enc.bh}x{enc.bw} "
        f"blocks, pad {enc.pad_h}x{enc.pad_w}), GOP {P_GOP}, me={path.me} "
        f"radius {enc.radius}; residuals at {enc.p_bits} bits, lane length "
        f"{enc.mv_cap} MV slots + {enc.stream_lens[0]} px = p_n_max "
        f"{enc.p_n_max}; {BATCH}x{frames} frames"
        f"{'' if dec else ', encode only'}")
    enc_s, dec_s, peak, parse_ms, mv_ms, sizes = [], [], [], [], [], []
    reset_counts()
    for t in range(frames):
        # the warm-up P frame's launches (plain checks) and the last
        # frame's (stage times)
        rec_enc.armed = rec_dec.armed = t in (1, frames - 1)
        frame = [streams[b][t] for b in range(BATCH)]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = enc.encode_frames(frame)
        enc_s.append(time.perf_counter() - t0)
        peak.append((torch.cuda.max_memory_allocated() - base) / 2**30)
        sizes.append(sum(len(r[0]) for r in res))
        for b in range(BATCH):
            want = golden["packets"][b][t]
            check(digest(res[b][0]) == {"sha256": want["sha256"],
                                        "len": want["len"]} and
                  res[b][1] == want["key"],
                  f"{name} stream {b} frame {t}: packet differs from the "
                  f"golden ({len(res[b][0])} vs {want['len']} B)")
        decoded = ""
        if dec:
            t0 = time.perf_counter()
            out = dec.decode_frames([r[0] for r in res])
            dec_s.append(time.perf_counter() - t0)
            for b in range(BATCH):
                planes, kf = out[b]
                check(kf == (t == 0), "keyframe flag")
                for k in range(len(frame[b])):
                    check(np.array_equal(planes[k], frame[b][k]),
                          f"{name} stream {b} frame {t} plane {k}: decode "
                          f"not lossless")
            check(not dec.slice_damaged.any(), "slice flagged damaged")
            if t:
                parse_ms.append(dec.stage_ms["parse"])
                mv_ms.append(dec.stage_ms["mv_parse"])
            decoded = (f"decode lossless, {dec_s[-1] * 1e3:.2f} ms"
                       + (f" (MV parse {mv_ms[-1]:.2f})" if t else "") +
                       "; ")
        kind = "key" if t == 0 else "P, warm-up" if t <= WARM else "P"
        log(f"[{tag}] frame {t} ({kind}): {sizes[-1]} B, equal to the golden "
            f"digests; {decoded}encode {enc_s[-1] * 1e3:.2f} ms; peak device "
            f"memory {peak[-1]:.2f} GiB over the {base / 2**30:.2f} GiB held "
            f"({gpu})")
    rec_enc.armed = rec_dec.armed = False
    launches = all_launches()
    log(f"[{tag}] kernel launches in this path's {frames} steps: {launches}")
    want = collections.Counter({path.key_kernel: 1})
    want[k_enc] += frames - 1
    if k_dec:
        want[k_dec] += frames
    check(launches == dict(want), f"{name}: expected {dict(want)} launches "
          f"(one per frame and lane scan), and no other kernel: {launches}")
    enc_recs = rec_enc.take_all()
    dec_recs = rec_dec.take_all() if dec else []
    check(len(enc_recs) == 2 and len(dec_recs) == (2 if dec else 0) and
          enc_recs[0][0][8] == path.p_bits,
          f"{name}: the P frames' kernel calls were not recorded")

    mpix = BATCH * w * h / 1e6
    enc_ms = step_stats(tag, "encode", enc_s[1 + WARM:], mpix, gpu)
    up_ms, _x = host_time_ms(lambda: enc._upload(frame))
    search_ms = cuda_time_ms(lambda: search(*kept["_search"]), 3)
    res_ms = cuda_time_ms(lambda: residual(*kept["_residual_streams"]), 3)
    (k1_args, (packed, low, rng, _st)) = enc_recs[1]
    k1_ms = cuda_time_ms(lambda: rc_encode.rc_encode_packed(*k1_args), 3)
    _l, _r, prefixes, plens = enc._prefix_arrays(False)
    s2 = 4 if enc.p_bits <= 10 else 6
    fin_ms = cuda_time_ms(lambda: finalize_packed(packed, low, rng, prefixes,
                                                  plens, s2), 3)
    enc_rest = enc_ms - up_ms - search_ms - res_ms - k1_ms - fin_ms
    intra = int((k1_args[1][:, :enc.mv_cap:3] == 0).sum())
    log(f"[{tag}] encode stages (ms, L={enc.L}, each timed alone on the last "
        f"frame's inputs, {gpu}): upload {up_ms:.2f}, search ({path.me}) "
        f"{search_ms:.2f}, OBMC + residual + stencil {res_ms:.2f}, {k_enc} "
        f"(bits {enc.p_bits}) {k1_ms:.2f}, finalize s2={s2} {fin_ms:.2f}; the "
        f"median step minus these {enc_rest:.2f}; step peak "
        f"{max(peak[1 + WARM:]):.2f} GiB; P frames {sizes[1 + WARM:]} B "
        f"(keyframe {sizes[0]}); intra blocks in the last frame {intra} of "
        f"{enc.L * enc.bh * enc.bw}")
    result = dict(launches=launches, recs={k_enc: enc_recs[0]},
                  ms={k_enc: k1_ms}, p_launches={k_enc: frames - 1},
                  p_steps=frames - 1, mv_cap=enc.mv_cap, enc_ms=enc_ms,
                  dec_ms=None, p_frame_bytes=sizes[1:], key_bytes=sizes[0],
                  stages=dict(upload=up_ms, search=search_ms,
                              obmc_residual_stencil=res_ms, scan=k1_ms,
                              finalize=fin_ms, rest=enc_rest,
                              step_peak_gib=max(peak[1 + WARM:])))
    if not dec:
        return result
    dec_ms = step_stats(tag, "decode", dec_s[1 + WARM:], mpix, gpu)
    k2_args = dec_recs[1][0]
    k2_ms = cuda_time_ms(lambda: rc_decode.rc_decode_planes(*k2_args), 3)
    obmc_ms = cuda_time_ms(lambda: recon(*kept["_reconstruct"]), 3)
    parse = median(parse_ms[WARM:])
    mvp = median(mv_ms[WARM:])
    dec_rest = dec_ms - parse - mvp - k2_ms - obmc_ms
    log(f"[{tag}] decode stages (ms, {gpu}): parse {parse:.2f} and MV "
        f"sections {mvp:.2f} ({mvp / dec_ms * 100:.1f}% of the step; the "
        f"median of the decoder's own host clock over the timed steps: "
        f"{', '.join(f'{x:.2f}' for x in mv_ms[WARM:])}), {k_dec} (bits "
        f"{dec.p_bits}) {k2_ms:.2f}, OBMC reconstruction {obmc_ms:.2f} (each "
        f"timed alone on the last frame's inputs); the median step minus "
        f"these {dec_rest:.2f}")
    result["recs"][k_dec] = dec_recs[0]
    result["ms"][k_dec] = k2_ms
    result["p_launches"][k_dec] = frames - 1
    result["dec_ms"] = dec_ms
    result["stages"].update(parse=parse, mv_parse=mvp, dscan=k2_ms,
                            obmc=obmc_ms, dec_rest=dec_rest)
    return result


def strict(fn):
    """``fn`` run under torch.cuda.set_sync_debug_mode("error"): any call
    in it that waits for the card raises."""
    def call(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return call


def pipelined(submit, collect, steps, on_result):
    """Depth 2: two submits, then a collect before each further submit
    (each submit strict).  Calls ``on_result(t, result)`` per frame and
    returns the host-clock time from each collect's return to the next
    (the first: from the first submit), s."""
    submit = strict(submit)
    t_prev = time.perf_counter()
    submit(steps[0])
    times = []
    for t in range(len(steps)):
        if t + 1 < len(steps):
            submit(steps[t + 1])
        res = collect()
        now = time.perf_counter()
        times.append(now - t_prev)
        t_prev = now
        on_result(t, res)
    return times


# the intra paths pipelined (8bit_pipe, 16bit_pipe) and transcoded
# (transcode_8bit, transcode_16bit), and the P path pipelined
# (pframe_720p_pipe): frames, parameters and goldens of their cells
PIPE_PATHS = ("8bit", "16bit")
P_PIPE_PATH = "pframe_720p"


def pipeline_phase(dev, gpu, name):
    """<name>_pipe and transcode_<bits>: the cell's frames through
    TorchFFV1Encoder and TorchFFV1Decoder at depth 1 (encode_frames,
    decode_frames) and at depth 2 (``pipelined``, every submit under
    set_sync_debug_mode("error")); the packets equal the cell's goldens,
    the decodes lossless, each kernel launched once per frame at depth 2.
    Then the transcode: the depth-2 packets into
    TorchFFV1Decoder(device_out=True) and its planes into
    submit_device_frames of an encoder with the same parameters, both
    pipelined (and at depth 1 for the time), the packets again the
    goldens, and only (low, range, pos) and the byte slab fetched.
    Prints the median step at depth 1 and 2 (ms, host clock) and the
    slab's device-to-host time; returns the figures."""
    path = PATHS[name]
    w, h, frames = path.width, path.height, path.frames
    k_enc, k_dec = path.kernels
    streams = path_streams(name)
    golden = load_goldens()[name]
    steps = [[streams[b][t] for b in range(BATCH)] for t in range(frames)]
    bits = 8 if path.bits <= 8 else 16
    mpix = BATCH * w * h / 1e6

    def enc_new():
        return TorchFFV1Encoder(EncoderParams(**params_kw(name)),
                                batch=BATCH, device=dev)

    def packets_ok(label):
        def on_result(t, res):
            for b in range(BATCH):
                want = golden["packets"][b][t]
                check(digest(res[b][0]) == {"sha256": want["sha256"],
                                            "len": want["len"]} and
                      res[b][1] == want["key"],
                      f"{label} stream {b} frame {t}: packet differs from "
                      f"the golden")
        return on_result

    def lossless(label):
        def on_result(t, res):
            for b in range(BATCH):
                planes, kf = res[b]
                check(kf == (t == 0) and all(
                    a.dtype == f.dtype and np.array_equal(a, f)
                    for a, f in zip(planes, steps[t][b])),
                    f"{label} stream {b} frame {t}: decode not lossless")
        return on_result

    def launches_ok(label, want):
        got = all_launches()
        check(got == want, f"{label}: expected {want} launches, got {got}")
        return got

    tag = f"{name}_pipe"
    enc1 = enc_new()
    keep = {}
    fin = port_encoder.finalize_packed

    def finalize_kept(*args):
        out = fin(*args)
        keep["out"] = out[0]
        return out
    d1_enc = []
    for t, step in enumerate(steps):
        if t == frames - 1:
            port_encoder.finalize_packed = finalize_kept
        t0 = time.perf_counter()
        res = enc1.encode_frames(step)
        d1_enc.append(time.perf_counter() - t0)
        port_encoder.finalize_packed = fin
        packets_ok(f"{tag} depth 1")(t, res)
    slab = keep["out"][:, :enc1.out_cap]
    host_slab = torch.empty(slab.shape, dtype=slab.dtype, pin_memory=True)
    d2h_ms = cuda_time_ms(lambda: host_slab.copy_(slab, non_blocking=True),
                          3)
    enc2 = enc_new()
    reset_counts()
    packets = []

    def keep_packets(t, res):
        packets_ok(f"{tag} depth 2")(t, res)
        packets.append([r[0] for r in res])
    d2_enc = pipelined(enc2.submit_frames, enc2.collect_frames, steps,
                       keep_packets)
    enc_launches = launches_ok(f"{tag} encode", {k_enc: frames})
    dec1 = TorchFFV1Decoder(w, h, enc1.extradata, batch=BATCH, device=dev)
    d1_dec = []
    for t, pk in enumerate(packets):
        t0 = time.perf_counter()
        res = dec1.decode_frames(pk)
        d1_dec.append(time.perf_counter() - t0)
        lossless(f"{tag} depth 1")(t, res)
    dec2 = TorchFFV1Decoder(w, h, enc1.extradata, batch=BATCH, device=dev)
    reset_counts()
    d2_dec = pipelined(dec2.submit_frames, dec2.collect_frames, packets,
                       lossless(f"{tag} depth 2"))
    check(not dec2.slice_damaged.any(), f"{tag}: slice flagged damaged")
    dec_launches = launches_ok(f"{tag} decode", {k_dec: frames})
    med = {k: median([1e3 * x for x in v[1 + WARM:]])
           for k, v in (("enc_d1", d1_enc), ("enc_d2", d2_enc),
                        ("dec_d1", d1_dec), ("dec_d2", d2_dec))}
    log(f"[{tag}] {w}x{h} {path.pix_fmt}, batch {BATCH}, {frames} frames, "
        f"every submit under set_sync_debug_mode(\"error\"): packets equal "
        f"to the goldens, decodes lossless; launches at depth 2: encode "
        f"{enc_launches}, decode {dec_launches}; median step over the "
        f"{frames - 1 - WARM} timed frames ({gpu}): encode depth 1 "
        f"{med['enc_d1']:.2f} ms ({mpix / med['enc_d1'] * 1e3:.2f} Mpix/s), "
        f"depth 2 {med['enc_d2']:.2f} ms "
        f"({mpix / med['enc_d2'] * 1e3:.2f} Mpix/s); decode depth 1 "
        f"{med['dec_d1']:.2f} ms ({mpix / med['dec_d1'] * 1e3:.2f} "
        f"Mpix/s), depth 2 {med['dec_d2']:.2f} ms "
        f"({mpix / med['dec_d2'] * 1e3:.2f} Mpix/s); the byte slab "
        f"{tuple(slab.shape)} to pinned memory {d2h_ms:.2f} ms (CUDA "
        f"events, alone)")

    # the transcode: no plane reaches the host
    ttag = f"transcode_{bits}bit"
    tdec = TorchFFV1Decoder(w, h, enc1.extradata, batch=BATCH, device=dev,
                            device_out=True)
    tenc = enc_new()
    d1_tr = []
    for t, pk in enumerate(packets):
        t0 = time.perf_counter()
        planes, _kf = tdec.decode_frames(pk)
        tenc.submit_device_frames(planes)
        res = tenc.collect_frames()
        d1_tr.append(time.perf_counter() - t0)
        packets_ok(f"{ttag} depth 1")(t, res)
    tdec = TorchFFV1Decoder(w, h, enc1.extradata, batch=BATCH, device=dev,
                            device_out=True)
    tenc = enc_new()
    reset_counts()
    tdec_submit = strict(tdec.submit_frames)
    tenc_submit = strict(tenc.submit_device_frames)
    d2_tr = []
    t_prev = time.perf_counter()
    tdec_submit(packets[0])
    for t in range(frames):
        if t + 1 < frames:
            tdec_submit(packets[t + 1])
        planes, keyframes = tdec.collect_frames()
        check(keyframes == [t == 0] * BATCH and all(
            p.dtype == (torch.uint8 if bits == 8 else torch.int32) and
            p.device == dev for p in planes),
            f"{ttag}: device_out planes")
        tenc_submit(planes)
        if t:
            packets_ok(f"{ttag} depth 2")(t - 1, tenc.collect_frames())
            now = time.perf_counter()
            d2_tr.append(now - t_prev)
            t_prev = now
    packets_ok(f"{ttag} depth 2")(frames - 1, tenc.collect_frames())
    d2_tr.append(time.perf_counter() - t_prev)
    tr_launches = launches_ok(ttag, {k_enc: frames, k_dec: frames})
    d2h = (tdec.pipe.fetched_bytes + tenc.pipe.fetched_bytes) / frames
    check(tdec.pipe.fetched_bytes == frames * 3 * tdec.L * 4,
          f"{ttag}: the decoder fetched more than (low, range, pos)")
    med["tr_d1"] = median([1e3 * x for x in d1_tr[1 + WARM:]])
    med["tr_d2"] = median([1e3 * x for x in d2_tr[1 + WARM:]])
    log(f"[{ttag}] {name}'s packets -> TorchFFV1Decoder(device_out=True) "
        f"-> submit_device_frames, every submit strict: packets equal to "
        f"the goldens; launches {tr_launches}; bytes copied to the host "
        f"per frame {d2h:.0f} (the decoder's (low, range, pos) "
        f"{tdec.pipe.fetched_bytes // frames}, the encoder's counts, "
        f"overflow flags and byte slab {tenc.pipe.fetched_bytes // frames}; "
        f"no plane); median ms per frame ({gpu}): depth 1 "
        f"{med['tr_d1']:.2f}, depth 2 {med['tr_d2']:.2f}")
    return dict(med, slab_d2h_ms=d2h_ms, transcode_d2h_bytes=d2h,
                launches=dict(encode=enc_launches, decode=dec_launches,
                              transcode=tr_launches))


def pframe_pipeline_phase(dev, gpu):
    """pframe_720p_pipe: the P cell's frames through TorchFFV1PEncoder at
    depth 1 and at depth 2 (every submit strict), the packets equal to
    its goldens, each lane scan launched once per frame at depth 2;
    prints the median step at each depth."""
    name = P_PIPE_PATH
    path = P_PATHS[name]
    frames = path.frames
    streams = p_streams(name)
    golden = load_goldens()[name]
    steps = [[streams[b][t] for b in range(BATCH)] for t in range(frames)]
    tag = f"{name}_pipe"

    def enc_new():
        return TorchFFV1PEncoder(EncoderParams(**p_params_kw(name)),
                                 batch=BATCH, me=path.me, experimental=True,
                                 device=dev)

    def packets_ok(t, res):
        for b in range(BATCH):
            want = golden["packets"][b][t]
            check(digest(res[b][0]) == {"sha256": want["sha256"],
                                        "len": want["len"]} and
                  res[b][1] == want["key"],
                  f"{tag} stream {b} frame {t}: packet differs from the "
                  f"golden")
    enc = enc_new()
    d1 = []
    for t, step in enumerate(steps):
        t0 = time.perf_counter()
        res = enc.encode_frames(step)
        d1.append(time.perf_counter() - t0)
        packets_ok(t, res)
    enc = enc_new()
    reset_counts()
    d2 = pipelined(enc.submit_frames, enc.collect_frames, steps, packets_ok)
    want = collections.Counter({path.key_kernel: 1})
    want[path.kernels[0]] += frames - 1
    launches = all_launches()
    check(launches == dict(want), f"{tag}: expected {dict(want)} launches, "
          f"got {launches}")
    mpix = BATCH * path.width * path.height / 1e6
    med = {k: median([1e3 * x for x in v[1 + WARM:]])
           for k, v in (("enc_d1", d1), ("enc_d2", d2))}
    log(f"[{tag}] {path.width}x{path.height} {path.pix_fmt}, batch {BATCH}, "
        f"{frames} frames, every submit strict: packets equal to the "
        f"goldens; launches at depth 2 {launches}; median step over the "
        f"{frames - 1 - WARM} timed P frames ({gpu}): depth 1 "
        f"{med['enc_d1']:.2f} ms ({mpix / med['enc_d1'] * 1e3:.2f} Mpix/s), "
        f"depth 2 {med['enc_d2']:.2f} ms "
        f"({mpix / med['enc_d2'] * 1e3:.2f} Mpix/s)")
    return dict(med, launches=launches)


def ya8_phase(dev, gpu, name, recorders):
    """ya8 and ya8_golomb: 1080p gray + alpha (``ya8_kw``,
    ``synthetic_streams_ya8``), batch 2, 3 frames at GOP 2, through
    TorchFFV1Encoder and TorchFFV1Decoder at depth 1 and at depth 2
    (``pipelined``): the encoder splits each (H, W, 2) frame into a luma
    and an alpha plane, which ride K1 and K2 (G1 and G2) at the 8bit
    (8bit_golomb) path's shapes, two 320x270 planes a slice (N = 172,800);
    the packets equal the host C encoder's golden digests, each decode
    one (H, W, 2) array equal to the source, each kernel launched once
    per frame at each depth.  ``recorders``: the LastLaunch of the lane
    scans; frame 1's launches, from a third, untimed run, are kept for
    phase 6 and timed alone.  Prints the encode and decode ms of each
    step; returns the figures (``recs``: the kept launches)."""
    coder, (k_enc, k_dec) = YA8[name]
    rec_enc = recorders["packed" if coder else "golomb_encode"]
    rec_dec = recorders["decode" if coder else "golomb_decode"]
    streams = ya8_streams()
    golden = load_goldens()[name]
    steps = [[streams[b][t] for b in range(BATCH)]
             for t in range(YA8_FRAMES)]
    mpix = BATCH * W * H / 1e6
    params = EncoderParams(**ya8_kw(name))

    def packets_ok(label):
        def on_result(t, res):
            for b in range(BATCH):
                want = golden["packets"][b][t]
                check(digest(res[b][0]) == {"sha256": want["sha256"],
                                            "len": want["len"]} and
                      res[b][1] == want["key"],
                      f"{label} stream {b} frame {t}: packet differs from "
                      f"the golden")
        return on_result

    def lossless(label):
        def on_result(t, res):
            for b in range(BATCH):
                planes, kf = res[b]
                check(kf == (t % YA8_GOP == 0) and len(planes) == 1 and
                      planes[0].dtype == np.uint8 and
                      np.array_equal(planes[0], steps[t][b][0]),
                      f"{label} stream {b} frame {t}: decode not lossless")
        return on_result

    def launches_ok(label):
        got = all_launches()
        want = {k_enc: YA8_FRAMES, k_dec: YA8_FRAMES}
        check(got == want, f"{label}: expected {want} launches, got {got}")
        return got

    enc = TorchFFV1Encoder(params, batch=BATCH, device=dev)
    dec = TorchFFV1Decoder(W, H, enc.extradata, batch=BATCH, device=dev)
    check(digest(enc.extradata) == golden["extradata"],
          f"{name}: extradata differs from the golden")
    check(enc.ya and dec.ya and enc.L == SLICES * BATCH and enc.bits == 8 and
          enc.n_max == 2 * (W // 6) * (H // 4) and
          dec.slice_dims[0] == ((W // 6, H // 4, 0), (W // 6, H // 4, 1)),
          f"{name}: expected 48 lanes of two {W // 6}x{H // 4} planes at 8 "
          f"bits")
    tag = name
    reset_counts()
    d1_enc, d1_dec, packets = [], [], []
    for t, step in enumerate(steps):
        ms, res = host_time_ms(lambda: enc.encode_frames(step))
        d1_enc.append(ms)
        packets_ok(f"{tag} depth 1")(t, res)
        packets.append([r[0] for r in res])
        ms, out = host_time_ms(lambda: dec.decode_frames(packets[-1]))
        d1_dec.append(ms)
        lossless(f"{tag} depth 1")(t, out)
    launches = launches_ok(f"{tag} depth 1")
    enc2 = TorchFFV1Encoder(params, batch=BATCH, device=dev)
    reset_counts()
    d2_enc = pipelined(enc2.submit_frames, enc2.collect_frames, steps,
                       packets_ok(f"{tag} depth 2"))
    dec2 = TorchFFV1Decoder(W, H, enc.extradata, batch=BATCH, device=dev)
    d2_dec = pipelined(dec2.submit_frames, dec2.collect_frames, packets,
                       lossless(f"{tag} depth 2"))
    check(not dec.slice_damaged.any() and not dec2.slice_damaged.any(),
          f"{tag}: slice flagged damaged")
    launches_ok(f"{tag} depth 2")
    # phase 6's launches: frame 1 of a fresh depth-1 run that stops
    # there, untimed and uncounted (frame 2 is a keyframe, whose reset of
    # the decoder's VLC table in place would change a recorded output)
    enc3 = TorchFFV1Encoder(params, batch=BATCH, device=dev)
    dec3 = TorchFFV1Decoder(W, H, enc.extradata, batch=BATCH, device=dev)
    for t in range(2):
        rec_enc.armed = rec_dec.armed = (t == 1)
        pkts = [r[0] for r in enc3.encode_frames(steps[t])]
        check(pkts == packets[t], f"{tag}: the recording run's packets")
        dec3.decode_frames(pkts)
    rec_enc.armed = rec_dec.armed = False
    recs = {k_enc: rec_enc.take_all(), k_dec: rec_dec.take_all()}
    check(all(len(v) == 1 for v in recs.values()),
          f"{tag}: the warm-up frame's kernel calls were not recorded")
    recs = {k: v[0] for k, v in recs.items()}
    res = dict(enc_d1=d1_enc, dec_d1=d1_dec,
               enc_d2=[1e3 * x for x in d2_enc],
               dec_d2=[1e3 * x for x in d2_dec], launches=launches,
               steps=YA8_FRAMES, recs=recs, ms=scan_ms(recs))
    log(f"[{tag}] {W}x{H} ya8, {'range coder' if coder else 'Golomb-Rice'}, "
        f"batch {BATCH}, {YA8_FRAMES} frames at GOP {YA8_GOP} (luma and "
        f"alpha planes, {enc.n_max} px a lane): packets equal to the "
        f"goldens, decodes lossless at depth 1 and 2, every submit strict; "
        f"launches per depth {launches}; ms a step ({gpu}), frames "
        f"{', '.join(map(str, range(YA8_FRAMES)))}: depth 1 encode "
        + ", ".join(f"{x:.2f}" for x in d1_enc) + " (frames 1-2 median "
        f"{median(d1_enc[1:]):.2f} = "
        f"{mpix / median(d1_enc[1:]) * 1e3:.2f} Mpix/s), decode "
        + ", ".join(f"{x:.2f}" for x in d1_dec) + " (frames 1-2 median "
        f"{median(d1_dec[1:]):.2f} = "
        f"{mpix / median(d1_dec[1:]) * 1e3:.2f} Mpix/s); depth 2 encode "
        + ", ".join(f"{x:.2f}" for x in res["enc_d2"]) + ", decode "
        + ", ".join(f"{x:.2f}" for x in res["dec_d2"]) + "; the warm-up "
        f"frame's launches alone: " + ", ".join(
            f"{k} {v:.2f}" for k, v in res["ms"].items()))
    return res


SCANS = {"rc_encode": lambda: rc_encode.rc_encode_packed,
         "rc_decode": lambda: rc_decode.rc_decode_planes,
         "golomb_encode": lambda: golomb_encode.golomb_encode_lanes,
         "golomb_decode": lambda: golomb_decode.golomb_decode_planes}


def scan_ms(recs):
    """{instance: ms} of each recorded launch run again alone."""
    return {k: cuda_time_ms(lambda k=k, a=a: SCANS[k]()(*a), 3)
            for k, (a, _o) in recs.items()}


CLI_PATH = "8bit"


def cli_phase(dev, gpu, recorders, keep_avi=None):
    """cli: the 8bit path's stream 0 (8 frames of 1080p yuv420p) written to
    a y4m in a temporary directory, then the port's command line run in
    this process on the card (``python -m tpu_ffv1_torch``'s ``run``,
    default device cuda) with the path's parameters, ``-c:v ffv1 -level 3
    -coder 2 -slices 24 -benchmark`` into an avi: every packet of the
    file (demuxed with the port's avi reader) equal to the 8bit golden
    digests of stream 0, K1 launched once per frame; then the file
    decoded back through the command line to a y4m, equal to the source,
    K2 once per frame.  ``recorders``: the LastLaunch of K1 and K2; each
    run is made again, untimed, for its frame-1 launch (batch 1, L=24),
    kept for phase 6 and timed alone.  Prints each run's wall time and its -benchmark Mpix/s;
    returns the figures (``recs``: the kept launches).  ``keep_avi``: a
    path the encoded avi is copied to (the serve phase's file stream)."""
    frames = [s for s in path_streams(CLI_PATH)[0]]
    n = len(frames)
    golden = load_goldens()[CLI_PATH]
    k_enc, k_dec = PATHS[CLI_PATH].kernels
    out = {}
    recs = {}

    def cli(label, args, kernel):
        err = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = port_cli.run(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        said = err.getvalue()
        check(rc == 0, f"cli {label}: exit code {rc}: {said}")
        launches = all_launches()
        check(launches == {kernel: n},
              f"cli {label}: expected {{{kernel!r}: {n}}} launches, got "
              f"{launches}")
        bench = re.search(r"bench: ([\d.]+)s\s+([\d.]+) Mpixel/s", said)
        check(bench is not None, f"cli {label}: no -benchmark line: {said}")
        out[label] = dict(wall_s=wall, bench_s=float(bench.group(1)),
                          bench_mpix_s=float(bench.group(2)),
                          launches=launches)
        # phase 6's launch: frame 1 of the same run made again, untimed
        # and uncounted, into a file of its own
        rec = recorders["packed" if kernel == k_enc else "decode"]
        again = args[:-1] + [os.path.join(os.path.dirname(args[-1]),
                                          "again_" +
                                          os.path.basename(args[-1]))]
        rec.armed = True
        try:
            with contextlib.redirect_stderr(io.StringIO()):
                rc = port_cli.run(again)
        finally:
            rec.armed = False
        calls = rec.take_all()
        same = rc == 0 and filecmp.cmp(args[-1], again[-1], shallow=False)
        check(same and len(calls) == n,
              f"cli {label}: the recording run's exit code {rc}, its "
              f"{len(calls)} calls of {kernel}, or its file")
        recs[kernel] = calls[1]           # submitted in frame order
        return said.strip().splitlines()[0]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as d:
        src, avi, back = (os.path.join(d, f) for f in
                          ("in.y4m", "out.avi", "back.y4m"))
        write_y4m(src, frames, "yuv420p", W, H)
        line_enc = cli("encode", ["-i", src, "-c:v", "ffv1", "-level", "3",
                                  "-coder", "2", "-context", "0",
                                  "-slices", str(SLICES), "-benchmark",
                                  avi], k_enc)
        st = read_avi(avi)
        check((st.width, st.height, len(st.packets)) == (W, H, n) and
              digest(st.extradata) == golden["extradata"],
              "cli: the avi's geometry, frame count or extradata")
        for t, (pkt, key) in enumerate(zip(st.packets, st.keyflags)):
            want = golden["packets"][0][t]
            check(digest(pkt) == {"sha256": want["sha256"],
                                  "len": want["len"]} and
                  bool(key) == want["key"],
                  f"cli frame {t}: packet differs from the golden")
        if keep_avi:
            shutil.copyfile(avi, keep_avi)
        line_dec = cli("decode", ["-i", avi, "-benchmark", back], k_dec)
        got, fmt, w, h, _fps = read_y4m(back)
        check(fmt == "yuv420p" and (w, h) == (W, H) and len(got) == n and
              all(np.array_equal(a, b) for fa, fb in zip(got, frames)
                  for a, b in zip(fa, fb)),
              "cli: the decoded y4m differs from the source")
    out.update(recs=recs, ms=scan_ms(recs), steps=n,
               launches={k: out[lab]["launches"][k] for lab, k in
                         (("encode", k_enc), ("decode", k_dec))})
    log(f"[cli] python -m tpu_ffv1_torch on the card ({gpu}), {CLI_PATH}'s "
        f"stream 0, {n} frames {W}x{H} yuv420p, y4m -> avi -> y4m: "
        f"\"{line_enc}\", every packet equal to the golden digests; "
        f"\"{line_dec}\", equal to the source; encode wall "
        f"{out['encode']['wall_s']:.3f} s (-benchmark "
        f"{out['encode']['bench_mpix_s']:.2f} Mpix/s), decode wall "
        f"{out['decode']['wall_s']:.3f} s (-benchmark "
        f"{out['decode']['bench_mpix_s']:.2f} Mpix/s); launches "
        f"{out['encode']['launches']}, {out['decode']['launches']}; the "
        f"frame-1 launches alone: " + ", ".join(
            f"{k} {v:.2f}" for k, v in out["ms"].items()))
    return out


# ------------------------------------------------------------ serve phase

# the streaming server on the card (serve_phase): cli's content, the
# 8bit path's stream 0, published to a live feed whose stream options
# give that path's parameters (with _feed_params' level 3, coder 2,
# slicecrc 1); limits raised for 1080p (one client moves about 280
# Mbit/s at 25 fps, past the default MaxBandwidth of 1000 kbit/s)
SERVE_CONF = """
MaxClients 8
MaxBandwidth 10000000
<Feed cam.ffm>
FileMaxSize 40M
ACL allow 127.0.0.1
</Feed>
<Stream live.nut>
Feed cam.ffm
VideoGopSize 12
AVOptionVideo slices {slices}
</Stream>
<Stream live.y4m>
Feed cam.ffm
</Stream>
<Stream clip.avi>
File {avi}
</Stream>
"""
SERVE_TIMEOUT = 300                 # seconds for any one request


def http_post(port, path, payload):
    """POST ``payload`` over a raw socket -> the whole response."""
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=SERVE_TIMEOUT) as sk:
        sk.sendall(f"POST {path} HTTP/1.1\r\nHost: chip_smoke\r\n"
                   f"Content-Length: {len(payload)}\r\n\r\n".encode())
        sk.sendall(payload)
        resp = bytearray()
        while (b := sk.recv(1 << 20)):
            resp += b
    return bytes(resp)


def http_get(port, path):
    """GET ``path`` -> (status, body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=SERVE_TIMEOUT)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def serve_phase(gpu, avi):
    """serve: the port's streaming server (cli/serve.py) on the card, on a
    thread of this process, ``make_server(config=parse_config(SERVE_CONF),
    port=0, device="cuda")``.  A publisher POSTs cli's 8 frames of 1080p
    yuv420p as y4m at 25/1 (K1 once a frame, two in flight); once the
    first packet has landed, two /live.nut clients, one /live.y4m client
    (its own decoder: K2 once a frame) and a GET of the file stream
    /clip.y4m (``avi``, cli's file, decoded through play._decode_from)
    run while the ingest goes on.  Every NUT packet of both clients equals
    the 8bit golden of stream 0 (SHA-256, length, key flag), every y4m
    frame equals its source, K1 ran 8 times and K2 16 (8 for each y4m
    decode).  Then each alone: the same POST with no client (K1 8 times,
    the ring's packets the goldens) and a /live.y4m pull once it has
    ended (K2 8 times, the same body).  Then ``play -nodisp -ss 5`` on
    the avi (K2 8 times: the roll-in from keyframe 0) and its
    ``_decode_from`` frames 5-7 equal to the source.  Prints the ingest's
    frames/s, each client's wall time and MB/s, the runs alone and the
    play decode's wall time; returns the figures."""
    t_phase = time.perf_counter()
    frames = path_streams(CLI_PATH)[0]
    n = len(frames)
    golden = load_goldens()[CLI_PATH]
    want_pkts = [({"sha256": p["sha256"], "len": p["len"]}, p["key"])
                 for p in golden["packets"][0]]
    k_enc, k_dec = PATHS[CLI_PATH].kernels
    buf = io.BytesIO()
    write_y4m_stream(buf, frames, "yuv420p", W, H, (25, 1))
    payload = buf.getvalue()
    srv = port_serve.make_server(config=parse_config(SERVE_CONF.format(
        slices=SLICES, avi=avi)), port=0, device="cuda")
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    port = srv.server_address[1]
    feed = srv.RequestHandlerClass.live_feeds["cam.ffm"]
    res, errors = {}, []
    gets = {"nut_a": "/live.nut", "nut_b": "/live.nut",
            "y4m": "/live.y4m", "file_y4m": "/clip.y4m"}

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception as e:        # failed by the check after the join
            errors.append(f"{label}: {type(e).__name__}: {e}")
            return
        res[label] = (out, time.perf_counter() - t0)

    def launched(label, want):
        torch.cuda.synchronize()
        got = all_launches()
        check(got == want, f"serve {label}: expected launches {want}, got "
              f"{got}")
        return got

    def ingested(label):
        resp = res[label][0]
        check(resp.startswith(b"HTTP/1.0 200") and
              resp.endswith(f"ingested {n} frame(s)\n".encode()),
              f"serve {label}: the POST answered {resp[:200]!r}")

    try:
        # all at once: the ingest, then four clients once a packet landed
        reset_counts()
        pub = threading.Thread(target=timed, args=(
            "ingest", http_post, port, "/cam.ffm", payload))
        pub.start()
        t_end = time.perf_counter() + SERVE_TIMEOUT
        while not feed.ring and pub.is_alive() and \
                time.perf_counter() < t_end:
            time.sleep(0.001)
        check(bool(feed.ring), f"serve: no packet landed ({errors})")
        joined = feed.publishing
        clients = [threading.Thread(target=timed,
                                    args=(label, http_get, port, path))
                   for label, path in gets.items()]
        for t in clients:
            t.start()
        for t in [pub] + clients:
            t.join(SERVE_TIMEOUT)
            check(not t.is_alive(), "serve: a request did not end")
        check(not errors, f"serve: {errors}")
        ingested("ingest")
        launches = launched("all at once", {k_enc: n, k_dec: 2 * n})
        # each alone: the ingest with no client, then one y4m pull
        reset_counts()
        timed("ingest_alone", http_post, port, "/cam.ffm", payload)
        check(not errors, f"serve: {errors}")
        ingested("ingest_alone")
        launched("ingest alone", {k_enc: n})
        check([(digest(p), bool(k)) for _s, p, k in feed.ring] == want_pkts,
              "serve ingest alone: the ring's packets differ from the "
              "goldens")
        reset_counts()
        timed("y4m_alone", http_get, port, "/live.y4m")
        check(not errors, f"serve: {errors}")
        launched("y4m pull alone", {k_dec: n})
    finally:
        srv.shutdown()
        srv.server_close()
        server.join(60)
    check(res["y4m_alone"][0] == res["y4m"][0],
          "serve: the y4m pull alone differs from the one beside the ingest")
    out = dict(frames=n, ingest_s=res["ingest"][1],
               ingest_fps=n / res["ingest"][1],
               clients_joined_during_ingest=joined, launches=launches,
               ingest_alone_s=res["ingest_alone"][1],
               y4m_alone_s=res["y4m_alone"][1])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as d:
        for label in gets:
            (status, body), wall = res[label]
            check(status == 200, f"serve {label}: status {status}")
            path = os.path.join(d, f"{label}.{gets[label][-3:]}")
            with open(path, "wb") as f:
                f.write(body)
            if label.startswith("nut"):
                st = read_nut(path)
                check(digest(st.extradata) == golden["extradata"] and
                      [(digest(p), bool(k)) for p, k in
                       zip(st.packets, st.keyflags)] == want_pkts,
                      f"serve {label}: the packets differ from the goldens")
            else:
                got, fmt, w, h, _fps = read_y4m(path)
                check(fmt == "yuv420p" and (w, h) == (W, H) and
                      len(got) == n and
                      all(np.array_equal(a, b) for fa, fb in
                          zip(got, frames) for a, b in zip(fa, fb)),
                      f"serve {label}: the y4m differs from the source")
            out[label] = dict(wall_s=wall, bytes=len(body),
                              mb_s=len(body) / wall / 1e6)
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()) as err:
        rc = port_play.play(["-nodisp", "-ss", "5", avi, "-device", "cuda"])
    said = err.getvalue().strip()
    check(rc == 0, f"serve play: exit code {rc}: {said}")
    launched("play", {k_dec: n})
    play_s = time.perf_counter() - t0
    got, fmt, w, h, _fps, start = port_play._decode_from(avi, 5, "cuda")
    check(start == 0 and len(got) == n - 5 and
          all(np.array_equal(a, b) for fa, fb in zip(got, frames[5:])
              for a, b in zip(fa, fb)),
          "serve play: frames 5-7 differ from the source")
    out.update(play=dict(wall_s=play_s, said=said),
               seconds=time.perf_counter() - t_phase)
    log(f"[serve] the port's streaming server on the card ({gpu}): "
        f"{n} frames {W}x{H} yuv420p POSTed to cam.ffm in "
        f"{out['ingest_s']:.3f} s ({out['ingest_fps']:.2f} frames/s, K1 "
        f"two in flight); clients (joined "
        f"{'during' if joined else 'after'} the ingest): " + "; ".join(
            f"{label} {out[label]['wall_s']:.3f} s, "
            f"{out[label]['bytes']} B, {out[label]['mb_s']:.2f} MB/s"
            for label in gets) +
        f"; every NUT packet equal to the golden digests, every y4m frame "
        f"equal to its source; launches {launches}; alone: the ingest "
        f"{out['ingest_alone_s']:.3f} s ({n / out['ingest_alone_s']:.2f} "
        f"frames/s), the y4m pull {out['y4m_alone_s']:.3f} s, the same "
        f"bytes; play -nodisp -ss 5 {play_s:.3f} s (\"{said}\"), frames "
        f"5-7 equal to the source; the phase {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------- sharded phase

# the sharded phase (sharded_phase): the 8bit path (BASELINE config 2) and
# the 16bit path at full size, 48 lanes, a prefix of their frames and
# goldens; BASELINE config 5 at its real geometry, 16 lanes
SHARD_PATHS = ("8bit", "16bit")
SHARD_FRAMES = 4                    # a key, a warm-up and two timed frames
C5_W, C5_H, C5_SLICES = 3840, 2160, 16
C5_ME = "epzs"


def config5_kw():
    """EncoderParams fields of BASELINE config 5 as the JAX package's 4K
    dry run codes it (__graft_entry__.py:177-227): 3840x2160 yuv422p10le,
    16 slices (4 x 4), range coder, slice CRCs, GOP 2."""
    return dict(width=C5_W, height=C5_H, pix_fmt="yuv422p10le", level=3,
                coder=2, slices=C5_SLICES, slicecrc=1, gop_size=2)


def config5_frames():
    """That dry run's key frame and P frame (__graft_entry__.py:189-202): a
    ramp of step 9 mod 1024 moved by (t, 3t) in luma, (t, t) and (t, 2t)
    in the chroma planes."""
    base = (np.add.outer(np.arange(C5_H + 8), np.arange(C5_W + 8)) * 9
            % 1024).astype(np.uint16)
    return [[np.ascontiguousarray(p) for p in (
        base[t:t + C5_H, 3 * t:3 * t + C5_W],
        base[t:t + C5_H, t:t + C5_W // 2],
        base[t:t + C5_H, 2 * t:2 * t + C5_W // 2])] for t in range(2)]


def shard_devices():
    """The sharded phase's device list: make_devices(k) for the largest k
    of 2, 4 and 8 that the card count allows and that divides both of its
    lane counts (48 and 16); with one card, cuda:0 twice.  Prints the
    card count on a line of its own and what the groups run on."""
    n = torch.cuda.device_count()
    log(f"[sharded] torch.cuda.device_count() = {n}")
    ks = [k for k in (2, 4, 8)
          if k <= n and (BATCH * SLICES) % k == 0 and C5_SLICES % k == 0]
    if ks:
        devs = make_devices(max(ks))
        log(f"[sharded] {len(devs)} lane groups on {len(devs)} distinct "
            f"cards: {', '.join(map(str, devs))}")
    else:
        devs = [torch.device("cuda", 0)] * 2
        log("[sharded] one card: 2 lane groups, both on cuda:0, run one "
            "after the other; their step times are not a scaling figure")
    return devs


def on_device_ms(dev, fn, reps):
    """cuda_time_ms of fn with ``dev`` current."""
    with torch.cuda.device(dev):
        return cuda_time_ms(fn, reps)


def group_stages(devs, kept, blocks, s2, reps):
    """Each lane group's scan and finalize, and the gather of their outputs
    on the lead device, timed alone (CUDA events) on the last frame's
    recorded block launches ``blocks`` [(args, out)] and the prefixes of
    its kept ``_scan_finalize`` arguments.  Returns (scan ms per group,
    finalize ms per group, gather ms)."""
    prefixes, plens = kept[6], kept[7]
    scan_ms, fin_ms, outs = [], [], []
    for dev, sl, (args, out) in zip(
            devs, sharding.lane_blocks(prefixes.shape[0], len(devs)),
            blocks):
        packed, low, rng, states = out
        pre, pl = prefixes[sl].to(dev), plens[sl].to(dev)
        scan_ms.append(on_device_ms(
            dev, lambda a=args: rc_encode.rc_encode_packed(*a), reps))
        fin_ms.append(on_device_ms(dev, lambda: finalize_packed(
            packed, low, rng, pre, pl, s2), reps))
        with torch.cuda.device(dev):
            fo, fc, fv = finalize_packed(packed, low, rng, pre, pl, s2)
        outs.append((fo, fc, states, fv, packed, low, rng))
    dims = (0, 0, 0, 0, 2, 0, 0)
    gather_ms = cuda_time_ms(lambda: [
        sharding._gather(parts, devs[0], d)
        for parts, d in zip(zip(*outs), dims)], reps)
    return scan_ms, fin_ms, gather_ms


def sharded_intra(gpu, name, devs, recorders, unsharded):
    """(a): a prefix of ``name``'s frames (SHARD_FRAMES) through
    TorchFFV1Encoder(devices=devs) and TorchFFV1Decoder(devices=devs), at
    depth 1 (encode_frames, decode_frames) and at depth 2 (``pipelined``,
    every submit strict): every packet equal to the path's golden, every
    decode lossless in one lane group, each kernel launched once per
    frame and group.  Prints the median steps beside the unsharded ones
    of this run (``unsharded``: {enc_d1, dec_d1, enc_d2, dec_d2} or None)
    and the last frame's stages: the stencil, each group's scan and
    finalize (K2 decode), the gather.  Returns the figures and the last
    frame's block launches."""
    path = PATHS[name]
    w, h, frames = path.width, path.height, SHARD_FRAMES
    k_enc, k_dec = path.kernels
    streams = path_streams(name)
    golden = load_goldens()[name]
    steps = [[streams[b][t] for b in range(BATCH)] for t in range(frames)]
    ng = len(devs)
    tag = f"sharded {name}"
    mpix = BATCH * w * h / 1e6

    def packets_ok(label, keep=None):
        def on_result(t, res):
            for b in range(BATCH):
                want = golden["packets"][b][t]
                check(digest(res[b][0]) == {"sha256": want["sha256"],
                                            "len": want["len"]} and
                      res[b][1] == want["key"],
                      f"{label} stream {b} frame {t}: packet differs from "
                      f"the golden")
            if keep is not None:
                keep.append([r[0] for r in res])
        return on_result

    def lossless(label):
        def on_result(t, res):
            for b in range(BATCH):
                planes, kf = res[b]
                check(kf == (t == 0) and all(
                    a.dtype == f.dtype and np.array_equal(a, f)
                    for a, f in zip(planes, steps[t][b])),
                    f"{label} stream {b} frame {t}: decode not lossless")
        return on_result

    def launches_ok(label, want):
        got = all_launches()
        check(got == want, f"{label}: expected {want} launches (one per "
              f"frame and lane group), got {got}")
        return got

    def new_enc():
        return TorchFFV1Encoder(EncoderParams(**params_kw(name)),
                                batch=BATCH, devices=devs)

    rec_enc, rec_dec = recorders["packed"], recorders["decode"]
    enc = new_enc()
    check(enc.device == devs[0] and enc.L == BATCH * SLICES,
          f"{tag}: lead device {enc.device}, {enc.L} lanes")
    kept = {}
    scanfin = keep_args(enc, "_scan_finalize", kept)
    stencil = keep_args(enc, "_streams", kept)
    reset_counts()
    d1_enc, packets = [], []
    for t, step in enumerate(steps):
        rec_enc.armed = t == frames - 1
        t0 = time.perf_counter()
        res = enc.encode_frames(step)
        d1_enc.append(time.perf_counter() - t0)
        packets_ok(f"{tag} depth 1", packets)(t, res)
    rec_enc.armed = False
    launches = dict(encode=launches_ok(f"{tag} encode depth 1",
                                       {k_enc: frames * ng}))
    enc_blocks = rec_enc.take_all()
    enc2 = new_enc()
    reset_counts()
    d2_enc = pipelined(enc2.submit_frames, enc2.collect_frames, steps,
                       packets_ok(f"{tag} depth 2"))
    launches_ok(f"{tag} encode depth 2", {k_enc: frames * ng})
    dec1 = TorchFFV1Decoder(w, h, enc.extradata, batch=BATCH, devices=devs)
    reset_counts()
    d1_dec = []
    for t, pk in enumerate(packets):
        rec_dec.armed = t == frames - 1
        t0 = time.perf_counter()
        res = dec1.decode_frames(pk)
        d1_dec.append(time.perf_counter() - t0)
        lossless(f"{tag} depth 1")(t, res)
        check(len(dec1.last_groups) == 1, f"{tag}: one lane group")
    rec_dec.armed = False
    launches["decode"] = launches_ok(f"{tag} decode depth 1",
                                     {k_dec: frames * ng})
    dec_blocks = rec_dec.take_all()
    dec2 = TorchFFV1Decoder(w, h, enc.extradata, batch=BATCH, devices=devs)
    reset_counts()
    d2_dec = pipelined(dec2.submit_frames, dec2.collect_frames, packets,
                       lossless(f"{tag} depth 2"))
    check(not dec1.slice_damaged.any() and not dec2.slice_damaged.any(),
          f"{tag}: slice flagged damaged")
    launches_ok(f"{tag} decode depth 2", {k_dec: frames * ng})
    check(len(enc_blocks) == ng and len(dec_blocks) == ng,
          f"{tag}: the last frame's block launches were not recorded")
    med = {k: median([1e3 * x for x in v[1 + WARM:]])
           for k, v in (("enc_d1", d1_enc), ("enc_d2", d2_enc),
                        ("dec_d1", d1_dec), ("dec_d2", d2_dec))}

    # the last frame's stages, each timed alone
    st_ms = cuda_time_ms(lambda: stencil(*kept["_streams"]), 3)
    scan_ms, fin_ms, gather_ms = group_stages(
        devs, kept["_scan_finalize"], enc_blocks, enc.s2, 3)
    sf_ms = cuda_time_ms(lambda: scanfin(*kept["_scan_finalize"]), 2)
    dscan_ms = [on_device_ms(d, lambda a=a: rc_decode.rc_decode_planes(*a),
                             3) for d, (a, _o) in zip(devs, dec_blocks)]
    dgather_ms = cuda_time_ms(lambda: [
        sharding._gather(parts, devs[0], 0)
        for parts in zip(*(o for _a, o in dec_blocks))], 3)
    reset_counts()
    side = "" if not unsharded else (
        f"; unsharded in this run: encode {unsharded['enc_d1']:.2f} / "
        f"{unsharded['enc_d2']:.2f} ms, decode {unsharded['dec_d1']:.2f} / "
        f"{unsharded['dec_d2']:.2f} ms (depth 1 / depth 2)")
    log(f"[{tag}] {w}x{h} {path.pix_fmt}, batch {BATCH}, {frames} frames, "
        f"{ng} lane groups of {enc.L // ng} lanes on "
        f"{len(set(devs))} distinct card(s), every depth-2 submit strict: "
        f"packets equal to the goldens, decodes lossless; launches per "
        f"run: {launches}; median step over the {frames - 1 - WARM} timed "
        f"frames ({gpu}): encode {med['enc_d1']:.2f} ms "
        f"({mpix / med['enc_d1'] * 1e3:.2f} Mpix/s) at depth 1, "
        f"{med['enc_d2']:.2f} at depth 2; decode {med['dec_d1']:.2f} ms "
        f"({mpix / med['dec_d1'] * 1e3:.2f} Mpix/s), {med['dec_d2']:.2f}"
        f"{side}")
    log(f"[{tag}] last frame's stages (ms, each timed alone, {gpu}): "
        f"stencil {st_ms:.2f}; {k_enc} per group "
        f"{' + '.join(f'{x:.2f}' for x in scan_ms)}; finalize s2={enc.s2} "
        f"per group {' + '.join(f'{x:.2f}' for x in fin_ms)}; gather "
        f"{gather_ms:.2f}; the whole sharded scan + finalize {sf_ms:.2f}; "
        f"{k_dec} per group {' + '.join(f'{x:.2f}' for x in dscan_ms)}, "
        f"gather {dgather_ms:.2f}")
    return dict(
        med, frames=frames, groups=ng, distinct_cards=len(set(devs)),
        launches=launches, stages=dict(
            stencil=st_ms, scan=scan_ms, finalize=fin_ms, gather=gather_ms,
            scan_finalize=sf_ms, dscan=dscan_ms, dgather=dgather_ms),
        blocks={k_enc: enc_blocks, k_dec: dec_blocks},
        block_ms={k_enc: scan_ms, k_dec: dscan_ms},
        kernel_launches={k_enc: frames * ng, k_dec: frames * ng})


def sharded_config5(gpu, devs, recorders):
    """(b): BASELINE config 5 at its real geometry (``config5_kw``, me
    "epzs", batch 1, 16 lanes) through TorchFFV1PEncoder(devices=devs): a
    key frame (K1 at 10 bits per group) and a P frame (K1-ext at 11 bits
    per group), each packet equal to the golden ``config5_4k`` (the host
    FFV1PEncoder's).  No decode: the P decoder takes 8 bits only, as the
    JAX class.  Prints each frame's step and its stages: search, OBMC +
    residual + stencil (P), stencil (key), each group's scan and
    finalize, the gather."""
    golden = load_goldens()["config5_4k"]
    frames = config5_frames()
    ng = len(devs)
    tag = "sharded config5_4k"
    t0 = time.perf_counter()
    enc = TorchFFV1PEncoder(EncoderParams(**config5_kw()), batch=1,
                            me=C5_ME, experimental=True, devices=devs)
    check(digest(enc.extradata) == golden["extradata"],
          f"{tag}: extradata differs from the golden")
    check(enc.L == C5_SLICES and enc.p_bits == 11,
          f"{tag}: {enc.L} lanes, residuals at {enc.p_bits} bits")
    kept = {}
    scanfin = keep_args(enc, "_scan_finalize", kept)
    stencil = keep_args(enc, "_streams", kept)
    search = keep_args(enc, "_search", kept)
    residual = keep_args(enc, "_residual_streams", kept)
    rec = recorders["packed"]
    out, blocks, launches = {}, {}, {}
    for t, kind, k in ((0, "key", "rc_encode"), (1, "P", "rc_encode_ext")):
        reset_counts()
        rec.armed = True
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        (pkt, key), = enc.encode_frames([frames[t]])
        step = (time.perf_counter() - t1) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        rec.armed = False
        want = golden["packets"][0][t]
        check(digest(pkt) == {"sha256": want["sha256"], "len": want["len"]}
              and key == want["key"] == (t == 0),
              f"{tag} frame {t}: packet differs from the golden "
              f"({len(pkt)} vs {want['len']} B)")
        launches[k] = all_launches()
        check(launches[k] == {k: ng}, f"{tag} frame {t}: expected "
              f"{{{k!r}: {ng}}} launches, got {launches[k]}")
        blocks[k] = rec.take_all()
        check(len(blocks[k]) == ng, f"{tag}: block launches not recorded")
        reps = 2
        st = {}
        if t == 0:
            st["stencil"] = cuda_time_ms(lambda: stencil(*kept["_streams"]),
                                         reps)
        else:
            st["search"] = cuda_time_ms(lambda: search(*kept["_search"]),
                                        reps)
            st["obmc_residual_stencil"] = cuda_time_ms(
                lambda: residual(*kept["_residual_streams"]), reps)
        st["scan"], st["finalize"], st["gather"] = group_stages(
            devs, kept["_scan_finalize"], blocks[k],
            4 if kept["_scan_finalize"][8] <= 10 else 6, reps)
        st["scan_finalize"] = cuda_time_ms(
            lambda: scanfin(*kept["_scan_finalize"]), reps)
        reset_counts()
        out[kind] = dict(step_ms=step, bytes=len(pkt), peak_gib=peak,
                         stages=st)
        lane_n = blocks[k][0][0][0].shape[1]
        log(f"[{tag}] frame {t} ({kind}): {len(pkt)} B, equal to the "
            f"golden; step {step:.2f} ms (host clock, the first such "
            f"frame: allocations included); {k} at bits "
            f"{kept['_scan_finalize'][8]} over {ng} groups of "
            f"{enc.L // ng} lanes x {lane_n} slots; stages (ms, each timed "
            f"alone, {gpu}): " + ", ".join(
                f"{n} " + (' + '.join(f'{x:.2f}' for x in v)
                           if isinstance(v, list) else f"{v:.2f}")
                for n, v in st.items()) +
            f"; step peak {peak:.2f} GiB")
    log(f"[{tag}] {C5_W}x{C5_H} yuv422p10le, {C5_SLICES} slices, me "
        f"{C5_ME}: key and P frame equal to config5_4k on {ng} lane groups "
        f"({len(set(devs))} distinct card(s)) in "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(out, groups=ng, distinct_cards=len(set(devs)),
                launches=launches, blocks=blocks,
                block_ms={k: out[kind]["stages"]["scan"] for kind, k in
                          (("key", "rc_encode"), ("P", "rc_encode_ext"))},
                kernel_launches={k: ng for k in launches})


def sharded_phase(gpu, recorders, unsharded=None, probe=None, funcs=None):
    """The sharded phase: ``shard_devices``' groups, (a) the 8bit and
    16bit paths (``sharded_intra``), (b) BASELINE config 5
    (``sharded_config5``).  ``unsharded``: per path the unsharded steps of
    this run, or None.  With the decision probe's figures (``probe``) and
    the SASS (``funcs``), each path's ``entries`` for the kernels line
    (``sharded_entries``).  Returns ({path: figures}, config 5's last lane
    group's launches {instance: (args, outputs)}, which phase 6 holds
    against their plain versions on their last segment)."""
    t0 = time.perf_counter()
    devs = shard_devices()
    res = {f"sharded_{name}": sharded_intra(
        gpu, name, devs, recorders, (unsharded or {}).get(name))
        for name in SHARD_PATHS}
    res["config5_4k"] = sharded_config5(gpu, devs, recorders)
    tails = {k: b[-1] for k, b in res["config5_4k"]["blocks"].items()}
    for pn, p in res.items():
        blocks = p.pop("blocks")
        if probe is not None:
            p["entries"] = sharded_entries(pn, p, blocks, probe, funcs, gpu)
    log(f"[sharded] the sharded phase in {time.perf_counter() - t0:.1f} s")
    return res, tails


def sharded_entries(pn, p, blocks_by_name, probe, funcs, gpu):
    """A sharded path's launches as entries for the ``kernels`` line, one
    per instance, each to go under the row of that instance: its launches
    and the last frame's launch per group (time, roofline and chain bounds
    from the group's own inputs; a decode group's decisions are those of
    the encode group of the same lanes and frame).  Held to the golden
    packets (config 5's last group also to the plain version on its last
    segment, in phase 6); each instance is held whole to its plain
    version on its own row.  Returns {instance: entry}."""
    out = {}
    for name, blocks in blocks_by_name.items():
        if name.startswith("rc_encode"):
            src = blocks
        else:
            src = next(b for k, b in blocks_by_name.items()
                       if k.startswith("rc_encode"))
        decisions = torch.cat([decisions_per_lane(a[1], a[2])
                               for a, _o in src])
        lk = blocks[0][0][0].shape[0]
        lanes = [list(range(i * lk, (i + 1) * lk))
                 for i in range(len(blocks))]
        row = rc_row(name, pn, blocks, p["block_ms"][name],
                     [0.0] * len(blocks), lanes,
                     p["kernel_launches"][name],
                     p["kernel_launches"][name] // len(blocks),
                     decisions, probe, funcs, {},
                     launch_shape(name, *blocks[0]), [], gpu)
        out[name] = {k: row[k] for k in (
            "main_path", "launches", "launches_per_step", "ms",
            "bound_ms", "bound_by", "chain_bound_ms",
            "chain_decisions_max_lane", "main_path_shape")}
        out[name].update(groups=len(blocks),
                         distinct_cards=p["distinct_cards"],
                         group_ms=p["block_ms"][name], max_abs_err=0,
                         held_to="the golden packets")
    return out


def check_compact_launch(name, rec, raw_name, raw_rec):
    """A compact path's warm-up launch against its raw path's K1 launch
    on the same frame: the same inputs (SHA-256 of every input tensor),
    cm equal to compact_packed of K1's slots (on the host CPU, timed),
    and K1's low, range and states.  K1's launch is itself held against
    its plain version in phase 6.  Returns compact_packed's seconds."""
    (args, out), (raw_args, raw_out) = rec, raw_rec
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    check(output_digests(tensors) == output_digests(
        [a for a in raw_args if isinstance(a, torch.Tensor)]) and
          args[-1] == raw_args[-1],
          f"{name}'s warm-up inputs differ from {raw_name}'s")
    packed = raw_out[0].cpu()
    t0 = time.perf_counter()
    want = compact_packed(packed)
    sec = time.perf_counter() - t0
    check(torch.equal(out[0].cpu(), want),
          f"{name}'s cm differs from compact_packed of {raw_name}'s slots")
    check(all(torch.equal(a, b) for a, b in zip(out[1:], raw_out[1:])),
          f"{name}'s low, range or states differ from {raw_name}'s")
    log(f"[check] {name}, main path's warm-up frame "
        f"({launch_shape(name, args, out)}): the inputs of {raw_name}'s "
        f"launch (equal SHA-256), cm = compact_packed of its slots "
        f"({int(out[0][:, 5].sum())} overflowing pixels; compact_packed on "
        f"the host CPU {sec:.1f} s), its low, range and states")
    return sec


STAGE_REPLACES = ("scripts/probes/ablate_kernel.py:206, "
                  "scripts/probes/ablate3.py:274")


def stage_split(gpu, recs, reps=5):
    """K1's, K1-ext's, K2's, K2-ext's, G1's and G2's stage probes on their
    paths' warm-up inputs (K1 and its global form, K2 and K2-five on the
    8bit and 8bit_ctx1 inputs at 1080p; K1-ext and K2-ext on the 16bit
    inputs at 1080p, K1-ext's global form and K2-ext-five on
    16bit_ctx1_540p's; G1 and G2 on 8bit_golomb's; B1 on rgb8's and
    B1-ext on rgb14_540p's; 48 lanes): ``full`` through the stage entry
    point equals the production launch; each variant's
    median of ``reps`` launches, each timed alone with CUDA events.
    Returns the rows of the ``stages`` JSON line."""
    rows = []
    for path_name, inst in (("8bit", "rc_encode"),
                            ("8bit_ctx1", "rc_encode_global"),
                            ("16bit", "rc_encode_ext"),
                            ("16bit_ctx1_540p", "rc_encode_ext_global"),
                            ("8bit", "rc_decode"),
                            ("8bit_ctx1", "rc_decode_five_global"),
                            ("16bit", "rc_decode_ext"),
                            ("16bit_ctx1_540p",
                             "rc_decode_ext_five_global"),
                            ("8bit_golomb", "golomb_encode"),
                            ("8bit_golomb", "golomb_decode"),
                            ("rgb8", "rc_decode_rgb"),
                            ("rgb14_540p", "rc_decode_ext_rgb")):
        args, out = recs[inst]
        if inst.endswith("_rgb"):
            probe = rc_decode.rc_decode_rgb_stages
            variants = rc_decode.EXT_RGB_STAGE_VARIANTS \
                if inst.startswith("rc_decode_ext") else \
                rc_decode.RGB_STAGE_VARIANTS
            L, N = args[0].shape[0], args[8] * args[9] * args[10]
            replaces = None
        elif inst.startswith("golomb_encode"):
            probe, variants = (golomb_encode.golomb_encode_stages,
                               golomb_encode.STAGE_VARIANTS)
            L, N = args[0].shape
            replaces = None
        elif inst.startswith("golomb_decode"):
            probe, variants = (golomb_decode.golomb_decode_stages,
                               golomb_decode.STAGE_VARIANTS)
            L, N = args[0].shape[0], sum(w * h for (w, h, _b) in args[4])
            replaces = None
        elif inst.startswith("rc_encode"):
            probe, variants = (rc_encode.rc_encode_ext_stages,
                               rc_encode.EXT_STAGE_VARIANTS) \
                if inst.startswith("rc_encode_ext") else \
                (rc_encode.rc_encode_stages, rc_encode.STAGE_VARIANTS)
            args = args[:8]
            L, N = args[0].shape
            replaces = STAGE_REPLACES
        else:
            probe, variants = (rc_decode.rc_decode_ext_stages,
                               rc_decode.EXT_STAGE_VARIANTS) \
                if inst.startswith("rc_decode_ext") else \
                (rc_decode.rc_decode_stages, rc_decode.STAGE_VARIANTS)
            args = (*args[:9], args[10])           # without bits
            L, N = args[0].shape[0], sum(w * h for (w, h, _b) in args[8])
            replaces = None

        def launch(variant):
            return probe(*args, variant)

        check(all(torch.equal(a, b) for a, b in
                  zip(flat_outputs(launch("full")), flat_outputs(out))),
              f"{inst}: the stage entry point's full variant differs from "
              f"the production launch")
        med = {}
        for variant in variants:
            launch(variant)
            times = sorted(launch_ms(lambda: launch(variant))
                           for _ in range(reps))
            med[variant] = times[reps // 2]
        for variant, ms in med.items():
            share = None if variant == "full" else med["full"] - ms
            rows.append(dict(instance=inst, path=path_name, variant=variant,
                             ms=ms, ns_per_pixel=ms * 1e6 / N,
                             stage_ms=share, replaces=replaces))
        log(f"[stage] {inst} ({path_name} warm-up inputs, L={L}, N={N}, "
            f"median of {reps}, {gpu}): " + ", ".join(
                f"{v} {ms:.2f} ms ({ms * 1e6 / N:.1f} ns/px" +
                ("" if v == "full" else
                 f"; full minus this {med['full'] - ms:.2f}") + ")"
                for v, ms in med.items()))
    return rows


# ------------------------------------------- main-path plain checks


def output_digests(out):
    """(shape, dtype, sha256) of every output tensor, in a canonical
    contiguous layout on the host."""
    res = []
    for t in flat_outputs(out):
        a = t.cpu().contiguous().numpy()
        res.append((tuple(a.shape), str(a.dtype),
                    hashlib.sha256(a.data).hexdigest()))
    return res


def plain_version(name):
    """The plain PyTorch version of kernel instance ``name``."""
    if name.startswith("golomb_encode"):
        return golomb_encode.golomb_encode_lanes_ref
    if name.startswith("golomb_decode"):
        return golomb_decode.golomb_decode_planes_ref
    if name.startswith("rc_encode_ext_stats"):
        return rc_encode.rc_encode_ext_stats_ref
    if name.startswith("rc_encode_stats"):
        return rc_encode.rc_encode_stats_scan_ref
    if name == "rc_stats_rows":
        return rc_encode.rc_stats_rows_ref
    if name.startswith("rc_encode_compact"):
        return rc_encode.rc_encode_compact_ref
    if name.startswith("rc_encode"):
        return rc_encode.rc_encode_packed_ext_ref \
            if name.startswith("rc_encode_ext") else \
            rc_encode.rc_encode_packed_ref
    if "_rgb" in name:
        return rc_decode.rc_decode_rgb_ref
    return rc_decode.rc_decode_planes_ext_ref \
        if name.startswith("rc_decode_ext") else rc_decode.rc_decode_planes_ref


def plain_worker(name, args):
    """Worker process: the plain version of kernel instance ``name`` on
    CPU tensors; returns (seconds, output digests).  Under
    inference_mode, which skips autograd's bookkeeping on each of the
    plain versions' many small tensor ops; the outputs are the same."""
    torch.set_num_threads(1)
    fn = plain_version(name)
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
             for a in args]
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = fn(*targs)
    return time.perf_counter() - t0, output_digests(out)


def encode_cuts(N, bits):
    """Where ``segments`` cuts an encode launch of N pixels: equal parts,
    two per 129,600 pixels, three above 10 bits."""
    nseg = (3 if bits > 10 else 2) * -(-N // 129_600)
    return [N * i // nseg for i in range(nseg + 1)]


def segments(name, args, out, tail=False):
    """Split one main-path launch into independent segments for the
    plain version: [(plain args, the kernel's outputs for them)].

    The scans are causal, so a segment's start state (adaptive states,
    low, range, and for the decoder pos) is that of the kernel
    relaunched on the prefix before it.  The relaunch must reproduce the
    main-path launch's outputs on that prefix exactly; each segment's
    outputs under the plain version must equal the main-path launch's
    outputs on it and the state the next prefix run (or the full run)
    ends in.  By induction over the segments the plain version run on
    the whole launch would give the main-path launch's outputs.  The
    encoder splits its pixel stream in equal parts (two per 129,600
    pixels, three above 10 bits), the planar decoder at its plane
    boundaries (each plane starts from zeroed rows), the RGB decoder
    (B1, B1-ext) at rows: a segment starts from the coder and states a
    relaunch on the rows before it ends in, and from each plane's two
    rows above it in the launch's output (rc_decode_rgb_ref's rows0).

    The Golomb-Rice scans (G1, G2) carry their state from pixel to pixel
    (bit accumulator, run state) and run whole: their plain versions loop
    over every pixel of a lane, so a split by lanes would only repeat the
    loop (the checks are CPU-bound).

    ``tail`` (an encode launch): its last segment alone, from the state of
    the kernel relaunched on every pixel before it: the far end of a lane
    too long to check whole, at the cost of one segment.

    A stats instance of K1 or K1-ext splits as the encoder does; a
    segment's decision counts are those of the relaunch on the pixels up
    to its end less those up to its start, so that each segment's plain
    run holds all six outputs."""
    if name.startswith("golomb"):
        return [(args, out)]
    if name.startswith("rc_encode"):
        ctx, diff, act, st0, one, zero, low0, rng0, bits = args
        packed, low, rng, st, *counts = out
        # a stats instance's counts are those of its own pixels: a
        # segment's are the relaunch to its end's less the one to its start
        # (K1's stats scan: stat alone; K1-ext's: stat and stat2)
        scan = rc_encode.rc_encode_packed if not counts else \
            rc_encode.rc_encode_stats if bits > 10 else \
            rc_encode.rc_encode_stats_scan
        cuts = encode_cuts(ctx.shape[1], bits)
        if tail:
            cuts = cuts[-2:]
        # the coder at each cut: (low, range, states, counts so far)
        at = []
        for c in cuts[:-1]:
            if not c:
                at.append((low0, rng0, st0,
                           *[torch.zeros_like(x) for x in counts]))
                continue
            pk, *end = scan(
                ctx[:, :c].contiguous(), diff[:, :c].contiguous(),
                act[:, :c].contiguous(), st0, one, zero, low0, rng0, bits)
            check(torch.equal(pk, packed[:c]),
                  f"{name} relaunched on {c} pixels is not the main-path "
                  f"launch's prefix")
            at.append(tuple(end))
        at.append((low, rng, st, *counts))
        return [((ctx[:, a:b], diff[:, a:b], act[:, a:b], s0, one, zero,
                  l0, r0, bits),
                 (packed[a:b], *at[i + 1][:3],
                  *[e - c0 for e, c0 in zip(at[i + 1][3:], c0s)]))
                for i, (a, b, (l0, r0, s0, *c0s)) in enumerate(
                    zip(cuts, cuts[1:], at))]
    if "_rgb" in name:
        return rgb_segments(name, args, out)
    bufs, st0, one, zero, qt, low0, rng0, pos0, specs, bits, five = args
    planes, st, low, rng, pos = out
    ends = []
    for k in range(1, len(specs)):
        pl, s, lo, ra, po = rc_decode.rc_decode_planes(
            bufs, st0, one, zero, qt, low0, rng0, pos0, specs[:k], bits,
            five)
        check(all(torch.equal(x, y) for x, y in zip(pl, planes)),
              f"{name} relaunched on {k} planes is not the main-path "
              f"launch's prefix")
        ends.append((s, lo, ra, po))
    ends.append((st, low, rng, pos))
    starts = [(st0, low0, rng0, pos0)] + ends[:-1]
    return [((bufs, s0, one, zero, qt, l0, r0, p0, (specs[k],), bits, five),
             ((planes[k],), *ends[k]))
            for k, (s0, l0, r0, p0) in enumerate(starts)]


# B1's plain version per segment: about this many decisions' worth of
# pixels (P x rows x w x (2 bits + 1)), some 40 s on one core
RGB_SEGMENT_COST = 3 * 34 * 320 * 19


def rgb_segments(name, args, out):
    """A B1 / B1-ext launch cut at rows (see ``segments``)."""
    bufs, st0, one, zero, qt, low0, rng0, pos0, w, h, P, cc, bits, five = \
        args
    planes, st, low, rng, pos = out
    nseg = max(1, min(h, -(-(P * h * w * (2 * bits + 1)) //
                             RGB_SEGMENT_COST)))
    cuts = [h * i // nseg for i in range(nseg + 1)]
    ends = []
    for c in cuts[1:-1]:
        pl, s, lo, ra, po = rc_decode.rc_decode_rgb(
            bufs, st0, one, zero, qt, low0, rng0, pos0, w, c, P, cc, bits,
            five)
        check(torch.equal(pl, planes[:, :, :c]),
              f"{name} relaunched on {c} rows is not the main-path "
              f"launch's prefix")
        ends.append((s, lo, ra, po))
    ends.append((st, low, rng, pos))
    starts = [(st0, low0, rng0, pos0)] + ends[:-1]
    segs = []
    for k, (a, b) in enumerate(zip(cuts, cuts[1:])):
        s0, l0, r0, p0 = starts[k]
        rows0 = torch.zeros((P, planes.shape[1], 2, w), dtype=torch.int32,
                            device=planes.device)
        if a:
            rows0[:, :, 2 - min(a, 2):] = planes[:, :, max(a - 2, 0):a]
        segs.append(((bufs, s0, one, zero, qt, l0, r0, p0, w, b - a, P, cc,
                      bits, five, rows0),
                     (planes[:, :, a:b], *ends[k])))
    return segs


def decode_five(args):
    """The ``five`` of a decode launch's arguments (planar or RGB)."""
    return args[13] if len(args) >= 14 else args[10]


def launch_shape(name, args, out):
    """A main-path launch's shape, for the log and the JSON line."""
    if name == "rc_stats_rows":
        return (f"L={args[0].shape[0]} N={args[0].shape[1]} CC={args[4]} "
                f"bits={args[3]}")
    if name.startswith("golomb_encode"):
        return (f"L={args[0].shape[0]} N={args[0].shape[1]} "
                f"CC={args[4].shape[1]} T={out[0].shape[1]} bits={args[7]}")
    if name.startswith("golomb_decode"):
        return (f"L={args[0].shape[0]} CC={args[1].shape[1]} "
                f"planes={args[4]} bits={args[5]} five={args[6]}")
    if name.startswith("rc_encode"):
        return (f"L={args[0].shape[0]} N={args[0].shape[1]} "
                f"CC={args[3].shape[1]} S={out[0].shape[1]} bits={args[8]}")
    if "_rgb" in name:
        return (f"L={args[0].shape[0]} CC={args[1].shape[1]} "
                f"{args[10]} planes of {args[8]}x{args[9]} bits={args[12]} "
                f"five={args[13]}")
    return (f"L={args[0].shape[0]} CC={args[1].shape[1]} planes={args[8]} "
            f"bits={args[9]} five={args[10]}")


def plain_cost(name, args):
    """A rough relative cost of the plain version on ``args`` (lanes x
    pixels x slots, the decoder's loop about twice the encoder's per
    decision; the Golomb-Rice scans' loops cost about the same per pixel
    whatever their lanes), to start the longest worker jobs first."""
    if name.startswith("golomb_encode"):
        return 600 * args[0].shape[1]
    if name.startswith("golomb_decode"):
        return 700 * sum(w * h for (w, h, _b) in args[4])
    if name == "rc_stats_rows":
        # vectorised over every slot of every pixel: one bincount
        return args[0].numel() * (2 * args[3] + 1) // 20
    if name.startswith("rc_encode"):
        return args[0].numel() * (2 * args[8] + 1)
    if "_rgb" in name:
        return 2 * args[0].shape[0] * (2 * args[12] + 1) * \
            args[8] * args[9] * args[10]
    return 2 * args[0].shape[0] * (2 * args[9] + 1) * \
        sum(w * h for (w, h, _b) in args[8])


def lane_layout(name):
    """The lane axes of a range-coder launch's arguments and outputs:
    (argument index -> axis, output index -> axis, the plane outputs'
    axis or None); the other arguments are shared by every lane.
    None for Golomb-Rice, whose launches run alone."""
    if name.startswith("golomb"):
        return None
    if name.startswith("rc_encode"):
        # ctx, diff, active, states0, low0, range0; packed (N, S, L), low,
        # range, states
        return {0: 0, 1: 0, 2: 0, 3: 0, 6: 0, 7: 0}, \
            {0: 2, 1: 0, 2: 0, 3: 0}, None
    # bufs, states0, low0, range0, pos0; planes (a tuple of (L, h, w), or
    # RGB's (P, L, h, w)), states, low, range, pos
    return {0: 0, 1: 0, 5: 0, 6: 0, 7: 0}, {1: 0, 2: 0, 3: 0, 4: 0}, \
        1 if "_rgb" in name else 0


def same_value(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) \
            and a.shape == b.shape and a.dtype == b.dtype and \
            torch.equal(a, b)
    return a == b


def mergeable(name, rec_a, rec_b):
    """Whether two launches of instance ``name`` differ only in their
    lanes: the same shared arguments and the same shapes along every
    other axis (a decoder's byte slabs may differ in length)."""
    lay = lane_layout(name)
    if lay is None:
        return False
    (args_a, out_a), (args_b, out_b) = rec_a, rec_b
    arg_axes, out_axes, _p = lay
    for i, (a, b) in enumerate(zip(args_a, args_b)):
        if i not in arg_axes:
            if not same_value(a, b):
                return False
        elif (i > 0 or name.startswith("rc_encode")) and \
                a.shape[1:] != b.shape[1:]:
            return False
    for i in out_axes:
        sa, sb = list(out_a[i].shape), list(out_b[i].shape)
        sa.pop(out_axes[i])
        sb.pop(out_axes[i])
        if sa != sb:
            return False
    return True


def cat_lanes(name, recs):
    """One launch record whose lanes are those of ``recs`` side by side
    (mergeable launches of instance ``name``); byte slabs are padded
    with zeros to the longest, which the scans read as the bytes past a
    lane's end."""
    arg_axes, out_axes, plane_axis = lane_layout(name)
    args, out = list(recs[0][0]), list(recs[0][1])
    for i, ax in arg_axes.items():
        parts = [r[0][i] for r in recs]
        if i == 0 and not name.startswith("rc_encode"):
            cap = max(t.shape[1] for t in parts)
            parts = [torch.nn.functional.pad(t, (0, cap - t.shape[1]))
                     for t in parts]
        args[i] = torch.cat(parts, ax)
    for i, ax in out_axes.items():
        out[i] = torch.cat([r[1][i] for r in recs], ax)
    if plane_axis is not None:
        planes = [r[1][0] for r in recs]
        out[0] = torch.cat(planes, plane_axis) if plane_axis else \
            tuple(torch.cat(ps, 0) for ps in zip(*planes))
    return tuple(args), tuple(out)


def merge_launches(recs):
    """Main-path launches grouped for phase 6: [(instance, launch record,
    keys)], one entry per group of launches of one instance that differ
    only in their lanes (``mergeable``), with their lanes side by side
    (``cat_lanes``).  The plain versions are loops over pixels,
    vectorised over lanes that never mix, so one plain run holds every
    launch of a group on its own inputs at about the cost of one."""
    groups = []
    for key, rec in recs.items():
        name = key[1]
        for g in groups:
            if g[0] == name and mergeable(name, g[2][0], rec):
                g[1].append(key)
                g[2].append(rec)
                break
        else:
            groups.append((name, [key], [rec]))
    return [(name, recs_g[0] if len(recs_g) == 1 else
             cat_lanes(name, recs_g), keys)
            for name, keys, recs_g in groups]


def plain_checks(launches):
    """Hold kernel launches exactly against their plain versions, run on
    CPU copies of the same inputs in parallel worker processes, one per
    CPU core, the longest launches first.  ``launches``: [(instance,
    (args, outputs), split)]; a launch with ``split`` is cut into
    segments (see ``segments``), the others run whole.  Each launch's
    segments are cut, copied to the host and submitted while the workers
    run the ones before (the cutting relaunches the kernel on prefixes,
    and the digests read every output: serial work that used to come
    before the first job).  The workers return digests of their
    outputs, which must equal the digests of the kernel's outputs.
    Returns the plain version's seconds per segment of each launch, in
    the order given, and the number of workers.  ``split`` "tail": only
    the last segment (``segments``' tail)."""

    def cost(launch):
        name, (args, _out), split = launch
        c = plain_cost(name, args)
        return c / (len(encode_cuts(args[0].shape[1], args[8])) - 1) \
            if split == "tail" else c

    secs = [{} for _ in launches]
    workers = os.cpu_count() or 4
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=workers, mp_context=ctx) as pool:
        futs = []
        for i in sorted(range(len(launches)),
                        key=lambda i: -cost(launches[i])):
            name, (args, out), split = launches[i]
            segs = segments(name, args, out, split == "tail") if split \
                else [(args, out)]
            for k, (seg_args, want) in enumerate(segs):
                cpu_args = [a.cpu().numpy() if isinstance(a, torch.Tensor)
                            else a for a in seg_args]
                futs.append(((i, k, name, output_digests(want)),
                             pool.submit(plain_worker, name, cpu_args)))
        log(f"[check] {len(futs)} plain jobs cut and submitted in "
            f"{time.perf_counter() - t0:.1f} s, the workers running")
        for (i, k, name, mine), fut in futs:
            sec, theirs = fut.result()
            check(theirs == mine,
                  f"{name} differs from its plain version on the same "
                  f"inputs: " + "; ".join(
                      f"output {n} {a[0]}"
                      for n, (a, b) in enumerate(zip(mine, theirs))
                      if a != b))
            secs[i][k] = sec
    return [[d[k] for k in sorted(d)] for d in secs], workers


def kernel_bounds(name, rec, ns_per_decision, ops_per_decision,
                  decisions, row_ns, extra_ops=0):
    """(roofline bound ms, its term, chain bound ms) of one kernel's
    main-path launch.  The chain bound is the longest lane's decisions x
    one dependent decision's latency; a decoder with its state table in
    global memory also waits on one dependent row read from L2 per pixel
    (``row_ns``), since each pixel's context needs the pixel before.
    The encoder's contexts are known in advance, so its row reads are
    not on the chain.  Operations: K1, K1-compact and K1-ext code only
    their active decisions, ``ops_per_decision`` each, plus
    ``extra_ops`` per pixel."""
    args, out = rec
    if name.startswith("rc_encode"):
        L, N = args[0].shape
        CC, S_out = args[3].shape[1], out[0].shape[1]
        nbytes = L * N * 9 + 2 * L * CC * 32 + 512 + 16 * L + \
            L * N * S_out * 4
        nops = int(decisions.sum()) * ops_per_decision + L * N * extra_ops
        px = 0
    else:
        planes, states_out, _low, _rng, pos = out
        L, CC = args[1].shape[0], args[1].shape[1]
        consumed = int((pos.long() - args[7].long()).sum())
        px = sum(p.shape[1] * p.shape[2] for p in planes)
        nq = 5 if decode_five(args) else 3
        nbytes = consumed + 2 * L * CC * 32 + 512 + nq * 1024 + 24 * L + \
            L * px * 4
        nops = int(decisions.sum()) * ops_per_decision
        if not name.endswith("_global"):
            px = 0
    bound, term = roofline_ms(nbytes, nops)
    chain = (int(decisions.max()) * ns_per_decision + px * row_ns) * 1e-6
    return bound, term, chain


def golomb_bounds(name, rec, steps, work):
    """(roofline bound ms, its term, chain bound ms, the longest lane) of
    a Golomb-Rice launch whose lanes do ``work`` = (vlc_px, run_steps,
    run_px), each (L,): the VLC symbols each lane codes
    (golomb_vlc_pixels) and its run work (golomb_run_work).  Bytes: G1
    reads ctx and diff (8 B) and active (1 B) per pixel, the flags (4 B a
    pixel, shared by the lanes) and the prefixes, reads and writes each
    lane's VLC table once and writes the bytes it counts; G2 reads the
    bytes its readers consumed and the quant tables, reads and writes the
    VLC tables and writes 4 B a pixel.  Operations and chain from the
    step probe's modes (``steps``: ns and SASS instructions of each): G1
    a VLC-coded pixel ("encode") and a run machine step ("run_encode")
    per completed run chunk, break or line-end flush; G2 a VLC-coded
    pixel ("decode") and a run pixel ("run_decode").  Chain: the lane
    whose steps, each dependent on the one before, add up to the most."""
    args, out = rec
    enc = name.startswith("golomb_encode")
    vlc_px, run_steps, run_px = work
    runs = run_steps if enc else run_px
    (vlc_ns, vlc_ops), (run_ns, run_ops) = (
        steps["encode"], steps["run_encode"]) if enc else (
        steps["decode"], steps["run_decode"])
    if enc:
        L, px = args[0].shape
        CC, pcap, T = args[4].shape[1], args[5].shape[1], out[0].shape[1]
        nbytes = L * px * 9 + px * 4 + 2 * L * CC * 16 + L * pcap * 4 + \
            12 * L + int(out[1].clamp(max=T).sum())
    else:
        planes, _vlc, bitpos = out
        L, CC = args[1].shape[0], args[1].shape[1]
        px = sum(p.shape[1] * p.shape[2] for p in planes)
        consumed = int(((bitpos.long() + 7) // 8 - args[3].long()).sum())
        nq = 5 if args[6] else 3
        nbytes = consumed + 2 * L * CC * 16 + nq * 1024 + 8 * L + L * px * 4
    vlc = vlc_px.numpy().astype(np.int64)
    bound, term = roofline_ms(nbytes, int(vlc.sum()) * vlc_ops +
                              int(runs.sum()) * run_ops)
    lane_ns = vlc * vlc_ns + runs * run_ns
    worst = int(lane_ns.argmax())
    return bound, term, float(lane_ns[worst]) * 1e-6, \
        (int(vlc[worst]), int(runs[worst]))


# kernel instance -> (source, the TPU kernel it replaces)
KERNELS = {
    "rc_encode": ("tpu_ffv1_torch/csrc/rc_encode.cu",
                  "tpu_ffv1/tpu/rc_pallas.py:58"),
    "rc_decode": ("tpu_ffv1_torch/csrc/rc_decode.cu",
                  "tpu_ffv1/tpu/rc_dec_pallas.py:60"),
    "rc_encode_ext": ("tpu_ffv1_torch/csrc/rc_encode_ext.cu",
                      "tpu_ffv1/tpu/rc_pallas.py:317"),
    "rc_decode_ext": ("tpu_ffv1_torch/csrc/rc_decode_ext.cu",
                      "tpu_ffv1/tpu/rc_dec_pallas.py:343"),
    "rc_encode_global": ("tpu_ffv1_torch/csrc/rc_encode.cu",
                         "tpu_ffv1/tpu/rc_pallas.py:58"),
    "rc_decode_five_global": ("tpu_ffv1_torch/csrc/rc_decode.cu",
                              "tpu_ffv1/tpu/rc_dec_pallas.py:201"),
    "rc_encode_ext_global": ("tpu_ffv1_torch/csrc/rc_encode_ext.cu",
                             "tpu_ffv1/tpu/rc_pallas.py:317"),
    "rc_decode_ext_five_global": ("tpu_ffv1_torch/csrc/rc_decode_ext.cu",
                                  "tpu_ffv1/tpu/rc_dec_pallas.py:201"),
    "rc_encode_compact": ("tpu_ffv1_torch/csrc/rc_encode.cu",
                          "tpu_ffv1/tpu/rc_pallas.py:419"),
    "rc_encode_compact_global": ("tpu_ffv1_torch/csrc/rc_encode.cu",
                                 "tpu_ffv1/tpu/rc_pallas.py:419"),
    # no Pallas kernel: XLA lax.scans of the JAX package
    "golomb_encode": ("tpu_ffv1_torch/csrc/golomb_encode.cu",
                      "tpu_ffv1/tpu/golomb_scan.py:86"),
    "golomb_decode": ("tpu_ffv1_torch/csrc/golomb_decode.cu",
                      "tpu_ffv1/tpu/golomb_dec_lanes.py:33"),
    "rc_decode_rgb": ("tpu_ffv1_torch/csrc/rc_decode.cu",
                      "tpu_ffv1/tpu/dec_scan_lanes.py:266"),
    "rc_decode_ext_rgb": ("tpu_ffv1_torch/csrc/rc_decode_ext.cu",
                          "tpu_ffv1/tpu/dec_scan_lanes.py:266"),
}


# the twopass phase's kernels: the stats instances on its paths, and
# find_best_state, which replaces the host C fold (the JAX package has
# no device kernel for it)
TWOPASS_KERNELS = {
    "rc_encode_stats": ("tpu_ffv1_torch/csrc/rc_encode.cu",
                        "tpu_ffv1/tpu/rc_pallas.py:58"),
    "rc_encode_ext_stats": ("tpu_ffv1_torch/csrc/rc_encode_ext.cu",
                            "tpu_ffv1/tpu/rc_pallas.py:317"),
    "rc_stats_rows": ("tpu_ffv1_torch/csrc/rc_encode.cu",
                      "tpu_ffv1/bitstream/symbols.py:26"),
    "find_best_state": ("tpu_ffv1_torch/csrc/find_best_state.cu",
                        "native/ffv1_native.c:850"),
}


def twopass_checks(tp_recs, secs):
    """The twopass phase's stats launches (``main_recs``: the small cuts'
    whole, 1080p pass 1's in segments) after ``plain_checks`` held them
    (``secs``: the plain version's seconds per segment of each): their
    entries by instance, for ``twopass_rows``."""
    tp_checks = {}
    for (name, rec, split, label, ms), segs in zip(tp_recs, secs):
        shape = launch_shape(name, *rec)
        tp_checks.setdefault(name, []).append(dict(
            label=label, check_shape=shape, check_ms=ms,
            check_plain_ms=sum(segs) * 1e3))
        what = "stat2, the row counts" if name == "rc_stats_rows" else \
            "all six outputs: slots, low, range, states and both count " \
            "tables" if name.startswith("rc_encode_ext") else \
            "all five outputs: slots, low, range, states and the state " \
            "counts"
        log(f"[check] {name}, {label} ({shape}): exact match"
            f"{f' in {len(segs)} segments' if split else ''} (equal SHA-256 "
            f"of {what}); plain version on the host CPU "
            f"{' + '.join(f'{x:.1f}' for x in segs)} s")
    return tp_checks


def twopass_rows(tp, checks, tp_checks, probe, funcs, gpu):
    """The ``kernels`` JSON rows of the twopass phase: the stats instances
    of K1 (1080p pass 1: the pair as pass 1 runs it, its scan beside its
    row counts on a side stream, with the scan's time alone) and K1-ext
    (the 16bit cut), each with the production instance's time on the
    same inputs, their roofline bound (K1's bytes and the count tables
    written once; the decisions' instructions from the decision probe and
    the instance's pixel loop) and chain bound, their plain versions
    timed on the main path's launch (``tp_checks``: the twopass launches
    held in phase 6, the rows' checks with the random ones; K1's the
    scan's, in segments); K1's row counts (rc_stats_rows, alone on the
    same inputs; bytes: ctx, diff and active read, the counts written);
    and find_best_state (FP64 operations: 10 a fold term, the fold's own
    count)."""
    ns_enc, ops_enc, _ns_dec, _ops_dec, _row_ns = probe
    n = tp["numbers"]
    rows = []
    for name, path_name, main_label, (args, out), launches, steps, ms, \
            prod_ms in (
            ("rc_encode_stats", "twopass_1080p_pass1",
             "twopass 1080p pass 1 frame 1", tp["p1_rec"],
             tp["launches"]["pass1"]["rc_encode_stats"], TWOPASS_FRAMES,
             n["stats_ms"], n["k1_ms"]),
            ("rc_encode_ext_stats", "twopass_16bit_cut",
             "twopass 16bit cut frame 1", tp["ext_rec"],
             tp["launches"]["cuts"]["rc_encode_ext_stats"],
             TWOPASS_CUT_FRAMES, n["ext_stats_ms"], n["k1_ext_ms"])):
        src, replaces = TWOPASS_KERNELS[name]
        bits = args[8]
        L, N = args[0].shape
        CC, S = args[3].shape[1], out[0].shape[1]
        lib = "rc_encode_ext" if bits > 10 else "rc_encode"
        # the pixel loop's SASS instructions, the stats instance's and the
        # production instance's
        loop, loop_prod = (pixel_loop_count(funcs[lib][label]) for label in (
            f"{lib}_stats_kernel<{bits},0>",
            f"{lib}_kernel<{bits},0,{'31' if bits > 10 else '0,15'}>"))
        extra = max(0, loop - (2 * bits + 2) * ops_enc)
        decisions = decisions_per_lane(args[1], args[2])
        nbytes = L * N * 9 + 2 * L * CC * 32 + 512 + 16 * L + \
            L * N * S * 4 + L * 512 * 4 + L * CC * 64 * 4
        bound, term = roofline_ms(
            nbytes, int(decisions.sum()) * ops_enc + L * N * extra)
        chain = int(decisions.max()) * ns_enc * 1e-6
        chk = tp_checks[name] + checks[name]
        plain = next(c for c in chk if c["label"] == main_label)
        shape = launch_shape(name, args, out)
        log(f"[bound] {name} ({path_name}, {gpu}): {ms:.3f} ms at {shape} "
            f"(production {prod_ms:.3f} ms on the same inputs); pixel loop "
            f"{loop} SASS instructions (production {loop_prod}); roofline "
            f"bound {bound:.3f} ms ({term}); chain bound {chain:.2f} ms")
        extra_ms = dict(scan_ms=n["stats_scan_ms"]) \
            if name == "rc_encode_stats" else {}
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            main_path=path_name, launches=launches,
            launches_per_step=launches / steps, max_abs_err=0, ms=ms,
            **extra_ms,
            production_ms=prod_ms, plain_ms=plain["check_plain_ms"],
            plain_shape=plain["check_shape"], plain_device="cpu",
            bound_ms=bound, bound_by=term, chain_bound_ms=chain,
            chain_decisions_max_lane=int(decisions.max()),
            ns_per_decision=ns_enc, ops_per_decision=ops_enc,
            extra_ops_per_pixel=extra, pixel_loop_instructions=loop,
            production_pixel_loop_instructions=loop_prod, library_ms=None,
            main_path_shape=shape,
            checks=[{k: c[k] for k in ("label", "check_shape", "check_ms",
                                       "check_plain_ms")} for c in chk]))
    # K1's row counts on 1080p pass 1's frame-1 inputs
    args = stats_rows_args(tp["p1_rec"][0])
    L, N = args[0].shape
    CC = args[4]
    nbytes = L * N * 9 + L * CC * 64 * 4
    bound, term = roofline_ms(nbytes, 0)
    src, replaces = TWOPASS_KERNELS["rc_stats_rows"]
    chk = tp_checks["rc_stats_rows"] + checks["rc_stats_rows"]
    plain = next(c for c in chk
                 if c["label"] == "twopass 1080p pass 1 frame 1")
    shape = launch_shape("rc_stats_rows", args, None)
    log(f"[bound] rc_stats_rows (twopass_1080p_pass1, {gpu}): "
        f"{n['stats_rows_ms']:.3f} ms alone at {shape}, the zeroing "
        f"included; roofline bound {bound:.4f} ms ({term}: {nbytes} B)")
    rows.append(dict(
        name="rc_stats_rows", route="cuda", source=src, replaces=replaces,
        main_path="twopass_1080p_pass1",
        launches=tp["launches"]["pass1"]["rc_stats_rows"],
        launches_per_step=tp["launches"]["pass1"]["rc_stats_rows"] /
        TWOPASS_FRAMES, max_abs_err=0, ms=n["stats_rows_ms"],
        plain_ms=plain["check_plain_ms"], plain_shape=plain["check_shape"],
        plain_device="cpu", bound_ms=bound, bound_by=term, library_ms=None,
        main_path_shape=shape,
        checks=[{k: c[k] for k in ("label", "check_shape", "check_ms",
                                   "check_plain_ms")} for c in chk]))
    fbs = tp["fbs"]
    # bytes: the table, l2tab and the output; operations: the fold terms
    bound, term = max(
        ((256 + 256 * 8 + 256 * 256) / PEAK_BYTES_S * 1e3, "bytes"),
        (10 * fbs["terms"] / PEAK_FP64_S * 1e3, "operations"))
    src, replaces = TWOPASS_KERNELS["find_best_state"]
    log(f"[bound] find_best_state (twopass pass 2, {gpu}): {fbs['ms']:.2f} "
        f"ms; roofline bound {bound:.5f} ms ({term}: {fbs['terms']} fold "
        f"terms x 10 FP64 operations at {PEAK_FP64_S / 1e12:.0f} TFLOP/s)")
    rows.append(dict(
        name="find_best_state", route="cuda", source=src, replaces=replaces,
        main_path="twopass_1080p_pass2",
        launches=tp["launches"]["pass2"]["find_best_state"],
        launches_per_step=0, max_abs_err=0, ms=fbs["ms"],
        plain_ms=fbs["plain_ms"],
        plain_shape=f"{len(TWOPASS_FBS_ROWS)} of 256 probabilities",
        plain_device="cpu", bound_ms=bound, bound_by=term,
        fold_terms=fbs["terms"], fold_rows=fbs["rows"], library_ms=None,
        main_path_shape="one_state (256,) -> best_state (256, 256)"))
    return rows


# instances no main path launches (the placement follows the table's size
# alone: reachable with custom quant tables), checked on random inputs
OFF_PATH = ("rc_decode_five", "rc_decode_global", "rc_decode_ext_five",
            "rc_decode_ext_global", "golomb_encode_global",
            "golomb_decode_five_global", "golomb_decode_five",
            "golomb_decode_global") + tuple(
                f"rc_decode{e}_rgb{i}" for e in ("", "_ext")
                for i in ("_five", "_global", "_five_global"))


def golomb_row(name, path_name, p, rec, mp, checks, steps, work, gpu):
    """The ``kernels`` JSON row of G1 or G2 on its main path: its time,
    launches, roofline bound and chain bound (golomb_bounds), from the
    step probe's modes (``steps``: ns and SASS instructions of each) and
    the lanes' work (VLC-coded pixels, run steps, run pixels)."""
    src, replaces = KERNELS[name]
    enc = name.startswith("golomb_encode")
    bound, term, chain, (w_vlc, w_runs) = golomb_bounds(name, rec, steps,
                                                         work)
    vlc_ns, vlc_ops = steps["encode" if enc else "decode"]
    run_ns, _run_ops = steps["run_encode" if enc else "run_decode"]
    run_what = "run steps" if enc else "run pixels"
    log(f"[bound] {name} ({path_name}, {gpu}): {p['ms'][name]:.2f} ms at "
        f"the main path's shape; roofline bound {bound:.3f} ms ({term}, "
        f"{int(work[0].sum())} VLC-coded pixels x {vlc_ops} SASS "
        f"instructions of the step probe and the {run_what}); chain bound "
        f"{chain:.2f} ms (the longest lane: {w_vlc} VLC-coded pixels x "
        f"{vlc_ns:.2f} ns + {w_runs} {run_what} x {run_ns:.2f} ns)")
    return dict(
        name=name, route="cuda", source=src, replaces=replaces,
        main_path=path_name, launches=p["launches"][name],
        launches_per_step=p["launches"][name] / p["steps"], max_abs_err=0,
        ms=p["ms"][name], plain_ms=mp["plain_ms"], plain_device="cpu",
        bound_ms=bound, bound_by=term, chain_bound_ms=chain,
        chain_vlc_pixels_max_lane=w_vlc, chain_run_steps_max_lane=w_runs,
        vlc_pixels=int(work[0].sum()), ns_per_vlc_pixel=vlc_ns,
        ops_per_vlc_pixel=vlc_ops, ns_per_run_step=run_ns,
        run_steps=int((work[1] if enc else work[2]).sum()), library_ms=None,
        main_path_shape=mp["main_path_shape"],
        checks=[{k: c[k] for k in ("check_shape", "check_ms",
                                   "check_plain_ms")} for c in checks])


def rc_row(name, path_name, recs, ms, plain_ms, lanes, launches, steps,
           decisions, probe, funcs, compact_sec, shape, checks, gpu):
    """The ``kernels`` JSON row of a range-coder kernel on a path: its
    launches of one step (``recs``; a grouped decode has one per lane
    group, run one after another, each over ``lanes``), their times
    ``ms`` and plain versions' ``plain_ms``, and the roofline and chain
    bounds (kernel_bounds) summed over the launches.  ``decisions``: the
    binary decisions of every lane of the step; ``probe``: the decision
    probe's (encode ns, encode ops, decode ns, decode ops, L2 row ns)."""
    src, replaces = KERNELS[name]
    ns_enc, ops_enc, ns_dec, ops_dec, row_ns = probe
    enc = name.startswith("rc_encode")
    ns, ops = (ns_enc, ops_enc) if enc else (ns_dec, ops_dec)
    extra = 0
    if enc:
        # K1's and K1-ext's instructions per pixel beside their
        # decisions: the pixel loop's, less the loop's S + 1 decision
        # bodies (the zero flag's twice: with a zero residual and a
        # nonzero one); the compact form's compaction is in it
        bits, g = recs[0][0][8], int(name.endswith("_global"))
        lib = "rc_encode_ext" if name.startswith("rc_encode_ext") \
            else "rc_encode"
        targs = f"{bits},{g},31" if lib == "rc_encode_ext" else \
            f"{bits},{g},{int(name in compact_sec)},15"
        extra = max(0, pixel_loop_count(
            funcs[lib][f"{lib}_kernel<{targs}>"]) - (2 * bits + 2) * ops_enc)
    bounds = [kernel_bounds(name, rec, ns, ops, decisions[ln], row_ns, extra)
              for rec, ln in zip(recs, lanes)]
    bound = sum(b for b, _t, _c in bounds)
    term = max(bounds)[1]
    chain = sum(c for _b, _t, c in bounds)
    longest = [int(decisions[ln].max()) for ln in lanes]
    row = name.startswith("rc_decode") and name.endswith("_global")
    out = dict(
        name=name, route="cuda", source=src, replaces=replaces,
        main_path=path_name, launches=launches,
        launches_per_step=launches / steps, max_abs_err=0, ms=sum(ms),
        plain_ms=sum(plain_ms), plain_device="cpu", bound_ms=bound,
        bound_by=term, chain_bound_ms=chain,
        chain_decisions_max_lane=max(longest), ns_per_decision=ns,
        ops_per_decision=ops, extra_ops_per_pixel=extra,
        row_read_ns=row_ns if row else None, library_ms=None,
        main_path_shape=shape,
        checks=[{k: c[k] for k in ("check_shape", "check_ms",
                                   "check_plain_ms")} for c in checks])
    if len(recs) > 1:
        out["groups"] = [dict(lanes=len(ln), shape=launch_shape(name, *rec),
                              ms=t, plain_ms=pm, bound_ms=b[0],
                              chain_bound_ms=b[2],
                              chain_decisions_max_lane=mx)
                         for rec, ln, t, pm, b, mx in zip(
                             recs, lanes, ms, plain_ms, bounds, longest)]
    log(f"[bound] {name} ({path_name}, {gpu}): {sum(ms):.2f} ms at the "
        f"path's shape" +
        (f" in {len(recs)} launches ({' + '.join(f'{t:.2f}' for t in ms)})"
         if len(recs) > 1 else "") +
        f"; roofline bound {bound:.3f} ms ({term}, {ops:.2f} instructions "
        f"per decision" + (f" + {extra:.0f} per pixel" if extra else "") +
        f"); chain bound {chain:.2f} ms ({' + '.join(map(str, longest))} "
        f"decisions on the longest lane{'s' if len(recs) > 1 else ''} x "
        f"{ns:.2f} ns" + (f", plus a {row_ns:.2f} ns row read per pixel)"
                          if row else ")"))
    return out


def main():
    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: this smoke run needs a GPU")
        return 1
    gpu = gpu_line()
    log(f"[env] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    libs = ("rc_encode", "rc_decode", "rc_encode_ext", "rc_decode_ext",
            "golomb_encode", "golomb_decode", "find_best_state",
            "chain_probe", "golomb_probe")
    t0 = time.perf_counter()
    build.build_all(libs)
    log(f"[build] " + ", ".join(f"{n} {build.BUILD_SECONDS[n]:.1f} s"
                                for n in libs) +
        f" (all started together; {time.perf_counter() - t0:.1f} s)")
    for name in libs:
        seen = set()
        for line in build.BUILD_LOG.get(name, "").splitlines():
            line = line.split(":", 1)[-1].strip()
            if ("registers" in line or "spill" in line) and line not in seen:
                seen.add(line)
                log(f"[build] {name} (all instances): {line}")
    funcs = {name: sass_functions(name) for name in libs}
    sass = {name: {label: sum(1 for _a, t in ins
                              if not re.search(r"\bNOP\b", t))
                   for label, ins in funcs[name].items()} for name in libs}
    for name in libs:
        log(f"[sass] {name}: SASS instructions per instance: " + ", ".join(
            f"{k} {v}" for k, v in sorted(sass[name].items())))

    ns_enc = chain_probe_ns(dev, 0)
    ns_dec = chain_probe_ns(dev, 1)
    ops_enc, ops_dec = probe_sass_ops()
    row_ns = row_probe_ns(dev)
    probe = (ns_enc, ops_enc, ns_dec, ops_dec, row_ns)
    smem_row_ns = smem_probe_ns(dev, "row")
    smem_byte_ns = smem_probe_ns(dev, "byte")
    # each mode's step loop is its instance's largest (the set-up loops
    # stay rolled): the empty marker counts every instruction
    golomb_step = {m: (golomb_step_ns(dev, m), pixel_loop_count(
        funcs["golomb_probe"][f"golomb_step_kernel<{i}>"], ""))
        for i, m in enumerate(probes.GOLOMB_MODES)}
    check(all(ops > 0 for _ns, ops in golomb_step.values()),
          "no pixel loop found in the Golomb-Rice step probe's SASS")
    log(f"[probe] one dependent decision on one warp ({gpu}): encode form "
        f"{ns_enc:.2f} ns, decode form {ns_dec:.2f} ns; SASS instructions "
        f"of one decision: encode form {ops_enc:.2f}, decode form "
        f"{ops_dec:.2f}; one dependent 32-byte row read from L2 "
        f"{row_ns:.2f} ns; from shared memory (1,332 rows) "
        f"{smem_row_ns:.2f} ns; one dependent transition-table byte "
        f"lookup in shared memory {smem_byte_ns:.2f} ns; one VLC-coded "
        f"pixel's dependent step: encode form (G1) "
        f"{golomb_step['encode'][0]:.2f} ns, {golomb_step['encode'][1]} SASS "
        f"instructions, decode form (G2) {golomb_step['decode'][0]:.2f} ns, "
        f"{golomb_step['decode'][1]} SASS instructions; a run step: G1's "
        f"run machine {golomb_step['run_encode'][0]:.2f} ns, "
        f"{golomb_step['run_encode'][1]} SASS instructions, G2's run pixel "
        f"{golomb_step['run_decode'][0]:.2f} ns, "
        f"{golomb_step['run_decode'][1]} SASS instructions (each held against "
        f"its plain loop)")

    random = ([check_encode_kernel(dev, 8, 4096, 0)] +
              check_decode_kernel(dev, 0) +
              [check_decode_random_bytes(dev, b, five, m) for b in (8, 10)
               for five, m in ((False, 0), (True, 1), (True, 0),
                               (False, 1))] +
              [check_encode_kernel(dev, b, 1024, 0) for b in (11, 16, 17)] +
              check_decode_ext_kernel(dev, 0) +
              [check_decode_random_bytes(dev, b, five, m)
               for b in (11, 16, 17) for five, m in ((True, 0), (False, 1))] +
              [check_encode_kernel(dev, 8, 4096, 1)] +
              check_decode_kernel(dev, 1) +
              [check_encode_kernel(dev, b, 1024, 1) for b in (11, 16, 17)] +
              check_decode_ext_kernel(dev, 1) +
              [check_encode_kernel(dev, 8, 4096, m, compact=True)
               for m in (0, 1)] +
              [check_encode_kernel(dev, b, 4096, m, compact=c, edges=True)
               for b in (8, 9, 10) for m in (0, 1) for c in (False, True)] +
              [check_encode_kernel(dev, b, 4096, m, edges=True)
               for b in (11, 16, 17) for m in (0, 1)] +
              [r for m in (0, 1) for r in check_golomb_encode_kernel(dev, m)] +
              [check_golomb_decode_kernel(dev, five, m)
               for five, m in ((False, 0), (True, 1), (True, 0),
                               (False, 1))] +
              [r for b in rc_decode.RGB_BITS
               for five, m in ((False, 0), (True, 1), (True, 0),
                               (False, 1))
               for r in check_rgb_decode_random_bytes(dev, b, five, m)] +
              [check_rgb_decode_kernel(dev, f, 1)
               for f in ("bgr0", "gbrp14le")])
    check(sorted({r[0] for r in random}) ==
          sorted(set(KERNELS) | set(OFF_PATH)),
          "the random checks do not cover every instance")

    recorders = dict(packed=LastLaunch(port_encoder, "rc_encode_packed"),
                     compact=LastLaunch(port_encoder, "rc_encode_compact"),
                     decode=LastLaunch(rc_decode, "rc_decode_planes"),
                     decode_rgb=LastLaunch(port_decoder, "rc_decode_rgb"),
                     golomb_encode=LastLaunch(port_encoder,
                                              "golomb_encode_lanes"),
                     golomb_decode=LastLaunch(port_decoder,
                                              "golomb_decode_planes"),
                     stats=LastLaunch(port_encoder, "rc_encode_stats"))
    paths = {name: main_path(dev, gpu, name, recorders) for name in PATHS}
    pcm = pcm_phase(dev, gpu, recorders["packed"])
    tp = twopass_phase(dev, gpu, recorders["stats"])
    random += tp.pop("random")
    tp_recs = tp.pop("main_recs")
    mixed = mixed_q_phase(dev, gpu, recorders["decode"], paths)
    nonuni = nonuniform_phase(dev, gpu, recorders["packed"],
                              recorders["decode"])
    ppaths = {name: pframe_phase(dev, gpu, name, recorders)
              for name in P_PATHS}
    t0 = time.perf_counter()
    pipes = {f"{name}_pipe": pipeline_phase(dev, gpu, name)
             for name in PIPE_PATHS}
    pipes[f"{P_PIPE_PATH}_pipe"] = pframe_pipeline_phase(dev, gpu)
    log(f"[pipe] the pipelined and transcode phases in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ya8 = {name: ya8_phase(dev, gpu, name, recorders) for name in YA8}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_clip_") as d:
        clip = os.path.join(d, "clip.avi")
        cli = cli_phase(dev, gpu, recorders, keep_avi=clip)
        serve = serve_phase(gpu, clip)
    # the ya8 and cli paths' launches: their own shapes (ya8 L=48 at two
    # planes a lane, cli L=24), each held to its plain version in phase 6
    side = dict(ya8, cli=cli)
    log(f"[ya8+cli+serve] the ya8, cli and serve phases in "
        f"{time.perf_counter() - t0:.1f} s")
    # the sharded phase, beside this run's unsharded pipelined steps
    sharded, c5_tails = sharded_phase(gpu, recorders, {
        name: {k: pipes[f"{name}_pipe"][k]
               for k in ("enc_d1", "dec_d1", "enc_d2", "dec_d2")}
        for name in SHARD_PATHS}, probe, funcs)
    # each instance's launch on the first path that ran it (K1 and K1-ext
    # also run on the RGB paths: their stage splits and compact checks
    # take the planar paths' launches)
    recs = {}
    for p in paths.values():
        for k, v in p["recs"].items():
            recs.setdefault(k, v)
    check(sorted(recs) == sorted(KERNELS),
          f"the main paths ran {sorted(recs)}, not every instance")
    # each compact launch against its raw path's K1 launch; the raw
    # instance of a compact one is its name without "_compact"
    compact_sec = {name: check_compact_launch(
        name, recs[name], name.replace("_compact", ""),
        recs[name.replace("_compact", "")])
        for name in recs if name.startswith("rc_encode_compact")}
    for name, p in paths.items():
        raw = PATHS[name].golden
        if raw:
            a, b = paths[raw]["stages"], p["stages"]
            log(f"[compact] {name} against {raw} ({gpu}): encode step "
                f"{p['enc_ms']:.2f} / {paths[raw]['enc_ms']:.2f} ms; scan "
                f"{b['scan']:.2f} / {a['scan']:.2f}, finalize "
                f"{b['finalize']:.2f} / {a['finalize']:.2f} ms; slots "
                f"{b['slots_gib']:.3f} / {a['slots_gib']:.3f} GiB; step "
                f"peak {b['step_peak_gib']:.2f} / {a['step_peak_gib']:.2f} "
                f"GiB")
    stages = stage_split(gpu, recs)

    # phase 6: every launch above against its plain version
    t0 = time.perf_counter()
    # every main-path launch but the compact ones, by (path, instance,
    # launch in the step): a grouped decode's launches each on its own
    # inputs, and those of mixed_q and nonuniform_ext
    main_recs = {}
    for pn, p in paths.items():
        for k, v in p["recs"].items():
            if k in compact_sec:
                continue
            if k == PATHS[pn].kernels[1] and len(p["group_recs"]) > 1:
                for gi, rec in enumerate(p["group_recs"]):
                    main_recs[(pn, k, gi)] = rec
            else:
                main_recs[(pn, k, 0)] = v
    for gi, rec in enumerate(mixed["recs"]):
        main_recs[("mixed_q", decode_instance(rec[0]), gi)] = rec
    main_recs[("nonuniform_ext", "rc_encode_ext", 0)] = nonuni["enc_rec"]
    for gi, rec in enumerate(nonuni["recs"]):
        main_recs[("nonuniform_ext", "rc_decode_ext", gi)] = rec
    for pn, p in ppaths.items():
        for k, rec in p["recs"].items():
            main_recs[(pn, k, 0)] = rec
    for pn, p in side.items():
        for k, rec in p["recs"].items():
            main_recs[(pn, k, 0)] = rec
    merged = merge_launches(main_recs)
    # config 5's launches (lanes of about 1M slots): the last group's last
    # segment, the far end of its lanes
    launches = [(name, rec, False) for name, _info, rec in random] + \
        [(name, rec, True) for name, rec, _keys in merged] + \
        [(name, rec, "tail") for name, rec in c5_tails.items()] + \
        [(name, rec, split) for name, rec, split, _l, _ms in tp_recs]
    secs, workers = plain_checks(launches)
    tp_checks = twopass_checks(tp_recs, secs[len(secs) - len(tp_recs):])
    checks = {}
    for (name, info, _rec), segs in zip(random, secs):
        info["check_plain_ms"] = segs[0] * 1e3
        checks.setdefault(name, []).append(info)
        log(f"[check] {name} {info['check_shape']} {info['label']}: exact "
            f"match (equal SHA-256 of every output); plain version on the "
            f"host CPU {segs[0]:.1f} s")
    c5_entries = sharded["config5_4k"]["entries"]
    for (name, (args, out)), segs in zip(
            c5_tails.items(), secs[len(random) + len(merged):]):
        a, n = encode_cuts(args[0].shape[1], args[8])[-2:]
        shape = f"{launch_shape(name, args, out)}, slots {a}:{n}"
        c5_entries[name].update(
            held_to=f"the golden packets; the last lane group's last "
            f"segment ({shape}) exact against the plain version",
            plain_segment_s=segs[0], plain_segment_shape=shape)
        log(f"[check] {name}, config5_4k's last lane group ({shape}): "
            f"exact match on its last segment, from the state of the "
            f"kernel relaunched on slots 0:{a} (equal SHA-256 of every "
            f"output); plain version on the host CPU {segs[0]:.1f} s")
    mp, group_plain = {}, {}
    for (name, rec, keys), segs in zip(merged, secs[len(random):]):
        lanes = [main_recs[k][0][0].shape[0] for k in keys]
        shared = "" if len(keys) == 1 else (
            f"; one plain run over the {sum(lanes)} lanes of " + ", ".join(
                f"{pn}{f' launch {gi + 1}' if gi else ''} ({n})"
                for (pn, _n, gi), n in zip(keys, lanes)) + " side by side")
        for pn, _name, gi in keys:
            shape = launch_shape(name, *main_recs[(pn, name, gi)])
            group_plain[(pn, name, gi)] = sum(segs) * 1e3
            m = mp.setdefault((pn, name), dict(plain_ms=0.0,
                                               main_path_shape=shape))
            m["plain_ms"] += sum(segs) * 1e3
            log(f"[check] {name}, {pn} path's warm-up frame"
                f"{f', launch {gi + 1} of the step' if gi else ''} "
                f"({shape}): exact match in {len(segs)} segments (equal "
                f"SHA-256 of every output){shared}; plain version on the "
                f"host CPU {' + '.join(f'{x:.1f}' for x in segs)} = "
                f"{sum(segs):.1f} s")
    for pn, path in PATHS.items():
        name = path.kernels[0]
        if name in compact_sec:
            # its plain version is the raw one's, then compact_packed
            raw = (path.golden, name.replace("_compact", ""))
            mp[(pn, name)] = dict(
                plain_ms=mp[raw]["plain_ms"] + compact_sec[name] * 1e3,
                main_path_shape=launch_shape(name, *recs[name]))
    log(f"[check] all plain checks in {time.perf_counter() - t0:.1f} s "
        f"({workers} worker processes, {sum(map(sum, secs)):.1f} s of "
        f"plain version in all)")

    kernels = []
    for path_name, path in PATHS.items():
        p = paths[path_name]
        enc_args = p["recs"][path.kernels[0]][0]
        # the decode of the warm-up frame makes the same decisions as its
        # encode
        decisions = decisions_per_lane(enc_args[1], enc_args[2])
        for name in filter(None, path.kernels):
            rec, m = p["recs"][name], mp[(path_name, name)]
            if name.startswith("golomb"):
                # G1's inputs: the warm-up frame's decode makes the same
                # decisions
                work = (golomb_vlc_pixels(*enc_args[:4], enc_args[8]),
                        *golomb_run_work(*enc_args[:4], enc_args[8]))
                kernels.append(golomb_row(
                    name, path_name, p, rec, m, checks[name], golomb_step,
                    work, gpu))
                continue
            grouped = name == path.kernels[1] and len(p["group_recs"]) > 1
            recs_g = p["group_recs"] if grouped else [rec]
            kernels.append(rc_row(
                name, path_name, recs_g,
                p["group_ms"] if grouped else [p["ms"][name]],
                [group_plain[(path_name, name, gi)]
                 for gi in range(len(recs_g))] if grouped
                else [m["plain_ms"]],
                p["groups"] if grouped else [list(range(len(decisions)))],
                p["launches"][name], p["steps"], decisions, probe,
                funcs, compact_sec, m["main_path_shape"], checks[name], gpu))
    # mixed_q: the 8bit path's decisions on even slices, 8bit_ctx1's on
    # odd ones (the same frames' encodes)
    dec8 = decisions_per_lane(*paths["8bit"]["recs"]["rc_encode"][0][1:3])
    dec1 = decisions_per_lane(
        *paths["8bit_ctx1"]["recs"]["rc_encode_global"][0][1:3])
    odd = (torch.arange(len(dec8), device=dec8.device) % SLICES) % 2 == 1
    mixed_dec = torch.where(odd, dec1, dec8)
    for gi, rec in enumerate(mixed["recs"]):
        name = decode_instance(rec[0])
        kernels.append(rc_row(
            name, "mixed_q", [rec], [mixed["group_ms"][gi]],
            [group_plain[("mixed_q", name, gi)]], [mixed["groups"][gi]],
            mixed["launches"][name], mixed["steps"], mixed_dec, probe,
            funcs, compact_sec, mp[("mixed_q", name)]["main_path_shape"],
            checks[name], gpu))
    nu_dec = decisions_per_lane(*nonuni["enc_rec"][0][1:3])
    nu_ms = [cuda_time_ms(lambda a=a: rc_encode.rc_encode_packed(*a), 3)
             for a in (nonuni["enc_rec"][0],)] + \
        [cuda_time_ms(lambda a=a: rc_decode.rc_decode_planes(*a), 3)
         for a, _o in nonuni["recs"]]
    kernels.append(rc_row(
        "rc_encode_ext", "nonuniform_ext", [nonuni["enc_rec"]], nu_ms[:1],
        [group_plain[("nonuniform_ext", "rc_encode_ext", 0)]],
        [list(range(len(nu_dec)))], nonuni["launches"]["rc_encode_ext"],
        nonuni["steps"], nu_dec, probe, funcs, compact_sec,
        mp[("nonuniform_ext", "rc_encode_ext")]["main_path_shape"],
        checks["rc_encode_ext"], gpu))
    kernels.append(rc_row(
        "rc_decode_ext", "nonuniform_ext", nonuni["recs"], nu_ms[1:],
        [group_plain[("nonuniform_ext", "rc_decode_ext", gi)]
         for gi in range(len(nonuni["recs"]))], nonuni["groups"],
        nonuni["launches"]["rc_decode_ext"], nonuni["steps"], nu_dec, probe,
        funcs, compact_sec,
        mp[("nonuniform_ext", "rc_decode_ext")]["main_path_shape"],
        checks["rc_decode_ext"], gpu))
    for pn, p in ppaths.items():
        # the warm-up P frame's decisions: the encode's over its whole
        # stream, the decode's over the residual planes (the MV section is
        # parsed on the host)
        ctx, diff, act = p["recs"][P_PATHS[pn].kernels[0]][0][:3]
        for name in filter(None, P_PATHS[pn].kernels):
            cut = 0 if name.startswith("rc_encode") else p["mv_cap"]
            decisions = decisions_per_lane(diff[:, cut:], act[:, cut:])
            kernels.append(rc_row(
                name, pn, [p["recs"][name]], [p["ms"][name]],
                [group_plain[(pn, name, 0)]], [list(range(len(decisions)))],
                p["p_launches"][name], p["p_steps"], decisions, probe, funcs,
                compact_sec, mp[(pn, name)]["main_path_shape"],
                checks[name], gpu))
    for pn, p in side.items():
        k_enc = YA8[pn][1][0] if pn in YA8 else PATHS[CLI_PATH].kernels[0]
        enc_args = p["recs"][k_enc][0]
        for name, rec in p["recs"].items():
            m = mp[(pn, name)]
            if name.startswith("golomb"):
                work = (golomb_vlc_pixels(*enc_args[:4], enc_args[8]),
                        *golomb_run_work(*enc_args[:4], enc_args[8]))
                kernels.append(golomb_row(
                    name, pn, p, rec, m, checks[name], golomb_step, work,
                    gpu))
                continue
            decisions = decisions_per_lane(enc_args[1], enc_args[2])
            kernels.append(rc_row(
                name, pn, [rec], [p["ms"][name]], [m["plain_ms"]],
                [list(range(len(decisions)))], p["launches"][name],
                p["steps"], decisions, probe, funcs, compact_sec,
                m["main_path_shape"], checks[name], gpu))
    kernels += twopass_rows(tp, checks, tp_checks, probe, funcs, gpu)
    # the sharded paths' launches, under the rows of their instances
    for p in sharded.values():
        for name, entry in p.pop("entries").items():
            next(r for r in kernels if r["name"] == name).setdefault(
                "sharded", []).append(entry)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps({"probes": dict(
        decision_encode_ns=ns_enc, decision_decode_ns=ns_dec,
        l2_row_ns=row_ns, smem_row_ns=smem_row_ns,
        smem_byte_ns=smem_byte_ns,
        golomb_step_encode_ns=golomb_step["encode"][0],
        golomb_step_decode_ns=golomb_step["decode"][0],
        golomb_step_run_encode_ns=golomb_step["run_encode"][0],
        golomb_step_run_decode_ns=golomb_step["run_decode"][0])}))
    log(json.dumps({"steps": {name: dict(encode_ms=p["enc_ms"],
                                         decode_ms=p["dec_ms"], **p["stages"])
                              for name, p in paths.items()}}))
    log(json.dumps({"v4_pcm": pcm}))
    log(json.dumps({"twopass": dict(launches=tp["launches"],
                                    **tp["numbers"])}))
    log(json.dumps({"mixed_q": {k: mixed[k] for k in (
        "launches", "dec_ms", "group_ms", "steps")},
        "nonuniform_ext": {k: nonuni[k] for k in (
            "launches", "encode_ms", "decode_ms", "steps")}}))
    log(json.dumps({"pframe": {name: dict(
        encode_ms=p["enc_ms"], decode_ms=p["dec_ms"],
        launches=p["launches"], p_frame_bytes=p["p_frame_bytes"],
        key_bytes=p["key_bytes"], **p["stages"])
        for name, p in ppaths.items()}}))
    log(json.dumps({"pipeline": pipes}))
    shown = {pn: {k: v for k, v in p.items() if k != "recs"}
             for pn, p in side.items()}
    log(json.dumps({"ya8": {pn: shown[pn] for pn in YA8},
                    "cli": shown["cli"], "serve": serve}))
    log(json.dumps({"sharded": sharded}))
    log(json.dumps({"stages": stages}))
    log(json.dumps({"kernels": kernels}))
    log(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
