#!/usr/bin/env python3
"""Compare copies of K1-ext's source (csrc/rc_encode_ext.cu) on the card.

    python3 tools/scan_variants.py [--variant TAG=PATH ...] [--reps 5]
        [--stages] [--sass-against PATH]

Run from the repository's root on a machine with one GPU.  Each
``--variant`` is a copy of ``rc_encode_ext.cu`` (a design under trial,
or the parent commit's source); the tree's own source is always variant
``tree``.  Every copy is built with the package's nvcc flags into its
own directory under ``tpu_ffv1_torch/_build/variants/`` (all at once),
and its registers and spills are printed.  Then, on the warm-up inputs
of chip_smoke.py's ``16bit`` path (1080p yuv444p16le, 48 lanes, the
shared-memory instance) and ``16bit_ctx1_540p`` path (the global-memory
instance), recorded from the port's encoder exactly as chip_smoke.py
records them:

- each variant's outputs must equal the tree's production launch (which
  chip_smoke.py holds to the plain version);
- each variant is timed in turns, every variant once per round, with
  CUDA events, ``--reps`` rounds; the median is reported;
- with ``--stages``, every variant that has the stage entry point
  (``rc_encode_ext_stages_launch``) is split: the median of ``--reps``
  launches of each stage probe.

``--sass-against PATH`` builds PATH (a source without ``STAGES``) and
checks that every production instance of the tree's source has the
same SASS as PATH's instance of the same width and placement
(``cuobjdump -sass``).

Prints one JSON line with every number, last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tpu_ffv1_torch import EncoderParams, TorchFFV1Encoder  # noqa: E402
from tpu_ffv1_torch.kernels import build  # noqa: E402
from tpu_ffv1_torch.tpu import encoder as port_encoder  # noqa: E402
from tpu_ffv1_torch.tpu import rc_encode  # noqa: E402

VARIANT_DIR = os.path.join(build.BUILD_DIR, "variants")
INPUTS = (("16bit", "rc_encode_ext"),
          ("16bit_ctx1_540p", "rc_encode_ext_global"))


def build_variants(sources):
    """{tag: (library directory, nvcc log)}: every source compiled at
    once, each to <dir>/librc_encode_ext.so."""
    jobs = {}
    for tag, src in sources.items():
        out_dir = os.path.join(VARIANT_DIR, tag)
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, "librc_encode_ext.so")
        jobs[tag] = (out_dir, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    res = {}
    for tag, (out_dir, proc) in jobs.items():
        log = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"nvcc failed for {tag}:\n{log}")
        res[tag] = (out_dir, log)
    return res


def resources(log):
    """Distinct ptxas register and spill lines of a build log."""
    seen = []
    for line in log.splitlines():
        line = line.split(":", 1)[-1].strip()
        if ("registers" in line or "spill" in line) and line not in seen:
            seen.append(line)
    return seen


def same_sass(tree_dir, other_dir):
    """[(instance, equal)] for every instance of the other build, each
    against the tree's production instance (STAGES = ALL_STAGES, 31) of
    the same width and placement; the first differing instructions of an
    instance that differs are printed."""
    mine = cs.sass_functions("rc_encode_ext", tree_dir)
    theirs = cs.sass_functions("rc_encode_ext", other_dir)
    res = []
    for label, ins in sorted(theirs.items()):
        targs = re.match(r"rc_encode_ext_kernel<(\d+),(\d)>", label)
        cs.check(targs is not None, f"unexpected instance {label}")
        want = f"rc_encode_ext_kernel<{targs[1]},{targs[2]},31>"
        cs.check(want in mine, f"the tree has no instance {want}")
        res.append((label, mine[want] == ins))
        if mine[want] != ins:
            diff = [(a, b) for a, b in zip(mine[want], ins) if a != b][:4]
            cs.log(f"[sass] {want}: {len(mine[want])} instructions against "
                   f"{len(ins)}; first differences (tree, other): {diff}")
    return res


def warmup_inputs(dev):
    """{path: (args, outputs)} of the encoder's lane-scan launch on each
    path's warm-up frame (frames 0 and 1 of chip_smoke.py's content)."""
    rec = cs.LastLaunch(port_encoder, "rc_encode_packed")
    res = {}
    for name, inst in INPUTS:
        streams = cs.path_streams(name)
        enc = TorchFFV1Encoder(EncoderParams(**cs.params_kw(name)),
                               batch=cs.BATCH, device=dev)
        for t in range(2):
            rec.armed = t == 1
            enc.encode_frames([streams[b][t] for b in range(cs.BATCH)])
        rec.armed = False
        args, out = rec.take()
        cs.check(rc_encode.instance(args[8], args[3].shape[1]) == inst,
                 f"{name}: not {inst}")
        res[name] = (args, out)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="TAG=PATH of a copy of rc_encode_ext.cu")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--sass-against", default=None)
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        cs.log("torch.cuda.is_available() is False: this needs a GPU")
        return 1
    gpu = cs.gpu_line()
    dev = torch.device("cuda", 0)
    sources = {"tree": os.path.join(build.CSRC, "rc_encode_ext.cu")}
    for v in opt.variant:
        tag, path = v.split("=", 1)
        sources[tag] = path
    if opt.sass_against:
        sources["sass_ref"] = opt.sass_against
    t0 = time.perf_counter()
    built = build_variants(sources)
    cs.log(f"[build] {len(built)} sources in "
           f"{time.perf_counter() - t0:.1f} s")
    result = dict(gpu=gpu, reps=opt.reps, resources={}, sass=None,
                  ms={}, stages={})
    for tag, (_d, log) in built.items():
        result["resources"][tag] = resources(log)
        cs.log(f"[build] {tag}: " + "; ".join(resources(log)))
    if opt.sass_against:
        eq = same_sass(built["tree"][0], built.pop("sass_ref")[0])
        result["sass"] = {label: same for label, same in eq}
        cs.log(f"[sass] the tree's production instances against "
               f"{opt.sass_against}: " + ", ".join(
                   f"{label} {'same' if same else 'DIFFERENT'}"
                   for label, same in eq))
    libs = {tag: ctypes.CDLL(os.path.join(d, "librc_encode_ext.so"))
            for tag, (d, _log) in built.items()}
    inputs = warmup_inputs(dev)
    for name, inst in INPUTS:
        args, want = inputs[name]
        args8, bits = args[:8], args[8]
        gtab = inst.endswith("_global")
        L, N = args[0].shape

        def launch(tag, entry=None, code=None):
            return rc_encode._launch("rc_encode_ext", gtab, *args8, bits,
                                     entry=entry, code=code, lib=libs[tag])

        for tag in libs:
            got = launch(tag)
            cs.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                     f"{tag} differs from the production launch on {name}")
        times = {tag: [] for tag in libs}
        for _ in range(opt.reps):
            for tag in libs:
                times[tag].append(cs.launch_ms(lambda: launch(tag)))
        med = {tag: sorted(v)[len(v) // 2] for tag, v in times.items()}
        result["ms"][name] = med
        cs.log(f"[time] {inst} on {name}'s warm-up inputs (L={L}, N={N}, "
               f"bits={bits}; outputs equal to the production launch; "
               f"median of {opt.reps} in turns; {gpu}): " + ", ".join(
                   f"{tag} {ms:.2f} ms" for tag, ms in med.items()))
        if not opt.stages:
            continue
        for tag, lib in libs.items():
            if not hasattr(lib, "rc_encode_ext_stages_launch"):
                continue
            split = {}
            for variant, code in rc_encode.EXT_STAGE_VARIANTS.items():
                def probe():
                    return launch(tag, "rc_encode_ext_stages_launch", code)
                probe()
                split[variant] = sorted(cs.launch_ms(probe)
                                        for _ in range(opt.reps))[
                    opt.reps // 2]
            result["stages"].setdefault(name, {})[tag] = split
            cs.log(f"[stage] {tag} {inst} on {name} (median of {opt.reps}, "
                   f"{gpu}): " + ", ".join(
                       f"{v} {ms:.2f} ms" + ("" if v == "full" else
                                             f" ({split['full'] - ms:.2f})")
                       for v, ms in split.items()))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
