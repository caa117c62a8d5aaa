#!/usr/bin/env python3
"""Compare copies of a lane scan's source on the card: K1-ext
(csrc/rc_encode_ext.cu), K2 (csrc/rc_decode.cu), K2-ext
(csrc/rc_decode_ext.cu), G1 (csrc/golomb_encode.cu) or G2
(csrc/golomb_decode.cu).

    python3 tools/scan_variants.py
        [--source rc_encode_ext|rc_decode|rc_decode_ext|golomb_encode|
                  golomb_decode]
        [--variant TAG=PATH ...] [--reps 5] [--stages]
        [--sass-against PATH]

Run from the repository's root on a machine with one GPU.  Each
``--variant`` is a copy of the ``--source`` (default rc_encode_ext; a
design under trial, or the parent commit's source); the tree's own
source is always variant ``tree``.  Every copy is built with the
package's nvcc flags into its own directory under
``tpu_ffv1_torch/_build/variants/`` (all at once), and its registers and
spills are printed.  Then, on the warm-up inputs of chip_smoke.py's
``16bit`` path (1080p yuv444p16le, 48 lanes: K1-ext's and K2-ext's
shared-memory instances) and ``16bit_ctx1_540p`` path (K1-ext's
global-memory instance, K2-ext-five), or for K2 of its ``8bit`` and
``8bit_ctx1`` paths (K2, K2-five), recorded from the port's encoder or
decoder exactly as chip_smoke.py records them; for G1 and G2 those of
the ``8bit_golomb`` path (1080p yuv420p, Golomb-Rice: G1's two
instances and G2's four, each instance on the same inputs) and of the
``ya8_golomb`` path (1080p ya8, two 320x270 planes a lane):

- each variant's outputs must equal the tree's production launch (which
  chip_smoke.py holds to the plain version; an instance the path does not
  pick itself: the tree's launch of that instance);
- each variant is timed in turns, every variant once per round, with
  CUDA events, ``--reps`` rounds; the median is reported;
- with ``--stages``, every variant that has the stage entry point
  (``<source>_stages_launch``) is split: the median of ``--reps``
  launches of each stage probe.

``--sass-against PATH`` builds PATH (a source with or without
``STAGES``) and checks that every production instance of the tree's
source has the same SASS as PATH's instance of the same template
arguments (``cuobjdump -sass``).

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
from tpu_ffv1_torch import (EncoderParams, TorchFFV1Decoder,  # noqa: E402
                            TorchFFV1Encoder)
from tpu_ffv1_torch.kernels import build  # noqa: E402
from tpu_ffv1_torch.tpu import decoder as port_decoder  # noqa: E402
from tpu_ffv1_torch.tpu import encoder as port_encoder  # noqa: E402
from tpu_ffv1_torch.tpu import (golomb_decode, golomb_encode,  # noqa: E402
                                rc_decode, rc_encode)

VARIANT_DIR = os.path.join(build.BUILD_DIR, "variants")
# per source: the paths whose warm-up inputs it runs and the instance
# each launches; its stage variants ("full": the production instances'
# STAGES)
INPUTS = {"rc_encode_ext": (("16bit", "rc_encode_ext"),
                            ("16bit_ctx1_540p", "rc_encode_ext_global")),
          "rc_decode": (("8bit", "rc_decode"),
                        ("8bit_ctx1", "rc_decode_five_global")),
          "rc_decode_ext": (("16bit", "rc_decode_ext"),
                            ("16bit_ctx1_540p",
                             "rc_decode_ext_five_global")),
          "golomb_encode": (("8bit_golomb", "golomb_encode"),
                            ("8bit_golomb", "golomb_encode_global"),
                            ("ya8_golomb", "golomb_encode")),
          "golomb_decode": (("8bit_golomb", "golomb_decode"),
                            ("8bit_golomb", "golomb_decode_five"),
                            ("8bit_golomb", "golomb_decode_global"),
                            ("8bit_golomb", "golomb_decode_five_global"),
                            ("ya8_golomb", "golomb_decode"))}
STAGE_VARIANTS = {"rc_encode_ext": rc_encode.EXT_STAGE_VARIANTS,
                  "rc_decode": rc_decode.STAGE_VARIANTS,
                  "rc_decode_ext": rc_decode.EXT_STAGE_VARIANTS,
                  "golomb_encode": golomb_encode.STAGE_VARIANTS,
                  "golomb_decode": golomb_decode.STAGE_VARIANTS}


def build_variants(name, sources):
    """{tag: (library directory, nvcc log)}: every source compiled at
    once, each to <dir>/lib<name>.so."""
    jobs = {}
    for tag, src in sources.items():
        out_dir = os.path.join(VARIANT_DIR, tag)
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, f"lib{name}.so")
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


def same_sass(name, tree_dir, other_dir):
    """[(instance, equal)] for every production instance of the other
    build, each against the tree's production instance (STAGES =
    ALL_STAGES) of the same other template arguments: where the other
    source has no STAGES, every instance of it; the first differing
    instructions of an instance that differs are printed."""
    mine = cs.sass_functions(name, tree_dir)
    theirs = cs.sass_functions(name, other_dir)
    full = str(STAGE_VARIANTS[name]["full"])
    n_tree = len(re.match(r".*<(.*)>", next(iter(mine)))[1].split(","))
    res = []
    for label, ins in sorted(theirs.items()):
        targs = re.match(rf"{name}_kernel<(.*)>", label)
        cs.check(targs is not None, f"unexpected instance {label}")
        targs = targs[1].split(",")
        if len(targs) == n_tree:
            if targs[-1] != full:
                continue                       # a stage probe
            targs = targs[:-1]
        want = f"{name}_kernel<{','.join(targs + [full])}>"
        cs.check(want in mine, f"the tree has no instance {want}")
        res.append((label, mine[want] == ins))
        if mine[want] != ins:
            diff = [(a, b) for a, b in zip(mine[want], ins) if a != b][:4]
            cs.log(f"[sass] {want}: {len(mine[want])} instructions against "
                   f"{len(ins)}; first differences (tree, other): {diff}")
    return res


def warmup_inputs(dev, source):
    """{path: (args, outputs)} of the encoder's (rc_encode_ext,
    golomb_encode) or the decoder's (rc_decode, rc_decode_ext,
    golomb_decode) lane-scan launch on each path's warm-up frame (frames
    0 and 1 of chip_smoke.py's content)."""
    decode = "decode" in source
    golomb = source.startswith("golomb")
    if golomb:
        rec = cs.LastLaunch(port_decoder, "golomb_decode_planes") \
            if decode else cs.LastLaunch(port_encoder, "golomb_encode_lanes")
    else:
        rec = cs.LastLaunch(port_decoder, "rc_decode_planes") if decode \
            else cs.LastLaunch(port_encoder, "rc_encode_packed")
    res = {}
    for name, inst in INPUTS[source]:
        if name in res:
            continue
        if name in cs.YA8:
            kw, (w, h) = cs.ya8_kw(name), (cs.W, cs.H)
            streams = cs.ya8_streams()
        else:
            kw, p = cs.params_kw(name), cs.PATHS[name]
            w, h, streams = p.width, p.height, cs.path_streams(name)
        enc = TorchFFV1Encoder(EncoderParams(**kw), batch=cs.BATCH,
                               device=dev)
        dec = TorchFFV1Decoder(w, h, enc.extradata, batch=cs.BATCH,
                               device=dev)
        for t in range(2):
            rec.armed = t == 1
            pkts = enc.encode_frames([streams[b][t] for b in range(cs.BATCH)])
            if decode:
                dec.decode_frames([pk for pk, _key in pkts])
        rec.armed = False
        args, out = rec.take()
        if golomb:
            got = golomb_decode.instance(
                args[6], args[1].shape[1],
                max(pw for (pw, _h, _b) in args[4])) if decode else \
                golomb_encode.instance(args[4].shape[1])
        else:
            got = cs.decode_instance(args) if decode else \
                rc_encode.instance(args[8], args[3].shape[1])
        cs.check(got == inst, f"{name}: not {inst}")
        res[name] = (args, out)
    return res


def launcher(name, inst, args, out, libs):
    """(launch(tag, entry=None, code=None), L, N, bits) of instance
    ``inst`` of source ``name`` on a recorded launch's ``args``."""
    if name == "golomb_encode":
        T = out[0].shape[1]

        def launch(tag, entry=None, code=None):
            return golomb_encode._launch(inst, *args[:9], T, code=code,
                                         lib=libs[tag])
        return launch, args[0].shape[0], args[0].shape[1], args[7]
    if name == "golomb_decode":
        def launch(tag, entry=None, code=None):
            return golomb_decode._launch(inst, *args[:6], "_five" in inst,
                                         code=code, lib=libs[tag])
        return launch, args[0].shape[0], sum(
            w * h for (w, h, _b) in args[4]), args[5]
    if name.startswith("rc_decode"):
        def launch(tag, entry=None, code=None):
            return rc_decode._launch(inst, *args, entry=entry, code=code,
                                     lib=libs[tag])
        return launch, args[0].shape[0], sum(
            w * h for (w, h, _b) in args[8]), args[9]

    def launch(tag, entry=None, code=None):
        return rc_encode._launch(name, inst.endswith("_global"), *args,
                                 entry=entry, code=code, lib=libs[tag])
    return launch, args[0].shape[0], args[0].shape[1], args[8]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", choices=sorted(INPUTS),
                    default="rc_encode_ext")
    ap.add_argument("--variant", action="append", default=[],
                    help="TAG=PATH of a copy of the source")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--sass-against", default=None)
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        cs.log("torch.cuda.is_available() is False: this needs a GPU")
        return 1
    gpu = cs.gpu_line()
    dev = torch.device("cuda", 0)
    name = opt.source
    sources = {"tree": os.path.join(build.CSRC, f"{name}.cu")}
    for v in opt.variant:
        tag, path = v.split("=", 1)
        sources[tag] = path
    if opt.sass_against:
        sources["sass_ref"] = opt.sass_against
    t0 = time.perf_counter()
    built = build_variants(name, sources)
    cs.log(f"[build] {len(built)} sources in "
           f"{time.perf_counter() - t0:.1f} s")
    result = dict(gpu=gpu, source=name, reps=opt.reps, resources={},
                  sass=None, ms={}, stages={})
    for tag, (_d, log) in built.items():
        result["resources"][tag] = resources(log)
        cs.log(f"[build] {tag}: " + "; ".join(resources(log)))
    if opt.sass_against:
        eq = same_sass(name, built["tree"][0], built.pop("sass_ref")[0])
        result["sass"] = {label: same for label, same in eq}
        cs.log(f"[sass] the tree's production instances against "
               f"{opt.sass_against}: " + ", ".join(
                   f"{label} {'same' if same else 'DIFFERENT'}"
                   for label, same in eq))
    libs = {tag: ctypes.CDLL(os.path.join(d, f"lib{name}.so"))
            for tag, (d, _log) in built.items()}
    inputs = warmup_inputs(dev, name)
    stage_entry = f"{name}_stages_launch"
    for path, inst in INPUTS[name]:
        args, want = inputs[path]
        launch, L, N, bits = launcher(name, inst, args, want, libs)
        if any(p == path and i != inst for p, i in INPUTS[name][:1]):
            want = launch("tree")          # an instance the path does not pick
        for tag in libs:
            got = cs.flat_outputs(launch(tag))
            cs.check(len(got) == len(cs.flat_outputs(want)) and
                     all(torch.equal(a, b) for a, b in
                         zip(got, cs.flat_outputs(want))),
                     f"{tag} differs from the production launch of {inst} "
                     f"on {path}")
        times = {tag: [] for tag in libs}
        for _ in range(opt.reps):
            for tag in libs:
                times[tag].append(cs.launch_ms(lambda: launch(tag)))
        med = {tag: sorted(v)[len(v) // 2] for tag, v in times.items()}
        result["ms"][f"{path}:{inst}"] = med
        cs.log(f"[time] {inst} on {path}'s warm-up inputs (L={L}, N={N}, "
               f"bits={bits}; outputs equal to the production launch; "
               f"median of {opt.reps} in turns; {gpu}): " + ", ".join(
                   f"{tag} {ms:.2f} ms" for tag, ms in med.items()))
        if not opt.stages:
            continue
        for tag, lib in libs.items():
            if not hasattr(lib, stage_entry):
                continue
            split = {}
            for variant, code in STAGE_VARIANTS[name].items():
                def probe():
                    return launch(tag, stage_entry, code)
                probe()
                split[variant] = sorted(cs.launch_ms(probe)
                                        for _ in range(opt.reps))[
                    opt.reps // 2]
            result["stages"].setdefault(f"{path}:{inst}", {})[tag] = split
            cs.log(f"[stage] {tag} {inst} on {path} (median of {opt.reps}, "
                   f"{gpu}): " + ", ".join(
                       f"{v} {ms:.2f} ms" + ("" if v == "full" else
                                             f" ({split['full'] - ms:.2f})")
                       for v, ms in split.items()))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
