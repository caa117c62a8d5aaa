#!/usr/bin/env python3
"""Compare copies of a lane scan's source on the card: K1
(csrc/rc_encode.cu), K1-ext (csrc/rc_encode_ext.cu), K2
(csrc/rc_decode.cu), K2-ext (csrc/rc_decode_ext.cu), G1
(csrc/golomb_encode.cu) or G2 (csrc/golomb_decode.cu).

    python3 tools/scan_variants.py
        [--source rc_encode|rc_encode_ext|rc_decode|rc_decode_ext|
                  golomb_encode|golomb_decode]
        [--variant TAG=PATH ...] [--reps 5] [--stages]
        [--sass-against PATH] [--sass-loops DIR]

Run from the repository's root on a machine with one GPU.  Each
``--variant`` is a copy of the ``--source`` (default rc_encode_ext; a
design under trial, or the parent commit's source); the tree's own
source is always variant ``tree``.  Every copy is built with the
package's nvcc flags into its own directory under
``tpu_ffv1_torch/_build/variants/`` (all at once), and its registers and
spills are printed.  Then, on the warm-up inputs of chip_smoke.py's
``16bit`` path (1080p yuv444p16le, 48 lanes: K1-ext's and K2-ext's
shared-memory instances) and ``16bit_ctx1_540p`` path (K1-ext's
global-memory instance, K2-ext-five), or for K1 and K2 of its ``8bit``
and ``8bit_ctx1`` paths (K1 and its global-memory instance; K2,
K2-five), recorded from the port's encoder or
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
  (``<source>_stages_launch``; B1's and B1-ext's
  ``<source>_rgb_stages_launch``) with the tree's stage codes is split:
  the median of ``--reps`` launches of each stage probe (for the
  range-coder decoders with the bytes each probe's coders read, a lane's
  mean: a stubbed stage changes the decoded symbols and their work).

``--sass-against PATH`` builds PATH (a source with or without
``STAGES``) and checks that every production instance of the tree's
source has the same SASS as PATH's instance of the same template
arguments (``cuobjdump -sass``); only ``<source>_kernel`` is compared,
not the stats kernels of K1 and K1-ext (``<source>_stats_kernel``, pass
1 of two-pass encoding).

``--sass-loops DIR`` (K2, K2-ext and B1, B1-ext's sources) counts the
pixel loop of every variant's instance on each path: its instructions,
its shuffles (one a decision) and the instructions between them, and
writes the loop's SASS into DIR.  On K1's source it counts, in every
variant that has them, the 8-bit pixel loops of K1 and of K1's stats
scan in both table placements (pass 1's scan beside the production
one) and the loop of K1's row-count kernel.

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
INPUTS = {"rc_encode": (("8bit", "rc_encode"),
                        ("8bit_ctx1", "rc_encode_global")),
          "rc_encode_ext": (("16bit", "rc_encode_ext"),
                            ("16bit_ctx1_540p", "rc_encode_ext_global")),
          "rc_decode": (("8bit", "rc_decode"),
                        ("8bit_ctx1", "rc_decode_five_global"),
                        ("rgb8", "rc_decode_rgb")),
          "rc_decode_ext": (("16bit", "rc_decode_ext"),
                            ("16bit_ctx1_540p",
                             "rc_decode_ext_five_global"),
                            ("rgb14_540p", "rc_decode_ext_rgb")),
          "golomb_encode": (("8bit_golomb", "golomb_encode"),
                            ("8bit_golomb", "golomb_encode_global"),
                            ("ya8_golomb", "golomb_encode")),
          "golomb_decode": (("8bit_golomb", "golomb_decode"),
                            ("8bit_golomb", "golomb_decode_five"),
                            ("8bit_golomb", "golomb_decode_global"),
                            ("8bit_golomb", "golomb_decode_five_global"),
                            ("ya8_golomb", "golomb_decode"))}
STAGE_VARIANTS = {"rc_encode": rc_encode.STAGE_VARIANTS,
                  "rc_encode_ext": rc_encode.EXT_STAGE_VARIANTS,
                  "rc_decode": rc_decode.STAGE_VARIANTS,
                  "rc_decode_ext": rc_decode.EXT_STAGE_VARIANTS,
                  "golomb_encode": golomb_encode.STAGE_VARIANTS,
                  "golomb_decode": golomb_decode.STAGE_VARIANTS}
# the RGB instances' (B1, B1-ext: their own entry points)
RGB_STAGE_VARIANTS = {"rc_decode": rc_decode.RGB_STAGE_VARIANTS,
                      "rc_decode_ext": rc_decode.EXT_RGB_STAGE_VARIANTS}


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
    instructions of an instance that differs are printed.  Only the
    ``<name>_kernel`` instances count."""
    mine, theirs = ({label: ins for label, ins in
                     cs.sass_functions(name, d).items()
                     if label.startswith(f"{name}_kernel<")}
                    for d in (tree_dir, other_dir))
    full = str(STAGE_VARIANTS[name]["full"])
    n_tree = len(re.match(r".*<(.*)>", next(iter(mine)))[1].split(","))
    # the other's ALL_STAGES: its largest STAGES (a source that adds a
    # stage raises it)
    their_full = max((int(m[1]) for m in (
        re.match(r".*,(\d+)>$", label) for label in theirs) if m), default=0)
    res = []
    for label, ins in sorted(theirs.items()):
        targs = re.match(rf"{name}_kernel<(.*)>", label)
        cs.check(targs is not None, f"unexpected instance {label}")
        targs = targs[1].split(",")
        if len(targs) == n_tree:
            if int(targs[-1]) != their_full:
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


def loop_counts(ins):
    """SASS counts of a range-coder decode instance's pixel loop (the
    innermost backward-branch span with the most shuffles: one shuffle a
    decision, the renormalisation's byte): its instructions (branches
    and NOPs left out, as chip_smoke.pixel_loop_count), its shuffles,
    the instructions from each shuffle to the next in address order (a
    decision's code where they follow one another), and those before the
    first and after the last shuffle (the per-pixel code around the
    decisions), with the loop's text."""
    best = None
    for addr, text in ins:
        m = re.search(r"\bBRA\S*\s+0x([0-9a-f]+)", text)
        if not m or int(m.group(1), 16) >= addr:
            continue
        body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
        key = (sum("SHFL" in t for t in body), -len(body))
        if best is None or key > best[0]:
            best = (key, body)
    if best is None:                   # no loop: the whole function
        best = (None, [t for _a, t in ins])
    body = [t for t in best[1] if not re.search(r"\b(BRA|NOP)\b", t)]
    at = [i for i, t in enumerate(body) if "SHFL" in t]
    return dict(instructions=len(body), shuffles=len(at),
                between_shuffles=[b - a for a, b in zip(at, at[1:])],
                before_first=at[0] if at else None,
                after_last=len(body) - 1 - at[-1] if at else None,
                text=best[1])


def instance_label(name, inst, bits, full):
    """The template instance ``<name>_kernel<...>`` of kernel instance
    ``inst`` at ``bits`` in a build whose ALL_STAGES is ``full``
    (rc_decode and rc_decode_ext: BITS, FIVE, GTAB, RGB, STAGES; the
    --sass-loops count reads the decoders only)."""
    return (f"{name}_kernel<{bits},{int('_five' in inst)},"
            f"{int(inst.endswith('_global'))},{int('_rgb' in inst)},{full}>")


def warmup_inputs(dev, source):
    """{path: (args, outputs)} of the encoder's (rc_encode, rc_encode_ext,
    golomb_encode) or the decoder's (rc_decode, rc_decode_ext,
    golomb_decode) lane-scan launch on each path's warm-up frame (frames
    0 and 1 of chip_smoke.py's content)."""
    decode = "decode" in source
    golomb = source.startswith("golomb")
    if golomb:
        rec = cs.LastLaunch(port_decoder, "golomb_decode_planes") \
            if decode else cs.LastLaunch(port_encoder, "golomb_encode_lanes")
    else:
        rec = cs.LastLaunch(rc_decode, "rc_decode_planes") if decode \
            else cs.LastLaunch(port_encoder, "rc_encode_packed")
    rec_rgb = cs.LastLaunch(port_decoder, "rc_decode_rgb") if decode and \
        not golomb else None
    res = {}
    for name, inst in INPUTS[source]:
        if name in res:
            continue
        rgb = inst.endswith("_rgb")
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
        on = rec_rgb if rgb else rec
        for t in range(2):
            on.armed = t == 1
            pkts = enc.encode_frames([streams[b][t] for b in range(cs.BATCH)])
            if decode:
                dec.decode_frames([pk for pk, _key in pkts])
        on.armed = False
        args, out = on.take()
        if rgb:
            got = rc_decode.instance(args[12], args[13], args[1].shape[1],
                                     args[8], args[10])
        elif golomb:
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
    if inst.endswith("_rgb"):
        w, h, P, cc, bits, five = args[8:]

        def launch(tag, entry=None, code=None):
            planes, *rest = rc_decode._launch(
                inst, *args[:8], rc_decode.rgb_specs(w, h, P, cc), bits,
                five, entry=entry or f"{name}_rgb_launch", code=code,
                lib=libs[tag])
            return (torch.stack(planes), *rest)
        return launch, args[0].shape[0], w * h * P, bits
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
    ap.add_argument("--sass-loops", default=None, metavar="DIR",
                    help="count each variant's pixel loop (range-coder "
                    "decoders) and write its text into DIR")
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
    if opt.sass_loops and name == "rc_encode":
        os.makedirs(opt.sass_loops, exist_ok=True)
        result["sass_loops"] = {}
        for tag, (d, _log) in built.items():
            funcs = cs.sass_functions(name, d)
            full = max(int(re.match(r".*,(\d+)>$", k)[1]) for k in funcs
                       if k.startswith("rc_encode_kernel<"))
            for label in (f"rc_encode_kernel<8,0,0,{full}>",
                          f"rc_encode_kernel<8,1,0,{full}>",
                          "rc_encode_stats_kernel<8,0>",
                          "rc_encode_stats_kernel<8,1>",
                          "rc_stats_rows_kernel"):
                if label not in funcs:
                    continue
                c = loop_counts(funcs[label])
                with open(os.path.join(opt.sass_loops,
                                       f"{tag}_{label}.sass"), "w") as f:
                    f.write("\n".join(c.pop("text")) + "\n")
                result["sass_loops"][f"{tag}:{label}"] = c
                cs.log(f"[sass] {tag} {label}: loop {c['instructions']} "
                       f"instructions, {c['shuffles']} shuffles")
    if opt.sass_loops and name.startswith("rc_decode"):
        out_dir = opt.sass_loops
        os.makedirs(out_dir, exist_ok=True)
        result["sass_loops"] = {}
        for tag, (d, _log) in built.items():
            funcs = cs.sass_functions(name, d)
            full = max(int(re.match(r".*,(\d+)>$", k)[1]) for k in funcs)
            for path, inst in INPUTS[name]:
                args = inputs[path][0]
                bits = args[12] if inst.endswith("_rgb") else args[9]
                label = instance_label(name, inst, bits, full)
                c = loop_counts(funcs[label])
                with open(os.path.join(out_dir, f"{tag}_{inst}.sass"),
                          "w") as f:
                    f.write("\n".join(c.pop("text")) + "\n")
                result["sass_loops"][f"{tag}:{inst}"] = c
                cs.log(f"[sass] {tag} {label}: pixel loop "
                       f"{c['instructions']} instructions, {c['shuffles']} "
                       f"shuffles; between shuffles {c['between_shuffles']}; "
                       f"before the first {c['before_first']}, after the "
                       f"last {c['after_last']}")
    for path, inst in INPUTS[name]:
        rgb = inst.endswith("_rgb")
        stage_entry = f"{name}{'_rgb' if rgb else ''}_stages_launch"
        variants = (RGB_STAGE_VARIANTS if rgb else STAGE_VARIANTS)[name]
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
            try:                   # another source's stage codes differ
                launch(tag, stage_entry, variants["full"])
            except RuntimeError as err:
                cs.log(f"[stage] {tag}: no split ({err})")
                continue
            split, read = {}, {}
            for variant, code in variants.items():
                def probe():
                    return launch(tag, stage_entry, code)
                out = probe()
                if name.startswith("rc_decode"):
                    # the bytes the lanes' coders read: a stubbed stage
                    # changes the decoded symbols, and with them the work
                    read[variant] = float((out[-1] - args[7]).float().mean())
                split[variant] = sorted(cs.launch_ms(probe)
                                        for _ in range(opt.reps))[
                    opt.reps // 2]
            result["stages"].setdefault(f"{path}:{inst}", {})[tag] = split
            if read:
                result.setdefault("stage_bytes_read", {}).setdefault(
                    f"{path}:{inst}", {})[tag] = read
            cs.log(f"[stage] {tag} {inst} on {path} (median of {opt.reps}, "
                   f"{gpu}): " + ", ".join(
                       f"{v} {ms:.2f} ms" + ("" if v == "full" else
                                             f" ({split['full'] - ms:.2f})") +
                       (f" [{read[v]:.0f} B a lane]" if read else "")
                       for v, ms in split.items()))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
