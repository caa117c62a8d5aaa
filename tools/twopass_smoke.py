#!/usr/bin/env python3
"""The twopass phase of chip_smoke.py alone, on the card.

    python3 tools/twopass_smoke.py

Run from the repository's root on a machine with one GPU.  Builds the
kernels two-pass encoding runs (K1, K1-ext and their stats instances,
K2, find_best_state), runs chip_smoke.py's ``twopass_phase`` (the small
cuts' pass-1 texts and the 1080p pass-2 packets against the host's
golden digests, find_best_state against the host's table and its plain
version's rows, the stats instance beside the production K1), holds the
stats instances' launches exactly against their plain versions
(``plain_checks``: the random ones, the small cuts' and 1080p pass 1's
frame 1 in segments), and prints the phase's kernel rows with the bounds
from the decision probe.  About two minutes; the quick check of a change
to two-pass encoding.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as c  # noqa: E402
from tpu_ffv1_torch.kernels import build  # noqa: E402
from tpu_ffv1_torch.tpu import encoder as port_encoder  # noqa: E402


def main():
    if not torch.cuda.is_available():
        c.log("torch.cuda.is_available() is False: this run needs a GPU")
        return 1
    gpu = c.gpu_line()
    c.log(f"[env] {gpu}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    t0 = time.perf_counter()
    libs = ("rc_encode", "rc_decode", "rc_encode_ext", "find_best_state",
            "chain_probe")
    build.build_all(libs)
    c.log(f"[build] {time.perf_counter() - t0:.1f} s")
    for name in libs:
        seen = []
        for line in build.BUILD_LOG.get(name, "").splitlines():
            line = line.split(":", 1)[-1].strip()
            if ("registers" in line or "spill" in line) and line not in seen:
                seen.append(line)
                c.log(f"[build] {name} (all instances): {line}")
    funcs = {name: c.sass_functions(name) for name in libs}
    dev = torch.device("cuda", 0)
    ns_enc = c.chain_probe_ns(dev, 0)
    ops_enc, _ops_dec = c.probe_sass_ops()
    tp = c.twopass_phase(dev, gpu, c.LastLaunch(port_encoder,
                                                "rc_encode_stats"))
    random = tp.pop("random")
    tp_recs = tp.pop("main_recs")
    secs, workers = c.plain_checks(
        [(name, rec, False) for name, _info, rec in random] +
        [(name, rec, split) for name, rec, split, _l, _ms in tp_recs])
    tp_checks = c.twopass_checks(tp_recs, secs[len(random):])
    checks = {}
    for (name, info, _rec), segs in zip(random, secs):
        info["check_plain_ms"] = segs[0] * 1e3
        checks.setdefault(name, []).append(info)
        c.log(f"[check] {name} {info['check_shape']}: exact match (equal "
              f"SHA-256 of every output); plain version on the host CPU "
              f"{segs[0]:.1f} s")
    rows = c.twopass_rows(tp, checks, tp_checks,
                          (ns_enc, ops_enc, 0.0, 0.0, 0.0), funcs, gpu)
    c.log(json.dumps({"twopass": dict(launches=tp["launches"],
                                      **tp["numbers"])}))
    c.log(json.dumps({"kernels": rows}))
    c.log("[done] two-pass encoding equal to its goldens")
    return 0


if __name__ == "__main__":
    sys.exit(main())
