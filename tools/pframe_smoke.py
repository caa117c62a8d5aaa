#!/usr/bin/env python3
"""The FFV1-P paths of chip_smoke.py alone, on the card.

    python3 tools/pframe_smoke.py

Run from the repository's root on a machine with one GPU.  Builds the
four range-coder lane scans (K1, K1-ext, K2, K2-ext), then runs
chip_smoke.py's ``pframe_phase`` for each of its P paths (golden
digests, lossless decode, one launch per frame and lane scan, step and
stage times) and relaunches each recorded P launch, which must give the
same outputs.  It holds no launch against its plain version: that is
chip_smoke.py's phase 6.  About two minutes where chip_smoke.py takes
fifteen; the quick check of a change to the P path.
"""
from __future__ import annotations

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
    build.build_all(("rc_encode", "rc_decode", "rc_encode_ext",
                     "rc_decode_ext"))
    c.log(f"[build] {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    recorders = dict(packed=c.LastLaunch(port_encoder, "rc_encode_packed"),
                     decode=c.LastLaunch(c.rc_decode, "rc_decode_planes"))
    for name in c.P_PATHS:
        p = c.pframe_phase(dev, gpu, name, recorders)
        for k, (args, out) in p["recs"].items():
            fn = c.rc_encode.rc_encode_packed if k.startswith("rc_encode") \
                else c.rc_decode.rc_decode_planes
            again = fn(*args)
            c.check(all(torch.equal(a, b) for a, b in zip(
                c.flat_outputs(again), c.flat_outputs(out))),
                f"{name}: {k} relaunched differs from its P launch")
    c.log("[done] every P path equal to its goldens")
    return 0


if __name__ == "__main__":
    sys.exit(main())
