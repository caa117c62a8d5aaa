#!/usr/bin/env python3
"""The sharded phase of chip_smoke.py alone, on the card.

    python3 tools/sharded_smoke.py

Run from the repository's root on a machine with a GPU.  Builds the four
range-coder lane scans (K1, K1-ext, K2, K2-ext), then runs chip_smoke.py's
``sharded_phase``: the lanes split into groups over the cards it finds
(two groups on one card), the 8bit and 16bit paths at depth 1 and 2
against their goldens, BASELINE config 5 (3840x2160 yuv422p10le P frames)
against ``config5_4k``.  It holds no launch against its plain version
(chip_smoke.py's phase 6 does) and prints no unsharded step beside the sharded ones: that is
chip_smoke.py.  A few minutes where chip_smoke.py takes fifteen; the
quick check of a change to the multi-device layer.
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
    build.build_all(("rc_encode", "rc_decode", "rc_encode_ext",
                     "rc_decode_ext"))
    c.log(f"[build] {time.perf_counter() - t0:.1f} s")
    recorders = dict(packed=c.LastLaunch(port_encoder, "rc_encode_packed"),
                     decode=c.LastLaunch(c.rc_decode, "rc_decode_planes"))
    res, _tails = c.sharded_phase(gpu, recorders)
    c.log(json.dumps({"sharded": res}))
    c.log("[done] every sharded packet equal to its golden")
    return 0


if __name__ == "__main__":
    sys.exit(main())
