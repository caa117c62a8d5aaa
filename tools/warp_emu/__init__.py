"""Host emulation of a warp, to run the port's CUDA lane-scan sources on
the CPU (no nvcc, no card).

``build(src, out_dir)`` rewrites a source of ``tpu_ffv1_torch/csrc``
for the host (``#include <cuda_runtime.h>`` becomes warp_emu.h, the
dynamic shared-memory array a pointer to the block's buffer, each
``kernel<<<grid, block, smem, stream>>>(...)`` a call of
``emu_launch``) and compiles it with g++ into a shared library with the
source's own plain C entry points; host arrays stand in for device
memory.  warp_emu.h runs each block's 32 threads as coroutines on one
host thread (ucontext), one block after another: every
``__shfl_sync``, ``__ballot_sync`` and ``__syncwarp`` is the point
where a thread hands its turn to the next, and a primitive's values are
read only after all 32 threads have published theirs, so code whose
warp primitives are reached by all 32 threads alike (the lane scans'
uniform branches) computes what the card computes.  One host thread a
block keeps the emulation's speed independent of how busy the machine's
other cores are (a test run's other workers).  A block whose threads
reach different numbers of warp primitives (a shuffle under a branch
that diverges) is counted as a fault: ``emu_fault_count()`` in the
library.  The emulated card has 2 SMs (``cudaDeviceGetAttribute``), for
kernels that size their grid by it.

It checks logic, not timing, and not the memory model beyond the
primitives: between two of them the threads run one after another, in
order, so a kernel that races within a warp between two primitives may
pass here and fail on the card.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess

HERE = os.path.dirname(os.path.abspath(__file__))


def compiler():
    """The host C++ compiler, or None."""
    return shutil.which("g++")


def transform(text: str) -> str:
    """A CUDA lane-scan source rewritten for the host emulation."""
    text = text.replace("#include <cuda_runtime.h>", '#include "warp_emu.h"')
    text = text.replace("extern __shared__ __align__(16) uint8_t smem[];",
                        "uint8_t* smem = emu_blk->smem;")
    return re.sub(
        r"(\w+(?:<[^;<>]*>)?)<<<([^>]*)>>>\((.*?)\);",
        lambda m: ("emu_launch(" + ",".join(m.group(2).split(",")[:3]) +
                   ", [&]() { " + m.group(1) + "(" + m.group(3) + "); });"),
        text, flags=re.S)


def build(src: str, out_dir: str) -> str:
    """Compile ``src`` for the emulation into ``out_dir``; returns the
    shared library's path.  The source's own directory is on the include
    path, for the headers it shares with its siblings."""
    name = os.path.basename(src)[:-3]
    os.makedirs(out_dir, exist_ok=True)
    cpp = os.path.join(out_dir, f"{name}_emu.cpp")
    with open(src) as f, open(cpp, "w") as g:
        g.write(transform(f.read()))
    lib = os.path.join(out_dir, f"lib{name}_emu.so")
    subprocess.run([compiler() or "g++", "-std=c++20", "-O1", "-pthread",
                    "-shared", "-fPIC", "-w", "-I", HERE, "-I",
                    os.path.dirname(os.path.abspath(src)), "-o", lib, cpp,
                    os.path.join(HERE, "warp_emu.cpp")], check=True)
    return lib
