"""Build the CUDA kernels of ``tpu_ffv1_torch/csrc`` at first use, and
check the tensors their wrappers pass.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (sm_90a) into ``tpu_ffv1_torch/_build/lib<name>.so``,
then loaded with ``ctypes``.  A library is rebuilt when its source, or
a header of ``csrc`` (``*.cuh``), is newer than it; ``build_all`` compiles several sources in parallel.
Nothing here falls back: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dynamic shared memory one block may have on Hopper (227 KB)
SMEM_PER_BLOCK = 232448

_LIBS: dict = {}
# seconds spent compiling each library in this process (0.0 when an
# existing build was loaded)
BUILD_SECONDS: dict = {}
# nvcc's output (ptxas register/shared-memory report) per library
BUILD_LOG: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME
        home = CUDA_HOME
    cand = os.path.join(home, "bin", "nvcc") if home else None
    if cand and os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels "
                       "of tpu_ffv1_torch cannot be built")


def expect(name, t, dtype, shape, device):
    """Raise unless kernel argument ``t`` is a contiguous ``dtype``
    tensor of ``shape`` on ``device``."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)} "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def table_in_global(table_bytes: int, other_smem_bytes: int) -> bool:
    """Whether a lane scan keeps its state table in global memory: when
    the table and the kernel's other shared memory do not fit a block.
    The lane-scan wrappers decide the placement here, from sizes alone,
    before the launch."""
    return table_bytes + other_smem_bytes > SMEM_PER_BLOCK


def _stale(name: str) -> bool:
    src = os.path.join(CSRC, f"{name}.cu")
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    deps = [src] + [os.path.join(CSRC, f) for f in os.listdir(CSRC)
                    if f.endswith(".cuh")]
    return not os.path.exists(out) or \
        os.path.getmtime(out) < max(map(os.path.getmtime, deps))


def build_all(names) -> None:
    """Compile every stale library of ``names`` at once: one nvcc per
    source, all started together, then wait for each."""
    jobs = []
    os.makedirs(BUILD_DIR, exist_ok=True)
    for name in names:
        BUILD_SECONDS.setdefault(name, 0.0)
        if not _stale(name):
            continue
        src = os.path.join(CSRC, f"{name}.cu")
        out = os.path.join(BUILD_DIR, f"lib{name}.so")
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, src, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, src, out, tmp, proc, t0 in jobs:
        BUILD_LOG[name] = proc.communicate()[0]
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src} (exit {proc.returncode}):"
                          f"\n{BUILD_LOG[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    lib = ctypes.CDLL(os.path.join(BUILD_DIR, f"lib{name}.so"))
    _LIBS[name] = lib
    return lib
