"""Shared-memory lookup probes (``csrc/chain_probe.cu``
``smem_probe_kernel``) and their plain loops.

Port of the TPU lookup probes ``scripts/probes/gather_probe.py``,
``gather_probe2.py``, ``gather_probe3.py``, ``gather_probe4.py`` and
``read_probe.py``: each timed one dependent per-lane lookup in a table
held in the TPU core's VMEM.  The lane scans on Hopper keep their tables
in shared memory and do two such lookups per pixel, so the probe has two
modes, each one warp in a dependent loop:

  row:  a 32-byte state row read (thread t reads byte t of row r), the
        next row's index from bytes 0 and 1 of the row just read; the
        table is one random cycle over its rows (``cycle_table``);
  byte: K1's transition lookup, each thread s = tab[s] in a 256-entry
        table, from s = t.

Both return int32 (32, 2): per thread the final index and the sum of
the values it read.  Not on the codec's path: chip_smoke.py times them.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import expect, load

MODES = {"row": 0, "byte": 1}


def cycle_table(rows: int, seed: int) -> np.ndarray:
    """uint8 (rows, 32) of random bytes whose bytes 0 and 1 hold the
    index of the next row of one random cycle over all rows."""
    r = np.random.RandomState(seed)
    order = r.permutation(rows)
    nxt = np.empty(rows, np.int64)
    nxt[order] = np.roll(order, -1)
    table = r.randint(0, 256, (rows, 32)).astype(np.uint8)
    table[:, 0] = nxt & 0xFF
    table[:, 1] = nxt >> 8
    return table


def row_walk_ref(table, n: int) -> torch.Tensor:
    """Plain loop of the row mode (and of the L2 row probe, whose thread
    0 is row 0 of the result): n dependent row reads from row 0."""
    tab = np.asarray(table, np.int64)
    r, acc = 0, np.zeros(32, np.int64)
    for _ in range(n):
        row = tab[r]
        acc += row
        r = int(row[0]) | int(row[1]) << 8
    return torch.from_numpy(np.stack([np.full(32, r), acc], 1)
                            .astype(np.int32))


def byte_walk_ref(table, n: int) -> torch.Tensor:
    """Plain loop of the byte mode: s = tab[s] per thread from s = t."""
    tab = np.asarray(table, np.int64)
    s, acc = np.arange(32), np.zeros(32, np.int64)
    for _ in range(n):
        s = tab[s]
        acc += s
    return torch.from_numpy(np.stack([s, acc], 1).astype(np.int32))


def smem_probe(table: torch.Tensor, n: int, mode: str) -> torch.Tensor:
    """Run the probe of ``mode`` for n dependent lookups: the kernel on
    a CUDA table, the plain loop on a CPU one.  ``table`` is uint8 (rows,
    32) in the row mode (at most 48 KB), uint8 (256,) in the byte mode."""
    dev = table.device
    if dev.type == "cpu":
        return (row_walk_ref if mode == "row" else byte_walk_ref)(
            table.numpy(), n)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    rows = table.shape[0]
    expect("table", table, torch.uint8,
           (rows, 32) if mode == "row" else (256,), dev)
    fn = load("chain_probe").smem_probe_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    out = torch.empty((32, 2), dtype=torch.int32, device=dev)
    err = fn(table.data_ptr(), rows, n, MODES[mode], out.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"smem_probe ({mode}) launch failed: CUDA error "
                           f"{err}")
    return out
