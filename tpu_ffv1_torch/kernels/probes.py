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

``golomb_step`` (``csrc/golomb_probe.cu``) is the Golomb-Rice lane
scans' counterpart: one warp running one VLC-coded pixel's dependent
step (the VlcState row read, k, the code, the row's update and store,
and the bit packing of G1 or the bit-window read, residual and
prediction of G2) n times; ``golomb_step_ref`` is its plain loop.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..tpu.golomb_encode import update_vlc, vlc_k
from .build import expect, load

MODES = {"row": 0, "byte": 1}
GOLOMB_MODES = {"encode": 0, "decode": 1}
GOLOMB_RING = 512


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
    # the runtime launches on the current device: make it the tensors'
    with torch.cuda.device(dev):
        err = fn(table.data_ptr(), rows, n, MODES[mode], out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"smem_probe ({mode}) launch failed: CUDA error "
                           f"{err}")
    return out


def golomb_step_inputs(rows: int, mode: str, seed: int):
    """Inputs of the Golomb-Rice step probe: (vlc0 int32 (rows, 4) of valid
    VlcStates, pix int32 (32, 2), bytes uint8 (512,), qt int32 (256,)).
    ``pix`` holds per entry the context (below rows) and a residual, mostly
    small, one in 16 large enough to escape (encode), or T and the part of
    the context that does not depend on L (decode)."""
    r = np.random.RandomState(seed)
    count = r.randint(1, 129, rows)
    vlc0 = np.stack([-r.randint(0, count), np.minimum(
        count * r.randint(0, 40, rows), 0xFFFF), r.randint(-20, 21, rows),
        count], 1).astype(np.int32)
    if mode == "encode":
        res = np.where(r.rand(32) < 1 / 16, r.randint(-128, 128, 32),
                       r.randint(-6, 7, 32))
        pix = np.stack([r.randint(0, rows, 32), res], 1)
    else:
        pix = np.stack([r.randint(0, 256, 32),
                        r.randint(-rows // 2, rows // 2, 32)], 1)
    return (vlc0, pix.astype(np.int32),
            r.randint(0, 256, GOLOMB_RING).astype(np.uint8),
            r.randint(-40, 41, 256).astype(np.int32))


def golomb_step_ref(vlc0, pix, data, qt, n: int, mode: str) -> torch.Tensor:
    """Plain loop of the Golomb-Rice step probe (``golomb_step``): int32
    (4 + 4 * rows + 512,), the chain's state (encode: bytes written, the
    pending bits' count and value; decode: bit position, L, LT), the
    table and the ring."""
    tab = np.array(vlc0, np.int64)
    pix, qt = np.asarray(pix, np.int64), np.asarray(qt, np.int64)
    ring = np.zeros(GOLOMB_RING, np.int64) if mode == "encode" else \
        np.asarray(data, np.int64)
    bits, half = 8, 128
    s0 = s1 = s2 = 0                   # encode: bytes, nacc, acc
    for i in range(n):
        if mode == "encode":
            c, res = map(int, pix[i & 31])
        else:                          # decode: bit position, L, LT
            T, part = map(int, pix[i & 31])
            c = part + int(qt[(s1 - s2) & 0xFF])
            csign = c < 0
            c = min(abs(c), len(tab) - 1)
        drift, esum, bias, count = map(int, tab[c])
        k = int(vlc_k(torch.tensor([count]), torch.tensor([esum]))[0])
        if mode == "encode":
            sym = ((res - bias + half) & 255) - half
            code = ~sym if 2 * drift + count < 0 else sym
            code2 = 2 * code if code >= 0 else -2 * code - 1
            nb, val = (12 + bits, code2 - 11) if (code2 >> k) >= 12 else \
                ((code2 >> k) + k + 1, (1 << k) + (code2 & ((1 << k) - 1)))
            s2, s1 = (s2 << nb) | val, s1 + nb
            while s1 >= 8:
                s1 -= 8
                ring[s0 & (GOLOMB_RING - 1)] = (s2 >> s1) & 0xFF
                s0 += 1
            s2 &= (1 << s1) - 1
        else:
            b, w = s0 >> 3, 0
            for j in range(5):
                w = (w << 8) | int(ring[(b + j) & (GOLOMB_RING - 1)])
            w32 = (w >> (8 - (s0 & 7))) & 0xFFFFFFFF
            e = 32 - w32.bit_length()
            if e >= 12:
                v = ((w32 >> (20 - bits)) & 255) + 11
                s0 += 12 + bits
            else:
                nb = e + 1 + k
                v = (e << k) | ((w32 >> (32 - nb)) & ((1 << k) - 1))
                s0 += nb
            sym = (v >> 1) ^ -(v & 1)
            if 2 * drift + count < 0:
                sym = ~sym
            diff = ((sym + bias + half) & 255) - half
            if csign:
                diff = -diff
            L, LT = s1, s2
            m = L + T - LT
            pred = L + m + T - min(L, m, T) - max(L, m, T)
            s1, s2 = (pred + diff) & 255, T
        tab[c] = update_vlc(torch.from_numpy(tab[c:c + 1]),
                            torch.tensor([sym]))[0].numpy()
    return torch.from_numpy(np.concatenate(
        [[s0, s1, s2, 0], tab.ravel(), ring]).astype(np.int32))


def golomb_step(vlc0: torch.Tensor, pix: torch.Tensor, data: torch.Tensor,
                qt: torch.Tensor, n: int, mode: str) -> torch.Tensor:
    """Run the Golomb-Rice step probe of ``mode`` ("encode", G1's step;
    "decode", G2's) for n pixels: the kernel on CUDA tensors, the plain
    loop on CPU ones.  Inputs as ``golomb_step_inputs`` gives them."""
    dev = vlc0.device
    if dev.type == "cpu":
        return golomb_step_ref(vlc0.numpy(), pix.numpy(), data.numpy(),
                               qt.numpy(), n, mode)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    rows = vlc0.shape[0]
    expect("vlc0", vlc0, torch.int32, (rows, 4), dev)
    expect("pix", pix, torch.int32, (32, 2), dev)
    expect("bytes", data, torch.uint8, (GOLOMB_RING,), dev)
    expect("qt", qt, torch.int32, (256,), dev)
    if mode == "encode" and not bool(((pix[:, 0] >= 0) &
                                      (pix[:, 0] < rows)).all()):
        raise ValueError("golomb_step: contexts must lie in the table")
    fn = load("golomb_probe").golomb_step_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    out = torch.empty(4 + 4 * rows + GOLOMB_RING, dtype=torch.int32,
                      device=dev)
    # the runtime launches on the current device: make it the tensors'
    with torch.cuda.device(dev):
        err = fn(vlc0.data_ptr(), rows, pix.data_ptr(), data.data_ptr(),
                 qt.data_ptr(), n, GOLOMB_MODES[mode], out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"golomb_step ({mode}) launch failed: CUDA error "
                           f"{err}")
    return out
