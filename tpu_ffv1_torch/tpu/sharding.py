"""Slice lanes split over several devices: the port's multi-device layer.

Port of ``tpu_ffv1/tpu/sharding.py``.  FFV1 slices are independent
bitstreams, so a frame's (or a batch of frames') slice lanes split into
contiguous blocks, one per device, with no data exchanged between the
blocks: each device runs the lane scan (and the encoder's finalize) on its
own block, and the blocks' outputs come back to the lead device,
``devices[0]``, concatenated in lane order.  That is what the JAX package
does with ``shard_map`` over a one-axis mesh (in_specs split on the lane
axis, the state tables replicated, no collectives).

A device list names torch devices (``make_devices(n)``: the first n CUDA
devices).  It may name a device more than once: its blocks then run one
after another on that device, which is how the CPU tests split lanes
(``["cpu"] * n``, the counterpart of the JAX tests' virtual devices) and
how one card runs several lane groups.  Only an explicit list does that;
``make_devices`` never repeats a card.

The classes take ``devices=``: ``TorchFFV1Encoder`` and
``TorchFFV1PEncoder`` split the lane scan and finalize (range coder) or
the Golomb-Rice scan, ``TorchFFV1Decoder`` the planar range-coder scan
when a frame's lanes form one group.  Everything else (upload, stencil,
the P search and OBMC, the states between frames) stays on the lead
device.
"""
from __future__ import annotations

import contextlib

import torch

from ..device import resolve_device
from . import rc_decode, rc_encode
from .finalize import finalize_packed_full


def _device(d) -> torch.device:
    """``d`` as a torch.device with its index (a CUDA device without one
    is the current device); raises where CUDA is asked for and absent."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_devices(n: int) -> list:
    """The first ``n`` CUDA devices (the counterpart of ``make_mesh``);
    raises when fewer exist.  It never repeats a card or substitutes the
    CPU: pass such a list to the classes yourself."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise ValueError(
            f"need {n} CUDA devices, have {have}; to run {n} lane groups on "
            f"fewer cards name a card more than once (devices=['cuda:0'] * "
            f"{n}), or devices=['cpu'] * {n} for the plain versions")
    return [torch.device("cuda", k) for k in range(n)]


def resolve_devices(devices, device=None):
    """(device list or None, lead device) of a class's ``devices=`` and
    ``device=`` arguments: without a list the lead is ``device`` (default
    "cuda"); with one it is ``devices[0]``, and a ``device`` that names
    another device raises rather than pick one."""
    if devices is None:
        return None, resolve_device("cuda" if device is None else device)
    devs = [_device(d) for d in devices]
    if not devs:
        raise ValueError("devices= names no device")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"devices= mixes device types: {devs}")
    want = None if device is None else torch.device(device)
    if want is not None and (want.type != devs[0].type or (
            want.index is not None and want != devs[0])):
        raise ValueError(f"device={device!r} is not devices[0] ({devs[0]}); "
                         f"the lead device is devices[0]")
    return devs, devs[0]


def lane_blocks(L: int, ndev: int, what: str = "") -> list:
    """The contiguous lane blocks of ``L`` lanes over ``ndev`` devices, as
    slices; a lane count the device count does not divide raises, as the
    JAX package's does (sharding.py:137-139 there)."""
    if L % ndev:
        raise ValueError(f"lane count {L}{what} not divisible by mesh size "
                         f"{ndev}; pad with inactive lanes")
    k = L // ndev
    return [slice(i * k, (i + 1) * k) for i in range(ndev)]


def _on(dev):
    return torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()


def _gather(parts, lead, dim):
    """Block outputs -> one output on ``lead``: tensors concatenated along
    their lane dim ``dim`` (moved to the front for the copy, so a lane scan's
    (N, S, L) view of (L, N, S) storage keeps that storage), tuples item by
    item, None stays None."""
    if parts[0] is None:
        return None
    if isinstance(parts[0], tuple):
        return tuple(_gather(p, lead, dim) for p in zip(*parts))
    return torch.cat([p.movedim(dim, 0).to(lead, non_blocking=True)
                      for p in parts]).movedim(0, dim)


def shard_lanes(devices, fn, args, lane, dims=None):
    """``fn(*args)`` over contiguous lane blocks, one block per entry of
    ``devices`` (the port's ``shard_map``).  ``lane``: the positions of the
    lane-major arguments, split on dim 0; every other tensor argument is
    copied whole to each block's device (the replicated tables), anything
    else passed as it is.  Each block runs with its device current.
    ``dims``: per output of ``fn``, its lane dim (default 0; a tuple
    output's items share it).  Returns ``fn``'s outputs on ``devices[0]``,
    the blocks in lane order; one device runs ``fn`` on the arguments as
    they are, and ``devices`` None (no list given) with no device made
    current."""
    if devices is None:
        return fn(*args)
    devs = [_device(d) for d in devices]
    if len(devs) == 1:
        with _on(devs[0]):
            return fn(*args)
    lane = set(lane)
    blocks = lane_blocks(args[min(lane)].shape[0], len(devs))
    # every block's inputs first: a copy between cards runs on the source
    # card's stream, so a copy enqueued after the lead's own block would
    # wait for that block's scan, and the other cards with it
    inputs = [[a[sl].to(dev, non_blocking=True) if i in lane else
               a.to(dev, non_blocking=True) if isinstance(a, torch.Tensor)
               else a for i, a in enumerate(args)]
              for dev, sl in zip(devs, blocks)]
    outs = []
    for dev, block in zip(devs, inputs):
        with _on(dev):
            outs.append(fn(*block))
    dims = dims or (0,) * len(outs[0])
    return tuple(_gather(parts, devs[0], d)
                 for parts, d in zip(zip(*outs), dims))


def encode_lanes_sharded(devices, ctx, diff, active, states0, one_tab,
                         zero_tab, lows, ranges, prefixes, plens,
                         bits: int):
    """The production encode lane scan (K1 at bits <= 10, K1-ext at
    11..17; their plain versions on the CPU) and the full-width finalize
    over lane blocks on ``devices`` (sharding.py:144 of the JAX package).
    ctx/diff/active (L, N), states0 (L, CC, 32), lows/ranges (L,),
    prefixes (L, P), plens (L,) split on the lanes; the tables replicate.
    Returns (bytes uint8 (L, CAP), counts int32 (L,), states_out) on
    ``devices[0]``.  The JAX function's API; no class calls it: the
    encoders shard their own scan and finalize (``_scan_finalize``, with
    the 2-byte carry rows and the overflow redo, or the compact form)
    through ``shard_lanes``."""

    def local(ctx, diff, active, states0, one_tab, zero_tab, lows, ranges,
              prefixes, plens):
        packed, low, rng, states_out = rc_encode.rc_encode_packed(
            ctx, diff, active, states0, one_tab, zero_tab, lows, ranges,
            bits)
        out, counts = finalize_packed_full(packed, low, rng, prefixes,
                                           plens)
        return out, counts, states_out

    return shard_lanes(devices, local,
                       (ctx, diff, active, states0, one_tab, zero_tab, lows,
                        ranges, prefixes, plens),
                       lane=(0, 1, 2, 3, 6, 7, 8, 9))


def decode_lanes_sharded(devices, bufs, states, one_tab, zero_tab, qt,
                         low0, range0, pos0, specs, bits: int, five: bool):
    """``rc_decode_planes`` (K2 / K2-ext, their plain versions on the CPU)
    over lane blocks on ``devices`` (sharding.py:125 of the JAX package):
    bufs, states, low0, range0, pos0 split on the lanes, the tables
    replicated.  Returns what rc_decode_planes returns, on
    ``devices[0]``."""
    return shard_lanes(devices, rc_decode.rc_decode_planes,
                       (bufs, states, one_tab, zero_tab, qt, low0, range0,
                        pos0, specs, bits, five),
                       lane=(0, 1, 5, 6, 7))
