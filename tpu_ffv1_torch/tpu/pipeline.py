"""Frame pipelining: what the encoders and the decoder share to keep the
card busy while the host assembles, and the host busy while the card
codes.

A submit stages its host inputs in pinned memory, copies them to the
card on a side stream (the compute stream waits on that copy's event),
enqueues the frame's device work on the current stream, and starts the
copies of what the collect reads back into pinned memory on a second
side stream, recording one event after them.  Nothing in a submit waits
for the card.  A collect waits on its frame's event and works on the
host copies.  This is the CUDA form of the JAX package's worker pools
(``tpu_ffv1/tpu/encoder.py:835-847``, ``decoder.py:365-553``): CUDA
launches return at once, so no thread is needed.

Streams and the caching allocator: a tensor made on one stream and read
on another gets ``record_stream`` for the reader, so its memory is not
handed to later work before that reader is done.

On the CPU (the tests) the same calls run with no stream and no event:
an upload is a host tensor, a fetch keeps the tensor, and a collect only
pops.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class InFlight:
    """One submitted frame: ``host``, per name the copy on the host of a
    device output the collect reads (a pinned tensor on CUDA, the tensor
    itself on the CPU); ``event``, recorded after those copies (None on
    the CPU); ``meta``, what else the collect needs (device tensors it
    may read again, host state of the frame); ``slots``, the ring slots
    the host copies occupy until the collect releases them."""
    host: dict
    event: object
    meta: dict
    slots: list


class _Slot:
    """One pinned buffer of a ring; free when not held and its last
    copy's event (if any) has fired."""
    __slots__ = ("buf", "array", "event", "held")

    def __init__(self, shape, dtype):
        self.buf = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.array = self.buf.numpy()
        self.event = None
        self.held = False

    def free(self) -> bool:
        return not self.held and (self.event is None or self.event.query())


class PinnedRing:
    """Pinned host buffers of one shape and dtype, allocated once and
    reused.  ``depth + 1`` slots exist from the start; a slot is handed out
    again only when it is not held and the event of its last copy has
    fired, and when none is, a slot is added (a caller that keeps more
    frames in flight than ``depth`` grows the ring instead of waiting)."""

    def __init__(self, shape, dtype, depth: int):
        self.slots = [_Slot(shape, dtype) for _ in range(depth + 1)]
        self.shape, self.dtype = shape, dtype

    def take(self) -> _Slot:
        for slot in self.slots:
            if slot.free():
                slot.held = True
                return slot
        slot = _Slot(self.shape, self.dtype)
        slot.held = True
        self.slots.append(slot)
        return slot


def _torch_dtype(dtype):
    return torch.from_numpy(np.empty(0, dtype)).dtype


class FramePipeline:
    """The staging rings, the two copy streams and the frames in flight of
    one encoder or decoder on ``device``.  ``fetched_bytes`` counts the
    bytes ``fetch`` copies from the card to the host (on the CPU, those
    it would copy)."""

    def __init__(self, device: torch.device, depth: int = 2):
        self.device = device
        self.depth = depth
        self.cuda = device.type == "cuda"
        self.rings = {}
        self._staged = {}
        self.pending = collections.deque()
        self.fetched_bytes = 0
        if self.cuda:
            self.up = torch.cuda.Stream(device)
            self.down = torch.cuda.Stream(device)

    def _ring(self, shape, dtype) -> PinnedRing:
        key = (tuple(shape), dtype)
        if key not in self.rings:
            self.rings[key] = PinnedRing(tuple(shape), dtype, self.depth)
        return self.rings[key]

    # ------------------------------------------------------ host -> card

    def staging(self, shape, dtype) -> np.ndarray:
        """A host array for the caller to fill and hand to ``upload``: on
        CUDA a pinned slot, which the upload then copies from as it is."""
        if not self.cuda:
            return np.empty(shape, dtype)
        slot = self._ring(shape, _torch_dtype(dtype)).take()
        self._staged[id(slot.array)] = slot
        return slot.array

    def upload(self, stacks):
        """Device tensors of host arrays: each item of ``stacks`` is an
        array, or a list of arrays of one shape stacked along a new first
        axis (a plane of each stream).  On CUDA the arrays are written into
        pinned slots, copied on the upload stream, and the compute stream
        waits for the copies; nothing waits on the host."""
        arrays = [s if isinstance(s, np.ndarray) else None for s in stacks]
        if not self.cuda:
            return tuple(torch.from_numpy(
                np.ascontiguousarray(a) if a is not None else np.stack(s))
                for a, s in zip(arrays, stacks))
        compute = torch.cuda.current_stream(self.device)
        slots, outs = [], []
        for a, s in zip(arrays, stacks):
            if a is not None and id(a) in self._staged:
                slots.append(self._staged.pop(id(a)))
                continue
            first = a if a is not None else s[0]
            shape = first.shape if a is not None else (len(s),) + first.shape
            slot = self._ring(shape, _torch_dtype(first.dtype)).take()
            if a is not None:
                slot.array[...] = a
            else:
                for i, x in enumerate(s):
                    slot.array[i] = x
            slots.append(slot)
        with torch.cuda.stream(self.up):
            for slot in slots:
                d = torch.empty(slot.buf.shape, dtype=slot.buf.dtype,
                                device=self.device)
                d.copy_(slot.buf, non_blocking=True)
                outs.append(d)
            done = torch.cuda.Event()
            done.record(self.up)
        for slot in slots:
            slot.event, slot.held = done, False
        compute.wait_event(done)
        for d in outs:
            d.record_stream(compute)
        return tuple(outs)

    def put(self, array):
        """One host array on the device (``upload`` of one array)."""
        return self.upload([np.asarray(array)])[0]

    # ------------------------------------------------------ card -> host

    def fetch(self, tensors: dict, meta: dict, owned=()):
        """Start copying ``tensors`` (name -> device tensor) to the host
        after the work enqueued so far, and queue the frame; the copies of
        the names in ``owned`` go to fresh pinned tensors that the caller
        keeps (the decoder's output planes), the others to ring slots that
        the collect releases."""
        self.fetched_bytes += sum(t.numel() * t.element_size()
                                  for t in tensors.values())
        if not self.cuda:
            self.pending.append(InFlight(dict(tensors), None, meta, []))
            return
        compute = torch.cuda.current_stream(self.device)
        ready = torch.cuda.Event()
        ready.record(compute)
        self.down.wait_event(ready)
        host, slots = {}, []
        with torch.cuda.stream(self.down):
            for name, t in tensors.items():
                t.record_stream(self.down)
                if name in owned:
                    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                else:
                    slot = self._ring(t.shape, t.dtype).take()
                    slots.append(slot)
                    buf = slot.buf
                buf.copy_(t, non_blocking=True)
                host[name] = buf
            done = torch.cuda.Event()
            done.record(self.down)
        for slot in slots:
            slot.event = done
        self.pending.append(InFlight(host, done, meta, slots))

    def pop(self) -> InFlight:
        """The oldest frame in flight, its copies landed (the host waits on
        its event)."""
        if not self.pending:
            raise RuntimeError("no submit_frames() in flight")
        rec = self.pending.popleft()
        if rec.event is not None:
            rec.event.synchronize()
        return rec

    @staticmethod
    def host(rec: InFlight, name: str) -> np.ndarray:
        """The host copy of ``name`` as a numpy array (a view of a pinned
        buffer on CUDA: valid until ``release``)."""
        return rec.host[name].numpy()

    @staticmethod
    def release(rec: InFlight):
        """Give a collected frame's ring slots back."""
        for slot in rec.slots:
            slot.held = False
        rec.slots = []

    def drain(self):
        """Drop every frame in flight (a reset), after its copies land."""
        while self.pending:
            self.release(self.pop())
