"""tpu_ffv1_torch — the FFV1 device tier in PyTorch with CUDA kernels.

A port of ``tpu_ffv1.tpu`` (JAX/Pallas) to PyTorch on NVIDIA Hopper.
The port keeps its own copies of the normative host layers it uses
(``core``, ``codec``, ``bitstream``: numpy-only, trimmed to what the
port reaches) and imports nothing of the JAX package, nor jax.

Covered so far: the planar range-coder path (version 3, context models 0
and 1, uniform slice grids) at every planar coded width, <= 10 bits through the
fast schedule and 11..16 bits through the extended one, encode and
decode, with GOP context carry-over; and FFV1-P, the fork's
motion-compensated inter codec (``TorchFFV1PEncoder``,
``TorchFFV1PDecoder``); README.md lists the rest.  The range-coder
scans run as hand-written CUDA kernels (``csrc/``) on CUDA tensors and
as their plain PyTorch versions on CPU tensors.

The classes load lazily so importing the package touches no device.
"""

__all__ = ["EncoderParams", "TorchFFV1Encoder", "TorchFFV1Decoder",
           "TorchFFV1PEncoder", "TorchFFV1PDecoder"]

_LAZY = {
    "EncoderParams": ("tpu_ffv1_torch.codec.params", "EncoderParams"),
    "TorchFFV1Encoder": ("tpu_ffv1_torch.tpu.encoder", "TorchFFV1Encoder"),
    "TorchFFV1Decoder": ("tpu_ffv1_torch.tpu.decoder", "TorchFFV1Decoder"),
    "TorchFFV1PEncoder": ("tpu_ffv1_torch.pframe.tpu", "TorchFFV1PEncoder"),
    "TorchFFV1PDecoder": ("tpu_ffv1_torch.pframe.tpu", "TorchFFV1PDecoder"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'tpu_ffv1_torch' has no attribute {name!r}")
