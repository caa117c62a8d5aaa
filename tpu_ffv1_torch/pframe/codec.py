"""What the device P codec reaches of ``tpu_ffv1/pframe/codec.py``: the
block size, the rate weight of the motion search and the P stream's
format marker, in plain Python.

The P stream is an experimental extension with no reference
counterpart, so its extradata carries its own version marker: the base
FFV1 extradata followed by ``P_MAGIC`` and one version byte.  Streams
without the marker, or with another P wire format, fail loudly instead
of decoding garbage.
"""
from __future__ import annotations

BLOCK = 16
LAMBDA = 16         # rate weight: SAD units per |mv delta| component

P_MAGIC = b"FFV1P"
P_FORMAT_VERSION = 3      # matches goldens/pframe_v3.sha256


def p_extradata(base_extradata: bytes) -> bytes:
    """Extradata for an FFV1-P stream: base FFV1 header + P marker."""
    return base_extradata + P_MAGIC + bytes([P_FORMAT_VERSION])


def split_p_extradata(extradata: bytes) -> bytes:
    """Validate + strip the P-format marker; returns the base FFV1
    extradata.  Raises ValueError on a missing marker (a plain-FFV1 or
    pre-marker P stream) or an unsupported P version."""
    if len(extradata) < len(P_MAGIC) + 1 or \
            extradata[-len(P_MAGIC) - 1:-1] != P_MAGIC:
        raise ValueError(
            "extradata carries no FFV1-P format marker (plain-FFV1 or "
            "pre-v3 P stream); P wire formats before the marker are "
            "not decodable by this version")
    ver = extradata[-1]
    if ver != P_FORMAT_VERSION:
        raise ValueError(f"unsupported FFV1-P format version {ver} "
                         f"(this build speaks v{P_FORMAT_VERSION})")
    return extradata[:-len(P_MAGIC) - 1]
