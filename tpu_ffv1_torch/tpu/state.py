"""Carry stream state across from the JAX package's classes.

The codec has no weights: its tables (quant tables, one/zero state
transitions, initial states) come from the normative tables
(``tpu_ffv1_torch.core``) and the extradata, as in the JAX classes.
What a running stream carries is its adaptive context states and the picture counter / keyframe gate.  These
helpers install that state, taken as numpy arrays from
``TPUFFV1Encoder`` / ``TPUFFV1Decoder``, into the port's classes, so a
GOP begun in JAX continues in the port with the same bytes.
"""
from __future__ import annotations

import numpy as np
import torch


def _states_tensor(obj, states, total_cc):
    st = np.asarray(states)
    want = (obj.L, total_cc, 32)
    if st.shape != want or st.dtype != np.uint8:
        raise ValueError(f"states must be uint8 {want}, got {st.dtype} "
                         f"{st.shape}")
    return torch.from_numpy(np.array(st)).to(obj.device)


def encoder_state_from_numpy(enc, states, picture_number: int):
    """Install ``TPUFFV1Encoder.states`` (uint8 (L, total_cc, 32)) and
    its ``picture_number`` into a TorchFFV1Encoder of the same params
    and batch."""
    enc.states = _states_tensor(enc, states, enc.total_cc)
    enc.picture_number = int(picture_number)


def decoder_state_from_numpy(dec, states, key_frame_ok):
    """Install ``TPUFFV1Decoder.states`` (uint8 (L, total_cc, 32), or
    None before the first frame) and its per-stream ``key_frame_ok``
    into a TorchFFV1Decoder of the same stream and batch."""
    if len(key_frame_ok) != dec.batch:
        raise ValueError(f"key_frame_ok needs {dec.batch} entries")
    if states is None:
        dec.states = None
    else:
        dec.states = _states_tensor(dec, states, np.asarray(states).shape[1])
    dec.key_frame_ok = [bool(k) for k in key_frame_ok]
