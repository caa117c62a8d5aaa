"""Carry stream state across from the JAX package's classes.

The codec has no weights: its tables (quant tables, one/zero state
transitions, initial states) come from the normative tables
(``tpu_ffv1_torch.core``) and the extradata, as in the JAX classes.
What a running stream carries is its adaptive context states (the range
coder's, and on a Golomb-Rice stream its VLC states) and the picture
counter / keyframe gate.  These helpers install that state, taken as
numpy arrays from ``TPUFFV1Encoder`` / ``TPUFFV1Decoder``, into the
port's classes, so a GOP begun in JAX continues in the port with the
same bytes.
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


def _vlc_tensor(obj, vlc_states, total_cc):
    vs = np.asarray(vlc_states)
    want = (obj.L, total_cc, 4)
    if vs.shape != want or vs.dtype != np.int32:
        raise ValueError(f"vlc_states must be int32 {want}, got {vs.dtype} "
                         f"{vs.shape}")
    return torch.from_numpy(np.array(vs)).to(obj.device)


def encoder_state_from_numpy(enc, states, picture_number: int,
                             vlc_states=None):
    """Install ``TPUFFV1Encoder.states`` (uint8 (L, total_cc, 32)), its
    ``picture_number`` and, for a Golomb-Rice stream, its ``vlc_states``
    (int32 (L, total_cc, 4)) into a TorchFFV1Encoder of the same params
    and batch."""
    if enc.golomb != (vlc_states is not None):
        raise ValueError("vlc_states go with a Golomb-Rice encoder, and "
                         "only with one")
    enc.states = _states_tensor(enc, states, enc.total_cc)
    if vlc_states is not None:
        enc.vlc_states = _vlc_tensor(enc, vlc_states, enc.total_cc)
    enc.picture_number = int(picture_number)


def decoder_state_from_numpy(dec, states, key_frame_ok, vlc_states=None):
    """Install ``TPUFFV1Decoder.states`` (uint8 (L, total_cc, 32), or
    None before the first frame), its per-stream ``key_frame_ok`` and,
    for a Golomb-Rice stream, its ``vlc_states`` (int32 (L, total_cc, 4),
    or None before the first frame) into a TorchFFV1Decoder of the same
    stream and batch."""
    if len(key_frame_ok) != dec.batch:
        raise ValueError(f"key_frame_ok needs {dec.batch} entries")
    if vlc_states is not None and not dec.golomb:
        raise ValueError("vlc_states go with a Golomb-Rice stream")
    if states is None:
        dec.states = None
    else:
        dec.states = _states_tensor(dec, states, np.asarray(states).shape[1])
    # every lane's table at the installed width
    dec.lane_rows = None
    if dec.golomb:
        dec.vlc_states = None if vlc_states is None else \
            _vlc_tensor(dec, vlc_states, np.asarray(vlc_states).shape[1])
    dec.key_frame_ok = [bool(k) for k in key_frame_ok]
