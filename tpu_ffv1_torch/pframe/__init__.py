"""FFV1-P, the fork's motion-compensated inter codec, in PyTorch: the
port of ``tpu_ffv1.pframe`` (``motion.py``, ``tpu.py``) with its own
numpy-only copy of the constants and extradata marker of ``codec.py``."""
