"""Codec parameters, pixel formats and slice geometry: the port's own
copy of the parts of ``tpu_ffv1.codec`` it reaches."""
