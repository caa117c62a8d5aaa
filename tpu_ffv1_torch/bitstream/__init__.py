"""Header and symbol bitstream layers: the port's own copy of the parts
of ``tpu_ffv1.bitstream`` it reaches."""
