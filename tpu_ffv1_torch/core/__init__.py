"""Normative FFV1 core (tables, range coder, CRC, integer helpers): the
port's own copy of ``tpu_ffv1.core``, trimmed to what the port reaches."""
