"""Container and raw-frame I/O for the command line: the port's own copy
of ``tpu_ffv1.io``."""
