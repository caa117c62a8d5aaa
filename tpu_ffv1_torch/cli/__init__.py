"""The port's command line: ``python -m tpu_ffv1_torch`` (cli/main.py)."""
