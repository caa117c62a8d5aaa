"""``python -m tpu_ffv1_torch``: the port's command line (cli/main.py)."""
from .cli.main import run

if __name__ == "__main__":
    raise SystemExit(run())
