"""``python -m tpu_ffv1_torch.cli`` entry point (ffmpeg.c:4302 main
analog)."""
from .main import run

if __name__ == "__main__":
    raise SystemExit(run())
