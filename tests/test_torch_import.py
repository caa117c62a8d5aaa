"""The port imports torch and never jax nor anything of the JAX package
(tpu_ffv1), and never hides a missing GPU."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = ["tpu_ffv1_torch", "tpu_ffv1_torch.device",
           "tpu_ffv1_torch.kernels.build",
           "tpu_ffv1_torch.kernels.probes", "tpu_ffv1_torch.tpu.schedule",
           "tpu_ffv1_torch.tpu.residual", "tpu_ffv1_torch.tpu.rc_encode",
           "tpu_ffv1_torch.tpu.finalize", "tpu_ffv1_torch.tpu.rc_decode",
           "tpu_ffv1_torch.tpu.golomb_encode",
           "tpu_ffv1_torch.tpu.golomb_decode",
           "tpu_ffv1_torch.tpu.encoder", "tpu_ffv1_torch.tpu.decoder",
           "tpu_ffv1_torch.tpu.state", "tpu_ffv1_torch.tpu.rct_search",
           "tpu_ffv1_torch.tpu.pipeline", "tpu_ffv1_torch.tpu.sharding",
           "tpu_ffv1_torch.core.tables",
           "tpu_ffv1_torch.core.rac", "tpu_ffv1_torch.core.crc",
           "tpu_ffv1_torch.core.intmath", "tpu_ffv1_torch.codec.pixfmt",
           "tpu_ffv1_torch.codec.params", "tpu_ffv1_torch.codec.context",
           "tpu_ffv1_torch.codec.slice_codec",
           "tpu_ffv1_torch.codec.twopass",
           "tpu_ffv1_torch.bitstream.symbols",
           "tpu_ffv1_torch.bitstream.headers",
           "tpu_ffv1_torch.pframe", "tpu_ffv1_torch.pframe.codec",
           "tpu_ffv1_torch.pframe.motion", "tpu_ffv1_torch.pframe.tpu",
           "tpu_ffv1_torch.io.rawvideo", "tpu_ffv1_torch.io.y4m",
           "tpu_ffv1_torch.io.avi", "tpu_ffv1_torch.io.mkv",
           "tpu_ffv1_torch.io.nut", "tpu_ffv1_torch.swscale",
           "tpu_ffv1_torch.filtergraph", "tpu_ffv1_torch.cli",
           "tpu_ffv1_torch.cli.main", "tpu_ffv1_torch.cli.__main__",
           "tpu_ffv1_torch.cli.ffserver_conf", "tpu_ffv1_torch.cli.serve",
           "tpu_ffv1_torch.cli.play",
           "tpu_ffv1_torch.__main__"]


def _jax_modules_after(imports: str) -> str:
    """Run ``imports`` in a fresh interpreter; the jax modules and the
    JAX package's modules (tpu_ffv1, tpu_ffv1.*) it left in sys.modules,
    comma-separated."""
    code = ("import sys\n" + imports +
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m == 'tpu_ffv1' or m.startswith('tpu_ffv1.'))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return res.stdout.strip()


def test_port_never_imports_jax():
    bad = _jax_modules_after(
        f"for m in {MODULES!r}:\n"
        "    __import__(m)\n"
        "import tpu_ffv1_torch\n"
        "tpu_ffv1_torch.TorchFFV1Encoder, tpu_ffv1_torch.TorchFFV1Decoder\n"
        "tpu_ffv1_torch.TorchFFV1PEncoder, tpu_ffv1_torch.TorchFFV1PDecoder\n"
        "tpu_ffv1_torch.EncoderParams\n")
    assert bad == "", f"port pulled in jax / tpu_ffv1: {bad}"


def test_command_line_never_imports_jax():
    """``python -m tpu_ffv1_torch``, run to its end (a conversion-only
    call: raw frames in, y4m out, no codec), imports the port and nothing
    of jax or tpu_ffv1."""
    bad = _jax_modules_after(
        "import os, runpy, tempfile\n"
        "d = tempfile.mkdtemp()\n"
        "raw = os.path.join(d, 'in.yuv')\n"
        "open(raw, 'wb').write(bytes(range(24)) * 2)\n"
        "sys.argv = ['tpu_ffv1_torch', '-s', '4x4', '-i', raw,\n"
        "            os.path.join(d, 'out.y4m')]\n"
        "try:\n"
        "    runpy.run_module('tpu_ffv1_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n")
    assert bad == "", f"the command line pulled in jax / tpu_ffv1: {bad}"


def test_chip_smoke_never_imports_jax():
    """chip_smoke.py imports everything it uses at module level: the port
    and nothing else of this repo, never jax or tpu_ffv1."""
    bad = _jax_modules_after("import chip_smoke\n")
    assert bad == "", f"chip_smoke pulled in jax / tpu_ffv1: {bad}"


@pytest.mark.parametrize("tool", ["scan_variants", "warp_emu",
                                  "pframe_smoke", "twopass_smoke"])
def test_tools_never_import_jax(tool):
    """The port's tools (tools/: the kernel-variant comparison on the
    card, the host warp emulation) import the port and chip_smoke.py,
    never jax or tpu_ffv1."""
    bad = _jax_modules_after(f"sys.path.insert(0, 'tools')\n"
                             f"import {tool}\n")
    assert bad == "", f"tools/{tool} pulled in jax / tpu_ffv1: {bad}"


@pytest.mark.parametrize("cls", ["encoder", "decoder", "p_encoder",
                                 "p_decoder"])
def test_cuda_request_without_cuda_raises(cls):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here; nothing to refuse")
    from tpu_ffv1 import EncoderParams, FFV1Encoder
    from tpu_ffv1_torch import (TorchFFV1Decoder, TorchFFV1Encoder,
                                TorchFFV1PDecoder, TorchFFV1PEncoder)
    from tpu_ffv1_torch.device import resolve_device
    from tpu_ffv1_torch.pframe.codec import p_extradata
    params = EncoderParams(width=16, height=16, pix_fmt="yuv420p", level=3,
                           coder=2, gop_size=12)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        # the device defaults to "cuda"
        if cls == "encoder":
            TorchFFV1Encoder(params)
        elif cls == "decoder":
            TorchFFV1Decoder(16, 16, FFV1Encoder(params).extradata)
        elif cls == "p_encoder":
            TorchFFV1PEncoder(params, experimental=True)
        else:
            TorchFFV1PDecoder(16, 16,
                              p_extradata(FFV1Encoder(params).extradata))
