"""The config5_4k golden digests that chip_smoke.py's sharded phase holds
the port's BASELINE config 5 packets to: regenerated here with the JAX
package's host FFV1PEncoder (me="epzs", experimental=True) on chip_smoke's
content (``config5_frames``, the 4K dry run's of __graft_entry__.py: a key
frame and a P frame of 3840x2160 yuv422p10le, 16 slices), and compared
with the committed file (tpu_ffv1_torch/goldens/chip_smoke.json) exactly.
The JAX package's device P encoder gives these bytes on a mesh
(DRYRUN_4K.json).  In a file of its own: the host encoder takes about 20
s for the two frames.

To rewrite the entry after a deliberate change of the content or the
configuration:  python tests/test_torch_goldens_4k.py
"""
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tests.torch_cpu import plain_inference_mode  # noqa: E402,F401

import chip_smoke  # noqa: E402
from tpu_ffv1 import EncoderParams  # noqa: E402
from tpu_ffv1.pframe.codec import FFV1PEncoder  # noqa: E402


def golden_config5():
    """Digests of config5_4k's two packets under the host FFV1PEncoder."""
    enc = FFV1PEncoder(EncoderParams(**chip_smoke.config5_kw()),
                       experimental=True, me=chip_smoke.C5_ME)
    packets = []
    for f in chip_smoke.config5_frames():
        pkt, key = enc.encode_frame(f)
        packets.append(dict(chip_smoke.digest(pkt), key=bool(key)))
    return {"pix_fmt": "yuv422p10le", "width": chip_smoke.C5_W,
            "height": chip_smoke.C5_H, "slices": chip_smoke.C5_SLICES,
            "me": chip_smoke.C5_ME, "frames": len(packets),
            "extradata": chip_smoke.digest(enc.extradata),
            "packets": [packets]}


def test_config5_goldens_match_host_p_encoder():
    assert golden_config5() == chip_smoke.load_goldens()["config5_4k"]


if __name__ == "__main__":
    goldens = chip_smoke.load_goldens()
    goldens["config5_4k"] = golden_config5()
    with open(chip_smoke.GOLDENS, "w") as f:
        json.dump(goldens, f, indent=1)
        f.write("\n")
    print(f"wrote config5_4k into {chip_smoke.GOLDENS}")
