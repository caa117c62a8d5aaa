"""The golden digests that chip_smoke.py holds the port's packets to
(tpu_ffv1_torch/goldens/chip_smoke.json) are the reference host C
encoder's: regenerated here from chip_smoke's seeded content generators
with tpu_ffv1.FFV1Encoder(engine="native") on the CPU, every packet of
every main path (2 streams x 8 frames of 1080p yuv420p and of 1080p
yuv444p16le at context model 0, of 1080p yuv420p at context model 1,
with Golomb-Rice, and of 1080p bgr0 at versions 3 and 4; 2 x 4 frames
of 960x540 yuv444p16le at context model 1 and at version 4 and of
960x540 gbrp14le), and compared with the committed file exactly (RGB
from the C encoder's RGB coder, ffv1n_encode_rgb; version 4's RCT
search from the host engine's choose_rct_params).  The v4_pcm phase's
digests (2 x 3 frames of 512x4 yuv444p16le at version 4, whose slices
retry as PCM) are TPUFFV1Encoder's on the CPU: the host encoder has no
PCM retry; so are the nonuniform_ext phase's (2 x 3 frames of 203x69
yuv444p16le at version 4 on a grid of four slice sizes).  The
non-uniform main paths (720p: 1280x720 yuv420p; ntsc10_ctx1: 720x486
yuv422p10le at context model 1; 2 x 8 frames each) are the host C
encoder's, as every main path's.  The FFV1-P paths' (pframe_720p:
1280x720 yuv420p, 2 x 8 frames, full search; pframe_720p_epzs: the same
content, 2 x 4 frames, the EPZS search; pframe_422p10_540p: 960x540
yuv422p10le, 2 x 4 frames) are the JAX package's host FFV1PEncoder's,
which the JAX package's device P encoder matches byte for byte
(tests/test_pframe_tpu.py).  The ya8 phase's (ya8, ya8_golomb: 2 x 3
frames of 1080p ya8 at GOP 2, range coder and Golomb-Rice) are the host
C encoder's, which codes ya8 as a luma and an alpha plane
(codec/encoder.py of the JAX package, engine="native").  The
compact-form paths
(8bit_compact, 8bit_ctx1_compact) have no digests of their own: the
host encoder on their content and configuration must give those of the
path they name (their packets are the raw form's, byte for byte).
The sharded phase's config5_4k digests are checked in
tests/test_torch_goldens_4k.py.  The twopass phase's: the host spec
encoder's pass-1 statistics texts and packets of its two small cuts
(2 x 2 frames of 256x144 yuv420p and of 128x72 yuv444p16le, 24
slices, coder 2), the host native find_best_state table of VER2_STATE
sorted by the 8-bit cut's stream-0 statistics, and the host native
encoder's pass-2 extradata and packets of the 8bit path's first 4
frames (2 streams) from those statistics.

To rewrite the file after a deliberate change of the content or the
configuration:  python tests/test_torch_goldens.py
"""
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tests.torch_cpu import plain_inference_mode  # noqa: E402,F401

import chip_smoke  # noqa: E402
from tpu_ffv1 import EncoderParams, FFV1Encoder, native  # noqa: E402
from tpu_ffv1.tpu.encoder import TPUFFV1Encoder  # noqa: E402


def golden_path(name):
    """Digests of one main path's packets under the host C encoder."""
    path = chip_smoke.PATHS[name]
    params = EncoderParams(**chip_smoke.params_kw(name))
    encs = [FFV1Encoder(params, engine="native")
            for _ in range(chip_smoke.BATCH)]
    assert all(e.engine == "native" for e in encs)
    packets = []
    for enc, frames in zip(encs, chip_smoke.path_streams(name)):
        packets.append([])
        for f in frames:
            pkt, key = enc.encode_frame(f)
            packets[-1].append(dict(chip_smoke.digest(pkt), key=bool(key)))
    return {"pix_fmt": path.pix_fmt, "width": path.width,
            "height": path.height, "context_model": path.context_model,
            "seed": path.seed, "frames": path.frames,
            "extradata": chip_smoke.digest(encs[0].extradata),
            "packets": packets}


def golden_pcm():
    """Digests of v4_pcm's packets under TPUFFV1Encoder (batch 2)."""
    enc = TPUFFV1Encoder(EncoderParams(**chip_smoke.pcm_kw()),
                         batch=chip_smoke.BATCH)
    streams = chip_smoke.synthetic_streams_pcm()
    packets = [[] for _ in streams]
    for t in range(chip_smoke.PCM_FRAMES):
        res = enc.encode_frames([s[t] for s in streams])
        for b, (pkt, key) in enumerate(res):
            packets[b].append(dict(chip_smoke.digest(pkt), key=bool(key)))
    return {"pix_fmt": "yuv444p16le", "width": chip_smoke.PCM_W,
            "height": chip_smoke.PCM_H, "seed": chip_smoke.PCM_SEED,
            "frames": chip_smoke.PCM_FRAMES,
            "extradata": chip_smoke.digest(enc.extradata),
            "packets": packets}


def golden_nonuniform():
    """Digests of nonuniform_ext's packets under TPUFFV1Encoder (batch 2):
    version 4 on a grid of four slice sizes, whose packets the JAX
    package's fused path gives as the host encoder does
    (test_torch_nonuniform.py)."""
    enc = TPUFFV1Encoder(EncoderParams(**chip_smoke.nonuniform_kw()),
                         batch=chip_smoke.BATCH)
    streams = chip_smoke.synthetic_streams_nonuniform()
    packets = [[] for _ in streams]
    for t in range(chip_smoke.NU_FRAMES):
        res = enc.encode_frames([s[t] for s in streams])
        for b, (pkt, key) in enumerate(res):
            packets[b].append(dict(chip_smoke.digest(pkt), key=bool(key)))
    return {"pix_fmt": "yuv444p16le", "width": chip_smoke.NU_W,
            "height": chip_smoke.NU_H, "seed": chip_smoke.NU_SEED,
            "frames": chip_smoke.NU_FRAMES,
            "extradata": chip_smoke.digest(enc.extradata),
            "packets": packets}


def golden_pframe(name):
    """Digests of a P path's packets under the host FFV1PEncoder, one
    encoder per stream."""
    from tpu_ffv1.pframe.codec import FFV1PEncoder
    path = chip_smoke.P_PATHS[name]
    params = EncoderParams(**chip_smoke.p_params_kw(name))
    encs = [FFV1PEncoder(params, experimental=True, me=path.me)
            for _ in range(chip_smoke.BATCH)]
    packets = []
    for enc, frames in zip(encs, chip_smoke.p_streams(name)):
        packets.append([])
        for f in frames:
            pkt, key = enc.encode_frame(f)
            packets[-1].append(dict(chip_smoke.digest(pkt), key=bool(key)))
    return {"pix_fmt": path.pix_fmt, "width": path.width,
            "height": path.height, "me": path.me, "seed": path.seed,
            "frames": path.frames,
            "extradata": chip_smoke.digest(encs[0].extradata),
            "packets": packets}


def golden_ya8(name):
    """Digests of a ya8 path's packets under the host C encoder, one
    encoder per stream."""
    params = EncoderParams(**chip_smoke.ya8_kw(name))
    encs = [FFV1Encoder(params, engine="native")
            for _ in range(chip_smoke.BATCH)]
    assert all(e.engine == "native" for e in encs)
    packets = []
    for enc, frames in zip(encs, chip_smoke.ya8_streams()):
        packets.append([])
        for f in frames:
            pkt, key = enc.encode_frame(f)
            packets[-1].append(dict(chip_smoke.digest(pkt), key=bool(key)))
    return {"pix_fmt": "ya8", "width": chip_smoke.W, "height": chip_smoke.H,
            "coder": chip_smoke.YA8[name][0], "seed": chip_smoke.YA8_SEED,
            "frames": chip_smoke.YA8_FRAMES,
            "extradata": chip_smoke.digest(encs[0].extradata),
            "packets": packets}


def golden_twopass():
    """Digests of the twopass phase: each small cut's pass-1 packets and
    statistics text per stream (the host spec encoder, the one that
    counts), the native find_best_state table of the table that the
    8-bit cut's stream-0 text sorts, and the native encoder's pass 2 of
    the 8bit path's first frames from that text."""
    from tpu_ffv1.codec.twopass import find_best_state, parse_stats, \
        sort_stt
    from tpu_ffv1.core import tables as JT
    out = {}
    for name in chip_smoke.TWOPASS_CUTS:
        params = EncoderParams(**chip_smoke.twopass_cut_kw(name),
                               pass1=True)
        texts, packets = [], []
        for frames in chip_smoke.twopass_cut_streams(name):
            enc = FFV1Encoder(params)
            assert enc.engine == "spec"
            packets.append([])
            for f in frames:
                pkt, key = enc.encode_frame(f)
                packets[-1].append(dict(chip_smoke.digest(pkt),
                                        key=bool(key)))
            texts.append(enc.get_stats())
        out[name] = {"stats": [chip_smoke.digest(t.encode()) for t in texts],
                     "packets": packets}
        if name == "8bit":
            stats_in = texts[0]
    stt = JT.VER2_STATE.copy()
    stt[0] = 0
    sort_stt(parse_stats(stats_in, 2, JT.CONTEXT_COUNTS)[0], stt)
    assert native.available(), \
        "the host C tier (native/) must build for find_best_state"
    out["find_best_state"] = chip_smoke.digest(find_best_state(stt)
                                               .tobytes())
    params = EncoderParams(**chip_smoke.params_kw("8bit"), stats_in=stats_in)
    encs = [FFV1Encoder(params, engine="native")
            for _ in range(chip_smoke.BATCH)]
    packets = []
    for enc, frames in zip(encs, chip_smoke.path_streams("8bit")):
        packets.append([])
        for f in frames[:chip_smoke.TWOPASS_FRAMES]:
            pkt, key = enc.encode_frame(f)
            packets[-1].append(dict(chip_smoke.digest(pkt), key=bool(key)))
    out["pass2"] = {"extradata": chip_smoke.digest(encs[0].extradata),
                    "packets": packets}
    return out


def test_twopass_goldens_match_host():
    assert golden_twopass() == chip_smoke.load_goldens()["twopass"]


@pytest.mark.parametrize("name", sorted(chip_smoke.YA8))
def test_ya8_goldens_match_host_c_encoder(name):
    assert native.available(), \
        "the host C encoder (native/) must build to check the goldens"
    assert golden_ya8(name) == chip_smoke.load_goldens()[name]


@pytest.mark.parametrize("name", sorted(chip_smoke.P_PATHS))
def test_pframe_goldens_match_host_p_encoder(name):
    assert golden_pframe(name) == chip_smoke.load_goldens()[name]


def test_pcm_goldens_match_jax_encoder():
    assert golden_pcm() == chip_smoke.load_goldens()["v4_pcm"]


def test_nonuniform_goldens_match_jax_encoder():
    assert golden_nonuniform() == \
        chip_smoke.load_goldens()["nonuniform_ext"]


@pytest.mark.parametrize("name", sorted(chip_smoke.PATHS))
def test_goldens_match_host_c_encoder(name):
    assert native.available(), \
        "the host C encoder (native/) must build to check the goldens"
    own = chip_smoke.PATHS[name].golden or name
    assert golden_path(name) == chip_smoke.load_goldens()[own]


if __name__ == "__main__":
    out = {name: golden_path(name) for name in sorted(chip_smoke.PATHS)
           if not chip_smoke.PATHS[name].golden}
    out["v4_pcm"] = golden_pcm()
    out["nonuniform_ext"] = golden_nonuniform()
    out.update((name, golden_pframe(name)) for name in chip_smoke.P_PATHS)
    out.update((name, golden_ya8(name)) for name in chip_smoke.YA8)
    out["twopass"] = golden_twopass()
    from test_torch_goldens_4k import golden_config5
    out["config5_4k"] = golden_config5()
    with open(chip_smoke.GOLDENS, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {chip_smoke.GOLDENS}")
