"""Shared cases of the two-pass tests (test_torch_twopass*.py): the
configurations of the matrix, each 4 frames at GOP 2 from a seed, and
both encoders' passes on them.  The host's pass 1 runs its spec engine
(the one that counts), its pass 2 the native engine; the port's run on
the CPU."""
import functools

from tpu_ffv1 import EncoderParams, FFV1Encoder
from tpu_ffv1_torch import EncoderParams as TorchEncoderParams
from tpu_ffv1_torch import TorchFFV1Encoder

from .util import synth_frames

N_FRAMES, GOP = 4, 2

# (id, EncoderParams fields): the two-pass matrix
CONFIGS = {
    "coder2": dict(pix_fmt="yuv420p", coder=2),
    "coder1_ctx1": dict(pix_fmt="yuv420p", coder=1, context_model=1),
    "default_table": dict(pix_fmt="yuv420p", coder=-2),
    "16bit": dict(pix_fmt="yuv444p16le", coder=2),
    "16bit_ctx1": dict(pix_fmt="yuv420p16le", coder=1, context_model=1),
    "bgr0": dict(pix_fmt="bgr0", coder=2),
    "nonuniform": dict(pix_fmt="yuv420p", coder=2, width=50),
    "v4": dict(pix_fmt="yuv420p", coder=2, level=4, strict=-2),
    "golomb": dict(pix_fmt="yuv420p", coder=0),
}


def config(name):
    """(EncoderParams fields, frames) of a configuration: 32x24 in 4
    slices (nonuniform: 50 wide, so its chroma slices differ)."""
    kw = dict(dict(width=32, height=24, level=3, slices=4, gop_size=GOP),
              **CONFIGS[name])
    return kw, synth_frames(kw["pix_fmt"], kw["width"], kw["height"],
                            N_FRAMES, seed=21)


def host_pass1(kw, frames):
    """(statistics text, packets) of the host's pass 1."""
    enc = FFV1Encoder(EncoderParams(**kw, pass1=True))
    pkts = [enc.encode_frame(f) for f in frames]
    return enc.get_stats(), pkts


@functools.lru_cache(maxsize=None)
def host_stats(name):
    """The host's pass-1 statistics text on a configuration's frames."""
    return host_pass1(*config(name))[0]


def port_pass1(kw, streams, depth=1, **enc_kw):
    """(a statistics text per stream, each stream's packets, extradata) of
    the port's pass 1 on ``streams`` (frames of each stream), ``depth``
    frames in flight."""
    enc = TorchFFV1Encoder(TorchEncoderParams(**kw, pass1=True),
                           batch=len(streams), device="cpu", **enc_kw)
    out = []
    for t in range(len(streams[0])):
        enc.submit_frames([s[t] for s in streams])
        if t + 1 >= depth:
            out.append(enc.collect_frames())
    out += [enc.collect_frames() for _ in range(depth - 1)]
    return ([enc.get_stats(b) for b in range(len(streams))],
            [list(p) for p in zip(*out)], enc.extradata)


def host_pass2(kw, frames, text):
    enc = FFV1Encoder(EncoderParams(**kw, stats_in=text), engine="native")
    assert enc.engine == "native"
    return enc.extradata, [enc.encode_frame(f) for f in frames]


def port_pass2(kw, frames, text, depth=1):
    enc = TorchFFV1Encoder(TorchEncoderParams(**kw, stats_in=text),
                           device="cpu")
    out = []
    for i, f in enumerate(frames):
        enc.submit_frames([f])
        if i + 1 >= depth:
            out.append(enc.collect_frames()[0])
    out += [enc.collect_frames()[0] for _ in range(depth - 1)]
    return enc.extradata, out




def check_two_pass(name):
    """Pass 1: the port's statistics text and packets equal the host's.
    Pass 2: its extradata and packets equal the host's, from that text
    (Golomb-Rice, whose pass 1 counts no decision, from the range
    coder's, coder2's, so that tuned states reach its extradata)."""
    kw, frames = config(name)
    text, pkts = host_pass1(kw, frames)
    texts, got, _extradata = port_pass1(kw, [frames])
    assert texts == [text]
    assert got == [pkts]
    if name == "golomb":
        text = host_stats("coder2")
    want = host_pass2(kw, frames, text)
    assert port_pass2(kw, frames, text) == want
    # the tuned states changed the stream (Golomb-Rice: its extradata)
    plain = FFV1Encoder(EncoderParams(**kw), engine="native")
    assert plain.extradata != want[0]
