"""The port's own copies of the host layers (tpu_ffv1_torch.core, .codec,
.bitstream) equal the JAX package's modules they were copied from:
tables, state-transition tables, CRC-32, resolved parameters, the global
header and the slice headers, byte for byte (exact: integer codec)."""
from .torch_cpu import plain_inference_mode  # noqa: F401
import io

import numpy as np
import pytest

from tpu_ffv1.bitstream import headers as jh
from tpu_ffv1.codec import context as jctx
from tpu_ffv1.codec import params as jp
from tpu_ffv1.codec import pixfmt as jpix
from tpu_ffv1.core import crc as jcrc
from tpu_ffv1.core import rac as jrac
from tpu_ffv1.core import tables as jT
from tpu_ffv1_torch.bitstream import headers as th
from tpu_ffv1_torch.codec import context as tctx
from tpu_ffv1_torch.codec import params as tp
from tpu_ffv1_torch.codec import pixfmt as tpix
from tpu_ffv1_torch.core import crc as tcrc
from tpu_ffv1_torch.core import rac as trac
from tpu_ffv1_torch.core import tables as tT

PIX = ["yuv420p", "yuv420p10le", "yuv444p16le", "gray16le"]


def test_tables_match():
    for bits in (8, 10, 16):
        assert np.array_equal(tT.default_quant_tables(bits),
                              jT.default_quant_tables(bits))
    assert tT.CONTEXT_COUNTS == jT.CONTEXT_COUNTS
    assert np.array_equal(tT.VER2_STATE, jT.VER2_STATE)
    for name in ("MAX_SLICES", "CONTEXT_SIZE", "MAX_QUANT_TABLES",
                 "AC_GOLOMB_RICE", "AC_RANGE_DEFAULT_TAB",
                 "AC_RANGE_CUSTOM_TAB", "AC_RANGE_DEFAULT_TAB_FORCE"):
        assert getattr(tT, name) == getattr(jT, name), name


def test_log2_run_matches():
    """The Golomb-Rice run-length table (ff_log2_run), as the JAX
    package's tables and its Golomb scan hold it."""
    from tpu_ffv1.tpu.golomb_scan import LOG2_RUN
    assert tT.LOG2_RUN.dtype == np.int32
    assert np.array_equal(tT.LOG2_RUN, jT.LOG2_RUN)
    assert np.array_equal(tT.LOG2_RUN, LOG2_RUN)


def test_state_tables_match():
    for a, b in zip(trac.build_rac_states(), jrac.build_rac_states()):
        assert np.array_equal(a, b)
    for a, b in zip(trac.default_state_tables(), jrac.default_state_tables()):
        assert np.array_equal(a, b)
    for a, b in zip(trac.custom_state_tables(tT.VER2_STATE),
                    jrac.custom_state_tables(jT.VER2_STATE)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n", [0, 1, 3, 64, 4099])
def test_crc32_matches(n):
    """The port's zlib form against the JAX package's table loop, from a
    zero and a running start."""
    data = np.random.RandomState(n).randint(0, 256, n).astype(np.uint8) \
        .tobytes()
    for start in (0, 0x1234ABCD):
        assert tcrc.crc32_ieee(data, start) == jcrc.crc32_ieee(data, start)
    # appending the little-endian CRC makes the whole buffer's CRC zero
    tail = tcrc.crc32_ieee(data).to_bytes(4, "little")
    assert tcrc.crc32_ieee(data + tail) == 0


def test_range_coders_match():
    """The encoders' bytes and provisional values, and the decoder's bits,
    on a random bit sequence under random states."""
    r = np.random.RandomState(5)
    bits = r.randint(0, 2, 3000)
    idx = r.randint(0, 32, 3000)
    outs = []
    for mod in (trac, jrac):
        enc = mod.RangeEncoder(*mod.custom_state_tables(jT.VER2_STATE))
        prov = mod.ProvisionalRangeEncoder()
        s1 = np.full(32, 128, np.uint8)
        s2 = s1.copy()
        for b, i in zip(bits, idx):
            enc.put_rac(s1, i, b)
            prov.put_rac(s2, i, b)
        data = enc.terminate()
        dec = mod.RangeDecoder(data, *mod.custom_state_tables(jT.VER2_STATE))
        s3 = np.full(32, 128, np.uint8)
        got = [dec.get_rac(s3, i) for i in idx]
        outs.append((data, prov.prov, prov.low, prov.range, got, dec.pos))
    assert outs[0] == outs[1]
    assert list(outs[0][4]) == list(bits)


@pytest.mark.parametrize("pix", PIX)
def test_resolve_and_extradata_match(pix):
    kw = dict(width=64, height=48, pix_fmt=pix, level=3, coder=2, slices=4)
    a, b = tp.resolve(tp.EncoderParams(**kw)), jp.resolve(jp.EncoderParams(**kw))
    for f in ("width", "height", "version", "micro_version", "ac",
              "colorspace", "bits_per_raw_sample", "chroma_planes",
              "chroma_h_shift", "chroma_v_shift", "transparency",
              "packed_at_lsb", "plane_count", "context_model",
              "context_counts", "quant_table_count", "num_h_slices",
              "num_v_slices", "ec", "intra", "gop_size", "sar"):
        assert getattr(a, f) == getattr(b, f), f
    assert np.array_equal(a.quant_tables, b.quant_tables)
    assert np.array_equal(a.state_transition, b.state_transition)
    assert a.fmt.name == b.fmt.name
    extra = th.write_extradata(a)
    assert extra == jh.write_extradata(b)
    # the port's classes also take the JAX package's EncoderParams
    assert th.write_extradata(tp.resolve(jp.EncoderParams(**kw))) == extra

    ga, gb = th.read_extra_header(extra), jh.read_extra_header(extra)
    for f in ("version", "micro_version", "ac", "colorspace",
              "bits_per_raw_sample", "chroma_planes", "chroma_h_shift",
              "chroma_v_shift", "transparency", "plane_count",
              "num_h_slices", "num_v_slices", "quant_table_count",
              "context_counts", "ec", "intra"):
        assert getattr(ga, f) == getattr(gb, f), f
    assert np.array_equal(ga.quant_tables, gb.quant_tables)
    assert np.array_equal(ga.state_transition, gb.state_transition)
    assert tpix.reconstruct_pix_fmt(
        ga.colorspace, ga.bits_per_raw_sample, ga.chroma_planes,
        ga.chroma_h_shift, ga.chroma_v_shift, ga.transparency) == \
        jpix.reconstruct_pix_fmt(
            gb.colorspace, gb.bits_per_raw_sample, gb.chroma_planes,
            gb.chroma_h_shift, gb.chroma_v_shift, gb.transparency)


@pytest.mark.parametrize("pix", ["yuv420p", "yuv444p16le"])
def test_slice_headers_round_trip(pix):
    """write_slice_header bytes and read_slice_header results, per slice,
    for the port's and the JAX package's modules."""
    kw = dict(width=64, height=48, pix_fmt=pix, level=3, coder=2, slices=6)
    rp = tp.resolve(tp.EncoderParams(**kw))
    grid = tctx.slice_grid(64, 48, rp.num_h_slices, rp.num_v_slices)
    assert [vars(g) for g in grid] == \
        [vars(g) for g in jctx.slice_grid(64, 48, rp.num_h_slices,
                                          rp.num_v_slices)]
    g = th.read_extra_header(th.write_extradata(rp))

    class Dec:
        width, height = 64, 48
        version, plane_count = g.version, g.plane_count
        num_h_slices, num_v_slices = g.num_h_slices, g.num_v_slices
        quant_table_count = g.quant_table_count

    for geom in grid:
        data = []
        for mod, hmod, cmod in ((trac, th, tctx), (jrac, jh, jctx)):
            enc = mod.RangeEncoder()
            hmod.write_slice_header(rp, cmod.SliceState(geom=geom), enc)
            data.append(enc.terminate())
        assert data[0] == data[1]
        read = []
        for mod, hmod, cmod in ((trac, th, tctx), (jrac, jh, jctx)):
            ss = cmod.SliceState(geom=cmod.SliceGeometry(0, 0, 0, 0, 0, 0))
            dec = mod.RangeDecoder(data[0])
            qidx, info = hmod.read_slice_header(Dec, ss, dec)
            read.append((qidx, info, vars(ss.geom), dec.pos, dec.low,
                         dec.range))
        assert read[0] == read[1]
        assert read[0][2] == {**vars(geom), "sx": 0, "sy": 0}


@pytest.mark.parametrize("pix,w,h", [
    ("yuv444p16le", 9, 3), ("yuv420p10le", 7, 4), ("yuv420p", 6, 2),
    ("gray16le", 5, 3), ("yuva420p10le", 6, 4),
    ("bgr0", 5, 3), ("bgra", 4, 2), ("gbrp14le", 6, 3)])
def test_pcm_slice_codec_matches(pix, w, h):
    """codec/slice_codec.py (the PCM retry's lines: encode_plane_pcm,
    encode_rgb_pcm) against the JAX package's slice codec in
    slice_coding_mode 1 (encode_plane, encode_rgb_frame): the same bytes
    for one PCM slice, its header included, at both context models."""
    from tpu_ffv1.codec import slice_codec as jsc
    from tpu_ffv1_torch.codec import slice_codec as tsc
    r = np.random.RandomState(w * h)
    for cm in (0, 1):
        kw = dict(width=w, height=h, pix_fmt=pix, level=4, strict=-2,
                  coder=2, context_model=cm)
        rp, jrp = tp.resolve(tp.EncoderParams(**kw)), \
            jp.resolve(jp.EncoderParams(**kw))
        fmt = jpix.get_pix_fmt(pix)
        geom = tctx.slice_grid(w, h, 1, 1)[0]
        bits = max(8, fmt.bits)
        if fmt.colorspace == 1 and fmt.bits <= 8:
            planes = r.randint(0, 256, (h, w, 4)).astype(np.uint8)
        elif fmt.colorspace == 1:
            planes = [r.randint(0, 1 << fmt.bits, (h, w)).astype(np.uint16)
                      for _ in range(3)]
        else:
            sub = fmt.chroma_h_shift
            dims = [(h, w)] + [(-(-h >> sub), -(-w >> sub))] * (
                2 * rp.chroma_planes) + [(h, w)] * rp.transparency
            planes = [r.randint(0, 1 << fmt.bits, d).astype(
                np.uint8 if fmt.bits <= 8 else np.uint16) for d in dims]
        # (plane, plane index) in the reference's order: luma, chroma, alpha
        idx = [0] + [1, 1] * rp.chroma_planes + [2] * rp.transparency
        out = []
        for rac, hmod, ss, params in (
                (trac, th, tctx.SliceState(geom=geom, slice_coding_mode=1),
                 rp),
                (jrac, jh, jctx.alloc_slice_state(jrp, geom), jrp)):
            ss.slice_coding_mode = 1
            enc = rac.RangeEncoder(*rac.custom_state_tables(jT.VER2_STATE))
            hmod.write_slice_header(params, ss, enc)
            if rac is trac and fmt.colorspace == 1:
                tsc.encode_rgb_pcm(enc, planes, bits, rp.transparency)
            elif rac is trac:
                for src in planes:
                    tsc.encode_plane_pcm(enc, src, bits, rp.packed_at_lsb)
            elif fmt.colorspace == 1:
                jsc.encode_rgb_frame(params, ss, (enc, None), planes, w, h)
            else:
                for src, k in zip(planes, idx):
                    ph, pw = src.shape
                    jsc.encode_plane(params, ss, (enc, None), src, pw, ph, k,
                                     bits)
            out.append(enc.terminate())
        assert out[0] == out[1], cm


def test_pframe_codec_matches():
    """The P stream's constants and extradata marker
    (tpu_ffv1_torch/pframe/codec.py), errors included."""
    from tpu_ffv1.pframe import codec as jcodec
    from tpu_ffv1_torch.pframe import codec as tcodec
    for name in ("BLOCK", "LAMBDA", "P_MAGIC", "P_FORMAT_VERSION"):
        assert getattr(tcodec, name) == getattr(jcodec, name)
    base = b"\x01\x02\x03"
    assert tcodec.p_extradata(base) == jcodec.p_extradata(base)
    assert tcodec.split_p_extradata(jcodec.p_extradata(base)) == base
    for bad in (base, base + b"FFV1P\x02", b""):
        with pytest.raises(ValueError) as want:
            jcodec.split_p_extradata(bad)
        with pytest.raises(ValueError) as got:
            tcodec.split_p_extradata(bad)
        assert str(got.value) == str(want.value)


# ------------------------------------------------- the command line's I/O

def _frame(pix_fmt, w, h, seed):
    """One frame of random samples in the format's storage convention."""
    from tpu_ffv1.io.rawvideo import frame_shape
    r = np.random.RandomState(seed)
    hi = 1 << jpix.get_pix_fmt(pix_fmt).bits
    return [r.randint(0, min(hi, 256) if dt == np.uint8 else hi,
                      shape).astype(dt)
            for shape, dt in frame_shape(pix_fmt, w, h)]


def _same_frames(a, b):
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        fa = fa if isinstance(fa, (list, tuple)) else [fa]
        fb = fb if isinstance(fb, (list, tuple)) else [fb]
        assert len(fa) == len(fb)
        for pa, pb in zip(fa, fb):
            pa, pb = np.asarray(pa), np.asarray(pb)
            assert pa.dtype == pb.dtype and np.array_equal(pa, pb)


@pytest.mark.parametrize("pix", ["yuv420p", "yuv422p10le", "gray16le",
                                 "ya8", "bgr0", "gbrp14le", "yuva444p"])
def test_rawvideo_and_y4m_match(pix, tmp_path):
    """io/rawvideo.py and io/y4m.py: plane shapes, frame sizes, the bytes
    each writes and the frames each reads back, against the JAX package's
    (y4m where it carries the format)."""
    from tpu_ffv1.io import rawvideo as jraw
    from tpu_ffv1.io import y4m as jy4m
    from tpu_ffv1_torch.io import rawvideo as traw
    from tpu_ffv1_torch.io import y4m as ty4m
    w, h = 13, 7
    frames = [_frame(pix, w, h, seed) for seed in range(3)]
    assert traw.frame_shape(pix, w, h) == jraw.frame_shape(pix, w, h)
    assert traw.frame_size_bytes(pix, w, h) == \
        jraw.frame_size_bytes(pix, w, h)
    pt, pj = tmp_path / "t.raw", tmp_path / "j.raw"
    traw.write_frames(str(pt), frames)
    jraw.write_frames(str(pj), frames)
    assert pt.read_bytes() == pj.read_bytes()
    _same_frames(traw.read_frames(str(pj), pix, w, h),
                 jraw.read_frames(str(pj), pix, w, h))
    if pix not in jy4m._WRITE_TAGS:
        with pytest.raises(ValueError) as want:
            jy4m.write_y4m(str(tmp_path / "j.y4m"), frames, pix, w, h)
        with pytest.raises(ValueError) as got:
            ty4m.write_y4m(str(tmp_path / "t.y4m"), frames, pix, w, h)
        assert str(got.value) == str(want.value)
        return
    yt, yj = tmp_path / "t.y4m", tmp_path / "j.y4m"
    ty4m.write_y4m(str(yt), frames, pix, w, h, fps=(30000, 1001))
    jy4m.write_y4m(str(yj), frames, pix, w, h, fps=(30000, 1001))
    assert yt.read_bytes() == yj.read_bytes()
    got, want = ty4m.read_y4m(str(yj)), jy4m.read_y4m(str(yj))
    assert got[1:] == want[1:]
    _same_frames(got[0], want[0])


class _Chunked:
    """A socket-like reader: at most ``n`` bytes a read."""

    def __init__(self, data, n):
        self.f, self.n = io.BytesIO(data), n

    def read(self, n):
        return self.f.read(min(n, self.n))


def _stream_read(mod, data, chunk):
    """Header and frames through ``mod``'s stream readers -> what each
    call gave, an exception as its type and message."""
    f = io.BytesIO(data) if chunk is None else _Chunked(data, chunk)
    out = []
    try:
        hdr = mod.read_y4m_stream_header(f)
        out.append(hdr)
        while hdr is not None:
            planes = mod.read_y4m_stream_frame(f, *hdr[:3])
            out.append(planes)
            if planes is None:
                break
    except ValueError as e:
        out.append((type(e), str(e)))
    return out


@pytest.mark.parametrize("pix", ["yuv420p", "yuv422p10le"])
@pytest.mark.parametrize("body", ["whole", "chunked", "truncated"])
def test_y4m_stream_readers_match(body, pix):
    """io/y4m.py's stream readers (the server's ingest): a whole body, one
    read 7 bytes at a time, and one cut mid-frame, against the JAX
    package's; and an empty body."""
    from tpu_ffv1.io import y4m as jy4m
    from tpu_ffv1_torch.io import y4m as ty4m
    w, h = 13, 7
    frames = [_frame(pix, w, h, seed) for seed in range(3)]
    buf = io.BytesIO()
    jy4m.write_y4m_stream(buf, frames, pix, w, h, (30000, 1001))
    data = buf.getvalue()
    if body == "truncated":
        data = data[:len(data) - 5]
    chunk = 7 if body == "chunked" else None
    got, want = _stream_read(ty4m, data, chunk), _stream_read(jy4m, data,
                                                              chunk)
    assert len(got) == len(want)
    assert got[0] == want[0] == (pix, w, h, (30000, 1001))
    for g, x in zip(got[1:], want[1:]):
        if isinstance(x, list):
            _same_frames([g], [x])
        else:
            assert g == x
    if body == "truncated":
        assert want[-1] == (ValueError, "truncated y4m frame")
        _same_frames(got[1:3], frames[:2])
    else:
        assert want[-1] is None
        _same_frames(got[1:4], frames)
    assert _stream_read(ty4m, b"", chunk) == [None]


@pytest.mark.parametrize("container", ["avi", "mkv", "nut"])
def test_containers_match(container, tmp_path):
    """io/avi.py, io/mkv.py and io/nut.py: the bytes each muxer writes for
    the same stream, and the stream each demuxer reads back."""
    import importlib
    jmod = importlib.import_module(f"tpu_ffv1.io.{container}")
    tmod = importlib.import_module(f"tpu_ffv1_torch.io.{container}")
    cls = {"avi": "AviStream", "mkv": "MkvStream", "nut": "NutStream"}
    r = np.random.RandomState(7)
    kw = dict(width=36, height=20, fps=(24000, 1001),
              extradata=r.randint(0, 256, 41).astype(np.uint8).tobytes(),
              packets=[r.randint(0, 256, n).astype(np.uint8).tobytes()
                       for n in (300, 17, 1, 4096, 65)],
              keyflags=[True, False, False, True, False])
    pt, pj = tmp_path / f"t.{container}", tmp_path / f"j.{container}"
    getattr(tmod, f"write_{container}")(
        str(pt), getattr(tmod, cls[container])(**kw))
    getattr(jmod, f"write_{container}")(
        str(pj), getattr(jmod, cls[container])(**kw))
    assert pt.read_bytes() == pj.read_bytes()
    got = vars(getattr(tmod, f"read_{container}")(str(pj)))
    assert got == vars(getattr(jmod, f"read_{container}")(str(pj)))
    assert got["packets"] == kw["packets"]


SWS_PAIRS = [("yuv420p", "yuv444p"), ("yuv444p", "yuv420p"),
             ("yuv422p", "yuv410p"), ("yuv420p", "yuv420p10le"),
             ("yuv420p10le", "yuv420p"), ("yuv444p16le", "yuv422p10le"),
             ("gray", "gray16le"), ("yuv420p", "gray"),
             ("gray", "yuv420p"), ("bgr0", "yuv420p"),
             ("yuv420p", "bgr0"), ("gbrp10le", "yuv444p"),
             ("yuva420p", "yuv420p")]


@pytest.mark.parametrize("src,dst", SWS_PAIRS,
                         ids=[f"{a}->{b}" for a, b in SWS_PAIRS])
def test_swscale_matches(src, dst):
    """swscale.py: convert and scale_convert (resize + convert in one
    pass) give the JAX package's samples exactly, or its error."""
    from tpu_ffv1 import swscale as jsws
    from tpu_ffv1_torch import swscale as tsws
    w, h = 22, 14
    frame = _frame(src, w, h, seed=len(src) + len(dst))
    if jpix.get_pix_fmt(src).interleaved:
        frame = frame[0]        # a packed frame is its one array
    for call in (lambda m: m.convert(frame, src, dst, w, h),
                 lambda m: m.scale_convert(frame, src, dst, w, h, 15, 9)):
        try:
            want = call(jsws)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                call(tsws)
            assert str(got.value) == str(e)
            continue
        _same_frames([call(tsws)], [want])


VF_CHAINS = [("null", "yuv420p", None), ("copy,null", "yuv422p", None),
             ("scale=24:16", "yuv420p", None),
             ("scale=24:-1", "yuv444p16le", "yuv420p"),
             ("format=yuv422p", "yuv420p", None),
             ("scale=20:12,format=yuv444p", "yuv420p10le", None),
             ("crop=20:14:4:2", "yuv420p", None),
             ("crop=w=16:h=10", "gray16le", None),
             ("hflip,vflip", "yuv422p10le", None),
             ("transpose=1", "yuv420p", None),
             ("transpose=3,scale=30:20", "yuv444p", "yuv420p"),
             ("trim=start_frame=1:end_frame=3", "bgr0", None)]


@pytest.mark.parametrize("chain,src,dst", VF_CHAINS,
                         ids=[c[0] for c in VF_CHAINS])
def test_filtergraph_matches(chain, src, dst):
    """filtergraph.py: the negotiated output format and size, and every
    frame a chain gives, against the JAX package's FilterGraph."""
    from tpu_ffv1 import filtergraph as jfg
    from tpu_ffv1_torch import filtergraph as tfg
    w, h = 40, 30
    frames = [_frame(src, w, h, seed) for seed in range(4)]
    gt = tfg.FilterGraph(chain, src, w, h, dst_fmt=dst)
    gj = jfg.FilterGraph(chain, src, w, h, dst_fmt=dst)
    assert (gt.out_fmt, gt.out_w, gt.out_h) == \
        (gj.out_fmt, gj.out_w, gj.out_h)
    _same_frames(gt.run(frames), gj.run(frames))
