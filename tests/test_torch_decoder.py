"""media_tpu_torch's decoder against media_tpu's TpuDecoder: exact equality.

Streams come from the JAX package's EncoderSession (and, where the port can
encode them, from the port's own); every plane of every decoded picture must
equal the JAX TpuDecoder's, through both routes of the in-loop filter. The
JAX side is read from tests/golden_torch/ (the recipes below say what the
JAX package was asked; tests/jax_golden.py). Its uniform-QP streams were
decoded under MEDIA_TPU_DEBLOCK_KERNEL=pallas (its per-wave Pallas kernel in
interpret mode); the adaptive-QP stream needs, and so covers, the
wave-major route. The JAX package's host parsers and its decoder's refusals
run live. Everything is integer: tolerance 0. Sizes stay at 64x48 and below.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from jax_golden import Digest, Golden
from media_tpu.core.bitstream import BitReader as JBitReader
from media_tpu.pipeline import decoder_tpu as jdec
from media_tpu.pipeline import slice_coder as jsc
from media_tpu_torch.core import nal as tnal
from media_tpu_torch.core import syntax as tsyn
from media_tpu_torch.core.bitstream import BitReader
from media_tpu_torch.pipeline import decoder_tpu as tdec
from media_tpu_torch.pipeline import slice_coder as tsc
from media_tpu_torch.pipeline.codec import EncoderConfig, EncoderSession
from media_tpu_torch.pipeline.encoder import FrameEncoder
from media_tpu_torch.utils import yuv


def clip(w, h, n, seed=0):
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (h + 48, w + 48)).astype(np.float64)
    for _ in range(2):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) / 3
    out = []
    for t in range(n):
        y = big[2 * t : 2 * t + h, 3 * t : 3 * t + w].copy()
        y[10:22, 5 + 7 * t : 17 + 7 * t] = 235
        y = (y + rng.normal(0, 1.5, y.shape)).round().clip(0, 255).astype(
            np.uint8)
        out.append(yuv.pack_i420(y, (y[::2, ::2] // 2 + 40).astype(np.uint8),
                                 (y[::2, ::2] // 3 + 70).astype(np.uint8)))
    return out


STREAMS = {
    "64x48": dict(width=64, height=48),
    "64x48-nodeblock": dict(width=64, height=48, deblock=False),
    "64x48-2slices": dict(width=64, height=48, num_slices=2),
    "64x48-2slices-idc2": dict(width=64, height=48, num_slices=2,
                               deblock_across_slices=False),
    "44x30": dict(width=44, height=30),  # not a multiple of 16: 48x32 padded
    "48x32-nodeblock": dict(width=48, height=32, deblock=False),
    # Per-MB QP needs the rate controller; the bitrate makes qp_map vary.
    "64x48-adaptive-qp": dict(width=64, height=48, rc_mode="cbr",
                              bitrate=200_000, framerate=30,
                              adaptive_qp=True),
}


GOLDEN = Golden(__file__)


def frame_record(f) -> dict:
    return {"frame_num": f.frame_num, "idr": bool(f.idr),
            **{p: np.asarray(getattr(f, p)) for p in "yuv"}}


@GOLDEN.recipe(cases=list(STREAMS))
def jax_stream(name):
    """IDR + 3 P from the JAX EncoderSession and the JAX TpuDecoder's
    pictures of them (the per-wave Pallas deblock but for adaptive QP)."""
    from media_tpu.pipeline import codec as jcodec

    kw = STREAMS[name]
    with pytest.MonkeyPatch.context() as mp:
        if "adaptive" not in name:
            mp.setenv("MEDIA_TPU_DEBLOCK_KERNEL", "pallas")
        sess = jcodec.EncoderSession(jcodec.EncoderConfig(
            qp=28, gop_size=30, entropy_mode="host", **kw))
        aus = sess.encode_frames(clip(kw["width"], kw["height"], 4))
        frames = decode_all(jdec.TpuDecoder(), aus)
    return {"aus": aus, "frames": [frame_record(f) for f in frames]}


@functools.lru_cache(maxsize=None)
def port_stream(deblock=True, n=4):
    """IDR + P AUs and the final recon from the port's own encoder."""
    sess = EncoderSession(EncoderConfig(width=64, height=48, qp=28,
                                        gop_size=30, deblock=deblock,
                                        entropy_mode="host"), device="cpu")
    aus = sess.encode_frames(clip(64, 48, n))
    return tuple(aus), tuple(p.numpy() for p in sess.recon)


def decode_all(dec, aus):
    out = []
    for au in aus:
        out += dec.decode_annexb(au)
    return out


def assert_frames_equal(want, got, what):
    """want: frame_record()s of the JAX decoder's pictures."""
    assert len(want) == len(got) > 0
    for i, (a, b) in enumerate(zip(want, got)):
        assert (a["frame_num"], a["idr"]) == (b.frame_num, bool(b.idr))
        for p in "yuv":
            y = np.asarray(getattr(b, p))
            assert y.dtype == np.uint8
            np.testing.assert_array_equal(a[p], y, err_msg=f"{what} {i} {p}")


@pytest.mark.parametrize("name", list(STREAMS))
def test_decoder_matches_jax(name):
    jax = GOLDEN.read(jax_stream, name)
    aus, want = jax["aus"], jax["frames"]
    assert len(want) == 4
    dec = tdec.TpuDecoder(device="cpu")
    assert_frames_equal(want, decode_all(dec, aus), name)
    assert dec.frames[-1].y.shape == (
        dec.sps.pic_height_in_mbs * 16, dec.sps.pic_width_in_mbs * 16)
    wave = tdec.TpuDecoder(device="cpu", deblock_kernel="wave")
    if "adaptive" in name:
        # qp_map varies: the per-wave route takes uniform QP only, as in
        # the JAX package.
        assert len(wave.decode_annexb(aus[0])) == 1
        with pytest.raises(tdec.UnsupportedStream, match="per-MB QP"):
            decode_all(wave, aus[1:])
    else:
        assert_frames_equal(want, decode_all(wave, aus), name + " wave")


@pytest.mark.parametrize("kernel", ["frame", "wave"])
@pytest.mark.parametrize("deblock", [True, False])
def test_port_roundtrip_equals_encoder_recon(deblock, kernel):
    aus, recon = port_stream(deblock)
    dec = tdec.TpuDecoder(device="cpu", deblock_kernel=kernel)
    frames = decode_all(dec, [b"".join(aus)])  # one buffer, several AUs
    assert [f.frame_num for f in frames] == [0, 1, 2, 3]
    assert [f.idr for f in frames] == [True, False, False, False]
    for got, want in zip((frames[-1].y, frames[-1].u, frames[-1].v), recon):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(dec.ref_planes, recon):
        np.testing.assert_array_equal(got.numpy(), want)


def test_profile_records_a_split_per_picture():
    aus, _ = port_stream()
    dec = tdec.TpuDecoder(device="cpu", profile=True)
    decode_all(dec, aus)
    assert [t["idr"] for t in dec.timings] == [True, False, False, False]
    assert all(t["parse_ms"] > 0 and t["device_ms"] > 0 for t in dec.timings)


def _slices(aus):
    """(rbsp, nal_type, nal_ref_idc, sps, pps) of every slice NAL."""
    sps = pps = None
    for nu in tnal.iter_nal_units(b"".join(aus)):
        if nu.nal_type == 7:
            sps = tsyn.SPS.parse(BitReader(nu.rbsp))
        elif nu.nal_type == 8:
            pps = tsyn.PPS.parse(BitReader(nu.rbsp))
        elif nu.nal_type in (1, 5):
            yield nu.rbsp, nu.nal_type, nu.nal_ref_idc, sps, pps


@pytest.mark.parametrize("partial", [False, True])
def test_parser_copies_match_originals(partial):
    """The port's host parsers against media_tpu's on the same slices (the
    pure-Python originals; both sides read through their own BitReader)."""
    aus, _ = port_stream()
    n_i = n_p = 0
    for rbsp, nal_type, ref_idc, sps, pps in _slices(aus):
        R, C = sps.pic_height_in_mbs, sps.pic_width_in_mbs
        readers = JBitReader(rbsp), BitReader(rbsp)
        for br in readers:
            hdr = tsyn.SliceHeader.parse(br, sps, pps, nal_type=nal_type,
                                         nal_ref_idc=ref_idc)
        qp = pps.pic_init_qp + hdr.slice_qp_delta
        if hdr.is_p:
            n_p += 1
            want = jdec.parse_pslice_symbols(readers[0], R, C, qp, partial)
            got = tdec.parse_pslice_symbols(readers[1], R, C, qp, partial)
            assert want.keys() == got.keys()
        else:
            n_i += 1
            want = dataclasses.asdict(
                jsc.parse_islice_mbs(readers[0], R, C, qp, partial))
            got = dataclasses.asdict(
                tsc.parse_islice_mbs(readers[1], R, C, qp, partial))
            # An I_16x16 stream: the I_4x4 fields are there and empty.
            assert not got["is_i4"].any() and not got["luma4_levels"].any()
        for k in want:
            np.testing.assert_array_equal(want[k], got[k], err_msg=k)
        assert got["covered"] == R * C
        assert readers[0].bit_position == readers[1].bit_position
    assert (n_i, n_p) == (1, 3)
    assert any(np.any(got[k]) for k in ("mv", "luma_levels"))


def sparse_case():
    """The first P slice of the port's stream as the sparse entries take
    it: (R, C, reference planes, symbols, QP, flat levels, their nonzero
    indices, a digest of all of them)."""
    aus, _ = port_stream()
    dec = tdec.TpuDecoder(device="cpu")
    dec.decode_annexb(aus[0])
    ref = dec.ref_planes
    rbsp, nal_type, ref_idc, sps, pps = list(_slices(aus))[1]
    R, C = sps.pic_height_in_mbs, sps.pic_width_in_mbs
    br = BitReader(rbsp)
    hdr = tsyn.SliceHeader.parse(br, sps, pps, nal_type=nal_type,
                                 nal_ref_idc=ref_idc)
    qp = pps.pic_init_qp + hdr.slice_qp_delta
    sym = tdec.parse_pslice_symbols(br, R, C, qp)
    n = R * C
    flat = np.concatenate([sym["luma_levels"].reshape(n, 256),
                           sym["cdc_levels"].reshape(n, 8),
                           sym["cac_levels"].reshape(n, 120)], axis=1).reshape(-1)
    nz = np.flatnonzero(flat)
    digest = Digest.of(np.concatenate(
        [flat, sym["mv"].ravel(), [qp]] + [p.numpy().ravel() for p in ref]))
    return R, C, ref, sym, qp, flat, nz, digest


@GOLDEN.recipe
def jax_sparse_recon():
    """The JAX package's sparse wrapper on sparse_case(), unfiltered. It
    takes fixed-size arrays padded with the drop index."""
    R, C, ref, sym, qp, flat, nz, digest = sparse_case()
    n = R * C
    cap = len(nz) + 5
    idx = np.full(cap, n * 384, np.int32)
    idx[: len(nz)] = nz
    vals = np.zeros(cap, np.int16)
    vals[: len(nz)] = flat[nz]
    want = jdec._recon_pframe_device_sparse(
        R, C, *(p.numpy() for p in ref), sym["mv"], (idx, vals), False,
        np.int32(qp))
    return {"input": digest, "planes": [np.asarray(a) for a in want]}


def test_sparse_level_upload_matches_dense_and_jax():
    """Small pictures take the dense path (their whole level space is under
    the sparse cap), so the sparse scatter is held here to the dense path
    and to the JAX package's sparse wrapper on the same symbols."""
    R, C, ref, sym, qp, flat, nz, digest = sparse_case()
    assert 0 < len(nz) < len(flat)
    T = torch.as_tensor
    idx_vals = (nz.astype(np.int32), flat[nz].astype(np.int16))
    for deblock in (True, False):
        dense = tdec._recon_pframe_body(
            R, C, *ref, T(sym["mv"]), T(sym["luma_levels"]),
            (T(sym["cdc_levels"]), T(sym["cac_levels"])), deblock, qp)
        sparse = tdec._recon_pframe_device_sparse(
            R, C, *ref, T(sym["mv"]), tuple(map(T, idx_vals)), deblock, qp)
        for a, b in zip(dense, sparse):
            assert torch.equal(a, b)
    jax = GOLDEN.read(jax_sparse_recon)
    assert jax["input"] == digest, "the port's stream is not the recorded one"
    for a, b in zip(jax["planes"], sparse):
        np.testing.assert_array_equal(a, b.numpy())


@GOLDEN.recipe
def jax_decode_handover():
    """The JAX decoder on the first half of the port's stream (per-wave
    Pallas deblock): its SPS and PPS as RBSP bytes and as fields, its
    reference planes, and its pictures of the second half."""
    import pytest

    from media_tpu.core.bitstream import BitWriter as JBitWriter

    aus, _ = port_stream()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MEDIA_TPU_DEBLOCK_KERNEL", "pallas")
        jd = jdec.TpuDecoder()
        decode_all(jd, aus[:2])
        rec = {"aus": list(aus),
               "ref": tuple(np.asarray(p) for p in jd.ref_planes),
               "sps": dataclasses.asdict(jd.sps),
               "pps": dataclasses.asdict(jd.pps), "rbsp": []}
        for ps in (jd.sps, jd.pps):
            bw = JBitWriter()
            ps.write(bw)
            bw.rbsp_trailing_bits()
            rec["rbsp"].append(bw.get_bytes())
        rec["frames"] = [frame_record(f) for f in decode_all(jd, aus[2:])]
    return rec


@pytest.mark.parametrize("as_bytes", [True, False])
def test_load_state_continues_a_jax_decode(as_bytes):
    """The JAX decoder decodes the first half of a stream; the port's takes
    over its SPS, PPS and reference planes and decodes the rest."""
    aus, _ = port_stream()
    jd = GOLDEN.read(jax_decode_handover)
    assert list(aus) == jd["aus"]
    if as_bytes:
        sets = jd["rbsp"]
    else:
        sets = [tsyn.SPS(**jd["sps"]), tsyn.PPS(**jd["pps"])]
    dec = tdec.TpuDecoder(device="cpu")
    dec.load_state(*sets, jd["ref"])
    assert_frames_equal(jd["frames"], decode_all(dec, aus[2:]), "continued")


INTRA_KWS = (dict(cabac=True), dict(cabac=True, i4x4=True), dict(i4x4=True))


@GOLDEN.recipe
def jax_intra_streams():
    """Per INTRA_KWS, the JAX session's IDR of a 48x32 picture and its
    recon."""
    from media_tpu.pipeline import codec as jcodec

    out = []
    for kw in INTRA_KWS:
        sess = jcodec.EncoderSession(jcodec.EncoderConfig(
            width=48, height=32, qp=28, gop_size=30, deblock=False,
            entropy_mode="host", **kw))
        au = sess.encode_frame(clip(48, 32, 1)[0])
        out.append({"au": au,
                    "recon": tuple(np.asarray(p) for p in sess.recon)})
    return out


def test_cabac_and_i4x4_streams_raise_naming_the_roadmap():
    """Nothing raises any more (the name is the test's old one): a CABAC
    stream of I_16x16 macroblocks and I_4x4 streams, CAVLC and CABAC, from
    the JAX session decode to the JAX session's recon, and the I_4x4 streams
    do hold I_4x4 macroblocks."""
    for kw, jax in zip(INTRA_KWS, GOLDEN.read(jax_intra_streams)):
        au = jax["au"]
        dec = tdec.TpuDecoder(device="cpu", host_parser="python")
        (frame,) = dec.decode_annexb(au)
        for got, want in zip((frame.y, frame.u, frame.v), jax["recon"]):
            np.testing.assert_array_equal(got, want)
        (again,) = tdec.TpuDecoder(device="cpu").decode_annexb(au)
        np.testing.assert_array_equal(again.y, frame.y)
        rbsp, nal_type, ref_idc, sps, pps = next(iter(_slices([au])))
        br = BitReader(rbsp)
        hdr = tsyn.SliceHeader.parse(br, sps, pps, nal_type=nal_type,
                                     nal_ref_idc=ref_idc)
        if not kw.get("cabac"):
            parsed = tsc.parse_islice_mbs(br, 2, 3, 28 + hdr.slice_qp_delta)
            assert parsed.is_i4.any() == bool(kw.get("i4x4"))


def test_truncated_and_garbage_input_give_clean_errors():
    """The error behaviour of the JAX TpuDecoder on the same bytes: garbage
    holds no NAL, a slice before the parameter sets is a ValueError, a
    truncated or headless slice an UnsupportedStream that resets the picture
    assembly, and the next intact stream decodes."""
    aus, recon = port_stream()
    for make, unsupported in ((jdec.TpuDecoder, jdec.UnsupportedStream),
                              (lambda: tdec.TpuDecoder(device="cpu"),
                               tdec.UnsupportedStream)):
        dec = make()
        assert dec.decode_annexb(b"") == []
        assert dec.decode_annexb(bytes(range(7, 250)) * 9) == []
        with pytest.raises(ValueError, match="slice before SPS/PPS"):
            dec.decode_annexb(aus[1])
        units = list(tnal.iter_nal_units(aus[0]))
        headers = aus[0][: units[-1].offset]
        dec.decode_annexb(headers)
        with pytest.raises(unsupported, match="without reference"):
            dec.decode_annexb(aus[1])
        with pytest.raises(unsupported):
            dec.decode_annexb(aus[0][: units[-1].offset + units[-1].size // 2])
        assert getattr(dec, "_asm", None) is None
        assert dec.frames == []
    # dec is the port's decoder here: it recovers on the intact stream.
    frames = decode_all(dec, aus)
    np.testing.assert_array_equal(frames[-1].y, recon[0])


def test_mv_beyond_the_window_raises(monkeypatch):
    aus, _ = port_stream()
    monkeypatch.setattr(tdec, "MV_RANGE", 0)
    dec = tdec.TpuDecoder(device="cpu")
    dec.decode_annexb(aus[0])
    with pytest.raises(tdec.UnsupportedStream, match="MV beyond"):
        decode_all(dec, aus[1:])


def test_entry_points_default_to_cuda_and_do_not_fall_back():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the defaults resolve")
    for make in (tdec.TpuDecoder,
                 lambda: EncoderSession(EncoderConfig(width=64, height=48)),
                 lambda: FrameEncoder(64, 48)):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    with pytest.raises(ValueError):
        tdec.TpuDecoder(device="cpu", deblock_kernel="pallas")
