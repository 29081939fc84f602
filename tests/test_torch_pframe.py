"""media_tpu_torch P-frame core, on-device CAVLC packer and host slice
writers against media_tpu (JAX on the CPU): exact equality.

- local_pframe_core: the (R, C, 386) int16 symbols and the uint8 recon
  planes;
- pack_pslice_device: stream words and bit counts (including the overflow
  sentinel at a tight cap), and the bytes after merge_slice_data;
- the JAX-free copies of the I- and P-slice writers and of
  merge_slice_data: the same bytes as the originals.

The jitted JAX functions' results are read from tests/golden_torch/ (the
recipes say what they were asked; tests/jax_golden.py); the JAX package's
host writers and merge_slice_data run live.
"""

import numpy as np
import pytest
import torch

from jax_golden import Golden
from media_tpu.core.bitstream import BitWriter
from media_tpu.entropy import device_cavlc as jdc
from media_tpu.pipeline import slice_coder as jsc
from media_tpu_torch.entropy import device_cavlc as tdc
from media_tpu_torch.ops.pad import edge_pad
from media_tpu_torch.pipeline import pframe_core as tpc
from media_tpu_torch.pipeline import slice_coder as tsc

RS = 8
GOLDEN = Golden(__file__)


def moving_planes(R, C, seed):
    """A reference frame and a current frame displaced by a sub-pel pan."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (R * 16 + 40, C * 16 + 40)).astype(np.float64)
    for _ in range(2):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) / 3
    ref = big[8 : 8 + R * 16, 8 : 8 + C * 16]
    cur = 0.5 * (big[11 : 11 + R * 16, 6 : 6 + C * 16]
                 + big[12 : 12 + R * 16, 6 : 6 + C * 16])
    cur = cur + rng.normal(0, 2, cur.shape)
    out = []
    for p in (ref, cur):
        y = p.round().clip(0, 255).astype(np.uint8)
        out.append((y, (y[::2, ::2] // 2 + 40).astype(np.uint8),
                    (y[1::2, 1::2] // 3 + 70).astype(np.uint8)))
    return out


CORE_KEYS = ("symbols", "recon_y", "recon_u", "recon_v", "sad_total")


@GOLDEN.recipe(cases=[(30, 0), (22, 1)])
def jax_core(qp, seed):
    """The JAX package's jitted local_pframe_core on moving_planes() with
    edge-padded references at search range RS: its chroma QP, results and
    unpacked symbols."""
    import functools

    import jax
    import jax.numpy as jnp

    from media_tpu.pipeline import pframe_core as jpc

    @functools.partial(jax.jit, static_argnums=(8, 9, 10))
    def core(y, u, v, ry, ru, rv, qp, qp_c, rs, R, C):
        hy, hc = rs + jpc.INTERP_HALO, rs // 2 + 2
        ext = [jnp.pad(p.astype(jnp.int32), ((h, h), (0, 0)), mode="edge")
               for p, h in ((ry, hy), (ru, hc), (rv, hc))]
        return jpc.local_pframe_core(y.astype(jnp.int32), u.astype(jnp.int32),
                                     v.astype(jnp.int32), *ext, qp, qp_c, rs,
                                     R, C)

    qp_c = int(np.asarray(jpc.T.chroma_qp(qp)))
    (ry, ru, rv), (y, u, v) = moving_planes(3, 4, seed)
    out = core(y, u, v, ry, ru, rv, qp, qp_c, RS, 3, 4)
    out = {k: np.asarray(out[k]) for k in CORE_KEYS}
    return {"qp_c": qp_c, "out": out,
            "fields": dict(jpc.unpack_symbols(out["symbols"]))}


@pytest.mark.parametrize("qp,seed", [(30, 0), (22, 1)])
def test_local_pframe_core_matches_jax(qp, seed):
    R, C = 3, 4
    jax = GOLDEN.read(jax_core, qp, seed)
    qp_c, want = jax["qp_c"], jax["out"]
    assert qp_c == int(tpc.T.chroma_qp(qp))
    (ry, ru, rv), (y, u, v) = moving_planes(R, C, seed)
    hy, hc = RS + tpc.INTERP_HALO, RS // 2 + 2
    t = [torch.as_tensor(p).to(torch.int32) for p in (y, u, v, ry, ru, rv)]
    got = tpc.local_pframe_core(
        *t[:3], edge_pad(t[3], hy, hy, 0, 0), edge_pad(t[4], hc, hc, 0, 0),
        edge_pad(t[5], hc, hc, 0, 0), qp, qp_c, RS, R, C)
    assert got["symbols"].dtype == torch.int16
    for key in CORE_KEYS:
        np.testing.assert_array_equal(want[key], got[key].numpy(),
                                      err_msg=key)
    assert np.abs(want["symbols"][..., :2]).max() > 0  # real MVs
    fields = tpc.unpack_symbols(got["symbols"])
    for k, val in jax["fields"].items():
        np.testing.assert_array_equal(val, fields[k], err_msg=k)


def random_symbols(R, C, seed, density=6, big_levels=False):
    rng = np.random.default_rng(seed)
    hi = 2063 if big_levels else 8
    luma = (rng.integers(0, density, (R, C, 16, 16)) == 0) * rng.integers(
        -hi, hi + 1, (R, C, 16, 16))
    mv = rng.integers(-32, 33, (R, C, 2))
    zero = rng.random((R, C)) < 0.3  # zero MBs with zero MV: skip runs
    luma[zero] = 0
    mv[zero] = 0
    cdc = (rng.integers(0, 4, (R, C, 2, 4)) == 0) * rng.integers(
        -hi, hi + 1, (R, C, 2, 4))
    cac = (rng.integers(0, 8, (R, C, 2, 4, 15)) == 0) * rng.integers(
        -8, 9, (R, C, 2, 4, 15))
    cdc[zero] = 0
    cac[zero] = 0
    return tuple(a.astype(np.int32) for a in (mv, luma, cdc, cac))


def _host_bytes(write, **kw):
    bw = BitWriter()
    write(bw, **kw)
    bw.rbsp_trailing_bits()
    return bw.get_bytes()


PACK_CASES = [
    (0, (4, 6), 2048, False),
    (1, (5, 1), 2048, False),
    (2, (4, 6), 2048, True),   # 28-bit level escapes, dense blocks
    (3, (4, 6), 8, False),     # cap far below the stream: overflow sentinel
]


def pack_case(seed, shape, cap, big):
    """The symbols and the packer's ratio of a case."""
    sym = random_symbols(*shape, seed, density=2 if big else 6,
                         big_levels=big)
    return sym, 1.0 if big else 0.25


@GOLDEN.recipe(cases=PACK_CASES)
def jax_pack(seed, shape, cap, big):
    """The JAX package's jitted pack_pslice_device: (stream words, bits)."""
    import functools

    import jax
    import jax.numpy as jnp

    sym, ratio = pack_case(seed, shape, cap, big)
    pack = functools.partial(jax.jit, static_argnums=(4, 5))(
        lambda mv, luma, cdc, cac, cap, ratio:
        jdc.pack_pslice_device(mv, luma, cdc, cac, cap, ratio=ratio))
    stream, bits = pack(*map(jnp.asarray, sym), cap, ratio)
    return np.asarray(stream), int(bits)


@pytest.mark.parametrize("seed,shape,cap,big", PACK_CASES)
def test_pack_pslice_matches_jax(seed, shape, cap, big):
    sym, ratio = pack_case(seed, shape, cap, big)
    stream, bits = GOLDEN.read(jax_pack, seed, shape, cap, big)
    tstream, tbits = tdc.pack_pslice_device(*map(torch.as_tensor, sym), cap,
                                            ratio=ratio)
    assert int(bits) == int(tbits)
    if int(bits) > cap * 32:
        assert cap == 8  # only the tight cap may overflow
        return
    np.testing.assert_array_equal(stream, tstream.numpy().astype(np.uint32))
    bw = BitWriter()
    tdc.merge_slice_data(bw, tstream.numpy(), int(tbits))
    mv, luma, cdc, cac = sym
    kw = dict(mv=mv, luma_levels=luma, cdc_levels=cdc, cac_levels=cac)
    assert bw.get_bytes() == _host_bytes(jsc.write_pslice_mbs, **kw)
    assert bw.get_bytes() == _host_bytes(tsc.write_pslice_mbs, **kw)


def test_merge_slice_data_copy():
    rng = np.random.default_rng(4)
    words = rng.integers(0, 2 ** 32, (9,), dtype=np.uint64).astype(np.uint32)
    for head_bits in (0, 3, 8, 13):
        for total in (0, 7, 64, 200, 287):
            a, b = BitWriter(), BitWriter()
            for bw in (a, b):
                bw.u(head_bits, (1 << head_bits) - 1 if head_bits else 0)
            jdc.merge_slice_data(a, words, total)
            tdc.merge_slice_data(b, words, total)
            assert a.get_bytes() == b.get_bytes()


def test_islice_writer_copy():
    R, C = 3, 4
    rng = np.random.default_rng(7)

    def sparse(shape, hi):
        return ((rng.integers(0, 4, shape) == 0)
                * rng.integers(-hi, hi + 1, shape)).astype(np.int32)

    kw = dict(
        mode16=rng.integers(0, 4, (R, C)).astype(np.int32),
        chroma_mode=rng.integers(0, 4, (R, C)).astype(np.int32),
        dc_levels=sparse((R, C, 16), 3000),
        ac_levels=sparse((R, C, 16, 15), 9),
        cdc_levels=sparse((R, C, 2, 4), 40),
        cac_levels=sparse((R, C, 2, 4, 15), 5),
    )
    kw["ac_levels"][0, 1] = 0  # an MB without luma AC
    kw["cac_levels"][1, 2] = 0
    kw["cdc_levels"][1, 2] = 0  # an MB without chroma
    assert (_host_bytes(tsc.write_islice_mbs, **kw)
            == _host_bytes(jsc.write_islice_mbs, **kw))
