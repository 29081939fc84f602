"""media_tpu_torch deblocking against media_tpu: exact equality.

The plain version of the whole-frame wavefront (the CPU path of
deblock_frame) must equal the JAX wave-major scan in both QP modes and the
numpy raster oracle ref/deblock.py, working on uint8 planes in place; the
bS grids must equal the JAX ones. The CUDA kernel is held to the plain
version in tests/test_torch_cuda.py; what surrounds it is tested here: a
Python model of its schedule (MB by MB, rows advancing independently under
its progress rule, with its stores, its carried columns and the rows it
hands from one MB row to the next) must give the
plain version's planes in any order the rule allows, and other planes in an
order that breaks the rule by one MB. The JAX side is read from
tests/golden_torch/ (the recipes say what the JAX package was asked;
tests/jax_golden.py); the numpy oracle runs live. Everything is integer:
tolerance 0.
"""

import numpy as np
import pytest
import torch

from jax_golden import Golden
from media_tpu.ref.deblock import (
    deblock_frame_np, inter_bs_grids_np, intra_bs_grids_np)
from media_tpu_torch.ops import deblock as tdb
from media_tpu_torch.ops import deblock_wave as dw
from media_tpu_torch.ops.deblock_pallas import deblock_wave_step_plain
from media_tpu_torch.pipeline import deblock_apply as tda


# One wave per scan step: the same result as the default 8-wave unroll, and
# a much smaller program for XLA to compile.
GOLDEN = Golden(__file__, env={"MEDIA_TPU_DEBLOCK_UNROLL": "1"})


def jax_wavemajor(y, u, v, qp, qp_c, bs_v, bs_h, R, C, qp_map=None):
    """The JAX wave-major scan, jitted (QP traced): the planes out."""
    import jax

    from media_tpu.pipeline import deblock_apply as jda

    out = jax.jit(jda._deblock_frame_wavemajor, static_argnums=(7, 8))(
        y, u, v, qp, qp_c, bs_v, bs_h, R, C, qp_map=qp_map)
    return [np.asarray(p) for p in out]


def planes(R, C, seed, smooth):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 256, (R * s, C * s)).astype(np.int32)
           for s in (16, 8, 8)]
    if smooth:  # |p0-q0| < alpha, so most edges filter
        out = [(p // 8 + 100).astype(np.int32) for p in out]
    return out


def random_bs(R, C, seed):
    rng = np.random.default_rng(seed + 100)
    bs_v = rng.integers(0, 5, (R * 4, C * 4)).astype(np.int32)
    bs_h = rng.integers(0, 5, (R * 4, C * 4)).astype(np.int32)
    bs_v[:, 0] = 0
    bs_h[0, :] = 0
    return bs_v, bs_h


def torch_deblock(y, u, v, qp, qp_c, bs_v, bs_h, R, C, qp_map=None):
    T = torch.as_tensor
    out = tda.deblock_frame(T(y), T(u), T(v), qp, qp_c, T(bs_v), T(bs_h), R,
                            C, qp_map=None if qp_map is None else T(qp_map))
    assert all(p.dtype == torch.uint8 for p in out)
    return [p.numpy() for p in out]


WAVEMAJOR_CASES = [(qp, smooth, per_mb) for qp, smooth in
                   ((22, True), (30, True), (36, False))
                   for per_mb in (False, True)]


def wavemajor_case(qp, smooth, per_mb):
    """(planes, qp_c, bS grids, QP map or None) on 3x5 MBs."""
    R, C = 3, 5
    qp_map = None
    if per_mb:
        rng = np.random.default_rng(qp + 7)
        qp_map = np.clip(qp + rng.integers(-6, 7, (R, C)), 0, 51).astype(
            np.int32)
    return planes(R, C, qp, smooth), min(qp, 39), random_bs(R, C, qp), qp_map


@GOLDEN.recipe(cases=WAVEMAJOR_CASES)
def jax_wavemajor_case(qp, smooth, per_mb):
    (y, u, v), qp_c, (bs_v, bs_h), qp_map = wavemajor_case(qp, smooth, per_mb)
    return jax_wavemajor(y, u, v, qp, qp_c, bs_v, bs_h, 3, 5, qp_map=qp_map)


@pytest.mark.parametrize("per_mb", [False, True])
@pytest.mark.parametrize("qp,smooth", [(22, True), (30, True), (36, False)])
def test_plain_matches_jax_wavemajor(qp, smooth, per_mb):
    R, C = 3, 5
    (y, u, v), qp_c, (bs_v, bs_h), qp_map = wavemajor_case(qp, smooth, per_mb)
    want = GOLDEN.read(jax_wavemajor_case, qp, smooth, per_mb)
    got = torch_deblock(y, u, v, qp, qp_c, bs_v, bs_h, R, C, qp_map)
    for a, b, name in zip(want, got, "yuv"):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert any((b != p).any() for b, p in zip(got, (y, u, v)))


def inter_case():
    """Coded-block flags and MVs of 4x3 MBs."""
    rng = np.random.default_rng(1)
    nnz = rng.integers(0, 3, (4 * 4, 3 * 4)).astype(np.int32)
    mv = rng.integers(-9, 10, (4, 3, 2)).astype(np.int32)
    return nnz, mv


@GOLDEN.recipe(cases=[False, True])
def jax_bs_grids(inter):
    """The JAX package's bS grids of 4x3 MBs: inter on inter_case(), or
    intra."""
    from media_tpu.ops import deblock as jdb

    grids = (jdb.inter_bs_grids(*inter_case(), 4, 3) if inter
             else jdb.intra_bs_grids(4, 3))
    return [np.asarray(g) for g in grids]


@pytest.mark.parametrize("inter", [False, True])
def test_plain_matches_numpy_oracle(inter):
    R, C = 4, 3
    y, u, v = planes(R, C, 5, smooth=True)
    if inter:
        nnz, mv = inter_case()
        bs_v, bs_h = inter_bs_grids_np(nnz, mv)
        tv, th = tdb.inter_bs_grids(torch.as_tensor(nnz), torch.as_tensor(mv),
                                    R, C)
    else:
        bs_v, bs_h = intra_bs_grids_np(R, C)
        tv, th = tdb.intra_bs_grids(R, C)
    jv, jh = GOLDEN.read(jax_bs_grids, inter)
    for a, b, c in ((bs_v, tv, jv), (bs_h, th, jh)):
        np.testing.assert_array_equal(c, b.numpy())
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    want = deblock_frame_np(y, u, v, 30, 29, bs_v, bs_h)
    got = torch_deblock(y, u, v, 30, 29, bs_v, bs_h, R, C)
    for a, b, name in zip(want, got, "yuv"):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)


def deblock_entries_case():
    """uint8 planes and P symbols of 2x3 MBs."""
    R, C = 2, 3
    rng = np.random.default_rng(11)
    y, u, v = (p.astype(np.uint8) for p in planes(R, C, 11, smooth=True))
    sym = np.zeros((R, C, 386), np.int16)
    sym[..., :2] = rng.integers(-20, 21, (R, C, 2))
    sym[..., 2:258] = (rng.integers(0, 5, (R, C, 256)) == 0) * rng.integers(
        -3, 4, (R, C, 256))
    return (y, u, v), sym


@GOLDEN.recipe
def jax_deblock_entries():
    """The jitted JAX deblock_pframe_from_symbols (QP 30) and deblock_iframe
    (QP 36, a slice start at row 1) on deblock_entries_case()."""
    import jax

    from media_tpu.pipeline import deblock_apply as jda

    (y, u, v), sym = deblock_entries_case()
    pframe = jax.jit(jda.deblock_pframe_from_symbols,
                     static_argnums=(6, 7, 8))(y, u, v, sym, 30, 29, 2, 3, ())
    iframe = jax.jit(jda.deblock_iframe, static_argnums=(5, 6, 7))(
        y, u, v, 36, 34, 2, 3, (1,))
    return ([np.asarray(p) for p in pframe], [np.asarray(p) for p in iframe])


def test_pframe_and_iframe_drivers_match_jax():
    R, C = 2, 3
    (y, u, v), sym = deblock_entries_case()
    want_p, want_i = GOLDEN.read(jax_deblock_entries)
    T = torch.as_tensor
    got = tda.deblock_pframe_from_symbols(T(y), T(u), T(v), T(sym), 30, 29,
                                          R, C)
    for a, b in zip(want_p, got):
        np.testing.assert_array_equal(a, b.numpy())
    got = tda.deblock_iframe(T(y), T(u), T(v), 36, 34, R, C, slice_starts=(1,))
    for a, b in zip(want_i, got):
        np.testing.assert_array_equal(a, b.numpy())


def test_wave_schedule_covers_every_mb_once():
    R, C = 4, 7
    seen = []
    for k in range(dw.n_waves(R, C)):
        r, c = dw.wave_mbs(k, R, C, "cpu")
        assert ((2 * r + c) == k).all() and (c >= 0).all() and (c < C).all()
        seen += list(zip(r.tolist(), c.tolist()))
    assert sorted(seen) == [(r, c) for r in range(R) for c in range(C)]


def test_deblock_wave_rejects_bad_inputs():
    R, C = 1, 2
    y = torch.zeros((16, 32), dtype=torch.uint8)
    u = torch.zeros((8, 16), dtype=torch.uint8)
    meta = torch.zeros((2, dw.META_COLS), dtype=torch.int32)
    with pytest.raises(ValueError):
        dw.deblock_wave(y.int(), u, u.clone(), meta, R, C)
    with pytest.raises(ValueError):
        dw.deblock_wave(y, u, u.clone(), meta[:1], R, C)



class RowBlockModel:
    """The whole-frame kernel's dataflow, one MB step at a time: a block per
    MB row keeps the last 4 columns of its previous MB to itself, takes the
    last 4 (chroma: 2) sample rows above an MB from the mailbox of the row
    above, which that row fills instead of storing them, stores its own rows
    up to 4 columns short of the MB's right edge (the row's last MB: all of
    them) and the rows it took over, and hands its own last rows on."""

    SIZES = ((16, 4), (8, 2), (8, 2))  # per plane: MB size, rows handed on

    def __init__(self, planes, meta, R, C):
        self.planes = [p.clone() for p in planes]   # every sample: one writer
        self.pristine = [p.clone() for p in planes]
        self.mail = [[torch.zeros((h, s * C), dtype=torch.uint8)
                      for s, h in self.SIZES] for _ in range(R)]
        self.meta, self.R, self.C = meta, R, C
        self.done = [0] * R                         # finished MBs per row
        self.carry = [None] * R

    def ready(self, r, slack=0):
        """May row r filter its next MB? The progress rule, or the rule
        weakened by `slack` MBs."""
        c = self.done[r]
        if c >= self.C:
            return False
        return r == 0 or self.done[r - 1] >= min(c + 2 - slack, self.C)

    def step(self, r):
        c, C, last = self.done[r], self.C, r == self.R - 1
        patches = []
        for i, (p, (s, h)) in enumerate(zip(self.planes, self.SIZES)):
            own = p[s * r : s * r + s, s * c : s * c + s]
            # The prefetch may have read these long ago: nobody wrote them.
            assert torch.equal(
                own, self.pristine[i][s * r : s * r + s, s * c : s * c + s])
            patch = torch.zeros((1, s + 4, s + 4), dtype=torch.uint8)
            patch[0, 4:, 4:] = own
            if c > 0:
                patch[0, 4:, :4] = self.carry[r][i]
            if r > 0:
                patch[0, 4 - h : 4, 4:] = \
                    self.mail[r - 1][i][:, s * c : s * c + s]
            patches.append(patch)
        out = deblock_wave_step_plain(*patches, self.meta[r * C + c][None])
        carry = []
        for i, (p, o, (s, h)) in enumerate(zip(self.planes, out, self.SIZES)):
            lo = 0 if c > 0 else 4           # patch columns final in this row
            hi = s + 4 if c == C - 1 else s
            cols = slice(s * c - 4 + lo, s * c - 4 + hi)
            kept = s if last else s - h      # own rows this block stores
            p[s * r : s * r + kept, cols] = o[0, 4 : 4 + kept, lo:hi]
            if not last:
                self.mail[r][i][:, cols] = o[0, 4 + kept :, lo:hi]
            if r > 0:
                p[s * r - h : s * r, s * c : s * c + s] = o[0, 4 - h : 4, 4:]
            carry.append(o[0, 4:, s:].clone())
        self.carry[r] = carry
        self.done[r] = c + 1

    def run(self, rng, slack=0, eager_row=None):
        """Steps in a random order the rule allows; `eager_row` is taken
        whenever it is ready (with `slack`, the row that breaks the rule)."""
        while any(d < self.C for d in self.done):
            if eager_row is not None and self.ready(eager_row, slack):
                self.step(eager_row)
                continue
            rows = [r for r in range(self.R) if self.ready(r)]
            self.step(rows[rng.integers(len(rows))])
        return self.planes


def _model_case(R, C, seed, qp=30):
    y, u, v = planes(R, C, seed, smooth=True)
    bs_v, bs_h = random_bs(R, C, seed)
    T = torch.as_tensor
    meta = tda.build_meta(qp, min(qp, 39), T(bs_v), T(bs_h), R, C)
    return [T(p.astype(np.uint8)) for p in (y, u, v)], meta, (bs_v, bs_h)


@pytest.mark.parametrize("R,C", [(1, 1), (1, 5), (5, 1), (3, 5), (4, 7)])
@pytest.mark.parametrize("seed", range(3))
def test_row_block_schedule_matches_plain(R, C, seed):
    src, meta, _ = _model_case(R, C, seed)
    want = [p.clone() for p in src]
    dw.deblock_wave_plain(*want, meta, R, C)
    model = RowBlockModel(src, meta, R, C)
    got = model.run(np.random.default_rng(seed))
    for a, b, name in zip(want, got, "yuv"):
        assert torch.equal(a, b), name
    if R * C > 1:
        assert any(not torch.equal(a, p) for a, p in zip(want, src))


@GOLDEN.recipe
def jax_row_block_case():
    """The JAX wave-major scan on _model_case(3, 5, 30, 30)."""
    src, _meta, (bs_v, bs_h) = _model_case(3, 5, 30, 30)
    return jax_wavemajor(*(p.numpy().astype(np.int32) for p in src), 30,
                         30, bs_v, bs_h, 3, 5)


def test_row_block_schedule_matches_jax_wavemajor():
    R, C, qp = 3, 5, 30
    src, meta, (bs_v, bs_h) = _model_case(R, C, qp, qp)
    want = GOLDEN.read(jax_row_block_case)
    # Rows as far ahead of each other as the rule lets them: the last row
    # first whenever it may move.
    got = RowBlockModel(src, meta, R, C).run(np.random.default_rng(0),
                                             eager_row=R - 1)
    for a, b, name in zip(want, got, "yuv"):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


@pytest.mark.parametrize("seed", range(2))
def test_row_block_schedule_rule_is_tight(seed):
    """Row 1 running one MB earlier than the rule allows takes over columns
    of the rows above it that row 0 has not handed on yet."""
    R, C = 3, 6
    src, meta, _ = _model_case(R, C, seed)
    want = [p.clone() for p in src]
    dw.deblock_wave_plain(*want, meta, R, C)
    got = RowBlockModel(src, meta, R, C).run(np.random.default_rng(seed),
                                             slack=1, eager_row=1)
    assert any(not torch.equal(a, b) for a, b in zip(want, got))
