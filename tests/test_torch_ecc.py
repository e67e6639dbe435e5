"""The crossbar-level diagonal-parity ECC of §IV in the port
(repro_torch.core.ecc) against the JAX package (repro.core.ecc): every case
of tests/test_ecc.py, each run through both packages on the same numpy
blocks.  Parity tables, syndromes, corrected data, parity repairs, counters
and incremental updates must be identical (exact: bool and int results)."""
import numpy as np
import pytest
import torch

from repro_torch.core import ecc as TE

try:    # without JAX (as on a GPU machine) only the JAX-free cases run
    import jax.numpy as jnp
    from repro.core import ecc as JE
except ImportError:
    jnp = None

pytestmark = pytest.mark.skipif(jnp is None, reason="needs the JAX package")

CFGS = [(16, (1, -1, 2)), (15, (1, -1)), (8, (1, 2))]
NONCOPRIME = [(16, (1, 2, 4)), (8, (1, 2, 6))]


def _cfgs(m, slopes):
    return TE.EccConfig(m=m, slopes=slopes), JE.EccConfig(m=m, slopes=slopes)


def _data(seed, rows, cols):
    return np.random.default_rng(seed).random((rows, cols)) < 0.5


def _same_parity(tp, jp, slopes):
    assert sorted(tp) == sorted(jp) == sorted(slopes)
    for s in slopes:
        assert tp[s].dtype == torch.bool
        np.testing.assert_array_equal(tp[s].numpy(), np.asarray(jp[s]),
                                      err_msg=f"slope {s}")


def _both_correct(d, par_np, cfgs):
    """correct() in both packages on the same data and parity; holds data,
    parity and counters equal; returns the port's result."""
    tc, jc = cfgs
    tpar = {s: torch.from_numpy(v.copy()) for s, v in par_np.items()}
    jpar = {s: jnp.asarray(v) for s, v in par_np.items()}
    tf, tp2, ts = TE.correct(torch.from_numpy(d.copy()), tpar, tc)
    jf, jp2, js = JE.correct(jnp.asarray(d), jpar, jc)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    _same_parity(tp2, jp2, tc.slopes)
    assert {k: int(v) for k, v in ts.items()} == \
        {k: int(v) for k, v in js.items()}
    assert all(v.dtype == torch.int32 for v in ts.values())
    return tf, tp2, ts


def _encode_np(d, cfgs):
    """Both encodes on the same data, held equal; numpy parity tables."""
    tc, jc = cfgs
    tp = TE.encode(torch.from_numpy(d.copy()), tc)
    _same_parity(tp, JE.encode(jnp.asarray(d), jc), tc.slopes)
    return {s: v.numpy().copy() for s, v in tp.items()}


@pytest.mark.parametrize("m,slopes", CFGS, ids=lambda c: str(c))
def test_encode_verify_clean(m, slopes):
    cfgs = _cfgs(m, slopes)
    d = _data(0, m * 3, m * 2)
    par = _encode_np(d, cfgs)
    tv = TE.verify(torch.from_numpy(d), {s: torch.from_numpy(v)
                                         for s, v in par.items()}, cfgs[0])
    assert bool(tv) and bool(JE.verify(jnp.asarray(d), {
        s: jnp.asarray(v) for s, v in par.items()}, cfgs[1]))


@pytest.mark.parametrize("m,slopes", CFGS, ids=lambda c: str(c))
def test_syndrome_matches(m, slopes):
    cfgs = _cfgs(m, slopes)
    d = _data(1, m * 2, m * 3)
    par = _encode_np(d, cfgs)
    bad = d.copy()
    rng = np.random.default_rng(2)
    for r, c in zip(rng.integers(0, d.shape[0], 5),
                    rng.integers(0, d.shape[1], 5)):
        bad[r, c] = ~bad[r, c]
    ts = TE.syndrome(torch.from_numpy(bad), {s: torch.from_numpy(v)
                                             for s, v in par.items()},
                     cfgs[0])
    js = JE.syndrome(jnp.asarray(bad), {s: jnp.asarray(v)
                                        for s, v in par.items()}, cfgs[1])
    _same_parity(ts, js, slopes)
    assert not bool(TE.verify(torch.from_numpy(bad), {
        s: torch.from_numpy(v) for s, v in par.items()}, cfgs[0]))


@pytest.mark.parametrize("seed,r,c", [(0, 0, 0), (1, 47, 31), (7, 16, 15),
                                      (23, 5, 30), (50, 33, 2), (99, 20, 17)])
def test_single_error_corrected(seed, r, c):
    cfgs = _cfgs(*CFGS[0])
    d = _data(seed, 48, 32)
    par = _encode_np(d, cfgs)
    bad = d.copy()
    bad[r, c] = ~bad[r, c]
    fixed, _, stats = _both_correct(bad, par, cfgs)
    assert np.array_equal(fixed.numpy(), d)
    assert int(stats["corrected_data"]) == 1
    assert int(stats["uncorrectable"]) == 0


@pytest.mark.parametrize("seed,slope_i,bi,bj,k", [
    (0, 0, 0, 0, 0), (3, 1, 2, 1, 15), (8, 2, 1, 0, 7), (42, 1, 0, 1, 3),
    (77, 2, 2, 1, 12)])
def test_parity_bit_error_corrected(seed, slope_i, bi, bj, k):
    cfgs = _cfgs(*CFGS[0])
    d = _data(seed, 48, 32)
    par = _encode_np(d, cfgs)
    s = cfgs[0].slopes[slope_i]
    bad_par = {sl: v.copy() for sl, v in par.items()}
    bad_par[s][bi, bj, k] = ~bad_par[s][bi, bj, k]
    fixed, par2, stats = _both_correct(d, bad_par, cfgs)
    assert np.array_equal(fixed.numpy(), d)
    assert int(stats["corrected_parity"]) == 1
    assert all(np.array_equal(par2[sl].numpy(), par[sl])
               for sl in cfgs[0].slopes)


def test_double_error_in_block_flagged_uncorrectable():
    cfgs = _cfgs(*CFGS[0])
    d = _data(3, 32, 32)
    par = _encode_np(d, cfgs)
    bad = d.copy()
    bad[1, 2], bad[5, 9] = ~bad[1, 2], ~bad[5, 9]     # same 16x16 block
    _, _, stats = _both_correct(bad, par, cfgs)
    assert int(stats["uncorrectable"]) >= 1 or \
        int(stats["corrected_data"]) == 0


def test_errors_in_different_blocks_all_corrected():
    cfgs = _cfgs(*CFGS[0])
    d = _data(4, 32, 32)
    par = _encode_np(d, cfgs)
    bad = d.copy()
    bad[1, 2], bad[20, 25] = ~bad[1, 2], ~bad[20, 25]
    fixed, _, stats = _both_correct(bad, par, cfgs)
    assert np.array_equal(fixed.numpy(), d)
    assert int(stats["corrected_data"]) == 2


@pytest.mark.parametrize("m,slopes", CFGS + NONCOPRIME, ids=lambda c: str(c))
@pytest.mark.parametrize("n_data,n_par", [(40, 0), (0, 12), (60, 20)])
def test_correct_mixed_errors_matches(m, slopes, n_data, n_par):
    """Random data flips (singles, doubles, more per block) and check-bit
    flips over many blocks: every case of correct() at once."""
    cfgs = _cfgs(m, slopes)
    rng = np.random.default_rng(m * 100 + n_data + n_par)
    d = _data(m + n_data, m * 6, m * 5)
    par = _encode_np(d, cfgs)
    bad = d.copy()
    for r, c in zip(rng.integers(0, bad.shape[0], n_data),
                    rng.integers(0, bad.shape[1], n_data)):
        bad[r, c] = ~bad[r, c]
    bad_par = {s: v.copy() for s, v in par.items()}
    for _ in range(n_par):
        s = slopes[rng.integers(len(slopes))]
        i, j, k = (rng.integers(n) for n in bad_par[s].shape)
        bad_par[s][i, j, k] = ~bad_par[s][i, j, k]
    _both_correct(bad, bad_par, cfgs)


# --- the O(1) incremental updates -------------------------------------------

def _col_update(cfgs, d, new_col, col):
    tc, jc = cfgs
    par = _encode_np(d, cfgs)
    inc = TE.update_parity_col({s: torch.from_numpy(v) for s, v in
                                par.items()}, torch.from_numpy(d[:, col]),
                               torch.from_numpy(new_col), col, tc)
    jinc = JE.update_parity_col({s: jnp.asarray(v) for s, v in par.items()},
                                jnp.asarray(d[:, col]), jnp.asarray(new_col),
                                col, jc)
    _same_parity(inc, jinc, tc.slopes)
    d2 = d.copy()
    d2[:, col] = new_col
    _same_parity(inc, JE.encode(jnp.asarray(d2), jc), tc.slopes)
    # the given tables are not modified
    assert all(np.array_equal(v, _encode_np(d, cfgs)[s])
               for s, v in par.items())


def _row_update(cfgs, d, new_row, row):
    tc, jc = cfgs
    par = _encode_np(d, cfgs)
    inc = TE.update_parity_row({s: torch.from_numpy(v) for s, v in
                                par.items()}, torch.from_numpy(d[row]),
                               torch.from_numpy(new_row), row, tc)
    jinc = JE.update_parity_row({s: jnp.asarray(v) for s, v in par.items()},
                                jnp.asarray(d[row]), jnp.asarray(new_row),
                                row, jc)
    _same_parity(inc, jinc, tc.slopes)
    d2 = d.copy()
    d2[row] = new_row
    _same_parity(inc, JE.encode(jnp.asarray(d2), jc), tc.slopes)


@pytest.mark.parametrize("seed,col", [(0, 0), (5, 31), (11, 16), (30, 7),
                                      (49, 22)])
def test_incremental_column_update_matches_full_encode(seed, col):
    d = _data(seed, 48, 32)
    _col_update(_cfgs(*CFGS[0]), d, _data(seed + 1, 48, 1)[:, 0], col)


@pytest.mark.parametrize("seed,row", [(0, 0), (5, 47), (11, 16), (30, 9),
                                      (49, 33)])
def test_incremental_row_update_matches_full_encode(seed, row):
    d = _data(seed, 48, 32)
    _row_update(_cfgs(*CFGS[0]), d, _data(seed + 2, 1, 32)[0], row)


@pytest.mark.parametrize("m,slopes", NONCOPRIME, ids=lambda c: str(c))
@pytest.mark.parametrize("col", [0, 3, 7])
def test_incremental_column_update_noncoprime_slopes(m, slopes, col):
    d = _data(11, m * 3, m * 2)
    _col_update(_cfgs(m, slopes), d, _data(12 + col, m * 3, 1)[:, 0], col)


@pytest.mark.parametrize("m,slopes", NONCOPRIME, ids=lambda c: str(c))
@pytest.mark.parametrize("row", [0, 5, 11])
def test_incremental_row_update_noncoprime_slopes(m, slopes, row):
    d = _data(13, m * 3, m * 2)
    _row_update(_cfgs(m, slopes), d, _data(14 + row, 1, m * 2)[0], row)


def test_overhead():
    for m, slopes in CFGS + NONCOPRIME:
        tc, jc = _cfgs(m, slopes)
        assert TE.parity_overhead(tc) == JE.parity_overhead(jc)
    assert TE.parity_overhead(TE.EccConfig()) == pytest.approx(3 / 16)
    assert TE.parity_overhead(TE.EccConfig(m=15, slopes=(1, -1))) == \
        pytest.approx(2 / 15)


@pytest.mark.parametrize("m,slopes", [(16, (1, -1)), (8, (2, 4)),
                                      (12, (1, 3, 5))])
def test_no_locating_pair_rejected(m, slopes):
    for cls in (TE.EccConfig, JE.EccConfig):
        with pytest.raises(ValueError):
            cls(m=m, slopes=slopes)


def test_locating_pair_matches():
    for m, slopes in CFGS + NONCOPRIME + [(9, (2, -1, 1))]:
        tc, jc = _cfgs(m, slopes)
        assert tc.locating_pair() == jc.locating_pair()
        assert tc == TE.EccConfig(m=m, slopes=slopes)
