"""Slab-packed ESC engine (ops/slab.py): parity + viability gates."""

import numpy as np
import pytest
import scipy.sparse as sp

from ia_spgemm_tpu.formats.types import CSR
from ia_spgemm_tpu.ops import slab
from tests import fixtures


def _check(a, b, **kw):
    A = CSR.from_scipy(a.astype(np.float32))
    B = CSR.from_scipy(b.astype(np.float32))
    C = slab.spgemm_csr_slab(A, B, **kw)
    assert C is not None
    want = (a.astype(np.float64) @ b.astype(np.float64)).tocsr()
    want.sum_duplicates()
    want.eliminate_zeros()
    got = C.to_scipy().astype(np.float64)
    got.eliminate_zeros()
    d = abs(got - want)
    denom = max(1.0, abs(want).max())
    assert (d.max() if d.nnz else 0.0) / denom < 1e-5
    return C


def test_slab_random_square():
    a = fixtures.random_csr(200, 200, density=0.05, seed=7)
    _check(a, a)


def test_slab_rectangular_pair():
    rng = np.random.default_rng(11)
    a = sp.random(120, 90, density=0.08, random_state=rng,
                  format="csr")
    b = sp.random(90, 150, density=0.06, random_state=rng,
                  format="csr")
    _check(a, b)


def test_slab_empty_rows_and_cols():
    """Rows with no entries and entries pointing at empty B rows must
    pack/assemble correctly (zero-fragment entries, unpacked rows)."""
    rng = np.random.default_rng(3)
    a = sp.random(64, 64, density=0.05, random_state=rng,
                  format="csr").tolil()
    a[5] = 0
    a[31] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    b = a.copy().tolil()
    b[np.unique(a.tocoo().col)[:3]] = 0
    b = b.tocsr()
    b.eliminate_zeros()
    _check(a, b)


def test_slab_heavy_duplicates():
    """Many products collapsing to the same (i, j) — the in-slab
    compress must sum across fragment boundaries."""
    m = 16
    a = sp.csr_matrix(np.ones((m, m), np.float32) * 0.5)
    C = _check(a, a)
    assert int(np.asarray(C.nnz)) == m * m


def test_slab_banded():
    a = fixtures.banded_csr(256, bandwidth=3, seed=9)
    _check(a, a)


def test_slab_multirow_per_slab_keys():
    """Short rows pack many-per-slab; local-row keys must keep them
    disjoint (a row's cols never leak into a neighbor)."""
    rng = np.random.default_rng(5)
    lens = rng.integers(1, 4, 300)
    rows = np.repeat(np.arange(300), lens)
    cols = rng.integers(0, 300, rows.shape[0])
    a = sp.coo_matrix((rng.standard_normal(rows.shape[0]),
                       (rows, cols)), shape=(300, 300)).tocsr()
    a.sum_duplicates()
    _check(a, a)


def test_slab_run_override():
    """An explicit slab width overrides the planner's choice."""
    a = fixtures.random_csr(100, 100, density=0.06, seed=13)
    C = _check(a, a, width=512)
    assert C.keys.shape[1] == 512


def test_slab_to_csr_converter():
    """slab_to_csr flattens the native SlabCSR to exact device CSR
    (row_ptr/col/val agree with scipy entry-for-entry)."""
    a = fixtures.random_csr(150, 150, density=0.05, seed=17)
    A = CSR.from_scipy(a.astype(np.float32))
    Cs = slab.spgemm_csr_slab(A, A)
    assert Cs is not None
    C = slab.slab_to_csr(Cs)
    want = (a.astype(np.float32) @ a.astype(np.float32)).tocsr()
    want.sum_duplicates()
    got = C.to_scipy()
    assert got.shape == want.shape
    d = abs(got.astype(np.float64) - want.astype(np.float64))
    assert (d.max() if d.nnz else 0.0) < 1e-5
    # row_ptr is exact, not just the reconstruction
    nnzc = int(np.asarray(C.nnz))
    assert nnzc == want.nnz
    assert np.asarray(C.row_ptr)[-1] == nnzc
    # the gather engine (default) is bit-identical to the scatter
    # formulation it replaced (empty slabs, tails and all)
    C2 = slab.slab_to_csr(Cs, engine="scatter")
    for f in ("row_ptr", "col_ind", "values"):
        assert np.array_equal(np.asarray(getattr(C, f)),
                              np.asarray(getattr(C2, f))), f


def test_slab_to_csr_gather_empty_rows_and_lo():
    """Gather compaction across empty leading/mid rows (stacked slab
    deltas) and with compensated lo lanes fused into the same pass."""
    m = 96
    rng = np.random.default_rng(3)
    lens = np.zeros(m, np.int64)
    lens[40:60] = rng.integers(1, 6, 20)   # rows 0-39 empty
    rows = np.repeat(np.arange(m), lens)
    cols = rng.integers(0, m, rows.shape[0])
    a = sp.coo_matrix((rng.standard_normal(rows.shape[0]),
                       (rows, cols)), shape=(m, m)).tocsr()
    a.sum_duplicates()
    A = CSR.from_scipy(a.astype(np.float32))
    Cs = slab.spgemm_csr_slab(A, A)
    assert Cs is not None
    C = slab.slab_to_csr(Cs)
    want = (a.astype(np.float32) @ a.astype(np.float32)).tocsr()
    want.sum_duplicates()
    got = C.to_scipy()
    d = abs(got.astype(np.float64) - want.astype(np.float64))
    assert (d.max() if d.nnz else 0.0) < 1e-5
    assert int(np.asarray(C.nnz)) == want.nnz
    # compensated output: lo lane rides the same gather
    call = slab.plan_slab_csr(A, A, dd=True)
    if call is not None:
        Cd = call()
        if getattr(Cd, "values_lo", None) is not None:
            flat = slab.slab_to_csr(Cd)
            ref = slab.slab_to_csr(Cd, engine="scatter")
            assert flat.values_lo is not None
            assert np.array_equal(np.asarray(flat.values_lo),
                                  np.asarray(ref.values_lo))
            assert np.array_equal(np.asarray(flat.values),
                                  np.asarray(ref.values))


def test_slab_hybrid_skewed():
    """Heavy rows past the slab width cap take the global-sort residual;
    light rows ride the slab engine; the disjoint-row composition is
    exact."""
    rng = np.random.default_rng(8)
    m = 256
    lens = np.where(rng.random(m) < 0.03, 60, rng.integers(1, 4, m))
    rows = np.repeat(np.arange(m), lens)
    cols = rng.integers(0, m, rows.shape[0])
    a = sp.coo_matrix((rng.standard_normal(rows.shape[0]),
                       (rows, cols)), shape=(m, m)).tocsr()
    a.sum_duplicates()
    # make B rows long enough that heavy-row padded products blow the cap
    b = (a + sp.diags(np.ones(m))).tocsr()
    A = CSR.from_scipy(a.astype(np.float32))
    B = CSR.from_scipy(b.astype(np.float32))
    call = slab.plan_slab_hybrid(A, B, max_width=128)
    assert call is not None
    C = call()
    assert call.n_heavy > 0
    want = (a.astype(np.float64) @ b.astype(np.float64)).tocsr()
    want.sum_duplicates()
    want.eliminate_zeros()
    got = C.to_scipy().astype(np.float64)
    got.eliminate_zeros()
    d = abs(got - want)
    assert (d.max() if d.nnz else 0.0) / max(1.0, abs(want).max()) < 1e-5
    assert int(np.asarray(C.nnz)) == want.nnz


def test_slab_f64_not_viable():
    a = fixtures.random_csr(32, 32, density=0.1, seed=1)
    A = CSR.from_scipy(a.astype(np.float64))
    assert slab.plan_slab_csr(A, A) is None


def test_slab_wide_row_not_viable():
    """A row whose products exceed the slab width cap routes back to the
    global-sort engine (plan returns None)."""
    m = 64
    rows = np.concatenate([np.zeros(m, np.int64), np.arange(m)])
    cols = np.concatenate([np.arange(m), np.zeros(m, np.int64)])
    a = sp.coo_matrix((np.ones(2 * m, np.float32), (rows, cols)),
                      shape=(m, m)).tocsr()
    a.sum_duplicates()
    # row 0 has ~m entries, each hitting a B row with >= m entries:
    # products >> SLAB_MAX_WIDTH
    big = sp.csr_matrix(np.ones((m, m), np.float32))
    A = CSR.from_scipy(a.astype(np.float32))
    Bb = CSR.from_scipy(big)
    assert slab.plan_slab_csr(A, Bb) is None


def test_slab_plan_is_fast_and_hostonly():
    """Planning is nnz-scaled host numpy: no per-candidate device
    probing."""
    import time
    a = fixtures.random_csr(2000, 2000, density=0.004, seed=21)
    A = CSR.from_scipy(a.astype(np.float32))
    slab.plan_slab_csr(A, A)  # warm compile-free path
    t0 = time.perf_counter()
    call = slab.plan_slab_csr(A, A)
    dt = time.perf_counter() - t0
    assert call is not None
    assert dt < 2.0


@pytest.mark.parametrize("kind", ["general_real", "symmetric_real"])
def test_slab_reference_fixture_kinds(tmp_path, kind):
    from ia_spgemm_tpu.io import mmio
    path = fixtures.mtx_file(tmp_path, kind)
    A = mmio.read_mtx_to_csr(path)
    a = A.to_scipy()
    _check(a, a)
