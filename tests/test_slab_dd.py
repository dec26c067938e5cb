"""Compensated (double-double) slab engine: fp64-grade accumulation
through the slab pipeline — exact Dekker products, two-value-lane row
sort, two-sum compress."""

import numpy as np
import scipy.sparse as sp

from ia_spgemm_tpu.formats.types import CSR, SlabCSR
from ia_spgemm_tpu.ops import esc
from ia_spgemm_tpu.ops import slab as slab_mod


def _ill_conditioned(m=96, k=6, seed=11):
    """Rows of +/-big pairs with tiny residuals: plain f32 accumulation
    loses ~6 digits; the fp64 oracle on f32-rounded inputs is exact."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for r in range(m):
        ks = rng.choice(m, size=k, replace=False)
        big = rng.standard_normal() * 1e4
        for t, c in enumerate(ks):
            rows.append(r)
            cols.append(int(c))
            vals.append(big if t % 2 == 0
                        else -big + rng.standard_normal())
    a = sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsr()
    return a.astype(np.float32)


def test_slab_dd_matches_fp64_oracle():
    a32 = _ill_conditioned()
    want = (a32.astype(np.float64) @ a32.astype(np.float64)).tocsr()
    A = CSR.from_scipy(a32)
    call = slab_mod.plan_slab_csr(A, A, dd=True)
    assert call is not None
    C = call()
    assert isinstance(C, SlabCSR) and C.values_lo is not None
    got = C.to_scipy().tocsr()
    d = abs(got - want)
    scale = max(1.0, abs(want).max())
    assert (d.max() if d.nnz else 0.0) / scale < 1e-12


def test_slab_dd_flat_conversion_keeps_lo():
    a32 = _ill_conditioned(m=64, seed=3)
    want = (a32.astype(np.float64) @ a32.astype(np.float64)).tocsr()
    A = CSR.from_scipy(a32)
    C = slab_mod.plan_slab_csr(A, A, dd=True)()
    flat = slab_mod.slab_to_csr(C)
    assert isinstance(flat, CSR) and flat.values_lo is not None
    d = abs(flat.to_scipy().tocsr() - want)
    scale = max(1.0, abs(want).max())
    assert (d.max() if d.nnz else 0.0) / scale < 1e-12
    # checksum combines under two-sum on device
    assert abs(float(flat.checksum()) - want.sum()) \
        <= 1e-7 * max(1.0, abs(want).sum())


def test_compensated_auto_uses_slab_and_matches_global():
    a32 = _ill_conditioned(m=80, seed=7)
    A = CSR.from_scipy(a32)
    C_auto = esc.spgemm_csr_compensated(A, A)            # auto -> slab
    assert isinstance(C_auto, SlabCSR)
    C_glob = esc.spgemm_csr_compensated(A, A, engine="global")
    assert isinstance(C_glob, CSR)
    ga = C_auto.to_scipy().tocsr()
    gg = C_glob.to_scipy().tocsr()
    d = abs(ga - gg)
    assert (d.max() if d.nnz else 0.0) < 1e-9 * max(
        1.0, abs(gg).max())


def test_compensated_falls_back_when_slab_inviable():
    """A row whose products exceed the slab width cap: auto must still
    answer (global core), returning the CSR dd pair."""
    rng = np.random.default_rng(5)
    m = 256
    lens = rng.integers(1, 4, m)
    lens[:8] = 200   # rows hitting row 0..7's 200 entries: > 1024 products
    rows = np.repeat(np.arange(m), lens)
    cols = rng.integers(0, m, rows.shape[0])
    a = sp.coo_matrix(
        (rng.standard_normal(rows.shape[0]), (rows, cols)),
        shape=(m, m)).tocsr()
    a.sum_duplicates()
    a32 = a.astype(np.float32)
    A = CSR.from_scipy(a32)
    if slab_mod.plan_slab_csr(A, A, dd=True) is not None:
        # structure landed viable after dedup; not the case under test
        return
    C = esc.spgemm_csr_compensated(A, A)
    assert isinstance(C, CSR) and C.values_lo is not None
    want = (a32.astype(np.float64) @ a32.astype(np.float64)).tocsr()
    d = abs(C.to_scipy().tocsr() - want)
    assert (d.max() if d.nnz else 0.0) < 1e-12 * max(
        1.0, abs(want).max())
