"""Dense-row accumulator parity (ops/dense_row.py)."""

import numpy as np
import pytest

from ia_spgemm_tpu.formats import convert
from ia_spgemm_tpu.formats.types import CSR, Dense
from ia_spgemm_tpu.ops import dense_row
from tests import fixtures


@pytest.mark.parametrize("name,m,k,n,da,db", [
    ("small", 16, 16, 16, 0.3, 0.3),
    ("rect", 24, 10, 32, 0.25, 0.4),
    ("tall", 40, 8, 8, 0.3, 0.5),
    ("uneven_tile", 13, 13, 13, 0.3, 0.3),  # m not divisible by tile_rows
])
def test_dense_row_matches_oracle(name, m, k, n, da, db):
    a = fixtures.random_csr(m, k, density=da, seed=70)
    b = fixtures.random_csr(k, n, density=db, seed=71)
    A = convert.csr_to_ell(CSR.from_scipy(a.astype(np.float32)),
                           check_guard=False)
    B = convert.csr_to_dense(CSR.from_scipy(b.astype(np.float32)))
    C = dense_row.spgemm_dense_row(A, B)
    np.testing.assert_allclose(np.asarray(C.values), (a @ b).toarray(),
                               rtol=1e-5, atol=1e-5)


def test_dense_row_empty_rows():
    import scipy.sparse as sp
    a = sp.csr_matrix((16, 16), dtype=np.float32)
    a[3, 5] = 2.0
    a = a.tocsr()
    A = convert.csr_to_ell(CSR.from_scipy(a), check_guard=False)
    B = Dense(values=np.eye(16, dtype=np.float32))
    C = dense_row.spgemm_dense_row(A, B)
    np.testing.assert_allclose(np.asarray(C.values), a.toarray(), atol=1e-6)


def test_dense_row_rejects_oversized_n():
    """B and the (m, n) accumulator past the dense budget raise instead
    of allocating."""
    from ia_spgemm_tpu import config as cfg
    a = fixtures.random_csr(8, 8, density=0.5, seed=72)
    A = convert.csr_to_ell(CSR.from_scipy(a.astype(np.float32)),
                           check_guard=False)
    B = Dense(values=np.zeros((8, 1024), np.float32))
    small = cfg.SpGEMMConfig(dense_bytes_budget=16 * 1024 * 4 - 1)
    with pytest.raises(ValueError, match="dense budget"):
        dense_row.spgemm_dense_row(A, B, config=small)
    # exactly at the budget it runs
    fits = cfg.SpGEMMConfig(dense_bytes_budget=16 * 1024 * 4)
    C = dense_row.spgemm_dense_row(A, B, config=fits)
    assert np.asarray(C.values).shape == (8, 1024)
