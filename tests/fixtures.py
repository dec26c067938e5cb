"""Deterministic fixture matrices mirroring the reference's Inputs/ suite
coverage: pattern/real/integer x general/symmetric x square/rectangular
(reference: IA-SPGEMM-CPU_release/Inputs/*.mtx, see SURVEY.md §4.3)."""

import io

import numpy as np
import scipy.sparse as sp


def random_csr(m, n, density=0.1, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    nnz = max(1, int(m * n * density))
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz).astype(dtype)
    a = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    a.sum_duplicates()
    return a


def banded_csr(m, bandwidth=3, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    diags = [rng.standard_normal(m).astype(dtype)
             for _ in range(2 * bandwidth + 1)]
    offsets = list(range(-bandwidth, bandwidth + 1))
    return sp.diags(diags, offsets, shape=(m, m)).tocsr()


def cancelling_csr(m, seed=42, per_row=6):
    """Badly conditioned rows: +big / -big + residual pairs, so f32 row
    sums of A @ A cancel catastrophically (the compensated lane's
    accuracy input)."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for r in range(m):
        ks = rng.choice(m, size=per_row, replace=False)
        big = rng.standard_normal() * 1e4
        for t, k_ in enumerate(ks):
            rows.append(r)
            cols.append(int(k_))
            vals.append(big if t % 2 == 0 else -big + rng.standard_normal())
    return sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsr()


def mtx_text(kind):
    """Tiny hand-written .mtx files covering the reference suite's axes."""
    if kind == "general_real":
        return """%%MatrixMarket matrix coordinate real general
% tiny general real
4 4 7
1 1 1.5
1 3 -2.0
2 2 3.25
3 1 0.5
3 4 4.0
4 2 -1.0
4 4 2.0
"""
    if kind == "symmetric_real":
        return """%%MatrixMarket matrix coordinate real symmetric
5 5 6
1 1 2.0
2 1 -1.0
3 2 0.5
4 4 3.0
5 3 1.25
5 5 -0.75
"""
    if kind == "pattern_general":
        return """%%MatrixMarket matrix coordinate pattern general
3 7 5
1 2
1 7
2 4
3 1
3 5
"""
    if kind == "integer_general":
        return """%%MatrixMarket matrix coordinate integer general
4 3 5
1 1 3
2 2 -4
3 3 7
4 1 2
4 3 -1
"""
    if kind == "rect_real":
        return """%%MatrixMarket matrix coordinate real general
6 4 6
1 1 1.0
2 2 2.0
3 3 3.0
4 4 4.0
5 1 5.0
6 2 6.0
"""
    if kind == "skew_symmetric":
        return """%%MatrixMarket matrix coordinate real skew-symmetric
4 4 3
2 1 1.0
3 2 -2.5
4 1 0.75
"""
    raise KeyError(kind)


ALL_KINDS = ["general_real", "symmetric_real", "pattern_general",
             "integer_general", "rect_real", "skew_symmetric"]


def mtx_file(tmp_path, kind):
    p = tmp_path / f"{kind}.mtx"
    p.write_text(mtx_text(kind))
    return str(p)


def scipy_oracle_from_text(kind):
    """Independent parse via scipy.io.mmread (our reader's oracle)."""
    import scipy.io
    return scipy.io.mmread(io.StringIO(mtx_text(kind))).tocsr()
