"""SpGEMM kernel parity vs the SciPy oracle (the role MKL plays in the
reference, main.cpp:709-765) across all formats, on synthetic fixtures and
the reference Inputs/ suite (C = A @ A, the reference's default workload,
README.md:10)."""

import numpy as np
import pytest
import scipy.sparse as sp

from ia_spgemm_tpu.formats import convert
from ia_spgemm_tpu.formats.types import CSR
from ia_spgemm_tpu.io import mmio
from ia_spgemm_tpu.ops import esc, dense, ell as ell_ops, dia as dia_ops, flops
from tests import fixtures
from tests.conftest import fp_tol
from tests.conftest import reference_input_paths


def _oracle(a, b):
    c = (a @ b).tocsr()
    c.sum_duplicates()
    c.sort_indices()
    # scipy keeps explicit zeros out; keep them for exact nnz comparison?
    # The reference's symbolic phase counts structural nnz (all touched
    # columns), so do NOT eliminate zeros from our result; compare values.
    return c


def _pairs():
    sq = fixtures.random_csr(30, 30, density=0.12, seed=10)
    band = fixtures.banded_csr(24, bandwidth=2, seed=11)
    rect_a = fixtures.random_csr(18, 25, density=0.15, seed=12)
    rect_b = fixtures.random_csr(25, 9, density=0.2, seed=13)
    empty = sp.csr_matrix((8, 8))
    one = fixtures.random_csr(1, 1, density=1.0, seed=14)
    return [
        ("square_AA", sq, sq),
        ("band_AA", band, band),
        ("rect_AB", rect_a, rect_b),
        ("empty", empty, empty),
        ("one", one, one),
        ("band_x_random", band, fixtures.random_csr(24, 24, 0.1, seed=15)),
    ]


def _assert_matches(ours_sp, want):
    got = ours_sp.tocsr()
    got.sum_duplicates()
    got.sort_indices()
    assert got.shape == want.shape
    d = abs(got - want)
    scale = max(1.0, abs(want).max() if want.nnz else 0.0)
    assert (d.max() if d.nnz else 0.0) < fp_tol() * scale


@pytest.mark.parametrize("name,a,b", _pairs())
def test_spgemm_csr(name, a, b):
    A, B = CSR.from_scipy(a), CSR.from_scipy(b)
    C = esc.spgemm_csr(A, B)
    want = _oracle(a, b)
    _assert_matches(C.to_scipy(), want)
    # structural nnz == oracle nnz (oracle keeps numerically-zero products?
    # scipy drops true zeros only via eliminate_zeros; matmul keeps
    # structural) — compare counts
    assert int(C.nnz) == want.nnz


@pytest.mark.parametrize("name,a,b", _pairs())
def test_spgemm_coo(name, a, b):
    A = convert.csr_to_coo(CSR.from_scipy(a))
    B = convert.csr_to_coo(CSR.from_scipy(b))
    C = esc.spgemm_coo(A, B)
    _assert_matches(C.to_scipy(), _oracle(a, b))


@pytest.mark.parametrize("name,a,b", _pairs())
def test_spgemm_ell(name, a, b):
    A = convert.csr_to_ell(CSR.from_scipy(a), check_guard=False)
    B = convert.csr_to_ell(CSR.from_scipy(b), check_guard=False)
    C = ell_ops.spgemm_ell(A, B)
    _assert_matches(C.to_scipy(), _oracle(a, b))


@pytest.mark.parametrize("name,a,b", _pairs())
def test_spgemm_dia(name, a, b):
    A = convert.csr_to_dia(CSR.from_scipy(a), check_guard=False)
    B = convert.csr_to_dia(CSR.from_scipy(b), check_guard=False)
    C = dia_ops.spgemm_dia(A, B)
    got = np.asarray(convert.csr_to_dense(
        CSR.from_scipy(C.to_scipy())).values)
    want = _oracle(a, b).toarray()
    np.testing.assert_allclose(got, want, rtol=fp_tol(), atol=fp_tol())


@pytest.mark.parametrize("name,a,b", _pairs())
def test_spgemm_dense(name, a, b):
    A, B = CSR.from_scipy(a), CSR.from_scipy(b)
    C = dense.spgemm_dense(A, B)
    np.testing.assert_allclose(np.asarray(C.values),
                               (a @ b).toarray(), rtol=fp_tol(),
                               atol=fp_tol())


@pytest.mark.parametrize("path", reference_input_paths())
def test_reference_inputs_A_squared(path):
    """C = A @ A on every reference fixture matrix (square ones) across all
    formats; rectangular ones use C = A @ A^T."""
    A = mmio.read_mtx_to_csr(path)
    a = A.to_scipy()
    if A.nrows == A.ncols:
        b = a
        B = A
    else:
        b = a.T.tocsr()
        B = convert.transpose_csr(A)
    want = _oracle(a, b)

    C = esc.spgemm_csr(A, B)
    _assert_matches(C.to_scipy(), want)

    C2 = esc.spgemm_coo(convert.csr_to_coo(A), convert.csr_to_coo(B))
    _assert_matches(C2.to_scipy(), want)

    C3 = ell_ops.spgemm_ell(convert.csr_to_ell(A, check_guard=False),
                            convert.csr_to_ell(B, check_guard=False))
    _assert_matches(C3.to_scipy(), want)

    C4 = dia_ops.spgemm_dia(convert.csr_to_dia(A, check_guard=False),
                            convert.csr_to_dia(B, check_guard=False))
    got = C4.to_scipy().toarray()
    np.testing.assert_allclose(got, want.toarray(), rtol=fp_tol(), atol=fp_tol())

    # checksum (the reference's verified_sum, main.cpp:753-758)
    np.testing.assert_allclose(float(C.checksum()), want.sum(), rtol=fp_tol())


def test_get_flop_matches_reference_formula():
    a = fixtures.random_csr(20, 20, density=0.15, seed=20)
    A = CSR.from_scipy(a)
    # independent computation of sum over a_ij of nnz(B row j)
    want = sum(int(a.indptr[j + 1] - a.indptr[j])
               for j in a.indices)
    assert flops.get_flop(A, A) == want
    assert int(flops.get_flop_jit(A.col_ind, A.nnz, A.row_ptr)) == want
    plan = esc.plan_spgemm(A, A)
    assert plan.flops == want


def test_plan_capacities_are_buckets_and_sufficient():
    a = fixtures.random_csr(50, 50, density=0.1, seed=21)
    A = CSR.from_scipy(a)
    plan = esc.plan_spgemm(A, A)
    assert plan.expansion_capacity >= plan.flops
    # geometric bucket: mantissa in {8,10,12,14,16} x power of two
    cap = plan.expansion_capacity
    base = cap
    while base % 2 == 0:
        base //= 2
    assert base in (1, 3, 5, 7)
    assert plan.expansion_capacity <= max(plan.flops * 1.25, 8)
    C = esc.spgemm_csr(A, A)
    assert int(C.nnz) <= plan.out_capacity


def test_duplicate_entries_accumulate():
    """The reference keeps duplicate .mtx entries and they accumulate through
    SpGEMM; ESC must sum them."""
    rows = np.array([0, 0, 1])
    cols = np.array([1, 1, 0])
    vals = np.array([2.0, 3.0, 4.0])
    a = sp.coo_matrix((vals, (rows, cols)), shape=(2, 2))
    A = CSR.from_arrays(np.array([0, 2, 3]), cols, vals, (2, 2))
    C = esc.spgemm_csr(A, A)
    want = (a.tocsr() @ a.tocsr()).toarray()
    got = C.to_scipy().toarray()
    np.testing.assert_allclose(got, want)


def test_symbolic_plan_matches_host():
    """Device symbolic pass == host GetFlop formula."""
    import numpy as np
    from ia_spgemm_tpu.ops import symbolic
    from ia_spgemm_tpu.ops.flops import get_flop
    from tests import fixtures
    a = fixtures.random_csr(60, 40, density=0.15, seed=70)
    b = fixtures.random_csr(40, 50, density=0.2, seed=71)
    A, B = CSR.from_scipy(a), CSR.from_scipy(b)
    E, bound, mx = symbolic.plan_symbolic(A, B)
    assert E == get_flop(A, B)
    rf = np.asarray(symbolic.row_flops_csr(A.row_ptr, A.col_ind, A.nnz,
                                           B.row_ptr))
    want_rf = np.zeros(60, np.int64)
    b_len = np.diff(np.asarray(B.row_ptr))
    rp = np.asarray(A.row_ptr)
    col = np.asarray(A.col_ind)
    for r in range(60):
        want_rf[r] = b_len[col[rp[r]:rp[r + 1]]].sum()
    assert (rf == want_rf).all()
    assert bound == int(np.minimum(want_rf, 50).sum())
    assert mx == int(want_rf.max())


def test_compensated_matches_fp64_oracle():
    """Double-double accumulation: f32 operands, fp64-grade sums. A badly
    conditioned case (large +x paired with -x plus tiny residuals) that
    plain f32 accumulation gets wrong by ~1e-2."""
    a32 = fixtures.cancelling_csr(64, seed=42).astype(np.float32)
    # oracle on the EXACT f32-rounded inputs, accumulated in f64
    want = (a32.astype(np.float64) @ a32.astype(np.float64)).tocsr()
    A = CSR.from_scipy(a32)
    C = esc.spgemm_csr_compensated(A, A)
    got = C.to_scipy().tocsr()
    got.sum_duplicates()
    d = abs(got - want)
    scale = max(1.0, abs(want).max())
    assert (d.max() if d.nnz else 0.0) / scale < 1e-9
    # plain f32 is measurably worse on this input
    C32 = esc.spgemm_csr(A, A)
    d32 = abs(C32.to_scipy().astype(np.float64) - want)
    assert d32.max() / scale > 1e-8


def test_sliced_esc_matches_oracle():
    """Workspace slicing (reference: sliced ESC, coo_dev:388-450): a tiny
    workspace forces multiple row slabs; the assembled result must match
    the oracle exactly."""
    a = fixtures.random_csr(60, 60, density=0.15, seed=21)
    A = CSR.from_scipy(a)
    plan = esc.plan_spgemm(A, A, workspace_elems=150)
    assert plan.slabs is not None and len(plan.slabs) > 3
    C = esc.spgemm_csr(A, A, plan)
    got = C.to_scipy()
    got.sum_duplicates()
    want = _oracle(a, a)
    assert got.shape == want.shape
    d = abs(got - want)
    assert (d.max() if d.nnz else 0.0) < fp_tol()
    # row_ptr integrity: monotone, ends at nnz
    rp = np.asarray(C.row_ptr)
    assert (np.diff(rp) >= 0).all()
    assert rp[-1] == int(C.nnz)
    assert int(C.nnz) == want.nnz


def test_sliced_single_huge_row_raises():
    a = fixtures.random_csr(8, 8, density=0.9, seed=22)
    A = CSR.from_scipy(a)
    with pytest.raises(ValueError, match="row-partition"):
        esc.plan_spgemm(A, A, workspace_elems=3)


def test_sliced_matches_unsliced_plan_results():
    a = fixtures.banded_csr(48, bandwidth=3, seed=23)
    A = CSR.from_scipy(a)
    C1 = esc.spgemm_csr(A, A, esc.plan_spgemm(A, A))
    C2 = esc.spgemm_csr(A, A, esc.plan_spgemm(A, A, workspace_elems=200))
    s1 = C1.to_scipy()
    s2 = C2.to_scipy()
    d = abs(s1 - s2)
    assert (d.max() if d.nnz else 0.0) < fp_tol()


@pytest.mark.gpu
def test_sliced_esc_int32_overflow_expansion_completes():
    # E > 2^31 expansion: minutes on the CPU backend, so GPU only
    """The reference's GPU handles expansions beyond any single workspace
    by row-slicing (coo_dev:388-450); round 1 raised on E >= 2^31. Build
    a matrix whose TOTAL expansion exceeds int32 but whose C stays small
    (25 duplicated mega-rows in B collapse 25x), and check the sliced
    path completes single-chip with analytically known values."""
    import jax.numpy as jnp
    from ia_spgemm_tpu.formats.types import CSR as _CSR

    kb = 1_000_000       # nnz per B mega-row
    dup = 25             # A entries per row, all hitting identical rows
    m_a = 92             # total E = 92 * 25 * 1e6 = 2.3e9 > 2^31
    k = dup              # B has `dup` rows
    n = kb               # B cols = the mega-row pattern length
    # B: dup identical rows, cols 0..kb-1, values 1.0
    b_row_ptr = np.arange(k + 1, dtype=np.int32) * kb
    b_col = np.tile(np.arange(kb, dtype=np.int32), k)
    b_val = np.ones(k * kb, np.float32)
    B = _CSR(row_ptr=jnp.asarray(b_row_ptr), col_ind=jnp.asarray(b_col),
             values=jnp.asarray(b_val), nnz=jnp.int32(k * kb),
             shape=(k, n))
    # A: m_a rows x dup entries (cols 0..dup-1), value = (row+1)
    a_row_ptr = np.arange(m_a + 1, dtype=np.int32) * dup
    a_col = np.tile(np.arange(dup, dtype=np.int32), m_a)
    a_val = np.repeat(np.arange(1, m_a + 1, dtype=np.float32), dup)
    A = _CSR(row_ptr=jnp.asarray(a_row_ptr), col_ind=jnp.asarray(a_col),
             values=jnp.asarray(a_val), nnz=jnp.int32(m_a * dup),
             shape=(m_a, k))
    plan = esc.plan_spgemm(A, B)
    assert plan.flops == m_a * dup * kb
    assert plan.flops >= 2**31
    assert plan.slabs is not None
    C = esc.spgemm_csr(A, B, plan)
    assert int(C.nnz) == m_a * kb
    # C[r, :] = dup * (r+1) everywhere -> total = kb * dup * sum(r+1)
    want = float(kb) * dup * (m_a * (m_a + 1) // 2)
    got = float(np.sum(np.asarray(C.values, np.float64)))
    assert abs(got - want) / want < 1e-6


def _assert_matches_f32(ours_sp, want):
    got = ours_sp.tocsr()
    got.sum_duplicates()
    got.sort_indices()
    assert got.shape == want.shape
    d = abs(got - want)
    scale = max(1.0, abs(want).max() if want.nnz else 0.0)
    assert (d.max() if d.nnz else 0.0) < 1e-5 * scale


@pytest.mark.parametrize("name,a,b", _pairs())
def test_spgemm_csr_auto(name, a, b):
    """The production csr entry (default engine, and each engine forced)
    matches the oracle on every fixture."""
    A = CSR.from_scipy(a.astype(np.float32))
    B = CSR.from_scipy(b.astype(np.float32))
    C = esc.spgemm_csr_auto(A, B)
    _assert_matches_f32(C.to_scipy(), _oracle(a, b).astype(np.float32))


@pytest.mark.parametrize("engine", ["global", "tiled", "slab", "hybrid"])
@pytest.mark.parametrize("name,a,b", _pairs())
def test_spgemm_csr_engines(name, a, b, engine):
    """Each CSR engine run by name through plan_csr_engine matches the
    oracle; an engine that is not viable for the input returns None."""
    A = CSR.from_scipy(a.astype(np.float32))
    B = CSR.from_scipy(b.astype(np.float32))
    call = esc.plan_csr_engine(A, B, engine)
    if engine == "global":
        assert call is not None
    if call is None:
        return
    _assert_matches_f32(call().to_scipy(), _oracle(a, b).astype(np.float32))


def test_spgemm_csr_tiled_skew_and_fallbacks():
    """Tiled route: viable on a B-skewed f32 case (returns BlockCSR);
    declines on fp64 (the global-sort path keeps segment_sum order)."""
    from ia_spgemm_tpu.formats.types import BlockCSR
    rng = np.random.default_rng(31)
    m = 200
    rows, cols, vals = [], [], []
    for r in range(m):
        ln = 80 if r % 50 == 0 else int(rng.integers(1, 6))
        cs = rng.choice(m, size=ln, replace=False)
        rows += [r] * ln
        cols += cs.tolist()
        vals += rng.standard_normal(ln).tolist()
    a = sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsr()
    A32 = CSR.from_scipy(a.astype(np.float32))
    C = esc.spgemm_csr_tiled(A32, A32)
    assert isinstance(C, BlockCSR)
    _assert_matches_f32(C.to_scipy(), _oracle(a, a).astype(np.float32))
    # fp64 falls back (tiled declines); auto still answers via ESC
    A64 = CSR.from_scipy(a.astype(np.float64))
    assert esc.plan_csr_tiled(A64, A64) is None
    C64 = esc.spgemm_csr_auto(A64, A64)
    assert not isinstance(C64, BlockCSR)
    _assert_matches(C64.to_scipy(), _oracle(a, a))


def test_plan_csr_tiled_budget_guard(monkeypatch):
    """An operand whose padded ELL form exceeds the slot budget makes the
    tiled planner decline rather than allocate it."""
    # one dense-ish row of 3000 among 50k rows: m * K = 1.5e8 slots is
    # fine, but shrink the budget to force the guard
    rng = np.random.default_rng(7)
    m = 64
    a = sp.random(m, m, density=0.2, random_state=7, format="csr")
    A = CSR.from_scipy(a.astype(np.float32))
    import ia_spgemm_tpu.ops.esc as esc_mod
    assert esc_mod.plan_csr_tiled(A, A) is not None
    monkeypatch.setattr(esc_mod, "tiled_ell_budget_elems", lambda: 8)
    assert esc_mod.plan_csr_tiled(A, A) is None


def test_plan_workspace_bucket_stays_int32():
    """A workspace near 2^31 must not let the BUCKETED capacity round
    past int32 positions: E=2e9 buckets to 16*2^27 = 2^31 exactly, which
    would overflow the position arithmetic without the ws guard (the
    guard shrinks ws so such an E takes the sliced path instead)."""
    import scipy.sparse as sp
    m, k = 2000, 1000
    # k DISTINCT columns per row (duplicates would be merged by the CSR
    # canonicalization and shrink E below the overflow regime)
    cols = ((np.arange(k)[None, :] + np.arange(m)[:, None]) % m).ravel()
    a = sp.csr_matrix(
        (np.ones(m * k, np.float32),
         cols, np.arange(0, m * k + 1, k)), shape=(m, m))
    A = CSR.from_scipy(a)
    i32max = np.iinfo(np.int32).max
    plan = esc.plan_spgemm(A, A, workspace_elems=i32max - 1)
    assert plan.flops == 2_000_000_000  # each product row is k long
    caps = [plan.expansion_capacity, plan.out_capacity,
            plan.rows_capacity, plan.nnza_capacity,
            plan.total_out_capacity]
    for cap in caps:
        assert cap is None or 0 < cap <= i32max - 1


def test_compensated_rejects_sliced_plan():
    """A sliced plan's capacities are per-slab; the compensated engine
    must refuse them loudly (running anyway silently truncated the
    expansion before this guard)."""
    a = fixtures.random_csr(60, 60, density=0.15, seed=26)
    A = CSR.from_scipy(a.astype(np.float32))
    plan = esc.plan_spgemm(A, A, workspace_elems=150)
    assert plan.slabs is not None
    with pytest.raises(ValueError, match="does not slice"):
        esc.spgemm_csr_compensated(A, A, plan)


def test_coo_routes_sliced_plan_through_sliced_engine():
    """spgemm_coo with a sliced plan must produce the full product (it
    used to run one whole-matrix core call against per-slab capacities,
    silently dropping products past the slab workspace)."""
    from ia_spgemm_tpu.formats import convert
    a = fixtures.random_csr(60, 60, density=0.15, seed=27)
    A = CSR.from_scipy(a)
    plan = esc.plan_spgemm(A, A, workspace_elems=150)
    assert plan.slabs is not None
    C = esc.spgemm_coo(convert.csr_to_coo(A), convert.csr_to_coo(A), plan)
    got = convert.coo_to_csr(C).to_scipy()
    got.sum_duplicates()
    want = _oracle(a, a)
    d = abs(got - want)
    assert (d.max() if d.nnz else 0.0) < fp_tol()
    assert int(C.nnz) == want.nnz


def test_sliced_mixed_dtype_assembles_at_result_type():
    a = fixtures.random_csr(40, 40, density=0.15, seed=28)
    A32 = CSR.from_scipy(a.astype(np.float32))
    A64 = CSR.from_scipy(a.astype(np.float64))
    plan = esc.plan_spgemm(A32, A64, workspace_elems=150)
    assert plan.slabs is not None
    C = esc.spgemm_csr(A32, A64, plan)
    assert np.dtype(C.values.dtype) == np.float64
    want = _oracle(a, a)
    got = C.to_scipy()
    got.sum_duplicates()
    assert abs(got - want).max() < 1e-5  # f32 operand limits accuracy
