"""Row-local row-grid SpGEMM (ops/bitonic.py): oracle parity, canonical
ELL output form, planner viability guards, and the harness/autotune
wiring."""

import numpy as np
import pytest
import scipy.sparse as sp

from ia_spgemm_tpu.formats import convert
from ia_spgemm_tpu.formats.types import CSR
from ia_spgemm_tpu.ops import bitonic
from tests import fixtures


def _ell(a):
    return convert.csr_to_ell(CSR.from_scipy(a.astype(np.float32)),
                              check_guard=False)


def _check(a, b, C):
    want = (a @ b).tocsr().astype(np.float32)
    got = C.to_scipy()
    d = abs(got - want)
    err = d.max() if d.nnz else 0.0
    assert err < 1e-4, err
    assert int(C.nnz) == want.nnz


@pytest.mark.parametrize("m,k,n,da,db,seed", [
    (16, 16, 16, 0.3, 0.3, 0),
    (64, 64, 64, 0.05, 0.05, 1),
    (128, 96, 200, 0.08, 0.06, 2),
    (33, 17, 65, 0.2, 0.15, 3),
    (8, 8, 8, 1.0, 1.0, 4),       # fully dense rows
])
def test_bitonic_matches_oracle(m, k, n, da, db, seed):
    rng = np.random.default_rng(seed)
    a = sp.random(m, k, density=da,
                  random_state=np.random.RandomState(seed), format="csr")
    a.data[:] = rng.standard_normal(a.nnz)
    b = sp.random(k, n, density=db,
                  random_state=np.random.RandomState(seed + 100),
                  format="csr")
    b.data[:] = rng.standard_normal(b.nnz)
    C = bitonic.spgemm_bitonic(_ell(a), _ell(b))
    _check(a, b, C)


def test_bitonic_subrun_split():
    """kb just past a power of two: the flat grid is exactly Ka*Kb slots
    wide (no pow2 run padding); results must match the oracle."""
    rng = np.random.default_rng(7)
    m = 64
    cols = np.stack([rng.choice(m, 40, replace=False) for _ in range(m)])
    rows = np.repeat(np.arange(m), 40)
    a = sp.coo_matrix((rng.standard_normal(m * 40),
                       (rows, cols.ravel())), shape=(m, m)).tocsr()
    plan = bitonic.plan_bitonic(_ell(a), _ell(a))
    assert plan.viable and plan.width == 40 * 40, plan
    C = bitonic.spgemm_bitonic(_ell(a), _ell(a), plan)
    _check(a, a, C)


def test_bitonic_canonical_output():
    """Left-justified, strictly ascending columns, -1 tail sentinels."""
    a = fixtures.random_csr(48, 48, density=0.12, seed=9)
    C = bitonic.spgemm_bitonic(_ell(a), _ell(a))
    col = np.asarray(C.col_ind)
    nr = np.asarray(C.nnz_row)
    for r in range(col.shape[0]):
        row = col[r, :nr[r]]
        assert (row >= 0).all()
        if len(row) > 1:
            assert (np.diff(row) > 0).all()
        assert (col[r, nr[r]:] == -1).all()


def test_bitonic_empty_rows_and_cancellation():
    a = sp.csr_matrix((8, 8))
    a[0, 1] = 1.0
    a[1, 2] = 1.0
    a = a.tocsr()
    C = bitonic.spgemm_bitonic(_ell(a), _ell(a))
    _check(a, a, C)


def test_bitonic_rectangular_chain():
    rng = np.random.default_rng(5)
    a = sp.random(40, 24, density=0.2,
                  random_state=np.random.RandomState(5), format="csr")
    a.data[:] = rng.standard_normal(a.nnz)
    b = sp.random(24, 56, density=0.15,
                  random_state=np.random.RandomState(6), format="csr")
    b.data[:] = rng.standard_normal(b.nnz)
    C = bitonic.spgemm_bitonic(_ell(a), _ell(b))
    _check(a, b, C)


def test_plan_rejects_wide_products():
    plan = bitonic.plan_bitonic_dims(1000, 200, 200)  # 40000 > MAX_WIDTH
    assert not plan.viable and "slots per row" in plan.reason


def test_plan_rejects_product_budget():
    plan = bitonic.plan_bitonic_dims(200_000_000, 16, 16)
    assert not plan.viable and "budget" in plan.reason


def test_spgemm_raises_on_nonviable():
    a = fixtures.random_csr(16, 16, density=0.3, seed=1)
    A = _ell(a)
    bad = bitonic.BitonicPlan(width=2 * bitonic.MAX_WIDTH, viable=False,
                              reason="x")
    with pytest.raises(ValueError):
        bitonic.spgemm_bitonic(A, A, bad)


def test_harness_runs_bitonic():
    from ia_spgemm_tpu.bench import harness
    a = fixtures.random_csr(32, 32, density=0.15, seed=11)
    A = CSR.from_scipy(a)
    rep = harness.run_benchmark(A, A, ("baseline", "bitonic"), iters=1)
    res = rep.by_name("bitonic")
    assert res is not None and (res.ok or res.skipped)
    if res.ok:
        assert res.error == ""


def test_reference_inputs_bitonic():
    """A @ A on the reference fixture matrices: fp32 RELATIVE tolerance
    (LFAT5 sums reach ~1e12), and structural zeros from exact cancellation
    may exceed scipy's nnz (b1_ss has +1/-1 products that cancel)."""
    import glob
    paths = sorted(glob.glob(
        "/root/reference/IA-SPGEMM-CPU_release/Inputs/*.mtx"))[:4]
    from ia_spgemm_tpu.io import mmio
    for p in paths:
        A = mmio.read_mtx_to_csr(p)
        a = A.to_scipy().astype(np.float32)
        if A.ncols != A.nrows:
            continue
        C = bitonic.spgemm_bitonic(_ell(a), _ell(a))
        want = (a @ a).tocsr()
        d = abs(C.to_scipy() - want)
        err = d.max() if d.nnz else 0.0
        scale = max(1.0, abs(want).max())
        assert err / scale < 1e-6, (p, err, scale)
        assert int(C.nnz) >= want.nnz


def test_bucketed_matches_plain():
    from ia_spgemm_tpu.io import suitesparse as ss
    for gen, kw in ((ss.gen_powerlaw, dict(mean_nnz=6, seed=3)),
                    (ss.gen_uniform, dict(nnz_per_row=5, seed=2))):
        a = gen(160, **kw).astype(np.float32)
        A = _ell(a)
        Cb = bitonic.spgemm_bitonic_multiclass(A, A)
        want = (a @ a).tocsr()
        d = abs(Cb.to_scipy() - want)
        err = (d.max() if d.nnz else 0.0) / max(1.0, abs(want).max())
        assert err < 1e-5
        assert int(Cb.nnz) == want.nnz


def test_bucketed_viability_beyond_global_max():
    """One huge row rejects the flat plan but not the bucketed one as long
    as that row itself fits... and conversely a too-wide single row
    rejects both."""
    import scipy.sparse as sp
    rng = np.random.default_rng(8)
    a = sp.random(64, 64, density=0.05,
                  random_state=np.random.RandomState(8), format="csr")
    a.data[:] = rng.standard_normal(a.nnz)
    A = _ell(a)
    assert bitonic.spgemm_bitonic_multiclass(A, A) is not None


def test_bitonic_out_width_cap():
    """out_width cap: when every row's nnz(C) fits, the capped result
    matches the full-width result exactly; nnz_row lets the caller verify
    the contract."""
    rng = np.random.default_rng(7)
    a = sp.random(96, 96, density=0.08,
                  random_state=np.random.RandomState(7), format="csr")
    a.data[:] = rng.standard_normal(a.nnz)
    A = _ell(a)
    full = bitonic.spgemm_bitonic(A, A)
    max_nnz = int(np.max(np.asarray(full.nnz_row)))
    cap = 128
    while cap < max_nnz:
        cap *= 2
    capped = bitonic.spgemm_bitonic(A, A, out_width=cap)
    assert capped.col_ind.shape[1] == min(
        cap, full.col_ind.shape[1])
    w = capped.col_ind.shape[1]
    assert np.array_equal(np.asarray(capped.nnz_row),
                          np.asarray(full.nnz_row))
    assert np.array_equal(np.asarray(capped.col_ind),
                          np.asarray(full.col_ind)[:, :w])
    assert np.allclose(np.asarray(capped.values),
                       np.asarray(full.values)[:, :w])


def test_multiclass_matches_oracle_skewed():
    """Width-class kernel on a skewed matrix (some heavy rows) — the flat
    plan pads everything to the heavy rows' width; classes keep each row
    at its own pow2 width and must agree with the oracle."""
    rng = np.random.default_rng(11)
    m = 200
    rows, cols, vals = [], [], []
    for r in range(m):
        ln = 40 if r % 37 == 0 else int(rng.integers(1, 6))
        cs = rng.choice(m, size=ln, replace=False)
        for c in cs:
            rows.append(r)
            cols.append(int(c))
            vals.append(float(rng.standard_normal()))
    a = sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsr()
    A = _ell(a)
    C = bitonic.spgemm_bitonic_multiclass(A, A)
    assert C is not None
    plan, W = bitonic.plan_multiclass(bitonic.row_products(A, A))
    assert len(plan.widths) > 1  # the skew actually created classes
    _check(a, a, C)


def test_multiclass_empty_and_uniform():
    a = fixtures.random_csr(64, 64, density=0.05, seed=12)
    A = _ell(a.astype(np.float64))  # non-f32 path per class
    C = bitonic.spgemm_bitonic_multiclass(A, A)
    assert C is not None
    _check(a, a, C)


def test_multiclass_ragged_b_skew():
    """B-skew: a few huge B rows among tiny ones. The ragged expansion
    keeps each entry at its own B row's size, so the class widths follow
    each row's true product count."""
    rng = np.random.default_rng(13)
    m = 256
    rows, cols, vals = [], [], []
    for r in range(m):
        ln = 160 if r % 64 == 0 else int(rng.integers(1, 5))
        cs = rng.choice(m, size=ln, replace=False)
        for c in cs:
            rows.append(r)
            cols.append(int(c))
            vals.append(float(rng.standard_normal()))
    a = sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsr()
    A = _ell(a)
    prods = bitonic.row_products(A, A)
    plan, W = bitonic.plan_multiclass(prods)
    assert plan.viable
    # every row's class holds its own products, not Ka * Kb
    assert (W >= prods).all()
    assert (W < np.maximum(2 * prods, bitonic.MIN_CLASS_WIDTH + 1)).all()
    C = bitonic.spgemm_bitonic_multiclass(A, A)
    assert C is not None
    _check(a, a, C)


def _skewed(seed, m, heavy_every=37, heavy=40, light=6):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for r in range(m):
        ln = heavy if r % heavy_every == 0 else int(rng.integers(1, light))
        cs = rng.choice(m, size=ln, replace=False)
        for c in cs:
            rows.append(r)
            cols.append(int(c))
            vals.append(float(rng.standard_normal()))
    return sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsr()


def test_multiclass_bcsr_matches_oracle():
    """assemble='bcsr' returns a 128-aligned BlockCSR whose expansion
    matches the oracle AND the ELL-mode result; block invariants hold."""
    from ia_spgemm_tpu.formats.types import BlockCSR
    a = _skewed(21, 200)
    A = _ell(a)
    C = bitonic.spgemm_bitonic_multiclass(A, A, assemble="bcsr")
    assert isinstance(C, BlockCSR)
    _check(a, a, C)
    # same numbers as the ELL assembly
    E = bitonic.spgemm_bitonic_multiclass(A, A)
    assert np.array_equal(np.asarray(C.nnz_row), np.asarray(E.nnz_row))
    assert np.isclose(float(C.checksum()), float(E.checksum()), rtol=1e-5)
    # block invariants: each row's span covers its nnz (spans are fixed
    # per width class at plan time, so they may exceed ceil(nnz/128));
    # used blocks pad with col == -1 / val == 0 beyond each row's nnz
    bp = np.asarray(C.blk_ptr)
    nnz = np.asarray(C.nnz_row)
    assert ((bp[1:] - bp[:-1]) >= -(-nnz // 128)).all()
    assert (bp[1:] >= bp[:-1]).all()
    colb = np.asarray(C.col_blocks)
    valb = np.asarray(C.val_blocks)
    for r in range(C.nrows):
        span = colb[bp[r]:bp[r + 1]].reshape(-1)
        vspan = valb[bp[r]:bp[r + 1]].reshape(-1)
        k = nnz[r]
        assert (span[:k] >= 0).all()
        assert (span[:k][1:] > span[:k][:-1]).all()  # ascending cols
        assert (span[k:] == -1).all()
        assert (vspan[k:] == 0).all()
    total = int(bp[-1])
    assert (colb[total:] == -1).all() and (valb[total:] == 0).all()


def test_multiclass_bcsr_ragged_b_skew():
    """bcsr assembly over the ragged-fragment layout (B-skew)."""
    from ia_spgemm_tpu.formats.types import BlockCSR
    a = _skewed(23, 256, heavy_every=64, heavy=160, light=5)
    A = _ell(a)
    plan, _ = bitonic.plan_multiclass(bitonic.row_products(A, A))
    assert plan.viable and len(plan.widths) > 1
    C = bitonic.spgemm_bitonic_multiclass(A, A, assemble="bcsr")
    assert isinstance(C, BlockCSR)
    _check(a, a, C)


def test_multiclass_bcsr_out_width_cap():
    """A non-multiple-of-128 out_width rounds UP to block alignment; the
    cap clamps per-row nnz to the class output width."""
    a = _skewed(25, 200)
    A = _ell(a)
    full = bitonic.spgemm_bitonic_multiclass(A, A, assemble="bcsr")
    capped = bitonic.spgemm_bitonic_multiclass(A, A, assemble="bcsr",
                                               out_width=130)
    # 130 rounds up to 256; every row keeps min(nnz, its class cap)
    nnz_f = np.asarray(full.nnz_row)
    nnz_c = np.asarray(capped.nnz_row)
    assert (nnz_c <= np.minimum(nnz_f, 256)).all()
    assert (nnz_c == np.minimum(nnz_f, nnz_c.max(initial=0))).all() or \
        (nnz_c <= nnz_f).all()
    got = capped.to_scipy()
    want = (a @ a).tocsr().astype(np.float32)
    # uncapped rows agree exactly with the oracle
    for r in np.nonzero(nnz_c == nnz_f)[0][:50]:
        gr = got.getrow(int(r))
        wr = want.getrow(int(r))
        d = abs(gr - wr)
        assert (d.max() if d.nnz else 0.0) < 1e-4


def test_multiclass_plan_cache_hit_and_eviction():
    """Repeat-call planning must be a cache hit: the same
    ELL operands reuse the built pipeline; dead operands evict their
    entry so a recycled id() can never alias a stale plan."""
    import gc
    import time

    a = _skewed(31, 192)
    A = _ell(a)
    bitonic.clear_plan_cache()
    call1 = bitonic.multiclass_planned(A, A, assemble="bcsr")
    assert call1 is not None
    s = bitonic.plan_cache_stats()
    assert s["misses"] == 1 and s["hits"] == 0
    t0 = time.perf_counter()
    call2 = bitonic.multiclass_planned(A, A, assemble="bcsr")
    replan_ms = (time.perf_counter() - t0) * 1e3
    assert bitonic.plan_cache_stats()["hits"] == 1
    assert call2 is call1
    assert replan_ms < 100.0, f"cached replan took {replan_ms:.1f} ms"
    # results identical through the cached pipeline
    C = call2()
    _check(a, a, C)
    # a different assemble mode is a different plan, not a stale hit
    call3 = bitonic.multiclass_planned(A, A, assemble="ell")
    assert call3 is not call1
    assert bitonic.plan_cache_stats()["misses"] == 2
    # the FIFO bound holds: overflowing evicts the oldest entry
    for i in range(bitonic._BUILD_CACHE_MAX):
        Ai = _ell(_skewed(40 + i, 64))
        assert bitonic.multiclass_planned(Ai, Ai) is not None
    assert len(bitonic._BUILD_CACHE) <= bitonic._BUILD_CACHE_MAX
    del A, call1, call2, call3
    gc.collect()
    bitonic.clear_plan_cache()


def test_bitonic_bf16_value_lane():
    """value_mode='bf16' (packed single-array sort): same output
    STRUCTURE as the f32 route (nnz, columns bit-identical) with values
    within bf16 rounding of the oracle."""
    import scipy.sparse as sp

    rng = np.random.RandomState(5)
    a = sp.random(192, 192, density=0.06, format="csr", dtype=np.float32,
                  random_state=rng)
    a.data[:] = rng.standard_normal(a.nnz).astype(np.float32)
    A = CSR.from_scipy(a)
    Ae = convert.csr_to_ell(A, check_guard=False)
    plan = bitonic.plan_bitonic(Ae, Ae)
    C32 = bitonic.spgemm_bitonic(Ae, Ae, plan)
    C16 = bitonic.spgemm_bitonic(Ae, Ae, plan, value_mode="bf16")
    want = (a @ a).toarray()
    got = C16.to_scipy().toarray()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 2e-2
    assert int(C16.nnz) == int(C32.nnz)
    assert np.array_equal(np.asarray(C16.col_ind), np.asarray(C32.col_ind))
    assert np.array_equal(np.asarray(C16.nnz_row), np.asarray(C32.nnz_row))


def test_bitonic_bf16_rejects_wide_columns():
    """The packed key has a 15-bit column field — n > 32768 must raise,
    not silently corrupt."""
    import pytest as _pytest
    import scipy.sparse as sp

    a = sp.random(64, 64, density=0.1, format="csr", dtype=np.float32,
                  random_state=np.random.RandomState(0))
    A = CSR.from_scipy(a)
    Ae = convert.csr_to_ell(A, check_guard=False)
    from ia_spgemm_tpu.formats.types import ELL
    import jax.numpy as jnp
    wide_B = ELL(col_ind=Ae.col_ind, values=Ae.values, nnz_row=Ae.nnz_row,
                 nnz=Ae.nnz, shape=(64, 40000))
    plan = bitonic.plan_bitonic(Ae, wide_B)
    with _pytest.raises(ValueError, match="15 bits"):
        bitonic.spgemm_bitonic(Ae, wide_B, plan, value_mode="bf16")


def test_bitonic_bf16_pack_roundtrip():
    """_pack_colval/_unpack_colval: cols survive exactly; values to
    bf16 rounding (incl. negatives and zero)."""
    import jax.numpy as jnp

    cols = jnp.asarray([0, 1, 17, 32767, 5], jnp.int32)
    vals = jnp.asarray([0.0, 1.0, -3.25, 1e-20, -1e20], jnp.float32)
    p = bitonic._pack_colval(cols, vals)
    k, v = bitonic._unpack_colval(p)
    np.testing.assert_array_equal(np.asarray(k), np.asarray(cols))
    want = np.asarray(vals, dtype=np.float32).astype("bfloat16" if hasattr(
        np, "bfloat16") else np.float32)
    got = np.asarray(v)
    rel = np.abs(got - np.asarray(vals)) / np.maximum(
        np.abs(np.asarray(vals)), 1e-30)
    assert (rel < 2 ** -8).all() or np.allclose(got, np.asarray(vals),
                                                rtol=2 ** -8, atol=0)
