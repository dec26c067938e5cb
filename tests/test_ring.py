"""Ring-overlapped distributed SpGEMM on the virtual 8-device CPU mesh:
parity with the scipy oracle, uneven row counts, rectangular shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from ia_spgemm_tpu.formats import convert
from ia_spgemm_tpu.formats.types import CSR
from ia_spgemm_tpu.parallel import ring
from ia_spgemm_tpu.parallel.mesh import make_mesh
from tests import fixtures


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8)


def _ell(a):
    return convert.csr_to_ell(CSR.from_scipy(a.astype(np.float32)),
                              check_guard=False)


def _run(a, b, mesh, D=8):
    A, B = _ell(a), _ell(b)
    As = ring.partition_rows_ell(A, D, mesh=mesh)
    Bs = ring.partition_rows_ell(B, D, mesh=mesh)
    plan = ring.plan_ring(A, B, D)
    assert plan.viable, plan.reason
    C = ring.ring_spgemm(As, Bs, mesh, plan)
    got = ring.gather_result(C).to_scipy()
    want = (a @ b).tocsr().astype(np.float32)
    d = abs(got - want)
    err = d.max() if d.nnz else 0.0
    assert err < 1e-4, err
    assert got.nnz == want.nnz


def test_ring_square(mesh):
    a = fixtures.random_csr(64, 64, density=0.08, seed=60)
    b = fixtures.random_csr(64, 64, density=0.1, seed=61)
    _run(a, b, mesh)


def test_ring_uneven_rows(mesh):
    a = fixtures.random_csr(61, 53, density=0.12, seed=62)  # 61 % 8 != 0
    b = fixtures.random_csr(53, 47, density=0.15, seed=63)
    _run(a, b, mesh)


def test_ring_a_squared(mesh):
    a = fixtures.random_csr(96, 96, density=0.06, seed=64)
    _run(a, a, mesh)


def test_ring_matches_single_device_bitonic(mesh):
    from ia_spgemm_tpu.ops import bitonic
    a = fixtures.random_csr(64, 64, density=0.1, seed=65)
    A = _ell(a)
    single = bitonic.spgemm_bitonic(A, A)
    As = ring.partition_rows_ell(A, 8, mesh=mesh)
    plan = ring.plan_ring(A, A, 8)
    C = ring.gather_result(ring.ring_spgemm(As, As, mesh, plan))
    d = abs(C.to_scipy() - single.to_scipy())
    assert (d.max() if d.nnz else 0.0) < 1e-5


def test_ring_flops_balanced(mesh):
    """Flops-balanced A partition (permuted rows, inverted on gather)."""
    import scipy.sparse as sp
    dense_block = fixtures.random_csr(8, 72, density=0.9, seed=66)
    sparse_block = fixtures.random_csr(64, 72, density=0.02, seed=67)
    a = sp.vstack([dense_block, sparse_block]).tocsr()[:72, :72].tocsr()
    A = _ell(a)
    As = ring.partition_rows_ell(A, 8, mesh=mesh, balance="flops")
    Bs = ring.partition_rows_ell(A, 8, mesh=mesh)
    plan = ring.plan_ring(A, A, 8)
    C = ring.ring_spgemm(As, Bs, mesh, plan)
    got = ring.gather_result(C).to_scipy()
    want = (a @ a).tocsr().astype(np.float32)
    d = abs(got - want)
    assert (d.max() if d.nnz else 0.0) < 1e-4
    # the heavy rows must be spread across shards
    rmap = np.asarray(As.row_map)
    heavy_shards = {d_ for d_ in range(8) for r in rmap[d_] if 0 <= r < 8}
    assert len(heavy_shards) == 8


def test_ring_permuted_B(mesh):
    """Round-1 limitation lifted: B may be flops-balanced (permuted rows);
    the ring builds the inverse row map from an all_gather of B.row_map."""
    a = fixtures.random_csr(64, 64, density=0.1, seed=68)
    A = _ell(a)
    As = ring.partition_rows_ell(A, 8, mesh=mesh)
    Bs = ring.partition_rows_ell(A, 8, mesh=mesh, balance="flops")
    plan = ring.plan_ring(A, A, 8)
    C = ring.ring_spgemm(As, Bs, mesh, plan)
    got = ring.gather_result(C).to_scipy()
    want = (a @ a).tocsr().astype(np.float32)
    d = abs(got - want)
    assert (d.max() if d.nnz else 0.0) < 1e-4


def test_ring_subrun_split(mesh):
    """B rows just past a power of two (kb ~ 40): the circulating block's
    product grid is exactly Ka*Kb slots per row, matching the single-chip
    flat plan, and the result matches the oracle."""
    rng = np.random.default_rng(69)
    import scipy.sparse as sp
    m = 48
    rows, cols, vals = [], [], []
    for r in range(m):
        ln = int(rng.integers(33, 41))
        cs = rng.choice(m, size=ln, replace=False)
        for c in cs:
            rows.append(r)
            cols.append(int(c))
            vals.append(float(rng.standard_normal()))
    a = sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsr()
    A = _ell(a)
    plan = ring.plan_ring(A, A, 8)
    assert plan.width == A.max_nnz_per_row ** 2, plan
    As = ring.partition_rows_ell(A, 8, mesh=mesh)
    Bs = ring.partition_rows_ell(A, 8, mesh=mesh)
    C = ring.ring_spgemm(As, Bs, mesh, plan)
    got = ring.gather_result(C).to_scipy()
    want = (a @ a).tocsr().astype(np.float32)
    d = abs(got - want)
    assert (d.max() if d.nnz else 0.0) < 2e-4


def test_scaling_model_shapes_and_limits():
    """Analytic link model (bench/scaling.py): compute-bound problems scale
    ~linearly, wire-bound ones asymptote at t1/(D*comm); the comm volume
    per link is sizeof_ell(B)/D per step."""
    from ia_spgemm_tpu.bench import scaling

    a = fixtures.banded_csr(4096, bandwidth=3, seed=2)
    A = CSR.from_scipy(a.astype(np.float32))
    # hugely compute-bound: efficiency ~1 at every D
    pts = scaling.model_ring_efficiency(A, (1, 2, 4, 8), t1_ms=1e4)
    assert [p["devices"] for p in pts] == [1, 2, 4, 8]
    assert pts[0]["efficiency"] == 1.0 and pts[0]["comm_ms"] == 0.0
    assert all(p["efficiency"] > 0.99 for p in pts)
    # wire-bound: tiny t1 -> comm dominates, efficiency decays with D
    ptsw = scaling.model_ring_efficiency(A, (1, 2, 4, 8), t1_ms=1e-3)
    effs = [p["efficiency"] for p in ptsw[1:]]
    assert all(e2 < e1 for e1, e2 in zip(effs, effs[1:]))
    # per-link bytes: one B shard per step, at WIRE width (4 B col +
    # 4 B f32 val per padded ELL slot)
    kb = int(np.diff(np.asarray(A.row_ptr)).max())
    assert ptsw[2]["comm_bytes_per_link"] == int(
        A.nrows * kb * 8 / 4)
    # no-overlap pricing is never faster than overlapped
    pts_no = scaling.model_ring_efficiency(A, (8,), t1_ms=5.0,
                                           overlap=False)
    pts_ov = scaling.model_ring_efficiency(A, (8,), t1_ms=5.0)
    assert pts_no[0]["time_ms"] >= pts_ov[0]["time_ms"]


def test_ring_rejects_nonviable_plan(mesh):
    """A non-viable plan must raise, not drive placeholder dims into the
    sharded program."""
    import dataclasses
    a = fixtures.banded_csr(32, bandwidth=1, seed=77).astype(np.float32)
    A = convert.csr_to_ell(CSR.from_scipy(a), check_guard=False)
    As = ring.partition_rows_ell(A, 8, mesh=mesh)
    plan = ring.plan_ring(A, A, 8)
    bad = dataclasses.replace(plan, viable=False)
    with pytest.raises(ValueError, match="not viable"):
        ring.ring_spgemm(As, As, mesh, bad)
