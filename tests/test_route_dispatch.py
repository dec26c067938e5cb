"""Card-fitted CSR route dispatch (esc.predict_csr_route_ms): skewed
inputs must not auto-route to the global sort, and the predictor must
rank engines consistently with the H100 measurements it was fitted on."""

import numpy as np
import pytest
import scipy.sparse as sp

from ia_spgemm_tpu.formats.types import CSR
from ia_spgemm_tpu.ops import esc


def _skew_matrix(m=2048, heavy_every=300, heavy_len=1500, seed=3):
    """A few huge rows among short ones: the heavy rows' products exceed
    the slab width cap, so slab declines and hybrid/tiled compete."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, 6, m)
    lens[::heavy_every] = heavy_len
    rows = np.repeat(np.arange(m), lens)
    cols = rng.integers(0, m, rows.shape[0])
    a = sp.coo_matrix((rng.standard_normal(rows.shape[0]), (rows, cols)),
                      shape=(m, m)).tocsr()
    a.sum_duplicates()
    return a


def test_predict_routes_headline_shape():
    """Banded+random (the smoke matrix's family): the row-grid engines
    must be predicted to beat the global sort by a wide margin (measured
    on an H100, power limit 400 W, at m=2**19: 26-28 ms against 399
    ms)."""
    from bench import build_matrix
    a = build_matrix(m=2048)
    A = CSR.from_scipy(a.astype(np.float32))
    pred = esc.predict_csr_route_ms(A, A)
    assert "tiled" in pred and "global" in pred
    assert pred["tiled"] < pred["global"] / 5
    route, _call = esc.plan_csr_auto(A, A)
    assert route in ("tiled", "slab")


def test_skew_dispatches_to_hybrid():
    a = _skew_matrix()
    A = CSR.from_scipy(a.astype(np.float32))
    pred = esc.predict_csr_route_ms(A, A)
    # heavy rows blow the slab width cap -> no slab candidate; hybrid
    # and tiled must both be predicted cheaper than the global sort
    assert "hybrid" in pred and "slab" not in pred
    assert pred["hybrid"] < pred["global"]
    assert pred["tiled"] < pred["global"]
    route, call = esc.plan_csr_auto(A, A)
    assert route == min(pred, key=pred.get) != "global"
    C = call()
    want = (a @ a).astype(np.float32)
    got = C.to_scipy().astype(np.float32)
    d = abs(got - want)
    scale = max(1.0, abs(want).max())
    assert (d.max() if d.nnz else 0.0) < 1e-4 * scale


def test_hybrid_coerces_to_csr_in_autotune():
    from ia_spgemm_tpu.autotune import _as_csr
    from ia_spgemm_tpu.ops import slab as slab_mod
    a = _skew_matrix(m=1024, heavy_every=200, heavy_len=900)
    A = CSR.from_scipy(a.astype(np.float32))
    call = slab_mod.plan_slab_hybrid(A, A)
    if call is None:
        pytest.skip("hybrid not applicable at this size")
    C = _as_csr(call())
    assert isinstance(C, CSR)
    want = (a @ a).astype(np.float32)
    got = C.to_scipy()
    d = abs(got - want)
    scale = max(1.0, abs(want).max())
    assert (d.max() if d.nnz else 0.0) < 1e-4 * scale


def test_fp64_still_routes_global():
    a = _skew_matrix(m=512, heavy_every=100, heavy_len=300)
    A = CSR.from_scipy(a.astype(np.float64))
    pred = esc.predict_csr_route_ms(A, A)
    assert set(pred) == {"global"}
    route, _ = esc.plan_csr_auto(A, A)
    assert route == "global"


def test_hot_paths_never_flatten_slabcsr(monkeypatch):
    """The timed benchmark loops keep the slab engine's native
    SlabCSR/HybridCSR — slab_to_csr (the priced flatten) must only run
    for opt-in exact-CSR coercions (autotune contract, engine='slab'),
    never inside the harness timing loop or the cost-model auto
    route."""
    from ia_spgemm_tpu.bench import harness
    from ia_spgemm_tpu.ops import slab as slab_mod

    def _boom(*a, **k):
        raise AssertionError("slab_to_csr called on a hot path")

    monkeypatch.setattr(slab_mod, "slab_to_csr", _boom)
    a = _skew_matrix(m=512, heavy_every=100, heavy_len=300)
    A = CSR.from_scipy(a.astype(np.float32))
    # auto route (may pick slab/hybrid): plans + runs, native output
    _route, call = esc.plan_csr_auto(A, A)
    C = call()
    assert C.to_scipy().shape == (512, 512)
    # harness esc algorithm end-to-end (the timed loop the reports use)
    rep = harness.run_benchmark(A, A, ("baseline", "esc"), iters=1)
    assert all(r.ok for r in rep.results)


def test_dia_compute_budget_rejects_denseish():
    """A dense-ish matrix occupies ~2m diagonals; the sequential DIA
    pair scan would run for minutes and CANNOT be cancelled once
    dispatched. The budget guard must reject it pre-dispatch: harness
    skips, spgemm_dia raises."""
    from ia_spgemm_tpu.bench import harness
    from ia_spgemm_tpu.formats import convert
    from ia_spgemm_tpu.ops import dia as dia_ops

    rng = np.random.default_rng(0)
    m = 512
    a = sp.random(m, m, density=0.25, random_state=rng, format="csr")
    A = CSR.from_scipy(a.astype(np.float32))
    rep = harness.run_benchmark(A, A, ("baseline", "dia"), iters=1)
    dia_res = [r for r in rep.results if r.name == "dia"][0]
    assert dia_res.skipped and not dia_res.ok
    Ad = convert.csr_to_dia(A, check_guard=False)
    assert not dia_ops.dia_compute_viable(
        int(Ad.offsets.shape[0]), int(Ad.offsets.shape[0]), m)
    with pytest.raises(ValueError, match="compute budget"):
        dia_ops.spgemm_dia(Ad, Ad)
    # banded inputs stay viable (the format's real territory)
    assert dia_ops.dia_compute_viable(9, 9, 16384)
