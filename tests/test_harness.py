"""Benchmark harness + CLI end-to-end tests (CPU backend, fp64)."""

import json

import numpy as np
import pytest

from ia_spgemm_tpu.bench import harness, report as report_mod
from ia_spgemm_tpu.formats.types import CSR
from tests import fixtures


def test_run_benchmark_all_algorithms():
    a = fixtures.banded_csr(30, bandwidth=2, seed=40)
    A = CSR.from_scipy(a)
    rep = harness.run_benchmark(A, A, ("baseline", "csr", "esc", "dia",
                                       "ell", "coo", "dense"), iters=1)
    names = {r.name: r for r in rep.results}
    assert names["baseline"].ok
    for alg in ("csr", "esc", "dia", "ell", "coo", "dense"):
        assert names[alg].ok, f"{alg}: {names[alg].error}"
        assert not names[alg].error, names[alg].error
        # checksums agree with the oracle baseline
        np.testing.assert_allclose(names[alg].verified_sum,
                                   names["baseline"].verified_sum,
                                   rtol=1e-9)
        assert names[alg].gflops >= 0
    assert rep.winner
    assert rep.flops > 0


def test_viability_guard_skips_in_harness():
    import scipy.sparse as sp
    n = 3000
    k = np.arange(60)
    rows = k * 50
    cols = (rows + 31 * k) % n  # 60 distinct diagonals
    a = sp.coo_matrix((np.ones(len(rows)), (rows, cols)),
                      shape=(n, n)).tocsr()
    A = CSR.from_scipy(a)
    rep = harness.run_benchmark(A, A, ("baseline", "dia"), iters=1)
    dia = rep.by_name("dia")
    assert dia.skipped and not dia.ok


def test_matnet_verdict_line():
    a = fixtures.banded_csr(12, bandwidth=1, seed=41)
    A = CSR.from_scipy(a)
    rep = harness.run_benchmark(A, A, ("baseline", "csr"), iters=1,
                                matnet_pick="csr")
    assert rep.matnet_pick == "csr"
    assert rep.matnet_correct in (True, False)
    table = report_mod.format_table(rep)
    assert "MatNet" in table
    parsed = json.loads(report_mod.to_json(rep))
    assert parsed["matnet_pick"] == "csr"


def test_cli_end_to_end(tmp_path, capsys):
    from ia_spgemm_tpu.cli.main import main
    path = fixtures.mtx_file(tmp_path, "symmetric_real")
    out_json = tmp_path / "report.json"
    imgs = tmp_path / "imgs"
    rc = main([path, "--mode", "all", "--iters", "1",
               "--json", str(out_json), "--imgs-dir", str(imgs),
               "--testing"])
    assert rc == 0
    captured = capsys.readouterr().out
    assert "Fastest algorithm" in captured
    assert (imgs / "img1.txt").exists()
    rep = json.loads(out_json.read_text())
    assert rep["winner"]
    assert any(r["name"] == "csr" and r["ok"] for r in rep["results"])


def test_cli_autotune_mode(tmp_path, capsys):
    from ia_spgemm_tpu.cli.main import main
    path = fixtures.mtx_file(tmp_path, "general_real")
    rc = main([path, "--mode", "autotune"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "ran algorithm" in out


def test_cli_positional_testing_mode(tmp_path, capsys):
    """Reference CLI compat: ./spgemm-cpu A.mtx B.mtx 1 prints the input
    matrices (main.cpp:97-140,489-497) — the third positional arg must
    behave like --testing."""
    from ia_spgemm_tpu.cli.main import main
    path = fixtures.mtx_file(tmp_path, "general_real")
    rc = main([path, path, "1", "--mode", "ell", "--no-matnet",
               "--iters", "1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "A_csr" in out and "B_csr" in out and "C_csr" in out
    rc = main([path, path, "0", "--mode", "ell", "--no-matnet",
               "--iters", "1"])
    assert rc == 0
    assert "A_csr" not in capsys.readouterr().out


def test_cli_tpu_weight_set(tmp_path, capsys):
    """--weights P100 resolves to the reference's GPU selector (3-class
    CUSP/cuSPARSE/NSPARSE menu) and autotune runs its pick."""
    from ia_spgemm_tpu.cli.main import main
    path = fixtures.mtx_file(tmp_path, "general_real")
    rc = main([path, "--mode", "autotune", "--weights", "P100"])
    assert rc == 0
    assert "ran algorithm" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["dist", "ring"])
def test_cli_distributed_modes(tmp_path, capsys, mode):
    """--mode dist/ring row-shard C = A @ A over a 4-device mesh and
    gather the result on the host; the checksum matches scipy's."""
    from ia_spgemm_tpu.cli.main import main
    path = fixtures.mtx_file(tmp_path, "general_real")
    out = str(tmp_path / "dist.json")
    rc = main([path, "--mode", mode, "--shards", "4", "--no-matnet",
               "--iters", "1", "--json", out])
    assert rc == 0
    assert "[ok]" in capsys.readouterr().out
    with open(out) as f:
        rep = json.load(f)
    assert rep["shards"] == 4 and rep["checksum_rel_err"] < 1e-4


def test_cli_gpu_profile_end_to_end(tmp_path, capsys):
    """The composed GPU-driver profile replays the reference GPU flow
    (main.cu:30-557) as ONE configuration: load A -> B = A^T -> density
    images -> 18-feature P100 MatNet pick (3-class menu) -> bench the
    CUSP/cuSPARSE/NSPARSE-slot algorithms under the GPU tree's 20x size
    guards -> report."""
    import os as _os

    from ia_spgemm_tpu.cli.main import main
    from ia_spgemm_tpu.models import weights as w
    if not _os.path.exists(_os.path.join(w.LOCAL_WEIGHTS_DIR,
                                         "P100_matnet.npz")):
        import pytest as _pytest
        _pytest.skip("P100 weights not present")
    path = fixtures.mtx_file(tmp_path, "general_real")
    out_json = tmp_path / "gpu_report.json"
    imgs = tmp_path / "imgs"
    rc = main([path, "--profile", "gpu", "--mode", "all", "--iters", "1",
               "--json", str(out_json), "--imgs-dir", str(imgs)])
    assert rc == 0
    out = capsys.readouterr().out
    # MatNet ran with the 3-class P100 head and picked from the GPU menu
    assert "MatNet prediction" in out
    cls = int(out.split("MatNet prediction: class ")[1].split(" ")[0])
    assert 0 <= cls < 3
    assert (imgs / "img1.txt").exists() and (imgs / "img2.txt").exists()
    rep = json.loads(out_json.read_text())
    names = [r["name"] for r in rep["results"]]
    # the GPU menu: vendor baseline + CUSP(coo) + cuSPARSE(csr) +
    # NSPARSE-slot(bitonic) — and nothing from the CPU-only sweep
    assert names == ["baseline", "coo", "csr", "bitonic"]
    assert all(r["ok"] for r in rep["results"]), rep["results"]
    assert rep["matrix_b"] == path  # B came from A (transposed), not a file


def test_gpu_profile_guard_ratio():
    """--profile gpu threads the 20x guard (GPU detail/dia/common_dia.h:51)
    into the harness config: a format whose footprint lands between 20x
    and 50x CSR bytes is viable under the CPU profile, skipped under the
    GPU one."""
    from ia_spgemm_tpu import config as cfg
    from ia_spgemm_tpu.formats import convert
    # one dense row + scattered singletons: ELL width = m pushes the
    # padded footprint far past CSR's
    import scipy.sparse as sp
    m = 64
    rows = np.concatenate([np.zeros(m, np.int64), np.arange(m)])
    cols = np.concatenate([np.arange(m), np.arange(m)])
    a = sp.coo_matrix((np.ones(2 * m, np.float64), (rows, cols)),
                      shape=(m, m)).tocsr()
    a.sum_duplicates()
    A = CSR.from_scipy(a)
    ka = convert.plan_ell_width(A)
    ratio = convert.sizeof_ell(m, ka) / convert.sizeof_csr(m, int(A.nnz))
    assert cfg.SIZE_GUARD_RATIO_GPU < ratio < cfg.SIZE_GUARD_RATIO_CPU
    assert convert.csr_to_ell(A) is not None  # CPU 50x: viable
    assert convert.csr_to_ell(
        A, ratio=cfg.SIZE_GUARD_RATIO_GPU) is None  # GPU 20x: rejected


def test_cli_shape_mismatch(tmp_path):
    from ia_spgemm_tpu.cli.main import main
    pa = fixtures.mtx_file(tmp_path, "rect_real")        # 6x4
    pb = fixtures.mtx_file(tmp_path, "integer_general")  # 4x3 — ok
    assert main([pa, pb, "--mode", "csr", "--no-matnet", "--iters", "1"]) == 0
    pc = fixtures.mtx_file(tmp_path, "pattern_general")  # 3x7 — mismatch
    assert main([pc, pa, "--no-matnet"]) == 2


def test_autotune_spgemm_matches_oracle():
    from ia_spgemm_tpu import autotune
    a = fixtures.banded_csr(16, bandwidth=1, seed=42)
    A = CSR.from_scipy(a)
    try:
        C, sel = autotune.spgemm_auto(A, A)
    except FileNotFoundError:
        pytest.skip("weights unavailable")
    want = (a @ a).tocsr()
    got = C.to_scipy()
    assert abs(got - want).max() < 1e-10
    assert sel.algorithm in ("baseline", "csr", "dia", "ell", "coo")


def test_scaling_report_shape():
    """Ring scaling harness: points + efficiency bookkeeping (2 devices)."""
    import jax
    if len(jax.devices()) < 2:
        import pytest as _pytest
        _pytest.skip("needs 2 devices")
    from ia_spgemm_tpu.bench import scaling
    from tests import fixtures
    a = fixtures.random_csr(64, 64, density=0.1, seed=90)
    A = CSR.from_scipy(a.astype("float32"))
    pts = scaling.measure_ring_scaling(A, device_counts=(1, 2), iters=1)
    assert len(pts) == 2
    assert pts[0].efficiency == 1.0
    assert pts[1].devices == 2 and pts[1].nnz_out == pts[0].nnz_out
    rep = scaling.report(pts)
    assert rep["metric"] == "ring_spgemm_scaling"
    assert len(rep["points"]) == 2


def test_serve_route_first_class():
    """The bf16 serving lane is a selectable harness route with
    its own documented checksum bound (SERVE_CHECKSUM_TOL), not just a
    bench side-metric."""
    a = fixtures.banded_csr(64, bandwidth=2, seed=77)
    A = CSR.from_scipy(a.astype("float32"))
    rep = harness.run_benchmark(A, A, ("baseline", "serve"), iters=1)
    serve = rep.by_name("serve")
    assert serve.ok and not serve.error, (serve.error, serve.skipped)
    base = rep.by_name("baseline")
    rel = abs(serve.verified_sum - base.verified_sum) / max(
        1.0, abs(base.verified_sum))
    assert rel <= harness.SERVE_CHECKSUM_TOL


def test_serve_route_skips_when_unviable():
    """fp64 input (no bf16 pack path) must skip, not error, and say
    why."""
    a = fixtures.banded_csr(32, bandwidth=1, seed=78)
    A = CSR.from_scipy(a.astype("float64"))
    rep = harness.run_benchmark(A, A, ("baseline", "serve"), iters=1)
    serve = rep.by_name("serve")
    assert serve.skipped and not serve.ok
    assert "float32" in serve.skip_reason


def test_esc_slab_engine_routes():
    """spgemm_csr engine='slab' routes f32 problems through the slab
    engine (ops/slab.py) + flattener and engine='global' (the default)
    keeps the global sort; both match the oracle."""
    from ia_spgemm_tpu.ops import esc, slab
    a = fixtures.random_csr(128, 128, density=0.06, seed=79)
    A = CSR.from_scipy(a.astype("float32"))
    assert slab.plan_slab_csr(A, A) is not None
    want = (a @ a).tocsr()
    for engine in ("slab", "global"):
        C = esc.spgemm_csr(A, A, engine=engine)
        d = abs(C.to_scipy().astype("float64") - want)
        assert (d.max() if d.nnz else 0.0) < 1e-4


def test_dist_scaling_measured():
    """Measured dist-route scaling decomposition: per-shard standalone
    timings (real load balance), mesh-serialized check, modeled wire kept
    separate from the measured numbers."""
    import jax
    if len(jax.devices()) < 2:
        import pytest as _pytest
        _pytest.skip("needs 2 devices")
    from ia_spgemm_tpu.bench import scaling
    from tests import fixtures
    a = fixtures.random_csr(96, 96, density=0.08, seed=91)
    A = CSR.from_scipy(a.astype("float32"))
    rep = scaling.measure_dist_scaling(A, device_counts=(1, 2), iters=1)
    assert rep["metric"] == "dist_spgemm_scaling"
    assert len(rep["points"]) == 2
    p1, p2 = rep["points"]
    assert p1["devices"] == 1 and p2["devices"] == 2
    assert len(p2["per_shard_ms"]) == 2
    # same result every way it's computed
    assert p1["nnz_out"] == p2["nnz_out"] == int((a @ a).nnz)
    assert p1["efficiency_measured_compute"] == 1.0
    assert 0.0 < p2["efficiency_measured_compute"] <= 1.5
    # the wire is modeled, reported apart, and nonzero at D=2
    assert p2["comm_bytes_per_link"] > 0
    assert p2["comm_ms_modeled_per_device"] >= 0.0


def test_profiling_time_op():
    from ia_spgemm_tpu.bench import profiling
    import jax.numpy as jnp
    r = profiling.time_op(lambda x: x + 1, jnp.zeros(16), iters=2)
    assert r["median_ms"] >= 0 and r["iters"] == 2


def test_harness_bitonic_ragged_bskew():
    """A B-skewed matrix (flat + chunked class plans inviable) must still
    run the bitonic algorithm through the ragged-fragment probe, not be
    skipped."""
    import numpy as np
    import scipy.sparse as sp
    rng = np.random.default_rng(17)
    m = 512
    rows, cols, vals = [], [], []
    for r in range(m):
        ln = 400 if r % 128 == 0 else int(rng.integers(1, 4))
        cs = rng.choice(m, size=ln, replace=False)
        for c in cs:
            rows.append(r)
            cols.append(int(c))
            vals.append(float(rng.standard_normal()))
    a = sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsr()
    A = CSR.from_scipy(a.astype(np.float32))
    from ia_spgemm_tpu.formats import convert as _conv
    from ia_spgemm_tpu.ops import bitonic as bt
    assert not bt.plan_bitonic_dims(
        m, int(np.diff(np.asarray(A.row_ptr)).max()),
        _conv.plan_ell_width(A)).viable
    from ia_spgemm_tpu import config as _cfg
    slow_ok = _cfg.SpGEMMConfig(timeout_scale=1e6)  # CPU compiles are slow
    rep = harness.run_benchmark(A, A, ("baseline", "bitonic"), iters=1,
                                config=slow_ok)
    r = rep.by_name("bitonic")
    assert not r.skipped and r.ok, (r.skipped, r.error, r.timed_out)
    base = rep.by_name("baseline")
    assert abs(r.verified_sum - base.verified_sum) <= 1e-4 * max(
        1.0, abs(base.verified_sum))


def test_harness_csr_tiled_route():
    """The csr algorithm takes the tiled width-class route on a viable
    f32 input: result verifies vs baseline and memory reports the
    BlockCSR padded footprint."""
    import scipy.sparse as sp
    from ia_spgemm_tpu.bench import harness
    from ia_spgemm_tpu.formats.types import CSR
    rng = np.random.default_rng(41)
    m = 160
    a = sp.random(m, m, density=0.06, random_state=41, format="csr")
    A = CSR.from_scipy(a.astype(np.float32))
    rep = harness.run_benchmark(A, A, ("baseline", "csr"), iters=1)
    res = {r.name: r for r in rep.results}
    assert res["csr"].ok
    base = res["baseline"].verified_sum
    assert abs(res["csr"].verified_sum - base) <= 1e-4 * max(1.0, abs(base))
    # padded BlockCSR bytes: at least nnz * 8 and a multiple of row
    # block alignment is reflected (>= exact CSR bytes)
    from ia_spgemm_tpu.formats import convert
    c_nnz = (a @ a).nnz
    assert res["csr"].memory_bytes >= convert.sizeof_csr(m, c_nnz) - 4 * (m + 1)


def test_dense_routes_skip_past_hbm_budget(monkeypatch):
    """dense/dense_row materialize (m, n) arrays; past the memory budget
    the guard must skip them (a 65536^2 densify is an out-of-memory
    error), like every other format's viability guard."""
    import dataclasses

    from ia_spgemm_tpu import config as cfg

    a = fixtures.banded_csr(64, bandwidth=2, seed=42)
    A = CSR.from_scipy(a)
    tiny = dataclasses.replace(cfg.DEFAULT_CONFIG, dense_bytes_budget=64)
    rep = harness.run_benchmark(A, A, ("baseline", "dense", "dense_row"),
                                iters=1, config=tiny)
    names = {r.name: r for r in rep.results}
    assert names["dense"].skipped and not names["dense"].error
    assert names["dense_row"].skipped and not names["dense_row"].error
    # and with the real budget this size runs
    rep2 = harness.run_benchmark(A, A, ("baseline", "dense", "dense_row"),
                                 iters=1)
    names2 = {r.name: r for r in rep2.results}
    assert names2["dense"].ok and names2["dense_row"].ok
