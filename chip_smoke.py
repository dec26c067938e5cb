"""Chip smoke test: the SpGEMM main path once, on one GPU, at a real size.

    python chip_smoke.py [--seed N] [--m-log2 19]
    python chip_smoke.py --four-cards [--seed N]

Builds A = bench.build_matrix(m=2**19) from --seed (~8.9M nnz, ~1.5e8
intermediate products, ~1.1e8 output nonzeros; (m+1)(n+1) >= 2^31, so
the global sort takes its two-key path) and runs, in one process:

  1. cli       the CLI's `--mode all` sweep on A written as .mtx: every
               non-skipped algorithm ok and checksum-clean against the
               scipy baseline row, the MatNet verdict printed;
  2. engines   each CSR engine forced in turn (global, tiled, slab,
               hybrid), the cost-model route and autotune.spgemm_auto,
               each result converted to CSR and compared with scipy:
               structure equal to the float64 product's, and per entry
               |c - c_ref| <= 1e-5 * (|A|.|B|)_ij;
  3. rowsort   sort_compress_rows at the widths the tiled and slab
               planners chose, against a numpy reference;
  4. precision the compensated (double-double) engine at m=2**15 against
               float64 scipy at its per-entry bound, on the cancelling
               input (tests/fixtures.cancelling_csr) at its normwise
               bound, and the bf16 serve lane at its 2e-2 checksum bound;
  5. matnet    MatNet with each shipped weight set on A's density images
               against the numpy oracle (tests/matnet_oracle.py).

--four-cards runs only the multi-device path at m=2**20 on four GPUs:
dist_spgemm (replicated and all-gathered B) and ring_spgemm, each
gathered by its library gather_result and compared with the one-card
spgemm_csr_auto result and with scipy, then the CLI's `--mode ring`.

The last stdout line is one JSON object {"ok": true, "device": {...}}.
Without a GPU, or when any phase fails, the script exits non-zero and
prints no such line.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# per-entry tolerance of f32 results, relative to (|A|.|B|)_ij
F32_RTOL = 1e-5
# compensated results: ~2^-48 relative double-double sums plus the
# float64 reference's own rounding, relative to (|A|.|B|)_ij
DD_RTOL = 2.0 ** -46
# compensated results on the cancelling input: max |c - c_ref| over
# max(1, max |c_ref|), the lane's stated 3e-15
DD_NORMWISE_TOL = 3e-15


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def block(x):
    import jax
    return jax.block_until_ready(x)


def timed(call, runs=3):
    """(result, first-call seconds incl. compile, median steady ms)."""
    t0 = time.perf_counter()
    out = block(call())
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        block(call())
        times.append((time.perf_counter() - t0) * 1e3)
    return out, first_s, float(np.median(times))


def references(a32):
    """(C, |A|.|B|) in float64 by scipy, from the f32-rounded operand."""
    a64 = a32.astype(np.float64).tocsr()
    ref = (a64 @ a64).tocsr()
    absref = (abs(a64) @ abs(a64)).tocsr()
    for m in (ref, absref):
        m.sum_duplicates()
        m.sort_indices()
    return ref, absref


def compare(got, ref, absref, rtol):
    """Structure equal to the product's (every (i, j) some product
    touches — explicit zeros from cancellation included), and per-entry
    |got - ref| <= rtol * (|A|.|B|)_ij. Returns the largest ratio."""
    got = got.tocsr().astype(np.float64)
    got.sum_duplicates()
    got.sort_indices()
    check(got.shape == absref.shape, f"shape {got.shape} != {absref.shape}")
    check(got.nnz == absref.nnz
          and np.array_equal(got.indptr, absref.indptr)
          and np.array_equal(got.indices, absref.indices),
          f"structure differs: nnz {got.nnz} vs {absref.nnz}")
    d = abs(got - ref).tocsr()
    ratio = d.multiply(absref.power(-1)).tocsr()
    err = float(ratio.max()) if ratio.nnz else 0.0
    check(err <= rtol, f"entry error {err:.3g} x (|A|.|B|) > {rtol:.3g}")
    return err


def write_matrix(a32, work_dir):
    from ia_spgemm_tpu.formats.types import CSR
    from ia_spgemm_tpu.io import mmio
    os.makedirs(work_dir, exist_ok=True)
    path = os.path.join(work_dir, f"smoke_{a32.shape[0]}.mtx")
    mmio.write_mtx(path, CSR.from_scipy(a32))
    return path


# --------------------------------------------------------------------------
# phases (each returns a dict of what it measured; raises on failure)
# --------------------------------------------------------------------------

def phase_cli(a32, work_dir):
    from ia_spgemm_tpu.cli.main import main as cli_main
    path = write_matrix(a32, work_dir)
    out_json = os.path.join(work_dir, "cli_report.json")
    t0 = time.perf_counter()
    rc = cli_main([path, "--mode", "all", "--iters", "1",
                   "--json", out_json])
    wall = time.perf_counter() - t0
    os.remove(path)
    check(rc == 0, f"CLI exited {rc}")
    with open(out_json) as f:
        rep = json.load(f)
    check(rep["matnet_pick"], "no MatNet verdict")
    res = {r["name"]: r for r in rep["results"]}
    check(res["baseline"]["ok"], "scipy baseline failed")
    base = res["baseline"]["verified_sum"]
    summary = {}
    for name, r in res.items():
        if r["skipped"]:
            summary[name] = f"skipped ({r['skip_reason']})"
            continue
        check(r["ok"] and not r["error"],
              f"{name}: ok={r['ok']} error={r['error']!r}")
        rel = abs(r["verified_sum"] - base) / max(1.0, abs(base))
        summary[name] = {"run_ms": r["run_time_ms"], "sum_rel_err": rel}
    m, n = a32.shape
    if (m + 1) * (n + 1) >= 2**31:
        comp = res["compensated"]
        check(comp["skipped"] and "2^31" in comp["skip_reason"],
              f"compensated not skipped for m*n >= 2^31: {comp}")
    return {"wall_s": wall, "winner": rep["winner"],
            "matnet_pick": rep["matnet_pick"], "algorithms": summary}


def engine_calls(A):
    """(name, zero-arg runner or None) for every CSR engine, forced."""
    from ia_spgemm_tpu.ops import esc
    from ia_spgemm_tpu.ops import slab as slab_mod
    calls = [("global", esc.plan_csr_engine(A, A, "global")),
             ("tiled", esc.plan_csr_engine(A, A, "tiled"))]
    calls.append(("slab", esc.plan_csr_engine(A, A, "slab")))
    # the default slab cap leaves no heavy rows on near-uniform inputs;
    # a lower cap makes the hybrid split this matrix
    hybrid = None
    for cap in (slab_mod.SLAB_MIN_WIDTH, 256, 128):
        hybrid = slab_mod.plan_slab_hybrid(A, A, max_width=cap)
        if hybrid is not None:
            break
    calls.append(("hybrid", hybrid))
    route, auto = esc.plan_csr_auto(A, A)
    calls.append((f"auto:{route}", auto))
    return calls


def phase_engines(A, ref, absref):
    from ia_spgemm_tpu import autotune
    out = {}
    widths = {}
    for name, call in engine_calls(A):
        check(call is not None, f"engine {name} not viable")
        C, first_s, ms = timed(call)
        err = compare(autotune._as_csr(C).to_scipy(), ref, absref, F32_RTOL)
        out[name] = {"first_call_s": first_s, "steady_ms": ms,
                     "nnz": int(C.nnz), "max_err": err}
        if name == "tiled":
            widths["tiled"] = list(call.widths)
        elif name == "slab":
            widths["slab"] = [call.plan.width]
        log(f"  engine {name}: first call {first_s:.2f} s, steady "
            f"{ms:.3f} ms, nnz {int(C.nnz)}, max err {err:.3g} x |A||B|")
    t0 = time.perf_counter()
    C, sel = autotune.spgemm_auto(A, A)
    first_s = time.perf_counter() - t0
    err = compare(C.to_scipy(), ref, absref, F32_RTOL)
    out["spgemm_auto"] = {"algorithm": sel.algorithm, "first_call_s": first_s,
                          "max_err": err}
    log(f"  spgemm_auto -> {sel.algorithm}: {first_s:.2f} s, max err "
        f"{err:.3g} x |A||B|")
    return out, widths


def rowsort_reference(key, val):
    """numpy: per-row sorted unique keys (SENTINEL excluded), float64 sums
    and sums of magnitudes, left-justified like sort_compress_rows."""
    from ia_spgemm_tpu.ops.rowsort import SENTINEL
    R, W = key.shape
    rows = np.repeat(np.arange(R, dtype=np.int64), W)
    k = key.reshape(-1).astype(np.int64)
    v = val.reshape(-1).astype(np.float64)
    live = k != SENTINEL
    flat = rows[live] * (int(SENTINEL) + 1) + k[live]
    uniq, inv = np.unique(flat, return_inverse=True)
    sums = np.bincount(inv, weights=v[live], minlength=len(uniq))
    mags = np.bincount(inv, weights=np.abs(v[live]), minlength=len(uniq))
    urow = uniq // (int(SENTINEL) + 1)
    count = np.bincount(urow, minlength=R)
    rank = np.arange(len(uniq)) - np.repeat(np.cumsum(count) - count, count)
    col = np.full((R, W), -1, np.int64)
    s = np.zeros((R, W))
    g = np.zeros((R, W))
    col[urow, rank] = uniq % (int(SENTINEL) + 1)
    s[urow, rank] = sums
    g[urow, rank] = mags
    return col, s, g, count


def phase_rowsort(widths, seed, rows=8192):
    import jax.numpy as jnp
    from ia_spgemm_tpu.ops.rowsort import SENTINEL, sort_compress_rows
    rng = np.random.default_rng(seed)
    out = {}
    for W in sorted({w for ws in widths.values() for w in ws}):
        key = rng.integers(0, max(W // 2, 1), (rows, W)).astype(np.int32)
        key[rng.random((rows, W)) < 0.1] = SENTINEL
        val = rng.standard_normal((rows, W)).astype(np.float32)
        t0 = time.perf_counter()
        col, v, nnz = block(sort_compress_rows(
            jnp.asarray(key), jnp.asarray(val), out_width=W))
        wall = time.perf_counter() - t0
        want_col, want_v, mags, want_nnz = rowsort_reference(key, val)
        check(np.array_equal(np.asarray(nnz), want_nnz),
              f"W={W}: per-row counts differ")
        check(np.array_equal(np.asarray(col), want_col),
              f"W={W}: keys differ")
        err = np.abs(np.asarray(v, np.float64) - want_v)
        bound = 1e-6 * np.maximum(np.abs(want_v), mags)
        check((err <= bound).all(),
              f"W={W}: values off by {float((err / np.maximum(bound, 1e-300)).max()):.3g}x rtol 1e-6")
        out[W] = {"rows": rows, "wall_s": wall}
        log(f"  sort_compress_rows W={W}: {rows} rows, {wall:.3f} s, "
            "keys exact, values within 1e-6")
    return out


def phase_precision(a15):
    from ia_spgemm_tpu.bench import harness
    from ia_spgemm_tpu.formats.types import CSR
    from ia_spgemm_tpu.ops import esc
    from tests.fixtures import cancelling_csr
    A = CSR.from_scipy(a15)
    ref, absref = references(a15)
    out = {}
    for engine in ("auto", "global"):
        C, first_s, ms = timed(
            lambda e=engine: esc.spgemm_csr_compensated(A, A, engine=e))
        err = compare(C.to_scipy(), ref, absref, DD_RTOL)
        out[f"compensated_{engine}"] = {
            "first_call_s": first_s, "steady_ms": ms, "max_err": err,
            "bound": DD_RTOL, "result": type(C).__name__}
        log(f"  compensated ({engine} -> {type(C).__name__}): max err "
            f"{err:.3g} x |A||B| (bound {DD_RTOL:.3g}), steady {ms:.3f} ms")
    for m in (64, a15.shape[0]):
        ac = cancelling_csr(m).astype(np.float32)
        cref, cabs = references(ac)
        Ac = CSR.from_scipy(ac)
        for engine in ("auto", "global"):
            got = esc.spgemm_csr_compensated(Ac, Ac, engine=engine)
            got = got.to_scipy().tocsr().astype(np.float64)
            err = compare(got, cref, cabs, DD_RTOL)
            d = abs(got - cref)
            norm = (d.max() if d.nnz else 0.0) / max(1.0, abs(cref).max())
            check(norm <= DD_NORMWISE_TOL,
                  f"cancelling m={m} {engine}: normwise {norm:.3g} > "
                  f"{DD_NORMWISE_TOL:.3g}")
            out[f"cancelling_{m}_{engine}"] = {
                "normwise_err": norm, "bound": DD_NORMWISE_TOL,
                "max_err": err}
            log(f"  compensated ({engine}), cancelling m={m}: normwise "
                f"{norm:.3g} (bound {DD_NORMWISE_TOL:.3g}), max err "
                f"{err:.3g} x |A||B|")
    rep = harness.run_benchmark(A, A, ("baseline", "serve"), iters=1)
    serve, base = rep.by_name("serve"), rep.by_name("baseline")
    check(serve.ok and not serve.error,
          f"serve: ok={serve.ok} skipped={serve.skip_reason!r} "
          f"error={serve.error!r}")
    rel = abs(serve.verified_sum - base.verified_sum) / max(
        1.0, abs(base.verified_sum))
    check(rel <= harness.SERVE_CHECKSUM_TOL, f"serve checksum {rel:.3g}")
    out["serve"] = {"checksum_rel_err": rel,
                    "bound": harness.SERVE_CHECKSUM_TOL,
                    "run_ms": serve.run_time_ms}
    log(f"  serve: checksum rel err {rel:.3g} (bound "
        f"{harness.SERVE_CHECKSUM_TOL}), {serve.run_time_ms:.3f} ms")
    return out


def phase_matnet(A):
    from ia_spgemm_tpu.models import matnet, weights
    from ia_spgemm_tpu.ops import density, features
    from tests import matnet_oracle
    img = np.asarray(density.density_image_normalized(A), np.float64)
    fv = np.asarray(features.feature_vector(A, A), np.float64)
    out = {}
    for name in ("Intel", "Amd", "P100"):
        params, arch = weights.import_reference_weights(name)
        nf = arch["num_features"]
        f = fv[:nf] if len(fv) >= nf else np.pad(fv, (0, nf - len(fv)))
        got = np.asarray(matnet.predict_logits(params, img, img, f, **arch),
                         np.float64)
        want = matnet_oracle.forward(params, img, img, f)
        err = float(np.max(np.abs(got - want) / np.maximum(
            np.abs(want), 1e-6 * np.abs(want).max())))
        check(int(np.argmax(got)) == int(np.argmax(want)),
              f"{name}: argmax {np.argmax(got)} != {np.argmax(want)}")
        check(np.allclose(got, want, rtol=1e-4,
                          atol=1e-4 * np.abs(want).max()),
              f"{name}: logits differ, rel {err:.3g}")
        out[name] = {"argmax": int(np.argmax(got)), "max_rel_err": err}
        log(f"  matnet {name}: argmax {int(np.argmax(got))}, max rel "
            f"err {err:.3g}")
    return out


def phase_four_cards(a32, ref, absref, work_dir):
    """dist_spgemm (replicated and all-gathered B) and ring_spgemm over a
    4-device mesh, each gathered by its library gather_result and checked
    against scipy and the one-card result; then the CLI's --mode ring."""
    import jax
    from ia_spgemm_tpu import autotune
    from ia_spgemm_tpu.cli.main import main as cli_main
    from ia_spgemm_tpu.formats import convert
    from ia_spgemm_tpu.formats.types import CSR
    from ia_spgemm_tpu.ops import esc
    from ia_spgemm_tpu.parallel import distributed as dist
    from ia_spgemm_tpu.parallel import ring
    from ia_spgemm_tpu.parallel.mesh import make_mesh
    D = 4
    check(len(jax.devices()) >= D, f"{len(jax.devices())} devices < {D}")
    A = CSR.from_scipy(a32)
    route, call = esc.plan_csr_auto(A, A)
    C1, first_s, ms = timed(call)
    one_sp = autotune._as_csr(C1).to_scipy()
    del C1
    err = compare(one_sp, ref, absref, F32_RTOL)
    out = {"one_card": {"route": route, "first_call_s": first_s,
                        "steady_ms": ms, "max_err": err}}
    log(f"  one card ({route}): first call {first_s:.2f} s, steady "
        f"{ms:.3f} ms, max err {err:.3g}")
    mesh = make_mesh(D)
    e_cap, out_cap = dist.plan_dist_spgemm(A, A, D, balance="flops")
    As = dist.partition_rows(A, D, balance="flops", B=A, mesh=mesh)
    Bs = dist.partition_rows(A, D, mesh=mesh)
    runs = {
        "dist_replicated_B": (lambda: dist.dist_spgemm(
            As, A, mesh, e_cap=e_cap, out_cap=out_cap), dist.gather_result),
        "dist_allgather_B": (lambda: dist.dist_spgemm(
            As, Bs, mesh, e_cap=e_cap, out_cap=out_cap), dist.gather_result),
    }
    A_ell = convert.csr_to_ell(A, check_guard=False)
    plan = ring.plan_ring(A_ell, A_ell, D)
    check(plan.viable, f"ring plan: {plan.reason}")
    Ae = ring.partition_rows_ell(A_ell, D, mesh=mesh)
    runs["ring"] = (lambda: ring.ring_spgemm(Ae, Ae, mesh, plan),
                    ring.gather_result)
    for name, (call, gather) in runs.items():
        C, first_s, ms = timed(call)
        ndev = len(C.values.sharding.device_set)
        check(ndev == D, f"{name}: result on {ndev} devices, not {D}")
        got = gather(C).to_scipy()
        del C
        err = compare(got, ref, absref, F32_RTOL)
        vs_one = compare(got, one_sp, absref, F32_RTOL)
        out[name] = {"first_call_s": first_s, "steady_ms": ms,
                     "devices": ndev, "max_err": err,
                     "max_err_vs_one_card": vs_one}
        log(f"  {name}: {ndev} devices, first call {first_s:.2f} s, "
            f"steady {ms:.3f} ms, max err {err:.3g} (scipy), "
            f"{vs_one:.3g} (one card)")
    del As, Bs, Ae, A_ell
    path = write_matrix(a32, work_dir)
    out_json = os.path.join(work_dir, "cli_ring.json")
    t0 = time.perf_counter()
    rc = cli_main([path, "--mode", "ring", "--shards", str(D),
                   "--no-matnet", "--iters", "1", "--json", out_json])
    wall = time.perf_counter() - t0
    os.remove(path)
    check(rc == 0, f"CLI --mode ring exited {rc}")
    with open(out_json) as f:
        rep = json.load(f)
    check(rep["nnz_out"] == absref.nnz,
          f"CLI ring nnz {rep['nnz_out']} != {absref.nnz}")
    out["cli_ring"] = {"wall_s": wall, "run_ms": rep["run_time_ms"],
                       "checksum_rel_err": rep["checksum_rel_err"]}
    log(f"  cli --mode ring: {wall:.1f} s, run {rep['run_time_ms']:.3f} ms, "
        f"checksum rel err {rep['checksum_rel_err']:.3g}")
    return out


# --------------------------------------------------------------------------

def run_phase(name, results, fn, *args):
    log(f"phase {name}:")
    t0 = time.perf_counter()
    out = fn(*args)
    results[name] = out
    log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--m-log2", type=int, default=None,
                    help="matrix rows as a power of two (default 19; 20 "
                         "with --four-cards)")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-device dist/ring path")
    ap.add_argument("--work-dir", default=os.path.join(HERE, ".chip_smoke"))
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform} devices",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from bench import build_matrix
    from ia_spgemm_tpu.cli.main import (
        compilation_cache_dir,
        enable_compilation_cache,
    )
    from ia_spgemm_tpu.formats.types import CSR
    from ia_spgemm_tpu.ops import esc
    from ia_spgemm_tpu.ops.flops import get_flop

    log(card_line())
    log(f"jax {jax.__version__}, {len(devices)} x {devices[0].device_kind}")
    enable_compilation_cache()
    log(f"compile cache: {compilation_cache_dir()}")
    results = {}
    m = 1 << (args.m_log2 or (20 if args.four_cards else 19))
    t0 = time.perf_counter()
    a32 = build_matrix(m=m, seed=args.seed).astype(np.float32)
    ref, absref = references(a32)
    A = CSR.from_scipy(a32)
    log(f"A: {m}x{m}, nnz {a32.nnz}, products {get_flop(A, A)}, "
        f"nnz(C) {absref.nnz} (set-up {time.perf_counter() - t0:.1f} s)")
    if args.four_cards:
        run_phase("four_cards", results, phase_four_cards, a32, ref, absref,
                  args.work_dir)
    else:
        plan = esc.plan_spgemm(A, A)
        lowered = esc._esc_core.lower(
            esc.entry_rows(A.row_ptr, A.capacity), A.col_ind, A.values,
            A.nnz, A.row_ptr, A.col_ind, A.values,
            e_cap=plan.expansion_capacity, out_cap=plan.out_capacity,
            m=A.nrows, k=A.ncols, n=A.ncols)
        log(f"memory_analysis (global ESC core, {plan.flops} products): "
            f"{lowered.compile().memory_analysis()}")
        run_phase("cli", results, phase_cli, a32, args.work_dir)
        _, widths = run_phase("engines", results, phase_engines, A, ref,
                              absref)
        run_phase("rowsort", results, phase_rowsort, widths, args.seed)
        a15 = build_matrix(m=1 << 15, seed=args.seed).astype(np.float32)
        run_phase("precision", results, phase_precision, a15)
        run_phase("matnet", results, phase_matnet, A)
    shutil.rmtree(args.work_dir, ignore_errors=True)
    log(json.dumps({"results": results}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
