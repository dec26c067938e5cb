"""Headline benchmark — prints ONE JSON line.

Workload: single-precision CSR SpGEMM C = A @ A (the reference's default
workload, README.md:10) on a synthetic banded+random matrix, on one
device. Like the reference driver (main.cpp:709-952), it RUNS EVERY
candidate CSR engine (ops/esc.py CSR_ENGINES) and reports the fastest.

metric:      SpGEMM GFLOPS (2 * intermediate_products / time, the
             reference's formula, main.cpp:989), at the pipelined wall
             (back-to-back calls, one sync)
vs_baseline: speedup over scipy.sparse CSR@CSR on the host — the same
             vendor-library role MKL plays for the reference driver
             (main.cpp:968-979; reference publishes no absolute numbers,
             BASELINE.md).

Usage: python bench.py (IA_SPGEMM_BENCH_SMOKE=1 runs a 256-row smoke
size). The roofline needs the device's peaks (bench/roofline.py); a
device missing from that table is an error, and on the CPU backend the
roofline is null.
"""

import json
import os
import time

import numpy as np


def build_matrix(m=32768, band=4, extra_per_row=8, seed=0):
    """Banded + random off-band entries: structured and unstructured nnz,
    like the SuiteSparse mixes the reference targets."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    diags = [rng.standard_normal(m) for _ in range(2 * band + 1)]
    a = sp.diags(diags, list(range(-band, band + 1)),
                 shape=(m, m), format="coo")
    nnz_extra = m * extra_per_row
    rows = rng.integers(0, m, nnz_extra)
    cols = rng.integers(0, m, nnz_extra)
    vals = rng.standard_normal(nnz_extra)
    b = sp.coo_matrix((vals, (rows, cols)), shape=(m, m))
    out = (a + b).tocsr()
    out.sum_duplicates()
    return out


def main():
    import jax

    from ia_spgemm_tpu.bench import profiling, roofline
    from ia_spgemm_tpu.cli.main import enable_compilation_cache
    from ia_spgemm_tpu.formats.types import CSR
    from ia_spgemm_tpu.ops import esc
    from ia_spgemm_tpu.ops.flops import get_flop

    enable_compilation_cache()
    smoke = os.environ.get("IA_SPGEMM_BENCH_SMOKE") == "1"
    a = build_matrix(m=256) if smoke else build_matrix()
    A = CSR.from_scipy(a.astype(np.float32))
    flops = get_flop(A, A)

    # --- baseline: scipy CSR @ CSR on the host (vendor-library role) ---
    c_ref = a @ a
    scipy_times = []
    for _ in range(5):
        t0 = time.perf_counter()
        a @ a
        scipy_times.append((time.perf_counter() - t0) * 1e3)
    scipy_ms = float(np.median(scipy_times))
    ref_sum = float(c_ref.sum())
    # engine-independent traffic floor of this product
    cost = roofline.cost_esc(flops, int(A.nnz), int(A.nnz), int(c_ref.nnz))

    routes = {}
    plan_seconds = {}
    for engine in esc.CSR_ENGINES:
        t0 = time.perf_counter()
        call = esc.plan_csr_engine(A, A, engine)
        plan_seconds[engine] = round(time.perf_counter() - t0, 3)
        if call is None:
            continue
        C = profiling.force(call())  # compile + first run
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            profiling.force(call())
            times.append((time.perf_counter() - t0) * 1e3)
        rel = abs(float(C.checksum()) - ref_sum) / max(1.0, abs(ref_sum))
        routes[engine] = {
            "run": call, "nnz": int(C.nnz),
            "wall_ms": float(np.median(times)),
            "device_ms": profiling.device_time_ms(call, chain=8)[
                "device_ms"],
            "checksum_rel_err": rel}

    algorithm = min(routes, key=lambda k: routes[k]["wall_ms"])
    best = routes[algorithm]
    decomp = profiling.wall_decomposition(best["run"], n=4 if smoke else 16)
    pipelined_ms = decomp["pipelined_wall_ms"]
    dev = jax.devices()[0]
    # a device missing from the peaks table raises; the CPU has no roof
    chip = roofline.detect_chip() if dev.platform != "cpu" else None
    result = {
        "metric": "spgemm_gflops",
        "value": 2.0 * flops / (pipelined_ms * 1e6),
        "unit": "GFLOPS",
        "vs_baseline": scipy_ms / pipelined_ms,
        "detail": {
            "algorithm": algorithm,
            "m": A.nrows, "nnz": int(A.nnz),
            "intermediate_products": flops,
            "nnz_out": best["nnz"],
            "ours_ms": pipelined_ms,
            "single_call_wall_ms": best["wall_ms"],
            "wall_decomposition": decomp,
            "plan_seconds": plan_seconds,
            "device_ms": best["device_ms"],
            "scipy_ms": scipy_ms,
            "checksum_rel_err": best["checksum_rel_err"],
            "routes": {k: {"wall_ms": v["wall_ms"],
                           "device_ms": v["device_ms"]}
                       for k, v in routes.items()},
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "roofline": (roofline.analyze(pipelined_ms, cost, chip)
                         if chip is not None else None),
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
