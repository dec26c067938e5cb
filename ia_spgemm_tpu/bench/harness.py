"""Benchmark harness: per-algorithm timing, timeout, memory, checksum,
GFLOPS, speedup, and the MatNet verdict.

Reproduces the reference driver's measurement methodology
(main.cpp:709-1000):
- metrics per algorithm: run_time (ms), trans_time (format conversion, ms),
  memory_size (bytes of C in that format, via the sizeof* formulas),
  verified_sum (sum of C values), GFLOPS = 2*flops/(ms*1e6) with
  flops = GetFlop(A,B) (main.cpp:989), speedup = t_baseline / t_alg
  (main.cpp:968-979).
- timeout: an algorithm is abandoned at timeout_scale x the baseline's
  runtime and reported as failed with 0.0 times (the reference's pthread
  watchdog, main.cpp:43-93,770-793). Here the algorithm runs in a daemon
  worker thread we stop waiting on.
- viability: formats rejected by the 50x size guard are reported as
  skipped (the reference's choice=false, dia/common_dia.h:56).
- correctness: every algorithm's verified_sum is compared against the
  baseline's (the diff the reference computes at main.cpp:825,879,931).

Timing uses time.perf_counter around jax.block_until_ready — compilation is
excluded by a warmup run (the reference times steady-state host code; XLA's
compile step has no reference analogue).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import jax
import numpy as np

from ia_spgemm_tpu import config as cfg
from ia_spgemm_tpu.formats import convert
from ia_spgemm_tpu.formats.types import CSR
from ia_spgemm_tpu.ops import dense as dense_ops
from ia_spgemm_tpu.ops import dia as dia_ops
from ia_spgemm_tpu.ops import ell as ell_ops
from ia_spgemm_tpu.ops import esc
from ia_spgemm_tpu.ops.flops import get_flop

ALGORITHMS = ("baseline", "csr", "dia", "ell", "coo")  # reference menu

# serve-lane checksum gate: bf16-rounded products carry <= 2^-9 relative
# error each (f32 accumulation); the route's verified_sum is compared at
# this documented bound instead of the exact kernels' 1e-4
SERVE_CHECKSUM_TOL = 2e-2

# Budget for XLA compilation + first execution (no reference analogue —
# the watchdog there only ever measures steady-state C++ kernels).
COMPILE_BUDGET_S = 300.0


def csr_to_ell_probe(A: CSR, ratio: float):
    """Guard check without materializing (planner only)."""
    from ia_spgemm_tpu.formats.convert import ell_viable, plan_ell_width
    K = plan_ell_width(A)
    return K if ell_viable(A.nrows, int(A.nnz), K, ratio) else None


def csr_to_dia_probe(A: CSR, ratio: float):
    from ia_spgemm_tpu.formats.convert import dia_viable, plan_dia_offsets
    nd = len(plan_dia_offsets(A))
    return nd if dia_viable(A.nrows, A.ncols, int(A.nnz), nd, ratio) else None


@dataclasses.dataclass
class AlgorithmResult:
    name: str
    ok: bool = False
    skipped: bool = False           # viability guard rejected the format
    timed_out: bool = False
    run_time_ms: float = 0.0
    # device time (chained-dispatch estimate, profiling.device_time_ms)
    # — 0.0 unless the caller asked for device timers. run_time_ms also
    # carries the host's dispatch and sync; selector labels compare this.
    device_time_ms: float = 0.0
    trans_time_ms: float = 0.0
    memory_bytes: float = 0.0       # size of C in this algorithm's format
    verified_sum: float = 0.0
    gflops: float = 0.0
    speedup: float = 0.0
    error: str = ""
    skip_reason: str = ""           # why `skipped` (guard or contract)


@dataclasses.dataclass
class BenchReport:
    matrix_a: str
    matrix_b: str
    shape_a: tuple
    shape_b: tuple
    nnz_a: int
    nnz_b: int
    flops: int
    results: List[AlgorithmResult] = dataclasses.field(default_factory=list)
    winner: str = ""
    matnet_pick: str = ""
    matnet_correct: Optional[bool] = None

    def by_name(self, name: str) -> Optional[AlgorithmResult]:
        for r in self.results:
            if r.name == name:
                return r
        return None


def _time_ms(fn: Callable, warmup: int = 1, iters: int = 3) -> float:
    """Median wall-clock ms of fn() with device sync."""
    from ia_spgemm_tpu.bench.profiling import force
    for _ in range(warmup):
        force(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        force(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _run_with_timeout(fn: Callable, timeout_s: Optional[float]):
    """Run fn in a worker thread; abandon it past timeout (the watchdog)."""
    if timeout_s is None or timeout_s <= 0:
        return fn(), False
    ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    fut = ex.submit(fn)
    try:
        return fut.result(timeout=timeout_s), False
    except concurrent.futures.TimeoutError:
        ex.shutdown(wait=False, cancel_futures=True)
        return None, True
    finally:
        ex.shutdown(wait=False)


def _scipy_baseline(A: CSR, B: CSR):
    """Vendor-library baseline: scipy.sparse CSR x CSR plays the role MKL
    plays in the reference (main.cpp:709-765)."""
    a = A.to_scipy()
    b = B.to_scipy()

    def run():
        return a @ b

    c = run()
    t = _time_ms(run, warmup=0, iters=3)
    return t, float(c.sum()), c.nnz


def run_benchmark(A: CSR, B: CSR,
                  algorithms: Sequence[str] = ALGORITHMS,
                  *,
                  matrix_a: str = "A", matrix_b: str = "B",
                  config: cfg.SpGEMMConfig = cfg.DEFAULT_CONFIG,
                  matnet_pick: Optional[str] = None,
                  iters: int = 3,
                  device_timers: bool = False,
                  isolate: bool = False,
                  isolate_backend: Optional[str] = None,
                  progress=None) -> BenchReport:
    """Benchmark every algorithm computing C = A @ B, reference-style.

    isolate=True runs each non-baseline algorithm in a killable
    subprocess (bench/isolated.py) so a timed-out computation cannot
    occupy the device and poison later timings — the true equivalent of
    the reference's pthread_cancel watchdog (main.cpp:770-775). The
    in-process default is faster but can only abandon, not cancel."""
    flops = get_flop(A, B)
    report = BenchReport(matrix_a=matrix_a, matrix_b=matrix_b,
                         shape_a=A.shape, shape_b=B.shape,
                         nnz_a=int(A.nnz), nnz_b=int(B.nnz), flops=flops)

    baseline_ms: Optional[float] = None
    baseline_sum: Optional[float] = None
    timeout_s: Optional[float] = None

    for name in algorithms:
        if progress is not None:
            progress(name)
        res = AlgorithmResult(name=name)
        report.results.append(res)
        try:
            if name == "baseline":
                ms, vsum, nnz_c = _scipy_baseline(A, B)
                res.ok = True
                res.run_time_ms = ms
                res.verified_sum = vsum
                res.memory_bytes = convert.sizeof_csr(A.nrows, nnz_c)
                baseline_ms, baseline_sum = ms, vsum
                # watchdog budget for everything after the baseline
                # (main.cpp:510,751: 20 x baseline runtime)
                timeout_s = max(config.timeout_scale * ms / 1e3, 5.0)
                continue

            # custom menus without a leading 'baseline' have no
            # 20x-baseline budget — fall back to a fixed wall-clock cap
            # so the watchdog never silently disarms (isolated OR
            # in-process)
            budget_s = timeout_s if timeout_s is not None \
                else config.default_timeout_s
            if isolate:
                from ia_spgemm_tpu.bench.isolated import (
                    bench_algorithm_isolated,
                )
                iso = bench_algorithm_isolated(
                    A, B, name, timeout_s=budget_s, iters=iters,
                    backend=isolate_backend)
                report.results[-1] = iso
                continue
            out = _bench_one(name, A, B, config, budget_s, res, iters,
                             device_timers=device_timers)
            if out is None:
                continue
        except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
            res.error = f"{type(e).__name__}: {e}"
            continue

    # GFLOPS + speedups (main.cpp:968-991)
    for res in report.results:
        if res.ok and res.run_time_ms > 0:
            res.gflops = 2.0 * flops / (res.run_time_ms * 1e6)
            if baseline_ms:
                res.speedup = baseline_ms / res.run_time_ms
    ok = [r for r in report.results if r.ok and r.run_time_ms > 0]
    if ok:
        report.winner = max(ok, key=lambda r: r.speedup or
                            (1.0 / r.run_time_ms)).name
    if baseline_sum is not None:
        # dtype-aware tolerance: the oracle runs in fp64; our kernels run in
        # the matrix's dtype (fp32 unless x64 is enabled).
        tol = 1e-9 if A.dtype == np.float64 else 1e-4
        for res in report.results:
            if res.ok and res.name != "baseline":
                # the serve lane's documented bound: bf16-rounded
                # products (rel <= 2^-9 each, f32 accumulation)
                rtol = SERVE_CHECKSUM_TOL if res.name == "serve" else tol
                # the reference computes these diffs silently; surface big
                # mismatches as errors
                if abs(res.verified_sum - baseline_sum) > rtol * max(
                        1.0, abs(baseline_sum)):
                    res.error = (f"checksum mismatch vs baseline: "
                                 f"{res.verified_sum} != {baseline_sum}")
    if matnet_pick is not None:
        report.matnet_pick = matnet_pick
        report.matnet_correct = (matnet_pick == report.winner)
    return report


def _bench_one(name: str, A: CSR, B: CSR, config: cfg.SpGEMMConfig,
               timeout_s: Optional[float], res: AlgorithmResult, iters: int,
               device_timers: bool = False):
    """Convert (timed after compile), run (timed, under watchdog)."""
    ratio = config.size_guard_ratio

    if name == "csr":
        # production auto route (esc.plan_csr_auto). Planning is setup,
        # reported as trans time like conversions.
        def convert_fn():
            return esc.plan_csr_auto(A, B,
                                     bucket=config.bucket_capacities)

        def compute(ab):
            _route, call = ab
            return call()
    elif name == "esc":
        # the ESC engine (no tiled/width-class route): slab-packed row
        # sort when viable (native SlabCSR out, like bitonic's ELL and
        # the tiled route's BlockCSR), global-sort/sliced otherwise.
        # 'csr' stays the production auto route.
        from ia_spgemm_tpu.ops import slab as slab_mod
        scall = slab_mod.plan_slab_csr(A, B)
        if scall is None:
            # heavy rows past the slab cap: slab + global-sort residual
            scall = slab_mod.plan_slab_hybrid(A, B)
        plan = None if scall is not None else \
            esc.plan_spgemm(A, B, bucket=config.bucket_capacities)
        convert_fn = None

        def compute(ab=(A, B)):
            if scall is not None:
                return scall()
            return esc.spgemm_csr(ab[0], ab[1], plan, engine="global")
    elif name == "compensated":
        # double-double accumulation: fp64-grade sums from f32 operands
        if A.dtype != np.float32:
            res.skipped = True
            res.skip_reason = "compensated path takes float32 operands"
            return None
        if (A.nrows + 1) * (B.ncols + 1) >= 2**31:
            # the fused int32 (row, col) key spgemm_csr_compensated needs
            res.skipped = True
            res.skip_reason = "compensated path needs m*n < 2^31"
            return None
        plan = esc.plan_spgemm(A, B, bucket=config.bucket_capacities)
        if plan.slabs is not None:
            # the compensated engine does not slice — honest skip, the
            # same contract spgemm_csr_compensated enforces by raising
            res.skipped = True
            res.skip_reason = "compensated path does not slice"
            return None
        convert_fn = None

        def compute(ab=(A, B)):
            return esc.spgemm_csr_compensated(ab[0], ab[1], plan)
    elif name == "coo":
        if not convert.coo_viable(A.nrows, int(A.nnz), ratio):
            res.skipped = True
            res.skip_reason = "size guard"
            return None
        plan = esc.plan_spgemm(A, B, bucket=config.bucket_capacities)

        def convert_fn():
            return convert.csr_to_coo(A), convert.csr_to_coo(B)

        def compute(ab):
            return esc.spgemm_coo(ab[0], ab[1], plan)
    elif name == "ell":
        if csr_to_ell_probe(A, ratio) is None or \
                csr_to_ell_probe(B, ratio) is None:
            res.skipped = True
            res.skip_reason = "size guard"
            return None

        def convert_fn():
            return (convert.csr_to_ell(A, check_guard=False),
                    convert.csr_to_ell(B, check_guard=False))

        def compute(ab):
            return ell_ops.spgemm_ell(ab[0], ab[1])
    elif name == "dia":
        nda = csr_to_dia_probe(A, ratio)
        ndb = csr_to_dia_probe(B, ratio)
        if nda is None or ndb is None or \
                not dia_ops.dia_compute_viable(nda, ndb, A.nrows):
            # size guard (reference choice=false) OR compute budget —
            # the sequential pair scan cannot be cancelled once
            # dispatched (see dia.DIA_PAIR_FLOP_BUDGET)
            res.skipped = True
            res.skip_reason = "size guard or pair-scan budget"
            return None

        def convert_fn():
            return (convert.csr_to_dia(A, check_guard=False),
                    convert.csr_to_dia(B, check_guard=False))

        def compute(ab):
            return dia_ops.spgemm_dia(ab[0], ab[1])
    elif name == "dense":
        vb = np.dtype(A.dtype).itemsize
        dense_elems = (A.nrows * A.ncols + B.nrows * B.ncols
                       + A.nrows * B.ncols)
        if dense_elems * vb > config.dense_budget():
            res.skipped = True  # A, B and C all densify — memory guard
            res.skip_reason = "dense budget"
            return None

        def convert_fn():
            return convert.csr_to_dense(A), convert.csr_to_dense(B)

        def compute(ab):
            return dense_ops.spgemm_dense(ab[0], ab[1])
    elif name == "dense_row":
        from ia_spgemm_tpu.ops import dense_row as dr_ops
        vb = np.dtype(A.dtype).itemsize
        dense_elems = B.nrows * B.ncols + A.nrows * B.ncols  # B + C
        if (dense_elems * vb > config.dense_budget()
                or csr_to_ell_probe(A, ratio) is None):
            res.skipped = True
            res.skip_reason = "dense budget or size guard"
            return None

        def convert_fn():
            return (convert.csr_to_ell(A, check_guard=False),
                    convert.csr_to_dense(B))

        def compute(ab):
            return dr_ops.spgemm_dense_row(ab[0], ab[1], config=config)
    elif name == "serve":
        # bf16 serving lane as a FIRST-CLASS route: products round to
        # bfloat16 and pack with their column into one int32 sort key
        # (one array sorts instead of two). ACCURACY BOUND: per-product
        # relative error <= 2^-9 (bf16 round), sums accumulate in f32 —
        # the checksum gate for this route is SERVE_CHECKSUM_TOL, not
        # the 1e-4 exact-kernel gate. nnz/nnz_row/checksum/to_scipy
        # stay structurally exact.
        from ia_spgemm_tpu.formats.convert import plan_ell_width
        from ia_spgemm_tpu.ops import bitonic as bt_ops
        flat_plan = bt_ops.plan_bitonic_dims(A.nrows, plan_ell_width(A),
                                             plan_ell_width(B))
        if (A.dtype != np.float32 or B.ncols > 32768
                or not flat_plan.viable):
            res.skipped = True
            res.skip_reason = ("needs float32 operands, n <= 32768 and a "
                               "viable flat grid")
            return None

        def convert_fn():
            return (convert.csr_to_ell(A, check_guard=False),
                    convert.csr_to_ell(B, check_guard=False))

        def compute(ab):
            return bt_ops.spgemm_bitonic(ab[0], ab[1], flat_plan,
                                         value_mode="bf16")
    elif name == "bitonic":
        from ia_spgemm_tpu.formats.convert import plan_ell_width
        from ia_spgemm_tpu.ops import bitonic as bt_ops
        from ia_spgemm_tpu.ops.flops import row_flops
        flat_plan = bt_ops.plan_bitonic_dims(A.nrows, plan_ell_width(A),
                                             plan_ell_width(B))
        if not (flat_plan.viable
                or bt_ops.multiclass_viable(row_flops(A, B))):
            res.skipped = True
            res.skip_reason = "a row's products exceed the row-grid caps"
            return None

        def convert_fn():
            # planning (class partition) is conversion work and is
            # amortized like any format conversion
            A_ell = convert.csr_to_ell(A, check_guard=False)
            B_ell = convert.csr_to_ell(B, check_guard=False)
            if flat_plan.viable:
                return ("flat", A_ell, B_ell)
            # skewed outputs assemble as BlockCSR: nnz-scaled block
            # gather instead of an (m, max_class_width) ELL scatter
            return ("mc", bt_ops.multiclass_planned(A_ell, B_ell,
                                                    assemble="bcsr"))

        def compute(ab):
            # flat grid when viable (one dispatch); the width-class
            # pipeline extends viability to skewed matrices
            if ab[0] == "flat":
                return bt_ops.spgemm_bitonic(ab[1], ab[2], flat_plan)
            return ab[1]() if ab[1] is not None else None
    else:
        raise ValueError(f"unknown algorithm {name!r}")

    # Conversion: compile once (untimed — XLA compilation has no analogue in
    # the reference), then time steady-state like the reference's
    # transfer_formates pass (main.cpp:658-676).
    if convert_fn is None:
        converted = (A, B)
    else:
        converted = convert_fn()
        jax.block_until_ready(converted)
        res.trans_time_ms = _time_ms(lambda: convert_fn(), warmup=0,
                                     iters=max(iters, 1))

    # Compile+first run gets its own generous budget; the 20x-baseline
    # watchdog (main.cpp:510,751) applies to steady-state execution.
    C, timed_out = _run_with_timeout(
        lambda: jax.block_until_ready(compute(converted)),
        max(timeout_s or 0, COMPILE_BUDGET_S))
    if timed_out:
        res.timed_out = True
        return None
    if C is None:
        # the class probe is an upper bound: the planner may still
        # decline after merging classes (returns None)
        res.skipped = True
        res.skip_reason = "planner declined"
        return None
    run_once = lambda: compute(converted)  # noqa: E731
    (_, timed_out) = _run_with_timeout(
        lambda: jax.block_until_ready(run_once()), timeout_s)
    if timed_out:
        res.timed_out = True
        return None
    res.run_time_ms = _time_ms(run_once, warmup=0, iters=iters)
    if device_timers:
        # chained-dispatch device time: the selector's label signal
        from ia_spgemm_tpu.bench.profiling import device_time_ms
        res.device_time_ms = device_time_ms(
            run_once, chain=4, reps=2)["device_ms"]
    res.verified_sum = float(C.checksum())
    from ia_spgemm_tpu.formats.types import BlockCSR
    if isinstance(C, BlockCSR):
        res.memory_bytes = float(C.padded_bytes())
    elif name in ("csr", "esc", "coo", "compensated"):
        res.memory_bytes = (convert.sizeof_coo(C.nrows, int(C.nnz))
                            if name == "coo"
                            else convert.sizeof_csr(C.nrows, int(C.nnz)))
    elif name in ("ell", "bitonic", "serve"):
        res.memory_bytes = convert.sizeof_ell(C.nrows, C.max_nnz_per_row)
    elif name == "dia":
        res.memory_bytes = convert.sizeof_dia(C.nrows, C.ncols,
                                              C.num_diagonals)
    elif name in ("dense", "dense_row"):
        res.memory_bytes = 8.0 * C.nrows * C.ncols
    res.ok = True
    return C
