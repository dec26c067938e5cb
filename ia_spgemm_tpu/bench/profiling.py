"""Tracing/profiling helpers (SURVEY.md §5: the reference's only tracing
is wall-clock timers, detail/utime.h; here it is jax.profiler traces plus
the per-kernel roofline in bench/roofline.py).

Usage:
    with trace("/tmp/ia_spgemm_trace"):
        C = spgemm_csr_auto(A, B)
        jax.block_until_ready(C.values)
    # open the trace in TensorBoard / xprof, or use annotate() to mark
    # pipeline phases inside a jitted region.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import jax
import numpy as np


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context: writes an xplane trace to log_dir."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span that shows up inside profiler traces."""
    return jax.profiler.TraceAnnotation(name)


def force(out):
    """Wait until `out` (any pytree of arrays) is computed and return it.
    On a locally attached device block_until_ready is a true barrier."""
    return jax.block_until_ready(out)


def time_op(fn: Callable, *args, iters: int = 5, warmup: int = 1,
            **kwargs) -> Dict:
    """Median wall-clock of fn(*args) with device sync, plus spread.

    The reference times with gettimeofday around each kernel
    (main.cpp:715-749); this is the same measurement with
    block_until_ready standing in for kernel completion.
    """
    for _ in range(warmup):
        force(fn(*args, **kwargs))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        force(fn(*args, **kwargs))
        ts.append((time.perf_counter() - t0) * 1e3)
    arr = np.asarray(ts)
    return {"median_ms": float(np.median(arr)),
            "min_ms": float(arr.min()), "max_ms": float(arr.max()),
            "iters": iters}


def sync_rtt_ms(reps: int = 7) -> float:
    """Cost of ONE host<->device sync with no compute: forces a tiny
    already-materialized device array. The floor under every per-call
    wall measurement; it lives in the measurement path, not in the
    framework (a serving loop does not sync per call)."""
    import jax.numpy as jnp
    tiny = jnp.zeros(8)
    force(tiny)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        force(tiny)
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def dispatch_ms(fn: Callable, *args, reps: int = 5, **kwargs) -> float:
    """Host-side cost to ISSUE one (pre-compiled) call, without waiting.

    Covers python glue, argument handling and enqueue of every dispatch
    the call makes; excludes device compute and the sync. Each sample
    drains the queue afterwards so calls don't back up."""
    out = force(fn(*args, **kwargs))  # compile + drain
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        ts.append((time.perf_counter() - t0) * 1e3)
        force(out)
    return float(np.median(ts))


def pipelined_wall_ms(fn: Callable, *args, n: int = 16, reps: int = 3,
                      **kwargs) -> Dict:
    """Steady-state throughput wall: N back-to-back calls, ONE sync.

    The wall a consumer pays per call when it does not read results
    synchronously (keep the device queue full, sync rarely). Per-call
    cost includes device compute, host dispatch overlap, and 1/N of the
    sync.
    """
    force(fn(*args, **kwargs))  # compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = [fn(*args, **kwargs) for _ in range(n)]
        force(outs)
        ts.append((time.perf_counter() - t0) * 1e3 / n)
    return {"pipelined_wall_ms": float(np.median(ts)), "n": n}


def wall_decomposition(fn: Callable, *args, n: int = 16, chain: int = 8,
                       **kwargs) -> Dict:
    """Attribute a single-call sync wall to device / dispatch / sync.

    Components:
      device_ms     — chained-dispatch estimate (device_time_ms)
      dispatch_ms   — host cost to issue the call (no sync)
      sync_rtt_ms   — one no-op host<->device sync
      residual_ms   — single-call wall minus the above (host re-pack,
                      scheduling jitter); ~0 when fully attributed
      pipelined_wall_ms — N calls / one sync: the steady-state wall
    """
    dev = device_time_ms(fn, *args, chain=chain, **kwargs)
    disp = dispatch_ms(fn, *args, **kwargs)
    rtt = sync_rtt_ms()
    pipe = pipelined_wall_ms(fn, *args, n=n, **kwargs)
    single = dev["single_ms"]
    residual = single - dev["device_ms"] - disp - rtt
    return {
        "single_wall_ms": single,
        "device_ms": dev["device_ms"],
        "dispatch_ms": disp,
        "sync_rtt_ms": rtt,
        "residual_ms": residual,
        "pipelined_wall_ms": pipe["pipelined_wall_ms"],
        "pipeline_n": pipe["n"],
    }


def device_time_ms(fn: Callable, *args, chain: int = 8, reps: int = 3,
                   **kwargs) -> Dict:
    """Estimate DEVICE time of fn by amortizing dispatch and sync.

    Dispatching `chain` independent calls back-to-back and syncing ONCE
    serializes them on the device queue while paying the host's
    per-call dispatch and the sync once:

        device_ms ~= (t_chain - t_single) / (chain - 1)

    Both t_chain and t_single are medians over `reps`. Slight
    underestimate when per-dispatch host work overlaps. A host-clock
    estimate: per-kernel device time comes from a profiler trace.
    """
    def run(n):
        outs = [fn(*args, **kwargs) for _ in range(n)]
        force(outs)

    run(1)  # compile
    t1, tn = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        run(1)
        t1.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        run(chain)
        tn.append((time.perf_counter() - t0) * 1e3)
    t1_m = float(np.median(t1))
    tn_m = float(np.median(tn))
    dev = max((tn_m - t1_m) / (chain - 1), 0.0)
    return {"device_ms": dev, "single_ms": t1_m, "chain_ms": tn_m,
            "chain": chain}
