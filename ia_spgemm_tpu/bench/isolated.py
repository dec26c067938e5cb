"""Process-isolated algorithm benchmarking — a watchdog that can KILL.

The reference cancels a slow algorithm with pthread_cancel
(main.cpp:43-93,770-775), actually stopping the work. JAX cannot cancel a
dispatched XLA computation from Python: the round-1 thread watchdog
abandoned the worker thread but the computation kept running on the chip,
serializing every later dispatch behind it — a timed-out algorithm
poisoned the rest of the sweep's timings.

This module runs each candidate in its OWN subprocess (its own process
group). On timeout the parent kills the exact process group it spawned —
never by pattern — and the chip is freed; subsequent algorithms measure
clean. The worker measures internally (its own block_until_ready) and
ships one JSON line back, so process startup/compile never contaminates
the reported run_time.

Cost: each worker re-imports jax and re-initializes the backend (~2-10 s,
amortized by the persistent XLA compilation cache). Use it when timeout
fidelity matters (unknown/adversarial matrices); the in-process path
remains the default for interactive sweeps.

One process per device: a JAX process reserves most of a GPU's memory
when it first touches it, so the parent must not hold the device when
workers target it. The CLI pins its own process to the CPU under
--isolate; pass backend="cpu" to keep workers off the device instead.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np

from ia_spgemm_tpu.formats.types import CSR

# grace for worker startup + jax import + XLA compile, on top of the
# steady-state watchdog budget (the reference's 20x-baseline scale applies
# to steady state; compilation has no reference analogue)
STARTUP_GRACE_S = 240.0


def _dump_csr(z: dict, prefix: str, M: CSR) -> None:
    z[f"{prefix}_row_ptr"] = np.asarray(M.row_ptr)
    z[f"{prefix}_col_ind"] = np.asarray(M.col_ind)
    z[f"{prefix}_values"] = np.asarray(M.values)
    z[f"{prefix}_nnz"] = np.asarray(M.nnz)
    z[f"{prefix}_shape"] = np.asarray(M.shape)


def _load_csr(z, prefix: str) -> CSR:
    return CSR.from_arrays(z[f"{prefix}_row_ptr"], z[f"{prefix}_col_ind"],
                           z[f"{prefix}_values"],
                           shape=tuple(int(x) for x in z[f"{prefix}_shape"]),
                           nnz=int(z[f"{prefix}_nnz"]))


def bench_algorithm_isolated(A: CSR, B: CSR, name: str, *,
                             timeout_s: Optional[float],
                             iters: int = 3,
                             backend: Optional[str] = None):
    """Benchmark one algorithm in a killable subprocess.

    Returns an AlgorithmResult. timeout_s bounds the worker's TOTAL wall
    clock at timeout_s + STARTUP_GRACE_S; on expiry the worker's process
    group is killed by pgid (never by pattern) and the result reports
    timed_out=True with zeroed times, like the reference's cancelled
    pthreads (main.cpp:778-793).
    """
    from ia_spgemm_tpu.bench.harness import AlgorithmResult

    res = AlgorithmResult(name=name)
    with tempfile.TemporaryDirectory(prefix="ia_spgemm_iso_") as td:
        path = os.path.join(td, "mats.npz")
        z: dict = {}
        _dump_csr(z, "a", A)
        _dump_csr(z, "b", B)
        np.savez(path, **z)
        cmd = [sys.executable, "-m", "ia_spgemm_tpu.bench.isolated",
               path, name, "--iters", str(iters)]
        if backend:
            cmd += ["--backend", backend]
        budget = (None if timeout_s is None
                  else timeout_s + STARTUP_GRACE_S)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [p for p in [os.getcwd()] + sys.path if p])
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True, env=env)
        try:
            out, err = proc.communicate(timeout=budget)
        except subprocess.TimeoutExpired:
            # kill the exact process group we created (never a pattern)
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
            res.timed_out = True
            return res
        if proc.returncode != 0:
            res.error = (err or "").strip()[-500:] or \
                f"worker exited {proc.returncode}"
            return res
        line = out.strip().splitlines()[-1] if out.strip() else "{}"
        try:
            payload = json.loads(line)
        except json.JSONDecodeError:
            res.error = f"unparseable worker output: {line[:200]}"
            return res
        for f in dataclasses.fields(res):
            if f.name in payload:
                setattr(res, f.name, payload[f.name])
        return res


def _worker_main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("matrices")
    ap.add_argument("algorithm")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)

    if args.backend:
        import jax
        jax.config.update("jax_platforms", args.backend)
        if args.backend == "cpu":
            jax.config.update("jax_enable_x64", True)
    else:
        from ia_spgemm_tpu.cli.main import enable_compilation_cache
        enable_compilation_cache()

    if args.algorithm == "_test_slow":
        # test hook: a candidate that never finishes (stands in for a hung
        # XLA computation; see tests/test_watchdog.py)
        import time
        time.sleep(3600)
        return 0

    from ia_spgemm_tpu import config as cfg
    from ia_spgemm_tpu.bench.harness import AlgorithmResult, _bench_one

    z = np.load(args.matrices)
    A = _load_csr(z, "a")
    B = _load_csr(z, "b")
    res = AlgorithmResult(name=args.algorithm)
    try:
        # no inner watchdog: the parent's process-group kill is the timeout
        _bench_one(args.algorithm, A, B, cfg.DEFAULT_CONFIG, None, res,
                   args.iters)
    except Exception as e:  # noqa: BLE001 — ship the error, don't traceback
        res.error = f"{type(e).__name__}: {e}"
    print(json.dumps(dataclasses.asdict(res)))
    return 0


if __name__ == "__main__":
    raise SystemExit(_worker_main(sys.argv[1:]))
