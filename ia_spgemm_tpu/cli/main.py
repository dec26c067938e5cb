"""spgemm-run — the framework CLI.

Usage (the reference driver's `./spgemm-cpu A.mtx B.mtx testing_mode`,
main.cpp:97-140, re-expressed):

    python -m ia_spgemm_tpu.cli A.mtx [B.mtx] [--mode autotune|all|ALG]
        [--weights Intel|Amd|P100] [--testing] [--json OUT.json]
        [--imgs-dir DIR]

With one matrix the workload is C = A @ A (the reference's default,
README.md:10). --testing prints the input matrices like the reference's
testing_mode (main.cpp:489-497). --mode all runs the full benchmark sweep
with the MatNet verdict; --mode autotune runs only the predicted-fastest
algorithm; --mode <alg> forces one algorithm.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spgemm-run",
        description="Input-aware SpGEMM (ia_spgemm_tpu)")
    p.add_argument("matrix_a", help=".mtx file for A")
    p.add_argument("matrix_b", nargs="?", default=None,
                   help=".mtx file for B (default: B = A)")
    p.add_argument("testing_mode", nargs="?", default=None,
                   help="reference-CLI compat: nonzero third positional "
                        "arg == --testing (./spgemm-cpu A.mtx B.mtx "
                        "testing_mode, main.cpp:97-140)")
    p.add_argument("--mode", default="all",
                   help="autotune | all | baseline|csr|esc|coo|ell|dia|"
                        "dense|bitonic|dense_row|compensated|serve "
                        "(csr is the production auto route; esc is the "
                        "slab/global ESC engine; serve is the bf16 lane, "
                        "checksum gated at its documented 2e-2 bound) | "
                        "dist|ring (row-sharded over the device mesh: "
                        "all-gathered-B / ppermute ring; see --shards)")
    p.add_argument("--shards", type=int, default=None,
                   help="mesh size for --mode dist/ring (default: every "
                        "visible device)")
    p.add_argument("--weights", default="Intel",
                   help="MatNet weight set (Intel|Amd|P100 reference sets, "
                        "or a path.npz)")
    p.add_argument("--profile", default="cpu", choices=("cpu", "gpu"),
                   help="composed reference profile: cpu = the CPU driver "
                        "(Intel weights, 26 features, 50x size guards, "
                        "5-class menu, main.cpp:97-1001); gpu = the GPU "
                        "driver (P100 weights, 18 features, B = A^T when "
                        "no B given, 20x size guards, 3-class "
                        "CUSP/cuSPARSE/NSPARSE menu, main.cu:30-557)")
    p.add_argument("--testing", action="store_true",
                   help="print input matrices (reference testing_mode)")
    p.add_argument("--json", default=None, help="write JSON report here")
    p.add_argument("--imgs-dir", default=None,
                   help="write imgs/img1.txt, img2.txt density images "
                        "(reference main.cpp:567-643)")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--no-matnet", action="store_true",
                   help="skip the MatNet prediction")
    p.add_argument("--transpose-b", action="store_true",
                   help="use B = A^T (the reference GPU driver's workload,"
                        " main.cu:260-269)")
    p.add_argument("--isolate", action="store_true",
                   help="run each algorithm in a killable subprocess so a "
                        "timed-out kernel frees the device (the reference's "
                        "pthread_cancel watchdog, main.cpp:770-775); this "
                        "process then stays on the CPU so that only the "
                        "worker holds the device")
    return p


def _print_csr(name, A):
    import numpy as np
    print(f"{name}: row:{A.nrows} col:{A.ncols} nnz:{int(A.nnz)}")
    print(",".join(map(str, np.asarray(A.row_ptr))) + ",")
    nnz = int(A.nnz)
    print(",".join(map(str, np.asarray(A.col_ind)[:nnz])) + ",")
    print(",".join(f"{v:.2f}" for v in np.asarray(A.values)[:nnz]) + ",")


# Default persistent-compilation-cache directory: fixed, inside the
# checkout (a moving path would never hit), listed in .gitignore.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compilation_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else DEFAULT_CACHE_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache():
    """Persist XLA compilations across processes; returns the directory,
    or None on the CPU backend.

    With JAX_COMPILATION_CACHE_DIR set, JAX already caches there and
    nothing is set here. Otherwise the cache goes to DEFAULT_CACHE_DIR.
    The CPU backend is skipped: XLA:CPU entries are keyed without the
    host's CPU features, so one compiled on another host can crash the
    process that loads it, and CPU compiles are short anyway. Touches no
    backend (reads the platform setting only), so the --isolate parent
    can call it before pinning itself to the CPU."""
    import jax
    platforms = (jax.config.jax_platforms
                 or os.environ.get("JAX_PLATFORMS") or "")
    if platforms.split(",")[0] == "cpu":
        return None
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def _run_distributed(A, B, args) -> int:
    """--mode dist/ring: C = A @ B row-sharded over a 1-D device mesh —
    the scale-out capability the single-process reference lacks
    (SURVEY.md §2.7). dist all-gathers B's row blocks; ring streams them
    between neighbors with lax.ppermute. Multi-process meshes bootstrap
    via parallel.multihost.initialize (IA_SPGEMM_COORDINATOR env)."""
    import time

    import jax
    import numpy as np

    from ia_spgemm_tpu.parallel import multihost
    from ia_spgemm_tpu.parallel.mesh import make_mesh

    if os.environ.get("IA_SPGEMM_COORDINATOR"):
        multihost.initialize()
    ndev = len(jax.devices())
    D = args.shards or ndev
    if D > ndev:
        print(f"--shards {D} > {ndev} visible devices", file=sys.stderr)
        return 2
    mesh = make_mesh(D)
    print(f"mesh: {D} device(s) [{jax.devices()[0].platform}], "
          f"route={args.mode}, balance=flops")

    if args.mode == "dist":
        from ia_spgemm_tpu.parallel import distributed
        e_cap, out_cap = distributed.plan_dist_spgemm(A, B, D,
                                                      balance="flops")
        As = distributed.partition_rows(A, D, balance="flops", B=B,
                                        mesh=mesh)
        Bs = distributed.partition_rows(B, D, mesh=mesh)

        def run():
            return distributed.dist_spgemm(As, Bs, mesh,
                                           e_cap=e_cap, out_cap=out_cap)

        Cs = jax.block_until_ready(run())
        C = multihost.replicate_to_hosts(Cs)
    else:
        from ia_spgemm_tpu.formats import convert
        from ia_spgemm_tpu.parallel import ring
        A_ell = convert.csr_to_ell(A, check_guard=False)
        B_ell = convert.csr_to_ell(B, check_guard=False)
        plan = ring.plan_ring(A_ell, B_ell, D)
        As = ring.partition_rows_ell(A_ell, D, mesh=mesh)
        Bs = ring.partition_rows_ell(B_ell, D, mesh=mesh)

        def run():
            return ring.ring_spgemm(As, Bs, mesh, plan)

        Ce = jax.block_until_ready(run())
        C = ring.gather_result(Ce)

    times = []
    for _ in range(max(args.iters, 1)):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        times.append((time.perf_counter() - t0) * 1e3)
    wall = float(np.median(times))

    c_ref = A.to_scipy() @ B.to_scipy()
    rel = abs(float(C.checksum()) - float(c_ref.sum())) \
        / max(1.0, abs(float(c_ref.sum())))
    status = "ok" if rel < 1e-4 else f"CHECKSUM MISMATCH ({rel:.3g})"
    print(f"C: {C.nrows}x{C.ncols} nnz={int(C.nnz)} "
          f"verified_sum={float(C.checksum()):.10g} [{status}]")
    print(f"run_time(ms): {wall:.3f}  ({D}-shard {args.mode})")
    if args.json:
        import json as _json
        with open(args.json, "w") as f:
            _json.dump({"mode": args.mode, "shards": D,
                        "run_time_ms": wall, "nnz_out": int(C.nnz),
                        "checksum_rel_err": rel}, f, indent=1)
    return 0 if rel < 1e-4 else 3


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.testing_mode is not None and args.testing_mode not in ("0", ""):
        args.testing = True
    if args.isolate:
        # one process per device: the workers take it, this one stays off
        import jax
        jax.config.update("jax_platforms", "cpu")
    enable_compilation_cache()

    from ia_spgemm_tpu import autotune, config as cfg
    from ia_spgemm_tpu.bench import harness, report as report_mod
    from ia_spgemm_tpu.io import mmio
    from ia_spgemm_tpu.ops import density

    run_config = cfg.DEFAULT_CONFIG
    if args.profile == "gpu":
        # the composed GPU-driver profile (main.cu:30-557): P100 weights
        # (18-feature MatNet head), B = A^T workload, the GPU tree's 20x
        # size guards (GPU detail/dia/common_dia.h:51, coo/common_coo.h:37),
        # and the 3-class CUSP/cuSPARSE/NSPARSE menu
        run_config = cfg.SpGEMMConfig(
            size_guard_ratio=cfg.SIZE_GUARD_RATIO_GPU)
        if args.weights == "Intel":      # the CPU default was not asked for
            args.weights = "P100"
        if args.matrix_b is None:
            args.transpose_b = True

    try:
        A = mmio.read_mtx_to_csr(args.matrix_a)
    except (OSError, mmio.MatrixMarketError) as e:
        print(f"cannot read {args.matrix_a}: {e}", file=sys.stderr)
        return 1
    print(f"-------------- {args.matrix_a}, "
          f"{args.matrix_b or args.matrix_a} --------------")
    print(f"Weight Matrix (A): {A.nrows}x{A.ncols} nnz={int(A.nnz)}")
    if args.matrix_b:
        try:
            B = mmio.read_mtx_to_csr(args.matrix_b)
        except (OSError, mmio.MatrixMarketError) as e:
            print(f"cannot read {args.matrix_b}: {e}", file=sys.stderr)
            return 1
    else:
        B = A
    if args.transpose_b:
        from ia_spgemm_tpu.formats import convert as _conv
        B = _conv.transpose_csr(B)
    print(f"Activation Matrix (B): {B.nrows}x{B.ncols} nnz={int(B.nnz)}")
    if A.ncols != B.nrows:
        print(f"shape mismatch: {A.shape} @ {B.shape}", file=sys.stderr)
        return 2

    if args.testing:
        _print_csr("A_csr", A)
        _print_csr("B_csr", B)
        # the reference's testing_mode also dumps the vendor-baseline
        # result C (print_csr(&C_mkl), main.cpp:760) for eyeballing
        from ia_spgemm_tpu.formats.types import CSR as _CSR
        c_sp = (A.to_scipy() @ B.to_scipy()).tocsr()
        c_sp.sum_duplicates()
        _print_csr("C_csr", _CSR.from_scipy(c_sp))

    if args.imgs_dir:
        os.makedirs(args.imgs_dir, exist_ok=True)
        density.write_density_image(
            os.path.join(args.imgs_dir, "img1.txt"), density.density_image(A))
        density.write_density_image(
            os.path.join(args.imgs_dir, "img2.txt"), density.density_image(B))

    pick = None
    if not args.no_matnet:
        try:
            sel = autotune.select_algorithm(A, B, weight_name=args.weights)
            pick = sel.algorithm
            print(f"MatNet prediction: class {sel.class_index} -> {pick}")
        except FileNotFoundError:
            print("MatNet weights not found; skipping prediction")

    if args.mode in ("dist", "ring"):
        return _run_distributed(A, B, args)

    if args.mode == "autotune":
        C, sel = autotune.spgemm_auto(A, B, weight_name=args.weights)
        print(f"ran algorithm: {sel.algorithm}")
        print(f"C: {C.nrows}x{C.ncols} nnz={int(C.nnz)} "
              f"verified_sum={float(C.checksum()):.10g}")
        return 0

    if args.mode != "all":
        algorithms = ("baseline", args.mode)
    elif args.profile == "gpu":
        # the GPU driver benches its 3-class menu (CUSP -> coo,
        # cuSPARSE -> csr, NSPARSE -> bitonic; main.cu:470-544)
        algorithms = ("baseline",) + autotune.GPU_CLASS_TO_ALGORITHM
    else:
        algorithms = (harness.ALGORITHMS
                      + ("esc", "bitonic", "compensated", "dense",
                         "dense_row", "serve"))
    rep = harness.run_benchmark(
        A, B, algorithms,
        matrix_a=args.matrix_a, matrix_b=args.matrix_b or args.matrix_a,
        config=run_config,
        matnet_pick=pick, iters=args.iters, isolate=args.isolate)
    print(report_mod.format_table(rep))
    if args.json:
        with open(args.json, "w") as f:
            f.write(report_mod.to_json(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
