"""nnz/s scaling measurement for the distributed SpGEMM paths.

BASELINE.md's north star asks for nnz/s measured at 1 device / 1 host /
N>=2 hosts with >=70% scaling efficiency. On a multi-GPU host this
module measures the real thing; on the virtual CPU mesh it still
exercises the full sharded program — XLA compiles the same collectives —
and reports per-device-count throughput with the `simulated` flag set,
so CPU results are never mistaken for device numbers.

Scaling protocol (weak or strong):
  strong: fixed global problem, split over D devices;
  weak:   per-device rows held constant, global problem grows with D.
Efficiency(D) = throughput(D) / (D * throughput(1)).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence

import jax
import numpy as np

from ia_spgemm_tpu.formats import convert
from ia_spgemm_tpu.formats.types import CSR
from ia_spgemm_tpu.ops.flops import get_flop
from ia_spgemm_tpu.parallel import ring
from ia_spgemm_tpu.parallel.mesh import make_mesh


@dataclasses.dataclass
class ScalingPoint:
    devices: int
    nnz_out: int
    flops: int
    time_ms: float
    nnz_per_s: float
    gflops: float
    efficiency: float  # vs. linear scaling from the 1-device point


def _time_ms(fn, iters: int = 3, stat: str = "median") -> float:
    from ia_spgemm_tpu.bench.profiling import force
    force(fn())
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        force(fn())
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.min(ts) if stat == "min" else np.median(ts))


def measure_ring_scaling(A: CSR, device_counts: Sequence[int] = (1, 2, 4, 8),
                         iters: int = 3) -> List[ScalingPoint]:
    """Strong scaling of ring_spgemm C = A @ A over growing meshes."""
    n_avail = len(jax.devices())
    flops = get_flop(A, A)
    A_ell = convert.csr_to_ell(A, check_guard=False)
    points: List[ScalingPoint] = []
    base = None
    for d in device_counts:
        if d > n_avail:
            break
        mesh = make_mesh(d)
        As = ring.partition_rows_ell(A_ell, d, mesh=mesh)
        plan = ring.plan_ring(A_ell, A_ell, d)
        if not plan.viable:
            break

        def run():
            return ring.ring_spgemm(As, As, mesh, plan)

        ms = _time_ms(run, iters)
        C = run()
        nnz_out = int(np.asarray(C.nnz_row).sum())
        nnz_per_s = nnz_out / (ms / 1e3)
        if base is None:
            base = nnz_per_s
        eff = nnz_per_s / (d * base) if base else 0.0
        points.append(ScalingPoint(
            devices=d, nnz_out=nnz_out, flops=flops, time_ms=round(ms, 3),
            nnz_per_s=round(nnz_per_s, 1),
            gflops=round(2.0 * flops / (ms * 1e6), 4),
            efficiency=round(eff, 4)))
    return points


# One-way NVLink bandwidth between two H100 SXM cards (NVIDIA data
# sheet: 900 GB/s of NVLink per card, 450 GB/s each way). The virtual
# CPU mesh cannot measure the wire; the model uses this rate to price
# what the SAME program moves. Overridable per call.
NVLINK_ONEWAY_BYTES_PER_S = 4.5e11


def measure_dist_scaling(A: CSR, device_counts: Sequence[int] = (1, 2, 4, 8),
                         iters: int = 3, balance: str = "flops",
                         link_bytes_per_s: float = NVLINK_ONEWAY_BYTES_PER_S
                         ) -> dict:
    """MEASURED scaling decomposition of the pure-XLA dist route.

    On the virtual CPU mesh the D devices share the host's cores, so the
    mesh wall-clock at D>1 measures Σ per-device work, not parallel
    speedup. What such a host CAN measure honestly:

      per_shard_ms[d]   each shard's LOCAL program (B-block reassembly +
                        ESC kernel) run standalone on one device, all
                        shards sharing one compiled shape. On D real
                        devices these run concurrently, so the parallel
                        compute time is max_d(per_shard_ms) and

      efficiency_measured_compute(D) = t1 / (D * max_d per_shard_ms)

                        is a MEASURED load-balance x work-inflation
                        efficiency (the honest per-device work the
                        verdict asked for), excluding only the wire;
      mesh_serialized_ms   the full shard_map program (collectives
                        compiled in) for the work-conservation check
                        mesh ≈ Σ shards;
      comm wire         the only unmeasurable piece here — priced by
                        bytes/link-bandwidth and reported separately,
                        never folded into the measured numbers.

    The local program includes _assemble_global_csr (the work the
    all_gather forces every device to repeat), so inflation from the
    replicated reassembly is measured, not modeled."""
    from ia_spgemm_tpu.parallel import distributed as dist
    from ia_spgemm_tpu.parallel.mesh import make_mesh
    from ia_spgemm_tpu.ops import esc as esc_mod

    n_avail = len(jax.devices())
    flops = get_flop(A, A)
    m, n = A.shape
    out = {"metric": "dist_spgemm_scaling",
           "backend": jax.default_backend(),
           "balance": balance,
           "simulated": jax.devices()[0].platform == "cpu",
           "flops": int(flops),
           "points": []}
    t1_ms = None
    rerun_t1 = None
    for d in device_counts:
        if d > n_avail:
            break
        As = dist.partition_rows(A, d, balance=balance, B=A)
        e_cap, out_cap = dist.plan_dist_spgemm(A, A, d, balance=balance)
        m_loc = As.rows_per_shard

        # --- per-shard standalone local program (one device, one
        # compiled shape for every shard) --------------------------------
        rp_all = As.row_ptr
        col_all = As.col_ind
        val_all = As.values
        nnz_all = As.nnz
        rs_all = As.row_start
        _assemble_global_csr_local = dist._assemble_global_csr

        @jax.jit
        def local_run(a_rp, a_col, a_val, a_nnz,
                      g_rp=rp_all, g_col=col_all, g_val=val_all,
                      g_nnz=nnz_all, g_rs=rs_all,
                      e_cap=e_cap, out_cap=out_cap, m_loc=m_loc):
            # the gathered-B reassembly every device repeats post-all_gather
            b_rp_g, b_col_g, b_val_g, _ = _assemble_global_csr_local(
                g_rp, g_col, g_val, g_nnz, n_cols=n,
                row_start=g_rs, n_rows=m)
            a_row = esc_mod._entry_rows_from_row_ptr(a_rp, a_col.shape[0])
            return esc_mod._esc_core(
                a_row, a_col, a_val, a_nnz, b_rp_g, b_col_g, b_val_g,
                e_cap=e_cap, out_cap=out_cap, m=m_loc, k=m, n=n)

        per_shard = []
        for s in range(d):
            args = (rp_all[s], col_all[s], val_all[s], nnz_all[s])
            # min over iters: contention-robust (a median still drifts
            # with host load between the D=1 and D>1 measurements)
            per_shard.append(_time_ms(lambda a=args: local_run(*a),
                                      iters, stat="min"))
        max_ms, sum_ms = max(per_shard), sum(per_shard)
        if d == 1:
            args1 = (rp_all[0], col_all[0], val_all[0], nnz_all[0])
            rerun_t1 = (lambda f=local_run, a=args1:
                        _time_ms(lambda: f(*a), iters, stat="min"))

        # --- full shard_map program, serialized on this host ------------
        mesh = make_mesh(d)
        As_m = dist.partition_rows(A, d, balance=balance, B=A, mesh=mesh)
        Bs_m = As_m

        def mesh_run():
            return dist.dist_spgemm(As_m, Bs_m, mesh,
                                    e_cap=e_cap, out_cap=out_cap)

        mesh_ms = _time_ms(mesh_run, iters)
        C = mesh_run()
        nnz_out = int(np.asarray(C.nnz).sum())

        if t1_ms is None:
            t1_ms = max_ms
        # wire: each device ships its B block once per all_gather round;
        # ring all_gather moves (D-1)/D * sizeof(B block arrays) per link
        blk_bytes = int(col_all.nbytes + val_all.nbytes
                        + rp_all.nbytes) // d
        comm_ms = 0.0 if d == 1 else \
            (d - 1) * blk_bytes / link_bytes_per_s * 1e3
        eff_meas = t1_ms / (d * max_ms)
        t_par_model = max_ms + comm_ms
        out["points"].append({
            "devices": d,
            "per_shard_ms": [round(x, 3) for x in per_shard],
            "max_shard_ms": round(max_ms, 3),
            "sum_shard_ms": round(sum_ms, 3),
            "mesh_serialized_ms": round(mesh_ms, 3),
            "nnz_out": nnz_out,
            "efficiency_measured_compute": round(eff_meas, 4),
            "comm_ms_modeled_per_device": round(comm_ms, 4),
            "comm_bytes_per_link": 0 if d == 1 else blk_bytes * (d - 1),
            "efficiency_with_modeled_wire": round(
                t1_ms / (d * t_par_model), 4),
            "projected_nnz_per_s": round(
                nnz_out / (t_par_model / 1e3), 1),
            "_max_shard_raw": max_ms,
            "_comm_raw": comm_ms,
        })
    # re-measure the D=1 baseline AFTER the last point (host-load drift
    # between points is the dominant noise on a shared host; min of
    # first/last is conservative — it can only LOWER efficiencies)
    if out["points"] and rerun_t1 is not None:
        t1_best = min(t1_ms, rerun_t1())
        out["baseline_t1_ms_first"] = round(t1_ms, 3)
        out["baseline_t1_ms_best"] = round(t1_best, 3)
        for p in out["points"]:
            d_, mx = p["devices"], p["_max_shard_raw"]
            p["efficiency_measured_compute"] = 1.0 if d_ == 1 else round(
                t1_best / (d_ * mx), 4)
            p["efficiency_with_modeled_wire"] = 1.0 if d_ == 1 else round(
                t1_best / (d_ * (mx + p["_comm_raw"])), 4)
    for p in out["points"]:
        p.pop("_max_shard_raw", None)
        p.pop("_comm_raw", None)
    return out


def measure_weak_scaling(base_m: int = 4096,
                         device_counts: Sequence[int] = (1, 2, 4, 8),
                         iters: int = 3, band: int = 4,
                         extra_per_row: int = 8,
                         link_bytes_per_s: float = NVLINK_ONEWAY_BYTES_PER_S
                         ) -> dict:
    """WEAK scaling of the dist route: rows per device fixed at base_m,
    the global problem grows with D.

    Why this cannot be superlinear: STRONG scaling of a fixed problem
    split D ways shrinks each shard's pow2 sort/workspace capacities, so
    per-shard work can fall FASTER than 1/D and 'efficiency' exceed 1.
    Here every D runs the same per-shard row count and nnz distribution,
    so the D=1 shard is a lower bound on any D>1 shard (whose gathered-B
    reassembly covers a D-times-larger B) and

        eff_weak(D) = t_shard(1) / (max_d t_shard(D) + t_collective(D))

    is <= 1 by construction, up to timer noise.

    The all-gather is MEASURED, not modeled: its own jitted shard_map
    program over the same mesh and B-block arrays the dist route
    gathers. On the virtual CPU mesh the measurement validates the
    bytes/link VOLUME model (time should scale with (D-1) * block
    bytes); the wire time for the same volume is projected at
    link_bytes_per_s and reported separately, never folded into the
    measured efficiency."""
    from bench import build_matrix
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ia_spgemm_tpu.ops import esc as esc_mod
    from ia_spgemm_tpu.parallel import distributed as dist

    n_avail = len(jax.devices())
    out = {"metric": "dist_spgemm_weak_scaling",
           "backend": jax.default_backend(),
           "rows_per_device": base_m,
           "simulated": jax.devices()[0].platform == "cpu",
           "points": []}
    t1_ms = None
    rerun_t1 = None
    for d in device_counts:
        if d > n_avail:
            break
        m = base_m * d
        a = build_matrix(m=m, band=band, extra_per_row=extra_per_row)
        A = CSR.from_scipy(a.astype(np.float32))
        flops = get_flop(A, A)
        n = A.ncols
        As = dist.partition_rows(A, d, balance="flops", B=A)
        e_cap, out_cap = dist.plan_dist_spgemm(A, A, d, balance="flops")
        m_loc = As.rows_per_shard

        rp_all, col_all, val_all = As.row_ptr, As.col_ind, As.values
        nnz_all, rs_all = As.nnz, As.row_start
        _asm = dist._assemble_global_csr

        @jax.jit
        def local_run(a_rp, a_col, a_val, a_nnz,
                      g_rp=rp_all, g_col=col_all, g_val=val_all,
                      g_nnz=nnz_all, g_rs=rs_all,
                      e_cap=e_cap, out_cap=out_cap, m_loc=m_loc,
                      m=m, n=n):
            b_rp_g, b_col_g, b_val_g, _ = _asm(
                g_rp, g_col, g_val, g_nnz, n_cols=n,
                row_start=g_rs, n_rows=m)
            a_row = esc_mod._entry_rows_from_row_ptr(
                a_rp, a_col.shape[0])
            return esc_mod._esc_core(
                a_row, a_col, a_val, a_nnz, b_rp_g, b_col_g, b_val_g,
                e_cap=e_cap, out_cap=out_cap, m=m_loc, k=m, n=n)

        per_shard = []
        for s in range(d):
            args = (rp_all[s], col_all[s], val_all[s], nnz_all[s])
            per_shard.append(_time_ms(lambda a_=args: local_run(*a_),
                                      iters, stat="min"))
        max_ms = max(per_shard)
        if d == 1:
            # keep the D=1 runner so the baseline can be RE-measured
            # after the last point: host-load drift between the first
            # and last point can push an efficiency past 1;
            # min(first, last) is conservative (a faster baseline can
            # only LOWER every reported efficiency)
            args1 = (rp_all[0], col_all[0], val_all[0], nnz_all[0])
            rerun_t1 = (lambda f=local_run, a_=args1:
                        _time_ms(lambda: f(*a_), iters, stat="min"))

        # --- the collective, measured as its own jitted program ---
        ag_ms = 0.0
        blk_bytes = int(col_all.nbytes + val_all.nbytes
                        + rp_all.nbytes) // d
        if d > 1:
            mesh = make_mesh(d)
            As_m = dist.partition_rows(A, d, balance="flops", B=A,
                                       mesh=mesh)
            axis = mesh.axis_names[0]

            def gather_fn(b_rp, b_col, b_val):
                return (jax.lax.all_gather(b_rp[0], axis)[None],
                        jax.lax.all_gather(b_col[0], axis)[None],
                        jax.lax.all_gather(b_val[0], axis)[None])

            gather = jax.jit(shard_map(
                gather_fn, mesh=mesh,
                in_specs=(P(axis),) * 3, out_specs=(P(axis),) * 3,
                check_vma=False))
            ag_ms = _time_ms(lambda: gather(As_m.row_ptr, As_m.col_ind,
                                            As_m.values), iters,
                             stat="min")
        wire_bytes_per_link = 0 if d == 1 else blk_bytes * (d - 1)
        comm_link_ms = wire_bytes_per_link / link_bytes_per_s * 1e3
        if t1_ms is None:
            t1_ms = max_ms
        t_weak = max_ms + ag_ms
        out["points"].append({
            "devices": d,
            "global_rows": m,
            "flops": int(flops),
            "per_shard_ms": [round(x, 3) for x in per_shard],
            "max_shard_ms": round(max_ms, 3),
            "allgather_measured_ms": round(ag_ms, 3),
            "allgather_bytes_per_link": wire_bytes_per_link,
            "allgather_gbs_measured": round(
                wire_bytes_per_link * d / (ag_ms / 1e3) / 1e9, 3)
            if ag_ms > 0 else None,
            "comm_link_projected_ms": round(comm_link_ms, 4),
            "time_ms": round(t_weak, 3),
            "efficiency_weak": round(t1_ms / t_weak, 4),
            "efficiency_weak_link_projected": round(
                t1_ms / (max_ms + comm_link_ms), 4),
            "_max_shard_raw": max_ms,
            "_comm_link_raw": comm_link_ms,
        })
    if out["points"] and rerun_t1 is not None:
        t1_end = rerun_t1()
        t1_best = min(t1_ms, t1_end)
        out["baseline_t1_ms_first"] = round(t1_ms, 3)
        out["baseline_t1_ms_last"] = round(t1_end, 3)
        out["baseline_drift"] = round(max(t1_ms, t1_end) / t1_best, 3)
        for p in out["points"]:
            if p["devices"] == 1:
                # the baseline defines efficiency; 1.0 by construction
                p["efficiency_weak"] = 1.0
                p["efficiency_weak_link_projected"] = 1.0
                continue
            p["efficiency_weak"] = round(
                min(1.0, t1_best / (p["_max_shard_raw"]
                                    + p["allgather_measured_ms"])), 4)
            p["efficiency_weak_link_projected"] = round(
                min(1.0, t1_best / (p["_max_shard_raw"]
                                    + p["_comm_link_raw"])), 4)
    for p in out["points"]:
        p.pop("_max_shard_raw", None)
        p.pop("_comm_link_raw", None)
    return out


def model_ring_efficiency(A: CSR, device_counts: Sequence[int] = (1, 2, 4, 8),
                          *, t1_ms: float,
                          link_bytes_per_s: float = NVLINK_ONEWAY_BYTES_PER_S,
                          overlap: bool = True) -> List[dict]:
    """Analytic comm-volume/link model for the ring SpGEMM.

    The ring program (parallel/ring.py) row-partitions A and rotates B's
    shards D-1 times; each step every device sends its resident B shard
    (padded ELL, ~8 B/entry col+val) to its ring neighbor, so every link
    carries sizeof_ell(B)/D bytes per step concurrently:

        t_comm(D)   = (D-1) * sizeof_ell(B)/D / link_bw
        t_compute(D)= t1/D            (row-partitioned expand+sort)
        t(D)        = max(compute, comm)   when the ppermute overlaps
                      compute + comm       when it cannot
        eff(D)      = t1 / (D * t(D))

    The model prices the WIRE; t1_ms must come from a measured
    single-device run of the same program."""
    kb = int(A.max_nnz_per_row) if hasattr(A, "max_nnz_per_row") else \
        int(np.diff(np.asarray(A.row_ptr)).max(initial=0))
    # WIRE bytes of the padded ELL shard the ring actually ships:
    # 4 B col + itemsize val per slot (sizeof_ell's reference formula
    # assumes 8-byte doubles and would overstate f32 traffic 1.5x)
    val_bytes = np.dtype(np.asarray(A.values).dtype).itemsize \
        if hasattr(A, "values") else 4
    b_bytes = A.nrows * kb * (4 + val_bytes)
    out = []
    for d in device_counts:
        comm_ms = 0.0 if d == 1 else \
            (d - 1) * (b_bytes / d) / link_bytes_per_s * 1e3
        compute_ms = t1_ms / d
        t_ms = max(compute_ms, comm_ms) if overlap \
            else compute_ms + comm_ms
        out.append({
            "devices": d,
            "compute_ms": round(compute_ms, 4),
            "comm_ms": round(comm_ms, 4),
            "time_ms": round(t_ms, 4),
            "efficiency": round(t1_ms / (d * t_ms), 4),
            "comm_bytes_per_link": int(0 if d == 1 else b_bytes / d),
        })
    return out


def report(points: List[ScalingPoint], simulated: bool | None = None) -> dict:
    if simulated is None:
        simulated = jax.devices()[0].platform == "cpu"
    return {
        "metric": "ring_spgemm_scaling",
        "simulated": simulated,
        "backend": jax.default_backend(),
        "points": [dataclasses.asdict(p) for p in points],
    }


def main():
    """python -m ia_spgemm_tpu.bench.scaling [--cpu] [--dist|--weak]
    [--iters N] [--write OUT.json]: one JSON report on stdout. --cpu
    runs on an 8-device virtual CPU mesh (simulated)."""
    import json
    import sys

    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
    from bench import build_matrix
    from ia_spgemm_tpu.cli.main import enable_compilation_cache
    enable_compilation_cache()
    a = build_matrix(m=8192, band=4, extra_per_row=8)
    A = CSR.from_scipy(a.astype(np.float32))
    iters = 3
    if "--iters" in sys.argv:
        iters = int(sys.argv[sys.argv.index("--iters") + 1])
    if "--weak" in sys.argv:
        rep = measure_weak_scaling(iters=iters)
    elif "--dist" in sys.argv:
        rep = measure_dist_scaling(A, iters=iters)
    else:
        pts = measure_ring_scaling(A, iters=iters)
        rep = report(pts)
        if pts:
            rep["model_nvlink"] = model_ring_efficiency(
                A, sorted({p.devices for p in pts} | {8}),
                t1_ms=pts[0].time_ms)
    out = json.dumps(rep)
    print(out)
    if "--write" in sys.argv:
        with open(sys.argv[sys.argv.index("--write") + 1], "w") as f:
            f.write(out + "\n")


if __name__ == "__main__":
    main()
