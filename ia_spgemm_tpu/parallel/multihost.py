"""Multi-process (multi-host) execution for the distributed SpGEMM routes.

The reference is strictly single-process — no MPI/NCCL/UCX anywhere in the
tree (SURVEY.md §2.7) — so this layer is this framework's own: the
same `shard_map` pipelines in parallel/distributed.py (all_gather route)
and parallel/ring.py (ppermute ring) run unchanged over a mesh that spans
OS processes / hosts, with JAX's coordination service handling the DCN
leg. On a multi-host cluster each process owns its local devices; the CPU
backend runs
the identical code path over Gloo collectives, which is how the self-test
below exercises true multi-controller execution without a pod.

Multi-controller differences this module papers over:
- no single process can address every device, so host-side readback of a
  sharded result must either stay per-process (`local_csr_blocks` /
  `local_ell_rows`) or be an explicit collective (`replicate_to_hosts`);
- process bootstrap (`initialize`) must happen before the first jax call.
"""

from __future__ import annotations

import os
from typing import Iterator, NamedTuple

import numpy as np


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bootstrap this process into the cluster.

    Falls back to IA_SPGEMM_COORDINATOR / IA_SPGEMM_NUM_PROCS /
    IA_SPGEMM_PROC_ID env vars, and to JAX's own cluster auto-detection
    (SLURM, ...) when nothing is given. Call before any
    other jax use; idempotent if the service is already up.
    """
    import jax

    if jax.distributed.is_initialized():  # idempotent: keep the live service
        return
    if coordinator_address is None:
        coordinator_address = os.environ.get("IA_SPGEMM_COORDINATOR")
    if num_processes is None and "IA_SPGEMM_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["IA_SPGEMM_NUM_PROCS"])
    if process_id is None and "IA_SPGEMM_PROC_ID" in os.environ:
        process_id = int(os.environ["IA_SPGEMM_PROC_ID"])
    jax.distributed.initialize(coordinator_address, num_processes,
                               process_id)


class LocalCsrBlock(NamedTuple):
    shard: int        # global shard index d
    row_start: int    # global row of the block's first row
    nrows: int        # REAL rows in this block (padding excluded)
    row_ptr: np.ndarray   # (m_loc+1,) local offsets
    col_ind: np.ndarray   # (nnz,) — trimmed to the block's real entries
    values: np.ndarray    # (nnz,)


def _shard_index(sh) -> int:
    return sh.index[0].start or 0


def local_csr_blocks(C, row_starts: np.ndarray | None = None
                     ) -> Iterator[LocalCsrBlock]:
    """This process's addressable row blocks of a ShardedCSR result.

    `row_starts`: all D global block starts. Each process only holds its
    own shards' row_start, and a block's real row count needs the NEXT
    block's start — pass `all_row_starts(C)` (a collective) once, or None
    on a single-process mesh where everything is addressable.
    """
    D = C.num_shards
    m = C.shape[0]
    if row_starts is None:
        row_starts = np.asarray(C.row_start)
    for sh_rp, sh_col, sh_val, sh_nnz in zip(
            C.row_ptr.addressable_shards, C.col_ind.addressable_shards,
            C.values.addressable_shards, C.nnz.addressable_shards):
        d = _shard_index(sh_rp)
        r0 = int(row_starts[d])
        r1 = int(row_starts[d + 1]) if d + 1 < D else m
        nnz = int(np.asarray(sh_nnz.data)[0])
        yield LocalCsrBlock(
            shard=d, row_start=r0, nrows=r1 - r0,
            row_ptr=np.asarray(sh_rp.data)[0],
            col_ind=np.asarray(sh_col.data)[0][:nnz],
            values=np.asarray(sh_val.data)[0][:nnz])


class LocalEllRows(NamedTuple):
    shard: int
    row_ids: np.ndarray   # (m_loc,) global row ids, -1 = padding
    col_ind: np.ndarray   # (m_loc, K), -1 = empty slot
    values: np.ndarray    # (m_loc, K)
    nnz_row: np.ndarray   # (m_loc,)


def local_ell_rows(C) -> Iterator[LocalEllRows]:
    """This process's addressable rows of a ShardedELL result. Purely
    local — row_map already carries global row ids."""
    for sh_col, sh_val, sh_nr, sh_rm in zip(
            C.col_ind.addressable_shards, C.values.addressable_shards,
            C.nnz_row.addressable_shards, C.row_map.addressable_shards):
        yield LocalEllRows(
            shard=_shard_index(sh_col),
            row_ids=np.asarray(sh_rm.data)[0],
            col_ind=np.asarray(sh_col.data)[0],
            values=np.asarray(sh_val.data)[0],
            nnz_row=np.asarray(sh_nr.data)[0])


def all_row_starts(C) -> np.ndarray:
    """All D global block starts of a ShardedCSR. COLLECTIVE: every
    process in the mesh must call this together."""
    if C.row_start.is_fully_addressable:
        return np.asarray(C.row_start)
    from jax.experimental import multihost_utils
    return np.asarray(
        multihost_utils.process_allgather(C.row_start, tiled=True))


def replicate_to_hosts(C):
    """Pull a row-sharded result back to EVERY process as host numpy and
    fuse it into one global CSR (parallel/distributed.gather_result).
    COLLECTIVE — all processes must call together. For large results
    prefer consuming `local_csr_blocks` in place."""
    from jax.experimental import multihost_utils

    from ia_spgemm_tpu.parallel import distributed

    if C.row_ptr.is_fully_addressable:
        return distributed.gather_result(C)
    host = type(C)(
        *(np.asarray(multihost_utils.process_allgather(x, tiled=True))
          for x in (C.row_ptr, C.col_ind, C.values, C.nnz, C.row_start)),
        shape=C.shape)
    return distributed.gather_result(host)


def _selftest(argv: list[str]) -> None:
    """Worker for the multi-process self-test: run both distributed
    routes on a random fixture and validate every local shard against a
    locally-computed scipy oracle. Spawned by tests/test_multihost.py
    (and usable by hand with the environment that test sets)."""
    pid, nproc, port = int(argv[0]), int(argv[1]), argv[2]
    initialize(f"127.0.0.1:{port}", nproc, pid)

    import jax
    import scipy.sparse as sp

    from ia_spgemm_tpu.formats import convert
    from ia_spgemm_tpu.formats.types import CSR
    from ia_spgemm_tpu.parallel import distributed, ring
    from ia_spgemm_tpu.parallel.mesh import make_mesh

    D = len(jax.devices())
    mesh = make_mesh()
    a = sp.random(96, 96, density=0.08, format="csr", dtype=np.float32,
                  random_state=np.random.RandomState(7))
    c_ref = (a @ a).toarray()
    A = CSR.from_scipy(a)

    # all_gather route, flops-balanced (uneven) partitions
    e_cap, out_cap = distributed.plan_dist_spgemm(A, A, D, balance="flops")
    As = distributed.partition_rows(A, D, balance="flops", B=A, mesh=mesh)
    Bs = distributed.partition_rows(A, D, mesh=mesh)
    C = distributed.dist_spgemm(As, Bs, mesh, e_cap=e_cap, out_cap=out_cap)
    jax.block_until_ready(C.row_ptr)
    starts = all_row_starts(C)
    err = 0.0
    nblocks = 0
    for blk in local_csr_blocks(C, starts):
        dense = np.zeros((blk.nrows, A.ncols), np.float64)
        for r in range(blk.nrows):
            for t in range(blk.row_ptr[r], blk.row_ptr[r + 1]):
                if blk.col_ind[t] < A.ncols:
                    dense[r, blk.col_ind[t]] += blk.values[t]
        err = max(err, float(np.abs(
            dense - c_ref[blk.row_start:blk.row_start + blk.nrows]).max()))
        nblocks += 1
    assert nblocks >= 1 and err < 1e-4, (nblocks, err)
    print(f"[p{pid}] dist ok: {nblocks} blocks, err {err:.2e}", flush=True)

    # replicate_to_hosts: full result on every process
    Cg = replicate_to_hosts(C)
    err_g = float(np.abs(Cg.to_scipy().toarray() - c_ref).max())
    assert err_g < 1e-4, err_g

    # ppermute-ring route
    A_ell = convert.csr_to_ell(A, check_guard=False)
    plan = ring.plan_ring(A_ell, A_ell, D)
    As_e = ring.partition_rows_ell(A_ell, D, mesh=mesh)
    Bs_e = ring.partition_rows_ell(A_ell, D, mesh=mesh)
    Ce = ring.ring_spgemm(As_e, Bs_e, mesh, plan)
    jax.block_until_ready(Ce.col_ind)
    err2 = 0.0
    for rows in local_ell_rows(Ce):
        for r in range(rows.col_ind.shape[0]):
            g = int(rows.row_ids[r])
            if g < 0:
                continue
            dense = np.zeros(A.ncols, np.float64)
            for t in range(int(rows.nnz_row[r])):
                c = int(rows.col_ind[r, t])
                if 0 <= c < A.ncols:
                    dense[c] += rows.values[r, t]
            err2 = max(err2, float(np.abs(dense - c_ref[g]).max()))
    assert err2 < 1e-4, err2
    print(f"[p{pid}] ring ok: err {err2:.2e}", flush=True)
    print(f"[p{pid}] MULTIPROC_OK", flush=True)


if __name__ == "__main__":
    import sys

    _selftest(sys.argv[1:])
