"""Row-partitioned distributed SpGEMM over a device mesh.

The capability the single-process reference lacks (SURVEY.md §2.7): shard
A and C by row blocks across devices; B is either replicated (small B) or
row-sharded and exchanged with one all_gather over the interconnect, then
each device runs the local ESC kernel on its row block. C comes back
row-sharded.

Layout: a ShardedCSR stacks per-shard arrays along a leading device axis —
  row_ptr: (D, m_loc+1) LOCAL offsets; col/val: (D, cap_loc); nnz: (D,)
sharded with PartitionSpec('x') so each device holds exactly its block.
Row blocks can be balanced by row count or by flops (prefix-sum of per-row
intermediate-product counts — the skew the reference's CV feature measures,
csr/common_csr.h:276).
"""

from __future__ import annotations

import functools

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ia_spgemm_tpu import config as cfg
from ia_spgemm_tpu.formats.types import CSR, pytree_dataclass, static_field
from ia_spgemm_tpu.ops import esc


@pytree_dataclass
class ShardedCSR:
    """Row-block-sharded CSR: leading dim = shard."""

    row_ptr: jax.Array    # (D, m_loc+1) int32 — local offsets per shard
    col_ind: jax.Array    # (D, cap_loc) int32
    values: jax.Array     # (D, cap_loc)
    nnz: jax.Array        # (D,) int32
    row_start: jax.Array  # (D,) int32 — global row of each block's first row
    shape: Tuple[int, int] = static_field()

    @property
    def num_shards(self) -> int:
        return self.row_ptr.shape[0]

    @property
    def rows_per_shard(self) -> int:
        return self.row_ptr.shape[1] - 1


def _entry_flops_csum(A: CSR, B: CSR) -> np.ndarray:
    """Host prefix sum of per-entry intermediate products: csum[e] = Σ of
    len(B row a_col[j]) for j < e. Row r's flops = csum[rp[r+1]] -
    csum[rp[r]] — shared by the balancer and the capacity planner."""
    nnzA = int(A.nnz)
    col = np.asarray(A.col_ind)[:nnzA]
    b_len = np.diff(np.asarray(B.row_ptr)).astype(np.int64)
    per_entry = b_len[np.clip(col, 0, B.nrows - 1)]
    return np.concatenate([[0], np.cumsum(per_entry)])


def _row_boundaries(A: CSR, num_shards: int, balance: str,
                    B: CSR | None) -> np.ndarray:
    m = A.nrows
    if balance == "rows" or m < num_shards:
        bounds = np.linspace(0, m, num_shards + 1).astype(np.int64)
    elif balance == "flops":
        # balanced intermediate products per shard
        rp = np.asarray(A.row_ptr).astype(np.int64)
        ecsum = _entry_flops_csum(A, B if B is not None else A)
        csum = ecsum[rp]  # per-row flops prefix at row boundaries
        targets = np.linspace(0, csum[-1], num_shards + 1)
        bounds = np.searchsorted(csum, targets)
        bounds[0], bounds[-1] = 0, m
        bounds = np.maximum.accumulate(bounds)
    else:
        raise ValueError(balance)
    return bounds.astype(np.int64)


def partition_rows(A: CSR, num_shards: int, *, balance: str = "rows",
                   B: CSR | None = None,
                   mesh: Mesh | None = None) -> ShardedCSR:
    """Host-side row partitioner: equal-size padded blocks.

    All shards share one static (rows_per_shard, cap_loc); shorter blocks
    pad rows with empty row_ptr tails and entries with the column sentinel.
    """
    m, n = A.shape
    bounds = _row_boundaries(A, num_shards, balance, B)
    rp = np.asarray(A.row_ptr).astype(np.int64)
    ci = np.asarray(A.col_ind)
    vv = np.asarray(A.values)

    m_loc = int(np.max(bounds[1:] - bounds[:-1]))
    m_loc = max(m_loc, 1)
    caps = [int(rp[bounds[d + 1]] - rp[bounds[d]])
            for d in range(num_shards)]
    cap_loc = cfg.bucket_capacity(max(max(caps), 1))

    row_ptr = np.zeros((num_shards, m_loc + 1), np.int32)
    col = np.full((num_shards, cap_loc), n, np.int32)
    val = np.zeros((num_shards, cap_loc), vv.dtype)
    nnz = np.zeros(num_shards, np.int32)
    row_start = np.zeros(num_shards, np.int32)
    for d in range(num_shards):
        r0, r1 = int(bounds[d]), int(bounds[d + 1])
        e0, e1 = int(rp[r0]), int(rp[r1])
        local_rp = (rp[r0:r1 + 1] - rp[r0]).astype(np.int32)
        row_ptr[d, :r1 - r0 + 1] = local_rp
        row_ptr[d, r1 - r0 + 1:] = local_rp[-1]
        col[d, :e1 - e0] = ci[e0:e1]
        val[d, :e1 - e0] = vv[e0:e1]
        nnz[d] = e1 - e0
        row_start[d] = r0

    out = ShardedCSR(row_ptr=jnp.asarray(row_ptr), col_ind=jnp.asarray(col),
                     values=jnp.asarray(val), nnz=jnp.asarray(nnz),
                     row_start=jnp.asarray(row_start), shape=(m, n))
    if mesh is not None:
        axis = mesh.axis_names[0]
        shard = NamedSharding(mesh, P(axis))
        out = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, shard), out)
    return out


def _assemble_global_csr(rp_blocks, col_blocks, val_blocks, nnz_blocks,
                         *, n_cols: int, row_start=None,
                         n_rows: int | None = None):
    """Fuse gathered per-shard CSR blocks (padded) into one global CSR.

    rp_blocks: (D, m_loc+1) local offsets; returns global (row_ptr, col,
    val) with capacity D*cap_loc (entries compacted to the front).

    row_start/n_rows: the blocks' global first-row ids and the true global
    row count — REQUIRED when row counts don't divide evenly (blocks pad
    tail rows; the scatter below drops them). When omitted, every block is
    assumed to hold exactly m_loc real rows."""
    D, cap_loc = col_blocks.shape
    m_loc = rp_blocks.shape[1] - 1
    shard_off = jnp.concatenate([
        jnp.zeros(1, jnp.int32),
        jnp.cumsum(nnz_blocks.astype(jnp.int32))])
    if row_start is None:
        # even split: block-local offsets + per-shard entry offset
        row_ptr = (rp_blocks[:, :-1] + shard_off[:-1, None]).reshape(-1)
        row_ptr = jnp.concatenate([row_ptr, shard_off[-1:]])
    else:
        # uneven split: scatter each block's REAL rows to their global
        # positions; padded tail rows fall into a dropped slot
        rows_d = jnp.concatenate([row_start[1:],
                                  jnp.full(1, n_rows, jnp.int32)]) \
            - row_start
        li = jax.lax.broadcasted_iota(jnp.int32, (D, m_loc), 1)
        valid_r = li < rows_d[:, None]
        dst_r = jnp.where(valid_r, row_start[:, None] + li, n_rows + 1)
        rp_g = jnp.zeros(n_rows + 2, jnp.int32)
        rp_g = rp_g.at[dst_r.reshape(-1)].set(
            (rp_blocks[:, :-1] + shard_off[:-1, None]).reshape(-1),
            mode="drop")
        row_ptr = rp_g[:n_rows + 1].at[n_rows].set(shard_off[-1])
    # compact entries: local entry t of shard d -> shard_off[d] + t
    local_t = jax.lax.broadcasted_iota(jnp.int32, (D, cap_loc), 1)
    valid = local_t < nnz_blocks[:, None]
    dst = jnp.where(valid, shard_off[:-1, None] + local_t, D * cap_loc)
    col = jnp.full(D * cap_loc + 1, n_cols, jnp.int32)
    val = jnp.zeros(D * cap_loc + 1, val_blocks.dtype)
    col = col.at[dst.reshape(-1)].set(
        jnp.where(valid, col_blocks, n_cols).reshape(-1))
    val = val.at[dst.reshape(-1)].set(
        jnp.where(valid, val_blocks, 0).reshape(-1))
    return row_ptr, col[:-1], val[:-1], shard_off[-1]


@functools.lru_cache(maxsize=64)
def _dist_fn(mesh: Mesh, e_cap: int, out_cap: int, m_loc: int,
             k: int, n: int, b_sharded: bool):
    """Build + jit the sharded program once per (mesh, capacities) —
    rebuilding shard_map per call retraces and recompiles every time
    (same pattern as ring._ring_fn)."""
    from jax import shard_map

    axis = mesh.axis_names[0]
    if not b_sharded:
        def local_fn(a_rp, a_col, a_val, a_nnz,
                     b_rp, b_col, b_val):
            a_rp, a_col, a_val = a_rp[0], a_col[0], a_val[0]
            a_nnz = a_nnz[0]
            a_row = esc._entry_rows_from_row_ptr(a_rp, a_col.shape[0])
            rp, col, val, nnz = esc._esc_core(
                a_row, a_col, a_val, a_nnz, b_rp, b_col, b_val,
                e_cap=e_cap, out_cap=out_cap, m=m_loc, k=k, n=n)
            return (rp[None], col[None], val[None], nnz[None])

        return jax.jit(shard_map(
            local_fn, mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis), P(), P(), P()),
            out_specs=(P(axis), P(axis), P(axis), P(axis)),
            check_vma=False))

    def local_fn(a_rp, a_col, a_val, a_nnz,
                 b_rp, b_col, b_val, b_nnz, b_rs):
        a_rp, a_col, a_val = a_rp[0], a_col[0], a_val[0]
        a_nnz = a_nnz[0]
        # all_gather B's row blocks, reassemble global CSR
        g_rp = jax.lax.all_gather(b_rp[0], axis)       # (D, k_loc+1)
        g_col = jax.lax.all_gather(b_col[0], axis)
        g_val = jax.lax.all_gather(b_val[0], axis)
        g_nnz = jax.lax.all_gather(b_nnz[0], axis)
        # scatter the blocks' REAL rows into global positions by each
        # block's row_start — handles uneven splits (blocks pad tail
        # rows) and flops-balanced partitions alike
        g_rs = jax.lax.all_gather(b_rs[0], axis)       # (D, 1)
        b_rp_g, b_col_g, b_val_g, _ = _assemble_global_csr(
            g_rp, g_col, g_val, g_nnz, n_cols=n,
            row_start=g_rs[:, 0], n_rows=k)
        a_row = esc._entry_rows_from_row_ptr(a_rp, a_col.shape[0])
        rp, col, val, nnz = esc._esc_core(
            a_row, a_col, a_val, a_nnz, b_rp_g, b_col_g, b_val_g,
            e_cap=e_cap, out_cap=out_cap, m=m_loc, k=k, n=n)
        return (rp[None], col[None], val[None], nnz[None])

    return jax.jit(shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(axis),) * 9,
        out_specs=(P(axis),) * 4,
        check_vma=False))


def dist_spgemm(A: ShardedCSR, B, mesh: Mesh,
                *, e_cap: int, out_cap: int,
                b_sharded: bool = None) -> ShardedCSR:
    """C = A @ B with A, C row-sharded over `mesh`.

    B may be a replicated CSR (no communication — pure data parallelism) or
    a ShardedCSR (one all_gather over the mesh axis reassembles it on every
    device before the local ESC kernel).

    e_cap/out_cap are per-shard static capacities (use plan_dist_spgemm).
    """
    m, k = A.shape
    if b_sharded is None:
        b_sharded = isinstance(B, ShardedCSR)
    n = B.shape[1]
    m_loc = A.rows_per_shard

    fn = _dist_fn(mesh, int(e_cap), int(out_cap), m_loc, k, n,
                  bool(b_sharded))
    if not b_sharded:
        rp, col, val, nnz = fn(A.row_ptr, A.col_ind, A.values, A.nnz,
                               B.row_ptr, B.col_ind, B.values)
    else:
        rp, col, val, nnz = fn(A.row_ptr, A.col_ind, A.values, A.nnz,
                               B.row_ptr, B.col_ind, B.values, B.nnz,
                               B.row_start[:, None])

    return ShardedCSR(row_ptr=rp, col_ind=col, values=val, nnz=nnz,
                      row_start=A.row_start, shape=(m, n))


def plan_dist_spgemm(A: CSR, B: CSR, num_shards: int,
                     *, balance: str = "rows") -> Tuple[int, int]:
    """Per-shard (e_cap, out_cap): max expansion / output bound over row
    blocks. Guards the same int32 position arithmetic the single-chip
    planner does (esc.py) — this is the planner plan_spgemm's overflow
    errors redirect users to, so it must not itself wrap."""
    m = A.nrows
    bounds = _row_boundaries(A, num_shards, balance, B)
    rp = np.asarray(A.row_ptr).astype(np.int64)
    csum = _entry_flops_csum(A, B)
    # per-row flops -> per-row output bound min(flops, n)
    per_row = csum[rp[1:]] - csum[rp[:-1]]
    ocsum = np.concatenate(
        [[0], np.cumsum(np.minimum(per_row, B.ncols), dtype=np.int64)])
    e_max, o_max = 1, 1
    for d in range(num_shards):
        e0, e1 = int(rp[bounds[d]]), int(rp[bounds[d + 1]])
        e_max = max(e_max, int(csum[e1] - csum[e0]))
        o_max = max(o_max, int(ocsum[bounds[d + 1]] - ocsum[bounds[d]]))
    i32max = np.iinfo(np.int32).max
    if cfg.bucket_capacity(e_max) > i32max - 1:
        raise ValueError(
            f"a shard's expansion ({e_max}) overflows int32 positions; "
            "use more shards or balance='flops'")
    return cfg.bucket_capacity(e_max), cfg.bucket_capacity(o_max)


def gather_result(C: ShardedCSR) -> CSR:
    """Host-side: fuse a row-sharded result back into one global CSR."""
    D = C.num_shards
    m, n = C.shape
    rp = np.asarray(C.row_ptr)
    col = np.asarray(C.col_ind)
    val = np.asarray(C.values)
    nnz = np.asarray(C.nnz)
    row_start = np.asarray(C.row_start)
    g_rp = np.zeros(m + 1, np.int32)
    cols_out = []
    vals_out = []
    total = 0
    for d in range(D):
        r0 = int(row_start[d])
        r1 = int(row_start[d + 1]) if d + 1 < D else m
        nrows_d = r1 - r0
        g_rp[r0:r1 + 1] = rp[d, :nrows_d + 1] + total
        cols_out.append(col[d, :nnz[d]])
        vals_out.append(val[d, :nnz[d]])
        total += int(nnz[d])
    cols_np = np.concatenate(cols_out) if cols_out else np.zeros(0, np.int32)
    vals_np = np.concatenate(vals_out) if vals_out else np.zeros(0)
    return CSR.from_arrays(g_rp, cols_np, vals_np, (m, n), nnz=total)
