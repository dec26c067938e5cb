"""Ring-overlapped distributed SpGEMM.

The reference is a single process (SURVEY.md §2.7); the distributed
capability this framework adds is row-partitioned SpGEMM. The simple paths
(parallel/distributed.py) replicate or all_gather B, which materializes all
of B on every device. This module streams B around a ring instead:

  - A and C are row-sharded ELL blocks (one per device).
  - B is row-sharded into D equal blocks; at step s device d holds the
    block owned by (d + s) % D.
  - Each step, the device gathers the products for its A entries whose
    column falls in the circulating block, while lax.ppermute sends the
    block to the next device — an async collective-permute (NCCL over
    NVLink on a GPU host) that can overlap the gather. Peak per-device B
    footprint is one block (2 in flight), not all of B.
  - After D steps every product slot is filled; one row-local
    sort-compress (ops/rowsort.py) finishes the row block.

Capacity is static: each A row has ka * kb product slots regardless of
which step supplies them, so the product grid is allocated once and
steps only select into it (no dynamic shapes anywhere).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ia_spgemm_tpu.formats.types import (
    CSR,
    ELL,
    pytree_dataclass,
    static_field,
)
from ia_spgemm_tpu.ops import bitonic
from ia_spgemm_tpu.ops.rowsort import SENTINEL, sort_compress_rows


@pytree_dataclass
class ShardedELL:
    """Row-block-sharded ELL: leading dim = shard.

    row_map holds the GLOBAL row id of each (shard, local) slot (-1 =
    padding) so balanced partitionings can permute rows; contiguous blocks
    use the identity map."""

    col_ind: jax.Array   # (D, m_loc, K) int32, -1 empty
    values: jax.Array    # (D, m_loc, K)
    nnz_row: jax.Array   # (D, m_loc) int32
    row_map: jax.Array   # (D, m_loc) int32 global row ids, -1 padding
    shape: Tuple[int, int] = static_field()
    contiguous: bool = static_field(default=True)

    @property
    def num_shards(self) -> int:
        return self.col_ind.shape[0]

    @property
    def rows_per_shard(self) -> int:
        return self.col_ind.shape[1]

    @property
    def width(self) -> int:
        return self.col_ind.shape[2]


def partition_rows_ell(A: ELL, num_shards: int,
                       mesh: Mesh | None = None,
                       balance: str = "rows",
                       B: ELL | None = None) -> ShardedELL:
    """Row blocks of ceil(m / D) rows.

    balance="rows": contiguous blocks (identity row_map, tail padded).
    balance="flops": rows dealt greedily by descending per-row product
    count onto the least-loaded shard — the flops-balance the reference's
    CV feature motivates (csr/common_csr.h:276) — recorded in row_map.
    """
    m, K = A.col_ind.shape
    m_loc = -(-m // num_shards)
    pad = num_shards * m_loc - m
    if balance == "rows":
        order = np.arange(m, dtype=np.int64)
    elif balance == "flops":
        lens_b = np.asarray((B or A).nnz_row).astype(np.int64)
        cols = np.asarray(A.col_ind)
        rf = np.where(cols >= 0,
                      lens_b[np.clip(cols, 0, lens_b.shape[0] - 1)],
                      0).sum(axis=1)
        by_cost = np.argsort(-rf, kind="stable")
        # greedy deal: heaviest row onto the least-loaded shard
        assign = np.full((num_shards, m_loc), -1, np.int64)
        slot = np.zeros(num_shards, np.int64)
        load = np.zeros(num_shards, np.float64)
        for r in by_cost:
            d = int(np.argmin(load))
            assign[d, slot[d]] = r
            slot[d] += 1
            load[d] += float(rf[r])
            if slot[d] == m_loc:
                load[d] = np.inf  # shard full
        order = assign.reshape(-1)
    else:
        raise ValueError(balance)

    if balance == "rows":
        col = np.pad(np.asarray(A.col_ind), ((0, pad), (0, 0)),
                     constant_values=-1)
        val = np.pad(np.asarray(A.values), ((0, pad), (0, 0)))
        nnz_row = np.pad(np.asarray(A.nnz_row), (0, pad))
        row_map = np.concatenate([np.arange(m, dtype=np.int64),
                                  np.full(pad, -1, np.int64)])
    else:
        sel = np.clip(order, 0, m - 1)
        valid = (order >= 0)[:, None]
        col = np.where(valid, np.asarray(A.col_ind)[sel], -1)
        val = np.where(valid, np.asarray(A.values)[sel], 0)
        nnz_row = np.where(order >= 0, np.asarray(A.nnz_row)[sel], 0)
        row_map = order
    out = ShardedELL(
        col_ind=jnp.asarray(col.reshape(num_shards, m_loc, K)),
        values=jnp.asarray(val.reshape(num_shards, m_loc, K)),
        nnz_row=jnp.asarray(nnz_row.reshape(num_shards, m_loc)
                            .astype(np.int32)),
        row_map=jnp.asarray(row_map.reshape(num_shards, m_loc)
                            .astype(np.int32)),
        shape=A.shape, contiguous=(balance == "rows"))
    if mesh is not None:
        axis = mesh.axis_names[0]
        shard = NamedSharding(mesh, P(axis))
        out = jax.tree_util.tree_map(lambda x: jax.device_put(x, shard), out)
    return out


def plan_ring(A: ELL, B: ELL, num_shards: int) -> bitonic.BitonicPlan:
    m_loc = -(-A.nrows // num_shards)
    return bitonic.plan_bitonic_dims(m_loc, A.max_nnz_per_row,
                                     B.max_nnz_per_row)


def ring_spgemm(A: ShardedELL, B: ShardedELL, mesh: Mesh,
                plan: bitonic.BitonicPlan) -> ShardedELL:
    """C = A @ B, A and C row-sharded, B streamed around the ring.

    B may be partitioned with any balance: each device builds the
    inverse row map (global B row -> owning shard, local slot) once from
    an all_gather of B.row_map, so membership tests against the
    circulating block are O(1) per entry."""
    if not plan.viable:
        raise ValueError(
            f"ring plan not viable (width {plan.width}): "
            f"{plan.reason}; fall back to the distributed ESC path")
    m, _ = A.shape
    n = B.shape[1]
    fn = _ring_fn(mesh, A.num_shards, A.rows_per_shard, B.rows_per_shard,
                  A.width, B.width, min(plan.width, n), B.contiguous)
    col, val, nnz_row = fn(A.col_ind, A.values, B.col_ind, B.values,
                           B.row_map)
    return ShardedELL(col_ind=col, values=val, nnz_row=nnz_row,
                      row_map=A.row_map, shape=(m, n),
                      contiguous=A.contiguous)


@functools.lru_cache(maxsize=64)
def _ring_fn(mesh: Mesh, D: int, m_loc: int, k_loc: int, ka: int, kb: int,
             out_width: int, b_contiguous: bool = True):
    """Build + jit the sharded ring program once per (mesh, shapes) —
    rebuilding shard_map per call retraces and recompiles every time."""
    from jax import shard_map

    axis = mesh.axis_names[0]
    perm = [(i, (i - 1) % D) for i in range(D)]

    def local_fn(a_col, a_val, b_col, b_val, b_rmap):
        a_col, a_val = a_col[0], a_val[0]          # (m_loc, ka)
        b_col, b_val = b_col[0], b_val[0]          # (k_loc, kb)
        d = jax.lax.axis_index(axis)

        # --- per-entry (owner shard, local slot) of each A column ---
        if b_contiguous:
            valid_e = a_col >= 0
            owner_of = jnp.where(valid_e, a_col // k_loc, -1)
            local_of = jnp.clip(a_col - jnp.maximum(owner_of, 0) * k_loc,
                                0, k_loc - 1)
        else:
            # inverse of B's row permutation, built once per call from an
            # all_gather of the (D, k_loc) row map (tiny)
            g_rmap = jax.lax.all_gather(b_rmap[0], axis)   # (D, k_loc)
            k_total = D * k_loc
            ids = jnp.clip(g_rmap.reshape(-1), -1, k_total - 1)
            sh = jax.lax.broadcasted_iota(
                jnp.int32, (D, k_loc), 0).reshape(-1)
            sl = jax.lax.broadcasted_iota(
                jnp.int32, (D, k_loc), 1).reshape(-1)
            owner_tab = jnp.full((k_total + 1,), -1, jnp.int32)
            local_tab = jnp.zeros((k_total + 1,), jnp.int32)
            safe = jnp.where(ids >= 0, ids, k_total)
            owner_tab = owner_tab.at[safe].set(sh, mode="drop")
            local_tab = local_tab.at[safe].set(sl, mode="drop")
            a_safe = jnp.where(a_col >= 0,
                               jnp.clip(a_col, 0, k_total - 1), k_total)
            owner_of = owner_tab[a_safe]
            local_of = local_tab[a_safe]

        key0 = jnp.full((m_loc, ka, kb), SENTINEL, jnp.int32)
        val0 = jnp.zeros((m_loc, ka, kb), a_val.dtype)

        def step(s, carry):
            bc, bv, key, val = carry
            owner = jax.lax.rem(d + s, jnp.int32(D))
            in_blk = (owner_of == owner)[:, :, None]
            gc = bc[local_of]                       # (m_loc, ka, kb)
            sel = in_blk & (gc >= 0)
            key = jnp.where(in_blk, jnp.where(sel, gc, SENTINEL), key)
            val = jnp.where(sel, a_val[:, :, None] * bv[local_of], val)
            # send the block on while the gather above computes
            bc = jax.lax.ppermute(bc, axis, perm)
            bv = jax.lax.ppermute(bv, axis, perm)
            return bc, bv, key, val

        _, _, key, val = jax.lax.fori_loop(
            0, D, step, (b_col, b_val, key0, val0))
        col, out_val, nnz_row = sort_compress_rows(
            key.reshape(m_loc, ka * kb), val.reshape(m_loc, ka * kb),
            out_width=out_width)
        return col[None], out_val[None], nnz_row[None]

    return jax.jit(shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(axis),) * 5,
        out_specs=(P(axis),) * 3,
        check_vma=False))


def _host_blocks(x):
    """(first shard, host copy) of each distinct device block of a
    leading-axis-sharded (D, ...) array, read device by device: no
    device ever holds more than its own block."""
    blocks = {}
    for sh in x.addressable_shards:
        start = sh.index[0].start or 0
        if start not in blocks:
            blocks[start] = np.asarray(sh.data)
    return sorted(blocks.items())


def gather_result(C: ShardedELL) -> CSR:
    """Host-side: fuse the row-sharded ELL result into one global CSR,
    inverting the partition's row permutation. The (m, width) ELL is
    never assembled: each device block is compacted on the host into
    the CSR entry stream."""
    m, n = C.shape
    w = C.width
    nnz_row = np.asarray(C.nnz_row).reshape(-1).astype(np.int64)
    rmap = np.asarray(C.row_map).reshape(-1).astype(np.int64)
    live = rmap >= 0
    nnz_row = np.where(live, nnz_row, 0)
    lens = np.zeros(m, np.int64)
    lens[rmap[live]] = nnz_row[live]
    row_ptr = np.concatenate([[0], np.cumsum(lens)])
    total = int(row_ptr[-1])
    out_col = np.full(max(total, 1), n, np.int32)
    out_val = np.zeros(max(total, 1), C.values.dtype)
    m_loc = C.rows_per_shard
    for (d0, cb), (_, vb) in zip(_host_blocks(C.col_ind),
                                 _host_blocks(C.values)):
        r0 = d0 * m_loc
        rows = slice(r0, r0 + cb.shape[0] * m_loc)
        cnt = nnz_row[rows]
        keep = np.arange(w) < cnt[:, None]
        # row-major selection keeps each row's left-justified entries in
        # order; row r's run starts at row_ptr[rmap[r]]
        start = np.repeat(row_ptr[np.maximum(rmap[rows], 0)], cnt)
        first = np.repeat(np.cumsum(cnt) - cnt, cnt)
        dst = start + np.arange(int(cnt.sum())) - first
        out_col[dst] = cb.reshape(-1, w)[keep]
        out_val[dst] = vb.reshape(-1, w)[keep]
    return CSR.from_arrays(row_ptr.astype(np.int32), out_col, out_val,
                           (m, n), nnz=total)
