"""Slab-packed ESC — expand/sort/compress with many C rows per sort row.

Reference semantics: the GPU ESC pipeline
(IA-SPGEMM-GPU_release/detail/csr_dev/common_csr_dev.h:134-254) expands
every intermediate product, sorts the whole stream by (row, col), and
compresses duplicates with reduce_by_key; the sliced variant
(coo_dev/common_coo_dev.h:388-450) partitions rows so each slice's
expansion fits the workspace.

This engine keeps the ESC structure but packs WHOLE ROWS back-to-back
into fixed-width SLABS, so the sort is a batch of short row sorts
instead of one global sort:

  1. plan (host, m-sized numpy): greedy row packing over the per-row
     product counts — the reference's upper_bound search over
     cummulative_row_workspace (coo_dev:388-421) at slab scale.
  2. expand (device): the global ESC expansion (esc._expand_factors);
     slab s takes the contiguous product range of its rows, keyed
     local_row * n + col so one row sort orders every packed row at
     once (rows stay disjoint in key space).
  3. sort + compress: ops/rowsort.py over the (slabs, width) grid.

The result is the native SlabCSR (exact, row-major sorted, free
checksum); flattening to CSR is a priced conversion (slab_to_csr), like
BlockCSR/ELL. f32 only; fp64 stays on the global-sort engine whose
summation order the golden tests pin. dd=True carries exact Dekker
(hi, lo) products through the same sort and combines runs under
two-sum (fp64-grade sums from f32 operands).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ia_spgemm_tpu import config as cfg
from ia_spgemm_tpu.formats.types import (
    CSR,
    SlabCSR,
    pytree_dataclass,
    static_field,
)
from ia_spgemm_tpu.ops import esc
from ia_spgemm_tpu.ops.flops import row_flops
from ia_spgemm_tpu.ops.rowsort import (
    SENTINEL,
    compress_sorted_rows,
    sort_compress_rows,
)
from ia_spgemm_tpu.utils.scans import entry_rows

# Slab width bounds (products per slab). Rows with more products than
# SLAB_MAX_WIDTH go to the hybrid's global-sort residual. Not tuned on
# the card yet.
SLAB_MAX_WIDTH = 1024
SLAB_MIN_WIDTH = 512
# Share of device memory the (key, value) slab grid may take.
SLAB_BUDGET_FRACTION = 1 / 8


def slab_elems_budget() -> int:
    """Padded product slots (n_slabs * width) the grid may hold."""
    return cfg.memory_budget(SLAB_BUDGET_FRACTION) // 8


@dataclasses.dataclass
class SlabPlan:
    """Host-side slab packing + device operands for one (A, B) problem."""
    width: int
    n_slabs: int           # padded to a bucket capacity
    out_cap: int
    nnz_bound: int         # exact output-nnz upper bound (pre-bucket)
    m: int
    n: int
    padded_slots: int      # n_slabs * width (sort volume incl. padding)
    true_flops: int        # exact E (GetFlop)
    e_cap: int             # bucketed expansion capacity
    # device arrays, (n_slabs,) each
    slab_base: jax.Array       # first product of the slab
    slab_count: jax.Array      # products in the slab
    slab_first_row: jax.Array  # global row of local row 0


@functools.partial(jax.jit,
                   static_argnames=("e_cap", "W", "n", "k", "dd"))
def _slab_run(a_rp, a_col, a_val, a_nnz, b_rp, b_col, b_val,
              base, count, sfr, *, e_cap: int, W: int, n: int, k: int,
              dd: bool):
    """The whole per-call slab pipeline under ONE jit: expand -> slab
    grid -> row sort -> compress. Returns (keys, values, values_lo or
    None, nnz per slab, total nnz)."""
    cap = a_col.shape[0]
    ent_valid = jnp.arange(cap, dtype=jnp.int32) < a_nnz
    i, j, av, bv, _ = esc._expand_factors(
        entry_rows(a_rp, cap), jnp.clip(a_col, 0, k - 1), a_val,
        ent_valid, b_rp, b_col, b_val, e_cap=e_cap)
    S = base.shape[0]
    t = jax.lax.broadcasted_iota(jnp.int32, (S, W), 1)
    ok = t < count[:, None]
    idx = jnp.clip(base[:, None] + t, 0, e_cap - 1)
    key = jnp.where(ok, (i[idx] - sfr[:, None]) * n + j[idx], SENTINEL)
    a_s, b_s = av[idx], bv[idx]
    if not dd:
        keys, vals, nnz = sort_compress_rows(
            key, jnp.where(ok, a_s * b_s, 0.0), out_width=W)
        return keys, vals, None, nnz, jnp.sum(nnz, dtype=jnp.int32)
    hi, lo = esc._two_product(a_s, b_s)
    key_s, hi_s, lo_s = jax.lax.sort(
        (key, jnp.where(ok, hi, 0.0), jnp.where(ok, lo, 0.0)),
        dimension=1, num_keys=1, is_stable=True)
    keys, (his, los), nnz = compress_sorted_rows(
        key_s, (hi_s, lo_s), out_width=W, add=esc.dd_add)
    return keys, his, los, nnz, jnp.sum(nnz, dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("n", "out_cap"))
def _compact_xla(keys, vals, nnz_s, sfr, *, n: int, out_cap: int):
    """Slab concatenation as an XLA drop-mode scatter (~per-element
    cost): out position base[s] + t for survivor t of slab s."""
    S, W = keys.shape
    base = jnp.concatenate([jnp.zeros(1, jnp.int32),
                            jnp.cumsum(nnz_s[:, 0], dtype=jnp.int32)])
    t = jax.lax.broadcasted_iota(jnp.int32, (S, W), 1)
    ok = t < nnz_s
    dst = jnp.where(ok, base[:-1, None] + t, out_cap).reshape(-1)
    lrow = jnp.floor_divide(keys, n)
    rows = jnp.where(ok, sfr + lrow, 0).reshape(-1)
    cols = jnp.where(ok, keys - lrow * n, 0).reshape(-1)
    vv = jnp.where(ok, vals, 0).reshape(-1)
    out_r = jnp.zeros((out_cap + 1,), jnp.int32).at[dst].set(rows,
                                                             mode="drop")
    out_c = jnp.zeros((out_cap + 1,), jnp.int32).at[dst].set(cols,
                                                             mode="drop")
    out_v = jnp.zeros((out_cap + 1,), vals.dtype).at[dst].set(vv,
                                                              mode="drop")
    return out_r, out_c, out_v


def _compact_gather(keys, vals, nnz_s, sfr, *, n: int, out_cap: int,
                    vals_lo=None):
    """Slab concatenation INVERTED: per-OUTPUT-position source gather.

    The output->source map is piecewise-linear — within slab s, output
    base[s]+t reads slot t — so src(p) = p + off(p) where off jumps
    only at slab starts. off is built with one S-sized telescoping
    scatter + a cumsum, and the payload moves through flat gathers
    instead of scatters. Tail positions (p >= total) clip to the last
    element and are masked by _finalize_csr. Row ids are arithmetic on
    the gathered keys (no third array pass)."""
    S, W = keys.shape
    counts = nnz_s[:, 0]
    base = jnp.concatenate([jnp.zeros(1, jnp.int32),
                            jnp.cumsum(counts, dtype=jnp.int32)])
    # off deltas at each slab's first output position (empty slabs
    # stack their deltas on the same position — add-mode telescoping)
    offs = (jax.lax.iota(jnp.int32, S) * W - base[:-1])
    d_off = offs - jnp.pad(offs[:-1], (1, 0))
    sfr_d = sfr[:, 0] - jnp.pad(sfr[:-1, 0], (1, 0))
    pos_s = jnp.minimum(base[:-1], out_cap)
    g_off = jnp.zeros((out_cap + 1,), jnp.int32
                      ).at[pos_s].add(d_off, mode="drop")
    g_sfr = jnp.zeros((out_cap + 1,), jnp.int32
                      ).at[pos_s].add(sfr_d, mode="drop")
    p = jax.lax.iota(jnp.int32, out_cap)
    src = jnp.clip(p + jnp.cumsum(g_off[:out_cap]), 0, S * W - 1)
    sfr_p = jnp.cumsum(g_sfr[:out_cap])        # slab_first_row per pos
    k = jnp.take(keys.reshape(-1), src)
    vv = jnp.take(vals.reshape(-1), src)
    lrow = jnp.floor_divide(k, n)
    rows = jnp.pad(sfr_p + lrow, (0, 1))
    cols = jnp.pad(k - lrow * n, (0, 1))
    out_v = jnp.pad(vv, (0, 1))
    if vals_lo is not None:
        return rows, cols, out_v, jnp.pad(
            jnp.take(vals_lo.reshape(-1), src), (0, 1))
    return rows, cols, out_v


@functools.partial(jax.jit, static_argnames=("m", "n", "out_cap"))
def _finalize_csr(rows_raw, cols_raw, vals_raw, total,
                  *, m: int, n: int, out_cap: int):
    """Mask the uninitialized/garbage tail past the exact nnz, then
    derive row_ptr from the (ascending) compacted row stream."""
    o = jax.lax.iota(jnp.int32, out_cap)
    live = o < total
    rows = jnp.where(live, rows_raw[:out_cap], m)
    col = jnp.where(live, cols_raw[:out_cap], n)
    val = jnp.where(live, vals_raw[:out_cap], 0.0)
    row_ptr = jnp.searchsorted(
        rows, jnp.arange(m + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    return row_ptr, col, val


def slab_width(max_rf: int, max_width: int = SLAB_MAX_WIDTH) -> int:
    """Slab width for rows of at most max_rf products: the next pow2,
    at least SLAB_MIN_WIDTH (or max_width when that is smaller)."""
    return max(min(SLAB_MIN_WIDTH, max_width),
               1 << max(int(max_rf) - 1, 0).bit_length())


def pack_rows(rf: np.ndarray, W: int) -> np.ndarray:
    """Greedy row packing: slab boundaries [0, r1, ..., m] so that each
    slab's products fit W (every row must have <= W products) — the
    reference's upper_bound over cummulative_row_workspace
    (coo_dev/common_coo_dev.h:388-421)."""
    m = len(rf)
    csum = np.concatenate([[0], np.cumsum(rf)])
    bounds = [0]
    while bounds[-1] < m:
        r0 = bounds[-1]
        r1 = int(np.searchsorted(csum, csum[r0] + W, side="right")) - 1
        bounds.append(max(r1, r0 + 1))
    return np.asarray(bounds, dtype=np.int64)


def padded_slots(rf: np.ndarray, W: int) -> int:
    """Sort slots the slab grid of rows `rf` occupies at width W."""
    return cfg.bucket_capacity(len(pack_rows(rf, W)) - 1) * W


# identity-keyed build cache (same contract as bitonic._BUILD_CACHE):
# jax arrays are immutable, so identical operand objects imply identical
# content; each live entry's runner closes over its operands, pinning
# the ids. FIFO-bounded so dead plans cannot hoard device memory.
_BUILD_CACHE: dict = {}
_BUILD_CACHE_MAX = 2


def clear_plan_cache():
    _BUILD_CACHE.clear()


def plan_slab_csr(A: CSR, B: CSR, *, width: int | None = None,
                  max_width: int = SLAB_MAX_WIDTH, dd: bool = False):
    key = (id(A.row_ptr), id(A.col_ind), id(A.values),
           id(B.row_ptr), id(B.col_ind), id(B.values),
           width, max_width, dd)
    hit = _BUILD_CACHE.get(key)
    if hit is not None:
        return hit[0]
    call = _plan_slab_csr_uncached(A, B, width=width, max_width=max_width,
                                   dd=dd)
    if len(_BUILD_CACHE) >= _BUILD_CACHE_MAX:
        _BUILD_CACHE.pop(next(iter(_BUILD_CACHE)))
    # anchors pinned explicitly: a None (inviable) result closes over
    # nothing, so the ids must be kept alive by the cache itself
    _BUILD_CACHE[key] = (call, (A.row_ptr, A.col_ind, A.values,
                                B.row_ptr, B.col_ind, B.values))
    return call


def _plan_slab_csr_uncached(A: CSR, B: CSR, *, width: int | None,
                            max_width: int, dd: bool):
    """Host-plan the slab engine for C = A @ B (both CSR, f32) and return
    a zero-argument runner producing a SlabCSR — or None when the engine
    is not viable (non-f32, a row's products exceed max_width, or the
    padded volume blows the budget).

    dd=True runs the compensated pipeline: exact Dekker (hi, lo)
    products, two-value-lane sort, two-sum compress — fp64-grade sums
    (~2^-48 relative). The output SlabCSR carries values_lo."""
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    if (A.values.dtype != jnp.float32 or B.values.dtype != jnp.float32):
        return None
    m, n = A.nrows, B.ncols
    if int(A.nnz) == 0 or int(B.nnz) == 0:
        return None  # trivial problems stay on the general engine
    rf = row_flops(A, B)
    max_rf = int(rf.max(initial=0))
    if max_rf == 0:
        return None
    W = int(width) if width else slab_width(max_rf, max_width)
    if max_rf > W or W > max_width:
        return None
    bounds = pack_rows(rf, W)
    csum = np.concatenate([[0], np.cumsum(rf)])
    n_slabs = len(bounds) - 1
    S_pad = cfg.bucket_capacity(n_slabs)
    if S_pad * W > slab_elems_budget():
        return None
    # slab-local keys (row - first_row) * n + col must stay below SENTINEL
    if int(np.diff(bounds).max()) * n >= int(SENTINEL):
        return None
    E = int(csum[-1])
    e_cap = cfg.bucket_capacity(E)
    if e_cap >= 2**31 - 1:
        return None

    def padded(x):
        out = np.zeros(S_pad, np.int32)
        out[:n_slabs] = x
        return jnp.asarray(out)

    nnz_bound = int(np.minimum(rf, n).sum())
    out_cap = cfg.bucket_capacity(max(nnz_bound, 1))
    if out_cap + W >= 2**31:
        return None
    plan = SlabPlan(width=W, n_slabs=S_pad, out_cap=out_cap,
                    nnz_bound=nnz_bound, m=m, n=n,
                    padded_slots=S_pad * W, true_flops=E, e_cap=e_cap,
                    slab_base=padded(csum[bounds[:-1]]),
                    slab_count=padded(np.diff(csum[bounds])),
                    slab_first_row=padded(bounds[:-1]))
    shape = (m, n)

    def call() -> SlabCSR:
        keys, vals, lo, nnz_s, total = _slab_run(
            A.row_ptr, A.col_ind, A.values, A.nnz,
            B.row_ptr, B.col_ind, B.values,
            plan.slab_base, plan.slab_count, plan.slab_first_row,
            e_cap=e_cap, W=W, n=n, k=A.ncols, dd=dd)
        return SlabCSR(keys=keys, values=vals, values_lo=lo,
                       nnz_slab=nnz_s, slab_first_row=plan.slab_first_row,
                       nnz=total, shape=shape)

    call.plan = plan
    return call


def slab_to_csr(C: SlabCSR, *, out_cap: int | None = None,
                engine: str = "gather") -> CSR:
    """Flatten a SlabCSR to exact device CSR.

    Priced conversion (like convert.bcsr_to_csr), NOT part of the
    engine's hot path; use the SlabCSR directly (checksum/to_scipy are
    exact) when a flat layout isn't required. engine="gather" (default)
    inverts the concatenation into flat gathers (see _compact_gather);
    engine="scatter" keeps the drop-mode XLA scatter formulation as the
    A/B baseline."""
    m, n = C.shape
    if out_cap is None:
        # the exact nnz is a device scalar; cap by the grid size
        out_cap = cfg.bucket_capacity(max(int(C.keys.shape[0])
                                          * int(C.keys.shape[1]), 1))
    if engine == "gather":
        parts = _compact_gather(
            C.keys, C.values, C.nnz_slab[:, None],
            C.slab_first_row[:, None], n=n, out_cap=out_cap,
            vals_lo=C.values_lo)
        rows_raw, cols_raw, vals_raw = parts[:3]
        lo_raw = parts[3] if C.values_lo is not None else None
    else:
        rows_raw, cols_raw, vals_raw = _compact_xla(
            C.keys, C.values, C.nnz_slab[:, None],
            C.slab_first_row[:, None], n=n, out_cap=out_cap)
        lo_raw = None
        if C.values_lo is not None:
            _, _, lo_raw = _compact_xla(
                C.keys, C.values_lo, C.nnz_slab[:, None],
                C.slab_first_row[:, None], n=n, out_cap=out_cap)
    row_ptr, col, val = _finalize_csr(
        rows_raw, cols_raw, vals_raw, C.nnz, m=m, n=n, out_cap=out_cap)
    val_lo = None
    if lo_raw is not None:
        val_lo = jnp.where(
            jax.lax.iota(jnp.int32, out_cap) < C.nnz,
            lo_raw[:out_cap], 0.0)
    return CSR(row_ptr=row_ptr, col_ind=col, values=val,
               values_lo=val_lo, nnz=C.nnz, shape=C.shape)


def spgemm_csr_slab(A: CSR, B: CSR, *, width: int | None = None):
    """C = A @ B through the slab engine (native SlabCSR out); None when
    not viable."""
    call = plan_slab_csr(A, B, width=width)
    return call() if call is not None else None


@pytree_dataclass
class HybridCSR:
    """Disjoint-row composition of a SlabCSR (light rows) and a CSR
    (heavy-row residual) — the slab/global hybrid's native output.
    Exact: the parts cover disjoint row sets. A pytree, so
    jax.block_until_ready sees its arrays."""
    light: SlabCSR
    heavy: CSR
    shape: tuple = static_field()

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self):
        return self.light.nnz + self.heavy.nnz

    def checksum(self):
        return self.light.checksum() + self.heavy.checksum()

    def to_scipy(self):
        return (self.light.to_scipy() + self.heavy.to_scipy()).tocsr()


def plan_slab_hybrid(A: CSR, B: CSR, *, max_width: int = SLAB_MAX_WIDTH):
    """Slab engine for the rows it admits + the global-sort engine for
    the heavy residual (rows with more than max_width products) — the
    ESC fallback that stays fast on skewed inputs.

    The reference's sliced ESC partitions rows by workspace
    (coo_dev/common_coo_dev.h:388-421); this partitions by slab width.
    Returns a zero-arg runner producing HybridCSR, or None when A has no
    heavy rows (plain plan_slab_csr applies) or the light part is
    inviable."""
    from ia_spgemm_tpu.utils import hostcache
    if (A.values.dtype != jnp.float32 or B.values.dtype != jnp.float32):
        return None
    nnzA = int(A.nnz)
    if nnzA == 0:
        return None
    a_rp = hostcache.host_view(A.row_ptr).astype(np.int64)
    a_col = hostcache.host_view(A.col_ind)[:nnzA]
    a_val = hostcache.host_view(A.values)[:nnzA]
    heavy = row_flops(A, B) > max_width
    n_heavy = int(heavy.sum())
    if n_heavy == 0 or n_heavy == A.nrows:
        return None

    def split(mask):
        rl = np.diff(a_rp) * mask
        rp = np.concatenate([[0], np.cumsum(rl)]).astype(np.int64)
        keep = np.repeat(mask, np.diff(a_rp))
        total = int(rp[-1])
        col = np.full(max(total, 1), A.ncols, np.int32)
        val = np.zeros(max(total, 1), a_val.dtype)
        col[:total] = a_col[keep]
        val[:total] = a_val[keep]
        return CSR.from_arrays(rp.astype(np.int32), col, val,
                               A.shape, nnz=total)

    A_light = split(~heavy)
    A_heavy = split(heavy)
    light_call = plan_slab_csr(A_light, B, max_width=max_width)
    if light_call is None:
        return None
    heavy_plan = esc.plan_spgemm(A_heavy, B)
    shape = (A.nrows, B.ncols)

    def call() -> HybridCSR:
        return HybridCSR(
            light=light_call(),
            heavy=esc.spgemm_csr(A_heavy, B, heavy_plan, engine="global"),
            shape=shape)

    call.n_heavy = n_heavy
    return call
