"""Format conversions + the reference's size formulas and viability guards.

Each conversion is split into a host-side *planner* (computes the
data-dependent static dimensions: ELL's K, DIA's diagonal set) and a jitted
*fill* over static shapes. The reference does both in one C++ pass
(detail/dia/common_dia.h:29-96, ell/common_ell.h:30-77, coo/common_coo.h:29-66).

Size formulas replicate the reference byte-for-byte (sizeof(int)=4,
VALUE_TYPE=double=8):
  sizeofcsr (csr/common_csr.h:196-202), sizeofdia (dia/common_dia.h:20-26),
  sizeofell (ell/common_ell.h:21-27),   sizeofcoo (coo/common_coo.h:20-26).
The viability guard rejects a format when its size exceeds ratio x CSR
(50x on CPU, 20x on GPU; dia/common_dia.h:56, GPU dia/common_dia.h:51).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ia_spgemm_tpu import config as cfg
from ia_spgemm_tpu.formats.types import CSR, COO, DIA, ELL, Dense
from ia_spgemm_tpu.utils import scans as scan_utils


# --------------------------------------------------------------------------
# Size formulas (bytes) — identical arithmetic to the reference.
# --------------------------------------------------------------------------

def sizeof_csr(nrows: int, nnz: int) -> float:
    """csr/common_csr.h:196-202."""
    return cfg.SIZEOF_INDEX * (nrows + 1 + nnz + 3) + cfg.SIZEOF_VALUE * nnz


def sizeof_dia(nrows: int, ncols: int, num_diagonals: int) -> float:
    """dia/common_dia.h:20-26."""
    return (cfg.SIZEOF_INDEX * (nrows + ncols - 1 + num_diagonals + 3)
            + cfg.SIZEOF_VALUE * (nrows * num_diagonals))


def sizeof_ell(nrows: int, max_nnz_per_row: int) -> float:
    """ell/common_ell.h:21-27."""
    return (cfg.SIZEOF_INDEX * (nrows + nrows * max_nnz_per_row + 4)
            + cfg.SIZEOF_VALUE * (nrows * max_nnz_per_row))


def sizeof_coo(nrows: int, nnz: int) -> float:
    """coo/common_coo.h:20-26."""
    return cfg.SIZEOF_INDEX * (nrows + 1 + 2 * nnz + 3) + cfg.SIZEOF_VALUE * nnz


def dia_viable(nrows, ncols, nnz, num_diagonals,
               ratio: float = cfg.SIZE_GUARD_RATIO_CPU) -> bool:
    return sizeof_dia(nrows, ncols, num_diagonals) < ratio * sizeof_csr(nrows, nnz)


def ell_viable(nrows, nnz, max_nnz_per_row,
               ratio: float = cfg.SIZE_GUARD_RATIO_CPU) -> bool:
    return sizeof_ell(nrows, max_nnz_per_row) < ratio * sizeof_csr(nrows, nnz)


def coo_viable(nrows, nnz, ratio: float = cfg.SIZE_GUARD_RATIO_CPU) -> bool:
    return sizeof_coo(nrows, nnz) < ratio * sizeof_csr(nrows, nnz)


# --------------------------------------------------------------------------
# CSR -> COO (csr/common_coo.h:29-66 CSRtoCOO)
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("capacity", "nrows"))
def _csr_to_coo_fill(row_ptr, col_ind, values, nnz, *, capacity, nrows):
    idx = jnp.arange(capacity, dtype=jnp.int32)
    row_ind = scan_utils.entry_rows(row_ptr, capacity)
    row_ind = jnp.where(idx < nnz, row_ind, nrows)
    return row_ind


def csr_to_coo(A: CSR) -> COO:
    row_ind = _csr_to_coo_fill(A.row_ptr, A.col_ind, A.values, A.nnz,
                               capacity=A.capacity, nrows=A.nrows)
    return COO(row_offset=A.row_ptr, row_ind=row_ind, col_ind=A.col_ind,
               values=A.values, nnz=A.nnz, shape=A.shape)


def coo_to_csr(A: COO) -> CSR:
    return CSR(row_ptr=A.row_offset, col_ind=A.col_ind, values=A.values,
               nnz=A.nnz, shape=A.shape)


# --------------------------------------------------------------------------
# CSR -> ELL (ell/common_ell.h:30-77 CSRtoELL)
# --------------------------------------------------------------------------

def plan_ell_width(A: CSR) -> int:
    """Host planner: K = max nnz per row (ell/common_ell.h:33-39)."""
    rp = np.asarray(A.row_ptr)
    if A.nrows == 0:
        return 0
    return int(np.max(np.diff(rp)))


def csr_to_ell(A: CSR, width: int | None = None,
               check_guard: bool = True,
               ratio: float = cfg.SIZE_GUARD_RATIO_CPU) -> ELL | None:
    """Returns None when the viability guard rejects the format
    (reference sets choice=false, ell/common_ell.h:71-74)."""
    K = plan_ell_width(A) if width is None else width
    if width is not None and width < plan_ell_width(A):
        # a narrower width would scatter a long row's overflow into its
        # NEIGHBOR's slots (and return nnz_row > stored entries on the
        # gather path) — refuse rather than corrupt
        raise ValueError(
            f"width {width} < max row length {plan_ell_width(A)}; "
            "ELL cannot truncate rows")
    if check_guard and not ell_viable(A.nrows, int(A.nnz), K, ratio):
        return None
    if K == 0:
        K = 1  # keep static shapes non-degenerate
    # gather fill: one packed gather per (m*K) slot, 0.29 ms against the
    # former scatter fill's 0.67 ms at 8.9M nnz on an H100 (power limit
    # 400 W)
    from ia_spgemm_tpu.formats.ell_fill import ell_fill_gather
    col_p = jnp.pad(A.col_ind, (0, K), constant_values=-1)
    val_p = jnp.pad(A.values, (0, K))
    col, val, nnz_row = ell_fill_gather(A.row_ptr, col_p, val_p,
                                        width=K, nrows=A.nrows)
    out = ELL(col_ind=col, values=val, nnz_row=nnz_row, nnz=A.nnz,
              shape=A.shape)
    # lazy host views: when A's host CSR arrays are already cached
    # (readers/from_scipy register them), the ELL grids can be DERIVED
    # on the host instead of pulled back through the device link.
    # Thunks cost nothing unless a planner actually asks.
    from ia_spgemm_tpu.utils import hostcache
    rp_h = hostcache.peek(A.row_ptr)
    ci_h = hostcache.peek(A.col_ind)
    vv_h = hostcache.peek(A.values)
    if rp_h is not None and ci_h is not None:
        m = A.nrows
        Kc = K

        def _grid(fill, src, dtype):
            # width >= max row length is a csr_to_ell invariant, so the
            # left-justified fill is exactly the CSR entry stream
            def thunk():
                rl = np.diff(rp_h.astype(np.int64))
                total = int(rl.sum())
                g = np.full((m, Kc), fill, dtype)
                rows = np.repeat(np.arange(m), rl)
                slots = np.arange(total) \
                    - np.repeat(rp_h[:-1].astype(np.int64), rl)
                g[rows, slots] = src[:total]
                return g
            return thunk

        hostcache.register(out.col_ind, _grid(-1, ci_h, np.int32))
        if vv_h is not None:
            hostcache.register(
                out.values, _grid(0, vv_h, vv_h.dtype))
        hostcache.register(
            out.nnz_row,
            lambda: np.diff(rp_h.astype(np.int64)).astype(np.int32))
    return out


def ell_to_csr(A: ELL) -> CSR:
    m, K = A.col_ind.shape
    nnz_row = A.nnz_row
    row_ptr = jnp.concatenate([jnp.zeros(1, jnp.int32),
                               jnp.cumsum(nnz_row).astype(jnp.int32)])
    slot = jax.lax.broadcasted_iota(jnp.int32, (m, K), 1)
    valid = slot < nnz_row[:, None]
    dst = jnp.where(valid, row_ptr[:-1][:, None] + slot, m * K)
    cap = m * K
    col = jnp.full(cap + 1, A.ncols, dtype=jnp.int32)
    val = jnp.zeros(cap + 1, dtype=A.values.dtype)
    col = col.at[dst.reshape(-1)].set(
        jnp.where(valid, A.col_ind, A.ncols).reshape(-1))
    val = val.at[dst.reshape(-1)].set(
        jnp.where(valid, A.values, 0).reshape(-1))
    return CSR(row_ptr=row_ptr, col_ind=col[:cap], values=val[:cap],
               nnz=A.nnz, shape=A.shape)


def bcsr_to_csr(A) -> CSR:
    """BlockCSR -> exact CSR: undo the 128-lane row alignment with one
    flat scatter of the used block slots to their compact positions
    (the same dst-scatter shape as ell_to_csr above)."""
    from ia_spgemm_tpu.formats.types import BlockCSR
    assert isinstance(A, BlockCSR)
    nb = A.capacity_blocks
    m = A.nrows
    nnz_row = A.nnz_row
    row_ptr = jnp.concatenate([jnp.zeros(1, jnp.int32),
                               jnp.cumsum(nnz_row).astype(jnp.int32)])
    # block b's row: #rows whose block span ended at or before b
    marks = jnp.zeros((nb + 1,), jnp.int32
                      ).at[A.blk_ptr[1:]].add(1, mode="drop")
    row_of = jnp.cumsum(marks[:nb])              # == m past the used end
    rc = jnp.minimum(row_of, max(m - 1, 0))
    lane = jax.lax.broadcasted_iota(jnp.int32, (nb, 128), 1)
    inrow = (jax.lax.iota(jnp.int32, nb)
             - A.blk_ptr[rc])[:, None] * 128 + lane
    valid = (row_of < m)[:, None] & (inrow < nnz_row[rc][:, None])
    cap = max(nb * 128, 1)
    dst = jnp.where(valid, row_ptr[rc][:, None] + inrow, cap)
    col = jnp.full(cap + 1, A.ncols, dtype=jnp.int32)
    val = jnp.zeros(cap + 1, dtype=A.val_blocks.dtype)
    col = col.at[dst.reshape(-1)].set(
        jnp.where(valid, A.col_blocks, A.ncols).reshape(-1), mode="drop")
    val = val.at[dst.reshape(-1)].set(
        jnp.where(valid, A.val_blocks, 0).reshape(-1), mode="drop")
    return CSR(row_ptr=row_ptr, col_ind=col[:cap], values=val[:cap],
               nnz=A.nnz, shape=A.shape)


# --------------------------------------------------------------------------
# CSR -> DIA (dia/common_dia.h:29-96 CSRtoDIA)
# --------------------------------------------------------------------------

def plan_dia_offsets(A: CSR) -> np.ndarray:
    """Host planner: sorted offsets (col - row) of occupied diagonals.

    The reference marks diag_map[(m - i) + j] (dia/common_dia.h:36-49) and
    emits offsets n - m ascending (dia/common_dia.h:63-71); `col - row`
    ascending is the identical set.
    """
    rp = np.asarray(A.row_ptr)
    nnz = int(A.nnz)
    ci = np.asarray(A.col_ind)[:nnz]
    ri = np.repeat(np.arange(A.nrows, dtype=np.int64), np.diff(rp))
    offs = np.unique(ci.astype(np.int64) - ri)
    return offs.astype(np.int32)


@functools.partial(jax.jit, static_argnames=("num_diagonals", "nrows", "ncols"))
def _csr_to_dia_fill(row_ptr, col_ind, values, nnz, offsets,
                     *, num_diagonals, nrows, ncols):
    cap = col_ind.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    row = jnp.clip(scan_utils.entry_rows(row_ptr, cap), 0, nrows - 1)
    off = col_ind - row
    # slot lookup through the dense diag->slot map (the reference's
    # diagonal_ind, dia/common_dia.h:63-71): one small scatter + one
    # gather per entry, instead of a per-entry binary search
    dense_idx = offsets + (nrows - 1)
    diag_ind = jnp.full(nrows + ncols - 1, -1, dtype=jnp.int32)
    diag_ind = diag_ind.at[dense_idx].set(
        jnp.arange(num_diagonals, dtype=jnp.int32))
    slot = diag_ind[jnp.clip(off + nrows - 1, 0, nrows + ncols - 2)]
    # slot = -1 means the entry's diagonal is NOT in `offsets` (caller-
    # supplied subset): drop it rather than clip it onto slot 0, which
    # silently overwrote the first diagonal's values
    valid = (idx < nnz) & (slot >= 0)
    slot = jnp.clip(slot, 0, num_diagonals - 1)
    flat = jnp.where(valid, row * num_diagonals + slot, nrows * num_diagonals)
    vals = jnp.zeros(nrows * num_diagonals + 1, dtype=values.dtype)
    vals = vals.at[flat].set(jnp.where(valid, values, 0))
    return vals[:-1].reshape(nrows, num_diagonals), diag_ind


def csr_to_dia(A: CSR, offsets: np.ndarray | None = None,
               check_guard: bool = True,
               ratio: float = cfg.SIZE_GUARD_RATIO_CPU) -> DIA | None:
    offs = plan_dia_offsets(A) if offsets is None else np.asarray(offsets)
    nd = len(offs)
    if check_guard and not dia_viable(A.nrows, A.ncols, int(A.nnz), nd, ratio):
        return None
    if nd == 0:
        offs = np.zeros(1, np.int32)
        nd = 1
    vals, diag_ind = _csr_to_dia_fill(
        A.row_ptr, A.col_ind, A.values, A.nnz, jnp.asarray(offs),
        num_diagonals=nd, nrows=A.nrows, ncols=A.ncols)
    return DIA(offsets=jnp.asarray(offs, jnp.int32), values=vals,
               diag_ind=diag_ind, nnz=A.nnz, shape=A.shape)


def dia_to_csr(A: DIA, capacity: int | None = None) -> CSR:
    """Host-side (capacity is data-dependent)."""
    return CSR.from_scipy(A.to_scipy(), capacity=capacity)


# --------------------------------------------------------------------------
# CSR <-> Dense (dense/common_dense.h:20-40 CSRtoDENSE)
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("nrows", "ncols"))
def _csr_to_dense_fill(row_ptr, col_ind, values, nnz, *, nrows, ncols):
    cap = col_ind.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    row = jnp.clip(scan_utils.entry_rows(row_ptr, cap), 0, nrows - 1)
    valid = idx < nnz
    flat = jnp.where(valid, row * ncols + jnp.clip(col_ind, 0, ncols - 1),
                     nrows * ncols)
    out = jnp.zeros(nrows * ncols + 1, dtype=values.dtype)
    # .add (not .set): duplicates accumulate, matching SpGEMM semantics.
    out = out.at[flat].add(jnp.where(valid, values, 0))
    return out[:-1].reshape(nrows, ncols)


def csr_to_dense(A: CSR) -> Dense:
    return Dense(values=_csr_to_dense_fill(A.row_ptr, A.col_ind, A.values,
                                           A.nnz, nrows=A.nrows,
                                           ncols=A.ncols))


def dense_to_csr(A: Dense, capacity: int | None = None, tol: float = 0.0) -> CSR:
    """Host-side compaction of a dense matrix to CSR."""
    import scipy.sparse as sp
    arr = np.asarray(A.values)
    if tol > 0:
        arr = np.where(np.abs(arr) <= tol, 0, arr)
    return CSR.from_scipy(sp.csr_matrix(arr), capacity=capacity)


# --------------------------------------------------------------------------
# Transpose (reference defines Transpose_CSR, csr/common_csr.h:52-82, and the
# GPU driver builds B = A^T via mkl_dcsrcsc, main.cu:261-269).
# --------------------------------------------------------------------------

def transpose_csr(A: CSR, capacity: int | None = None) -> CSR:
    nnz = int(A.nnz)
    rp = np.asarray(A.row_ptr)
    ci = np.asarray(A.col_ind)[:nnz]
    vv = np.asarray(A.values)[:nnz]
    ri = np.repeat(np.arange(A.nrows, dtype=np.int64), np.diff(rp))
    order = np.argsort(ci, kind="stable")
    counts = np.bincount(ci, minlength=A.ncols)
    row_ptr = np.zeros(A.ncols + 1, dtype=np.int32)
    row_ptr[1:] = np.cumsum(counts).astype(np.int32)
    cap = capacity or max(nnz, 1)
    col = np.full(cap, A.nrows, dtype=np.int32)
    val = np.zeros(cap, dtype=vv.dtype)
    col[:nnz] = ri[order]
    val[:nnz] = vv[order]
    return CSR.from_arrays(row_ptr, col, val, (A.ncols, A.nrows), nnz=nnz)
