"""Symbolic pass — nnz/expansion upper bounds computed ON DEVICE.

The reference's symbolic phase walks every row with a dense marker to
count nnz(C) exactly (csr/common_csr.h:100-125). Under XLA, shapes must
be static, so the symbolic results feed HOST-side planners; what matters
is computing them without shipping the index arrays to the host. These
kernels reduce on device (gather + segment arithmetic — the vector form
of the reference's per-row loops) and the planner reads back a few
scalars instead of O(nnz) bytes.

Quantities:
  row_flops[r]  = sum over stored a_rj of nnz(B row j)  — per-row
                  intermediate products (the reference's GetFlop
                  restricted to one row, csr/common_csr.h:290-304).
  expansion E   = sum(row_flops) — the ESC buffer bound.
  nnz_c bound   = sum(min(row_flops, n)) — tighter per-row cap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ia_spgemm_tpu.formats.types import CSR
from ia_spgemm_tpu.utils.scans import entry_rows


@jax.jit
def row_flops_csr(a_row_ptr, a_col_ind, a_nnz, b_row_ptr):
    """(m,) int32 per-row intermediate-product counts, on device."""
    m = a_row_ptr.shape[0] - 1
    cap = a_col_ind.shape[0]
    k = b_row_ptr.shape[0] - 1
    col = jnp.clip(a_col_ind, 0, k - 1)
    ln = (b_row_ptr[col + 1] - b_row_ptr[col]).astype(jnp.int32)
    valid = jnp.arange(cap, dtype=jnp.int32) < a_nnz
    rows = entry_rows(a_row_ptr, cap)
    return jax.ops.segment_sum(jnp.where(valid, ln, 0),
                               jnp.clip(rows, 0, m - 1), num_segments=m,
                               indices_are_sorted=True)


def plan_symbolic(A: CSR, B: CSR, *, return_rows: bool = False):
    """Host planner entry: (E, nnz_c_bound, max_row_flops) as python ints,
    plus the (m,) int64 per-row flops array when return_rows (feeds the
    workspace-slab partitioner, the reference's cumulative_row_workspace,
    coo_dev/common_coo_dev.h:388-421).

    The per-row reduction runs on device; only the (m,) row_flops vector
    is read back (the final int64 sums happen on host because JAX runs
    without 64-bit integers by default and E can exceed int32).

    E feeds the ESC expansion capacity, the nnz bound feeds out_capacity,
    max_row_flops feeds the bitonic width / row-split planners.
    """
    import numpy as np
    # Overflow pre-check: the device reduction is int32. A single row can
    # wrap silently when max_row_nnz(A) * max_row_nnz(B) >= 2^31, which
    # would bypass the caller's 'expansion overflows int32' error with an
    # undersized capacity. Bound it from the row pointers (cheap host
    # readback of (m+1,)+(k+1,) ints) and recompute per-row flops on the
    # host in int64 when the bound is reachable.
    a_ptr = np.asarray(A.row_ptr, dtype=np.int64)
    b_ptr = np.asarray(B.row_ptr, dtype=np.int64)
    max_a = int(np.max(np.diff(a_ptr), initial=0))
    max_b = int(np.max(np.diff(b_ptr), initial=0))
    if max_a * max_b >= 2**31:
        col = np.asarray(A.col_ind, dtype=np.int64)[:int(A.nnz)]
        b_len = np.diff(b_ptr)
        ln = b_len[np.clip(col, 0, len(b_len) - 1)]
        rows = np.repeat(np.arange(len(a_ptr) - 1),
                         np.diff(a_ptr).clip(min=0))[:int(A.nnz)]
        rf = np.zeros(len(a_ptr) - 1, dtype=np.int64)
        np.add.at(rf, rows, ln)
    else:
        rf = np.asarray(row_flops_csr(A.row_ptr, A.col_ind, A.nnz,
                                      B.row_ptr)).astype(np.int64)
    if rf.size == 0:
        out = (0, 0, 0)
        return out + (rf,) if return_rows else out
    out = (int(rf.sum()), int(np.minimum(rf, B.ncols).sum()),
           int(rf.max()))
    return out + (rf,) if return_rows else out
