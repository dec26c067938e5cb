"""ELL x ELL SpGEMM — row-local expand/sort/compress over padded rows.

The reference's ELL_MUL_ELL reuses the Gustavson mask + linked-list
accumulator into padded rows (ell/common_ell.h:80-189). Here ELL's
rectangular (rows, K) layout is used directly: all Ka*Kb candidate
products of a row are materialized as one padded row, then sorted and
compressed in-row (ops/rowsort.py) — no global sort. Fully static
shapes: output width Kc = min(ncols, Ka*Kb).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ia_spgemm_tpu.formats.types import ELL
from ia_spgemm_tpu.ops.rowsort import SENTINEL, sort_compress_rows


def expand_rows(a_col, a_val, b_col, b_val):
    """Every candidate product of each A row: slot (ka, kb) of row i
    multiplies A[i, ka] with B[a_col[i, ka], kb]. Returns (m, Ka*Kb)
    keys (B's column, SENTINEL for empty slots) and values."""
    m, ka = a_col.shape
    kb = b_col.shape[1]
    val_dtype = jnp.result_type(a_val.dtype, b_val.dtype)
    rows = jnp.clip(a_col, 0, b_col.shape[0] - 1)
    j = b_col[rows]                                    # (m, Ka, Kb)
    bv = b_val[rows]
    ok = (a_col >= 0)[:, :, None] & (j >= 0)
    key = jnp.where(ok, j, SENTINEL).reshape(m, ka * kb)
    val = jnp.where(ok, a_val[:, :, None].astype(val_dtype)
                    * bv.astype(val_dtype), 0).reshape(m, ka * kb)
    return key, val


@functools.partial(jax.jit, static_argnames=("out_width",))
def _ell_core(a_col, a_val, b_col, b_val, *, out_width: int):
    key, val = expand_rows(a_col, a_val, b_col, b_val)
    return sort_compress_rows(key, val, out_width=out_width)


def spgemm_ell(A: ELL, B: ELL, out_width: int | None = None) -> ELL:
    """C = A @ B with both operands ELL (reference: ell/common_ell.h:80-189)."""
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    Kc = out_width or min(B.ncols, A.max_nnz_per_row * B.max_nnz_per_row)
    Kc = max(Kc, 1)
    col, val, nnz_row = _ell_core(A.col_ind, A.values, B.col_ind, B.values,
                                  out_width=Kc)
    return ELL(col_ind=col, values=val, nnz_row=nnz_row,
               nnz=jnp.sum(nnz_row).astype(jnp.int32),
               shape=(A.nrows, B.ncols))
