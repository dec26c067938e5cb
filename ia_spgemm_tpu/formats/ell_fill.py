"""Gather-based CSR->ELL fill.

The reference's CSRtoELL packs rows left-justified with a serial loop
(ell/common_ell.h:30-77). On the device: out[r, j] = entries[rp[r] + j],
masked at j >= len(r) — one packed (col | value-bits) gather at (m*K)
positions.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("width", "nrows"))
def ell_fill_gather(row_ptr, col_ind, values, *, width: int, nrows: int):
    """(row_ptr, col, val) CSR arrays -> (m, K) ELL col/val tables.

    col_ind/values must already be padded by >= width entries past nnz.
    """
    nnz_row = (row_ptr[1:] - row_ptr[:-1]).astype(jnp.int32)
    slot = jax.lax.broadcasted_iota(jnp.int32, (nrows, width), 1)
    pos = row_ptr[:-1, None] + slot                       # (m, K)
    pos = jnp.clip(pos, 0, col_ind.shape[0] - 1).reshape(-1)
    valid = slot < nnz_row[:, None]
    if values.dtype == jnp.float32:
        packed = jnp.stack(
            [col_ind, jax.lax.bitcast_convert_type(values, jnp.int32)],
            axis=1)                                       # (N, 2)
        g = packed[pos]
        col = g[:, 0].reshape(nrows, width)
        val = jax.lax.bitcast_convert_type(g[:, 1], jnp.float32
                                           ).reshape(nrows, width)
    else:
        col = col_ind[pos].reshape(nrows, width)
        val = values[pos].reshape(nrows, width)
    col = jnp.where(valid, col, -1)
    val = jnp.where(valid, val, jnp.zeros_like(val))
    return col, val, nnz_row
