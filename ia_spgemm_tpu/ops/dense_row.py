"""Dense-row-accumulator SpGEMM (Gustavson with a dense accumulator).

The reference's CPU kernels accumulate each output row into a dense
per-thread array indexed by column (`sums[col] += v`, with a mask/linked
list to track touched columns — csr/common_csr.h:130-189). Here the
accumulator is the whole (m, n) output and each ELL slot of A is one
fused gather-multiply-add over every row:

    for each ELL slot kk:
        acc[r, :] += A_val[r, kk] * B[A_col[r, kk], :]

a `lax.scan` over the Ka slots. The update is an elementwise
multiply-add, never a matrix product, so no reduced-precision matrix
unit can round it. This wins when C's rows are dense-ish (n moderate):
no sort, no scatter. B is taken dense ((k, n)); the densification is
format-conversion time, like any other format's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ia_spgemm_tpu import config as cfg
from ia_spgemm_tpu.formats.types import Dense, ELL


@jax.jit
def _dense_row_core(a_col, a_val, b_dense):
    m, _ = a_col.shape
    k, n = b_dense.shape

    def slot(acc, kk):
        col = a_col[:, kk]
        v = jnp.where(col >= 0, a_val[:, kk], 0).astype(b_dense.dtype)
        return acc + v[:, None] * b_dense[jnp.clip(col, 0, k - 1)], None

    acc, _ = jax.lax.scan(slot, jnp.zeros((m, n), b_dense.dtype),
                          jnp.arange(a_col.shape[1]))
    return acc


def spgemm_dense_row(A: ELL, B: Dense, *,
                     config: cfg.SpGEMMConfig = cfg.DEFAULT_CONFIG) -> Dense:
    """C = A @ B, A in ELL, B dense; dense-row accumulator. Raises
    ValueError when B and the (m, n) accumulator exceed the config's
    dense budget."""
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    itemsize = jnp.dtype(B.dtype).itemsize
    need = (A.nrows + B.nrows) * B.ncols * itemsize
    if need > config.dense_budget():
        raise ValueError(
            f"dense_row needs {need} bytes for B and the accumulator, "
            f"over the dense budget ({config.dense_budget():.0f})")
    return Dense(values=_dense_row_core(A.col_ind, A.values, B.values))
