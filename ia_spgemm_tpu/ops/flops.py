"""FLOP counting — the reference's GetFlop (csr/common_csr.h:290-304):
flops = sum over stored a_ij of nnz(B row j) = number of intermediate
products. GFLOPS reporting multiplies by 2 (multiply + add, main.cpp:989).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ia_spgemm_tpu.formats.types import CSR


def get_flop(A: CSR, B: CSR) -> int:
    """Host-side exact count (numpy, O(nnz))."""
    b_len = np.diff(np.asarray(B.row_ptr)).astype(np.int64)
    nnzA = int(A.nnz)
    colA = np.asarray(A.col_ind)[:nnzA]
    if nnzA == 0:
        return 0
    return int(b_len[np.clip(colA, 0, B.nrows - 1)].sum())


def row_flops(A: CSR, B: CSR) -> np.ndarray:
    """Exact intermediate products per A row (host, nnz-scaled numpy)."""
    from ia_spgemm_tpu.utils import hostcache
    nnzA = int(A.nnz)
    a_rp = hostcache.host_view(A.row_ptr).astype(np.int64)
    a_col = hostcache.host_view(A.col_ind)[:nnzA].astype(np.int64)
    b_len = np.diff(hostcache.host_view(B.row_ptr)).astype(np.int64)
    ecs = np.concatenate(
        [[0], np.cumsum(b_len[np.clip(a_col, 0, B.nrows - 1)])])
    return ecs[a_rp[1:]] - ecs[a_rp[:-1]]


@jax.jit
def get_flop_jit(a_col_ind, a_nnz, b_row_ptr) -> jax.Array:
    """Traceable variant for use inside jitted pipelines."""
    cap = a_col_ind.shape[0]
    k = b_row_ptr.shape[0] - 1
    col = jnp.clip(a_col_ind, 0, k - 1)
    ln = b_row_ptr[col + 1] - b_row_ptr[col]
    valid = jnp.arange(cap, dtype=jnp.int32) < a_nnz
    return jnp.sum(jnp.where(valid, ln, 0))
