"""DIA x DIA SpGEMM — diagonal algebra.

The reference's DIA_mul_DIA (dia/common_dia.h:101-195) runs three phases:
occupancy of output diagonals, offset construction, and a triple loop
accumulating C[i][slot(dA+dB)] += A[i][sA] * B[i+dA][sB].

Here: a diagonal of C at offset dC = dA + dB receives, for every
contributing pair, the elementwise product of A's dA-column with a
dA-shifted view of B's dB-column — pure vector ops of length nrows, scanned
over the (static) ndA x ndB pair list. Output diagonal set is computed by a
host planner from the offset arrays alone.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ia_spgemm_tpu.formats.types import DIA


def plan_dia_out_offsets(A: DIA, B: DIA) -> np.ndarray:
    """Host planner: sorted unique {dA + dB} clipped to C's valid band
    (the reference's phase 1 occupancy flags, dia/common_dia.h:104-140)."""
    oa = np.asarray(A.offsets).astype(np.int64)
    ob = np.asarray(B.offsets).astype(np.int64)
    sums = np.unique((oa[:, None] + ob[None, :]).ravel())
    m, _ = A.shape
    n = B.shape[1]
    sums = sums[(sums >= -(m - 1)) & (sums <= n - 1)]
    if len(sums) == 0:
        sums = np.zeros(1, np.int64)
    return sums.astype(np.int32)


@functools.partial(jax.jit, static_argnames=("m", "ka", "n"))
def _dia_core(a_offs, a_vals, b_offs, b_vals, c_offs, *, m: int, ka: int,
              n: int):
    """Accumulate every (dA, dB) diagonal pair into C's diagonal slots.

    a_vals: (m, ndA); b_vals: (kb_rows, ndB); returns (m, ndC).
    ka = A.ncols == B.nrows.
    """
    nda = a_offs.shape[0]
    ndb = b_offs.shape[0]
    ndc = c_offs.shape[0]
    val_dtype = jnp.result_type(a_vals.dtype, b_vals.dtype)
    rows = jnp.arange(m, dtype=jnp.int32)

    def pair_step(c, p):
        pa = p // ndb
        pb = p % ndb
        dA = a_offs[pa]
        dB = b_offs[pb]
        # middle index j = i + dA must be a valid row of B
        jmid = rows + dA
        ok = (jmid >= 0) & (jmid < ka)
        jmid_c = jnp.clip(jmid, 0, ka - 1)
        av = jax.lax.dynamic_index_in_dim(a_vals, pa, axis=1, keepdims=False)
        bcol = jax.lax.dynamic_index_in_dim(b_vals, pb, axis=1, keepdims=False)
        bv = jnp.where(ok, bcol[jmid_c], 0)
        # output col index kout = i + dA + dB must be valid
        kout = rows + dA + dB
        ok2 = ok & (kout >= 0) & (kout < n)
        prod = jnp.where(ok2, av.astype(val_dtype) * bv.astype(val_dtype), 0)
        slot = jnp.searchsorted(c_offs, dA + dB).astype(jnp.int32)
        slot = jnp.clip(slot, 0, ndc - 1)
        c = jax.lax.dynamic_update_index_in_dim(
            c, jax.lax.dynamic_index_in_dim(c, slot, axis=1,
                                            keepdims=False) + prod,
            slot, axis=1)
        return c, None

    c0 = jnp.zeros((m, ndc), dtype=val_dtype)
    c, _ = jax.lax.scan(pair_step, c0,
                        jnp.arange(nda * ndb, dtype=jnp.int32))
    return c


# Compute-viability budget: _dia_core scans the ndA x ndB pair list
# SEQUENTIALLY (one (m,)-vector FMA per step). A dense-ish matrix at
# m=1024 occupies ~2047 diagonals -> 4.2M scan steps x (m, ndC) carry —
# an hours-long kernel that XLA cannot cancel once dispatched: the
# harness watchdog abandons its thread but the DEVICE stays wedged and
# every later dispatch in the process fails with a device error. The
# reference survives the same blow-up only because pthread_cancel kills
# host OpenMP work (main.cpp:770-793); device work must be rejected
# BEFORE dispatch instead. Budget in scalar FMA terms (pairs * m):
# real DIA territory (bands/scattered diagonals, nd <= ~200) stays well
# under it; dense-ish inputs that would take minutes-to-hours are
# declined like any other viability guard.
DIA_PAIR_FLOP_BUDGET = 2 ** 28


def dia_compute_viable(ndA: int, ndB: int, m: int) -> bool:
    """True when the diagonal-algebra kernel's sequential pair scan fits
    the compute budget (see DIA_PAIR_FLOP_BUDGET)."""
    return int(ndA) * int(ndB) * max(int(m), 1) <= DIA_PAIR_FLOP_BUDGET


def spgemm_dia(A: DIA, B: DIA, out_offsets: np.ndarray | None = None) -> DIA:
    """C = A @ B with both operands DIA (reference: dia/common_dia.h:101-195).

    Raises ValueError when the pair scan exceeds DIA_PAIR_FLOP_BUDGET —
    the un-dispatchable analogue of the reference's watchdog kill."""
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    m, _ = A.shape
    n = B.ncols
    nda, ndb = int(A.offsets.shape[0]), int(B.offsets.shape[0])
    if not dia_compute_viable(nda, ndb, m):
        raise ValueError(
            f"DIA pair scan {nda}x{ndb} over m={m} rows exceeds the "
            f"compute budget ({nda * ndb * m:.2e} > "
            f"{DIA_PAIR_FLOP_BUDGET:.2e} scalar FMAs): the sequential "
            "kernel would run for minutes and cannot be cancelled once "
            "dispatched — use the csr/esc routes for dense-ish inputs")
    c_offs = (plan_dia_out_offsets(A, B) if out_offsets is None
              else np.asarray(out_offsets, np.int32))
    vals = _dia_core(A.offsets, A.values, B.offsets, B.values,
                     jnp.asarray(c_offs), m=m, ka=A.ncols, n=n)
    dense_idx = jnp.asarray(c_offs, jnp.int32) + (m - 1)
    diag_ind = jnp.full(m + n - 1, -1, dtype=jnp.int32)
    diag_ind = diag_ind.at[dense_idx].set(
        jnp.arange(len(c_offs), dtype=jnp.int32))
    nnz = jnp.sum(vals != 0).astype(jnp.int32)
    return DIA(offsets=jnp.asarray(c_offs, jnp.int32), values=vals,
               diag_ind=diag_ind, nnz=nnz, shape=(m, n))
