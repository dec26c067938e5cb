"""Sparse storage formats as pytrees of jnp arrays.

Re-design of the reference's POD structs for XLA
(reference: IA-SPGEMM-CPU_release/detail/format.h:7-76):

- All arrays have *static* shapes (XLA requirement); the true number of
  stored entries `nnz` travels as a 0-d int32 leaf so kernels can produce
  data-dependent results under jit, padded to a static capacity.
- 2-D layouts (ELL values/col_ind as (rows, K); DIA values as (rows, ndiag))
  are dense jnp arrays instead of the reference's row-pointer `malloc2d`
  tables (detail/common.h:19-31).
- Padding conventions: CSR/COO tail entries have col_ind == ncols (a sentinel
  that sorts after every real column) and values == 0; ELL empty slots have
  col_ind == -1 and values == 0 (the reference leaves ELL padding
  uninitialized and relies on nnz_row, ell/common_ell.h:53-55).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

Shape2 = Tuple[int, int]


def pytree_dataclass(cls):
    """A frozen dataclass registered as a JAX pytree: fields made with
    static_field() are static metadata (part of the treedef, like a
    shape), every other field is a leaf."""
    return jax.tree_util.register_dataclass(
        dataclasses.dataclass(frozen=True)(cls))


def static_field(**kwargs):
    return dataclasses.field(metadata={"static": True}, **kwargs)


def _as_nnz(nnz) -> jax.Array:
    return jnp.asarray(nnz, dtype=jnp.int32)


@pytree_dataclass
class CSR:
    """Compressed sparse row (reference: detail/format.h:29-39 CsrMatrix)."""

    row_ptr: jax.Array  # (nrows+1,) int32, row_ptr[-1] == nnz
    col_ind: jax.Array  # (capacity,) int32, tail padded with ncols
    values: jax.Array   # (capacity,) float
    nnz: jax.Array      # 0-d int32 — true entry count
    shape: Shape2 = static_field()
    # Compensated (double-double) results: the low-order halves of the
    # values, as a DEVICE array. values + values_lo is exact in float64;
    # the pair stays resident on device (JAX runs without 64-bit types by
    # default) and consumers combine on the host (values_f64) or reduce
    # under two-sum on device (checksum). None for plain results.
    values_lo: jax.Array | None = None

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def capacity(self) -> int:
        return self.col_ind.shape[0]

    @property
    def dtype(self):
        return self.values.dtype

    def nnz_int(self) -> int:
        return int(self.nnz)

    @classmethod
    def from_arrays(cls, row_ptr, col_ind, values, shape: Shape2,
                    nnz=None) -> "CSR":
        from ia_spgemm_tpu.utils import hostcache
        srcs = (row_ptr, col_ind, values)
        row_ptr = jnp.asarray(row_ptr, dtype=jnp.int32)
        col_ind = jnp.asarray(col_ind, dtype=jnp.int32)
        values = jnp.asarray(values)
        # numpy sources ARE the host views — pin them so the planners
        # never pull these bytes back through the device link
        for dev, src in zip((row_ptr, col_ind, values), srcs):
            if isinstance(src, np.ndarray):
                hostcache.register(dev, src.astype(
                    dev.dtype, copy=False))
        if nnz is None:
            nnz = row_ptr[-1]
        return cls(row_ptr=row_ptr, col_ind=col_ind, values=values,
                   nnz=_as_nnz(nnz), shape=tuple(shape))

    @classmethod
    def from_scipy(cls, mat, capacity: int | None = None) -> "CSR":
        """Build from a scipy.sparse matrix (the test oracle's type)."""
        from ia_spgemm_tpu.utils import hostcache
        m = mat.tocsr()
        m.sum_duplicates()
        nnz = int(m.nnz)
        cap = capacity or max(nnz, 1)
        col = np.full(cap, m.shape[1], dtype=np.int32)
        val = np.zeros(cap, dtype=m.data.dtype)
        col[:nnz] = m.indices
        val[:nnz] = m.data
        rp = np.asarray(m.indptr, np.int32)
        out = cls(row_ptr=jnp.asarray(rp),
                  col_ind=jnp.asarray(col),
                  values=jnp.asarray(val),
                  nnz=_as_nnz(nnz), shape=tuple(m.shape))
        hostcache.register(out.row_ptr, rp)
        hostcache.register(out.col_ind, col)
        hostcache.register(out.values, val)
        return out

    def values_f64(self) -> np.ndarray:
        """Stored values as HOST float64. For compensated results this is
        the exact hi + lo combination (numpy f64 — jnp would round back to
        f32 with x64 disabled, JAX's default)."""
        if self.values_lo is None:
            return np.asarray(self.values, np.float64)
        return (np.asarray(self.values, np.float64)
                + np.asarray(self.values_lo, np.float64))

    def to_scipy(self):
        import scipy.sparse as sp
        nnz = int(self.nnz)
        return sp.csr_matrix(
            (self.values_f64()[:nnz],
             np.asarray(self.col_ind)[:nnz],
             np.asarray(self.row_ptr)),
            shape=self.shape)

    def checksum(self):
        """Sum of stored values — the reference's `verified_sum`
        (main.cpp:753-758). Compensated results reduce ON DEVICE under
        double-double two-sum (log2(n) folding passes) and combine the
        final (hi, lo) scalar pair on the host — no O(nnz) transfer."""
        if self.values_lo is None:
            return jnp.sum(self.values)
        from ia_spgemm_tpu.ops.esc import dd_sum
        hi, lo = dd_sum(self.values, self.values_lo)
        return np.float64(np.asarray(hi, np.float64)
                          + np.asarray(lo, np.float64))


@pytree_dataclass
class COO:
    """Coordinate format. The reference's CooMatrix keeps BOTH a CSR-style
    row_offset pointer and per-entry row_ind (detail/format.h:16-27); we do
    the same so either view is free."""

    row_offset: jax.Array  # (nrows+1,) int32
    row_ind: jax.Array     # (capacity,) int32, tail padded with nrows
    col_ind: jax.Array     # (capacity,) int32, tail padded with ncols
    values: jax.Array      # (capacity,) float
    nnz: jax.Array         # 0-d int32
    shape: Shape2 = static_field()

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def capacity(self) -> int:
        return self.col_ind.shape[0]

    @property
    def dtype(self):
        return self.values.dtype

    def to_scipy(self):
        import scipy.sparse as sp
        nnz = int(self.nnz)
        return sp.coo_matrix(
            (np.asarray(self.values)[:nnz],
             (np.asarray(self.row_ind)[:nnz], np.asarray(self.col_ind)[:nnz])),
            shape=self.shape)

    def checksum(self) -> jax.Array:
        return jnp.sum(self.values)


@pytree_dataclass
class ELL:
    """ELLPACK: left-justified padded rows — a rectangular layout every
    row-grid engine consumes directly (reference: detail/format.h:65-76
    EllMatrix)."""

    col_ind: jax.Array  # (nrows, K) int32, empty slots == -1
    values: jax.Array   # (nrows, K) float, empty slots == 0
    nnz_row: jax.Array  # (nrows,) int32
    nnz: jax.Array      # 0-d int32
    shape: Shape2 = static_field()

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def max_nnz_per_row(self) -> int:
        return self.col_ind.shape[1]

    @property
    def dtype(self):
        return self.values.dtype

    def to_scipy(self):
        import scipy.sparse as sp
        col = np.asarray(self.col_ind)
        val = np.asarray(self.values)
        mask = col >= 0
        rows = np.broadcast_to(
            np.arange(self.nrows)[:, None], col.shape)[mask]
        return sp.coo_matrix((val[mask], (rows, col[mask])),
                             shape=self.shape).tocsr()

    def checksum(self) -> jax.Array:
        return jnp.sum(self.values)


@pytree_dataclass
class DIA:
    """Diagonal format (reference: detail/format.h:53-63 DiaMatrix).

    `offsets[d] = col - row` for occupied diagonal slot d, ascending.
    `values[i, d]` holds A[i, i + offsets[d]].
    `diag_ind` maps the dense diagonal index (row - i + j - 1 in the
    reference's numbering, i.e. offset + nrows - 1 here) to its slot, with -1
    for absent diagonals (the reference reuses a 0-initialized map,
    dia/common_dia.h:62-71; we use -1 to disambiguate slot 0).
    """

    offsets: jax.Array   # (ndiag,) int32, ascending
    values: jax.Array    # (nrows, ndiag) float
    diag_ind: jax.Array  # (nrows + ncols - 1,) int32, -1 if absent
    nnz: jax.Array       # 0-d int32 — nnz of the originating matrix
    shape: Shape2 = static_field()

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def num_diagonals(self) -> int:
        return self.offsets.shape[0]

    @property
    def dtype(self):
        return self.values.dtype

    def to_scipy(self):
        import scipy.sparse as sp
        m, n = self.shape
        offs = np.asarray(self.offsets)
        vals = np.asarray(self.values)
        rows, cols, data = [], [], []
        for d, off in enumerate(offs):
            i = np.arange(m)
            j = i + off
            ok = (j >= 0) & (j < n)
            rows.append(i[ok])
            cols.append(j[ok])
            data.append(vals[ok, d])
        return sp.coo_matrix(
            (np.concatenate(data),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=self.shape).tocsr()

    def checksum(self) -> jax.Array:
        return jnp.sum(self.values)


@pytree_dataclass
class BlockCSR:
    """128-aligned padded CSR — the width-class engine's CSR output.

    Row i's entries occupy whole 128-lane blocks [blk_ptr[i],
    blk_ptr[i+1]) of the (capacity_blocks, 128) block arrays; the first
    nnz_row[i] slots are valid (ascending columns), the remainder of the
    span is padded col == -1 / value == 0 (a row's span may exceed
    ceil(nnz/128) blocks — producers may fix spans at plan time, e.g.
    per width class, so the assembly gather map is a constant). Blocks
    past blk_ptr[nrows] are all-padding.

    Rationale: aligning every row to 128-slot blocks makes assembly from
    per-class outputs ONE constant-index block gather at the cost of
    <=127 padding slots per row; an exact CSR would need the rows'
    data-dependent offsets. The reference's CSR output
    (detail/format.h:29-39) plays this role; bcsr_to_csr converts.
    """

    blk_ptr: jax.Array      # (nrows+1,) int32, block offsets
    col_blocks: jax.Array   # (capacity_blocks, 128) int32, padding == -1
    val_blocks: jax.Array   # (capacity_blocks, 128) float, padding == 0
    nnz_row: jax.Array      # (nrows,) int32 — true entries per row
    nnz: jax.Array          # 0-d int32
    shape: Shape2 = static_field()

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def capacity_blocks(self) -> int:
        return self.col_blocks.shape[0]

    @property
    def dtype(self):
        return self.val_blocks.dtype

    def padded_bytes(self) -> int:
        """Bytes of C in this format (the reference's memory_size metric,
        csr/common_csr.h:196-202): used blocks including their alignment
        padding — the price of alignment is part of the format's cost."""
        itemsize = jnp.dtype(self.val_blocks.dtype).itemsize
        return int(self.blk_ptr[-1]) * 128 * (4 + itemsize) \
            + 4 * (self.nrows + 1)

    def to_scipy(self):
        import scipy.sparse as sp
        bp = np.asarray(self.blk_ptr).astype(np.int64)
        total = int(bp[-1])
        col = np.asarray(self.col_blocks)[:total].reshape(-1)
        val = np.asarray(self.val_blocks)[:total].reshape(-1)
        rows = np.repeat(np.arange(self.nrows), (bp[1:] - bp[:-1]) * 128)
        mask = col >= 0
        return sp.coo_matrix((val[mask], (rows[mask], col[mask])),
                             shape=self.shape).tocsr()

    def checksum(self) -> jax.Array:
        return jnp.sum(self.val_blocks)


@pytree_dataclass
class SlabCSR:
    """Slab-packed CSR — whole rows packed back-to-back into fixed-width
    sort slabs (ops/slab.py), the slab engine's native output.

    Slab s covers global rows [slab_first_row[s], next slab's first
    row); its first nnz_slab[s] key slots are valid, keys ascend, and
    key = (row - slab_first_row[s]) * ncols + col. Pad slots carry
    key == -1 / value == 0, so checksum() is one free reduction.

    Rationale (same family as BlockCSR): the slab layout is already
    row-major-sorted and exact; flattening to CSR (slab_to_csr) is a
    consumer-side choice priced separately, exactly like BlockCSR/ELL
    consumers.
    """

    keys: jax.Array            # (S, W) int32 packed (local_row, col)
    values: jax.Array          # (S, W) float, padding == 0
    nnz_slab: jax.Array        # (S,) int32 — survivors per slab
    slab_first_row: jax.Array  # (S,) int32 — global row of local row 0
    nnz: jax.Array             # 0-d int32
    shape: Shape2 = static_field()
    # Compensated (double-double) results: low-order halves (same
    # contract as CSR.values_lo). None for plain results.
    values_lo: jax.Array | None = None

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def width(self) -> int:
        return self.keys.shape[1]

    @property
    def dtype(self):
        return self.values.dtype

    def checksum(self):
        if self.values_lo is None:
            return jnp.sum(self.values)
        # device double-double fold, 8-byte host combine (CSR.checksum)
        from ia_spgemm_tpu.ops.esc import dd_sum
        hi, lo = dd_sum(jnp.ravel(self.values),
                        jnp.ravel(self.values_lo))
        return np.float64(np.asarray(hi, np.float64)
                          + np.asarray(lo, np.float64))

    def to_scipy(self):
        import scipy.sparse as sp
        S, W = self.keys.shape
        keys = np.asarray(self.keys).astype(np.int64)
        vals = np.asarray(self.values)
        if self.values_lo is not None:
            vals = (vals.astype(np.float64)
                    + np.asarray(self.values_lo, np.float64))
        nnz_s = np.asarray(self.nnz_slab).astype(np.int64)
        sfr = np.asarray(self.slab_first_row).astype(np.int64)
        ok = np.arange(W)[None, :] < nnz_s[:, None]
        k = keys[ok]
        lrow = k // self.ncols
        rows = np.repeat(sfr, nnz_s) + lrow
        cols = k - lrow * self.ncols
        return sp.coo_matrix((vals[ok], (rows, cols)),
                             shape=self.shape).tocsr()


@pytree_dataclass
class Dense:
    """Dense fallback / matrix-unit reference path
    (reference: detail/format.h:7-14 DenseMatrix)."""

    values: jax.Array  # (nrows, ncols)

    @property
    def shape(self) -> Shape2:
        return tuple(self.values.shape)

    @property
    def nrows(self) -> int:
        return self.values.shape[0]

    @property
    def ncols(self) -> int:
        return self.values.shape[1]

    @property
    def dtype(self):
        return self.values.dtype

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix(np.asarray(self.values))

    def checksum(self) -> jax.Array:
        return jnp.sum(self.values)


FORMAT_NAMES = ("csr", "coo", "ell", "dia", "dense")
