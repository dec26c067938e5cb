"""Row-local sort-compress: the accumulation step every row-grid engine
shares (flat and width-class ELL products, slab-packed ESC, the ring).

Each row of a (rows, width) grid holds candidate products as
(key, value) pairs. The row is sorted by key, equal keys are summed, and
the survivors are left-justified: the ESC sort-compress of the
reference's GPU build (csr_dev/common_csr_dev.h:134-254), done per row
with `lax.sort` along the row axis instead of one global sort.

Conventions: SENTINEL keys mark empty slots and sort last; output key
slots past a row's survivors hold -1 and their values 0; the returned
per-row count is clamped to `out_width` (a caller that passes a narrower
output than the row's survivor count gets the first out_width of them).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

SENTINEL = np.int32(np.iinfo(np.int32).max)


def _add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def segmented_scan(vals, head, add=_add):
    """Inclusive prefix combine along axis 1 that restarts at `head`.

    vals: tuple of (rows, width) arrays combined together by
    add(left, right) -> tuple. Hillis–Steele: ceil(log2 width)
    elementwise passes, each run combined in balanced-tree order (no
    cancellation against other runs, deterministic)."""
    width = head.shape[1]
    d = 1
    while d < width:
        shifted = tuple(jnp.pad(v[:, :-d], ((0, 0), (d, 0))) for v in vals)
        combined = add(shifted, vals)
        vals = tuple(jnp.where(head, v, c) for v, c in zip(vals, combined))
        head = head | jnp.pad(head[:, :-d], ((0, 0), (d, 0)),
                              constant_values=True)
        d *= 2
    return vals


def compress_sorted_rows(key, vals, *, out_width: int, add=_add):
    """Sum runs of equal keys in rows already sorted by key and
    left-justify one entry per run. Returns (keys (rows, out_width) with
    -1 padding, tuple of value arrays with 0 padding, per-row count)."""
    rows, width = key.shape
    valid = key != SENTINEL
    prev = jnp.pad(key[:, :-1], ((0, 0), (1, 0)), constant_values=-1)
    nxt = jnp.pad(key[:, 1:], ((0, 0), (0, 1)), constant_values=-1)
    head = key != prev
    is_last = valid & (key != nxt)
    seg = jnp.cumsum(head & valid, axis=1, dtype=jnp.int32) - 1
    nnz = jnp.sum(head & valid, axis=1, dtype=jnp.int32)
    sums = segmented_scan(tuple(vals), head, add)
    dst = jnp.where(is_last, seg, out_width)
    row = jax.lax.broadcasted_iota(jnp.int32, (rows, width), 0)
    out_key = jnp.full((rows, out_width), -1, jnp.int32).at[row, dst].set(
        key, mode="drop")
    out_vals = tuple(
        jnp.zeros((rows, out_width), s.dtype).at[row, dst].set(
            s, mode="drop") for s in sums)
    return out_key, out_vals, jnp.minimum(nnz, out_width)


@functools.partial(jax.jit, static_argnames=("out_width",))
def sort_compress_rows(key, val, *, out_width: int):
    """Sort each row of (key, val) by key, sum duplicate keys, and
    left-justify the survivors: returns (col (rows, out_width) int32 with
    -1 padding, values with 0 padding, nnz_row (rows,))."""
    key_s, val_s = jax.lax.sort((key, val), dimension=1, num_keys=1,
                                is_stable=True)
    col, (v,), nnz = compress_sorted_rows(key_s, (val_s,),
                                          out_width=out_width)
    return col, v, nnz
