"""Segmented-broadcast primitives shared by kernels and conversions.

A binary search (jnp.searchsorted) over k queries costs ~log2(n)
sequential gather passes; one scatter-max plus one cumulative max answers
the common "which segment covers position e" lookup in two passes.
These helpers implement that form. No intra-package imports (safe for
both formats/ and ops/).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def segment_broadcast(values: jax.Array, starts: jax.Array, active,
                      out_size: int, fill) -> jax.Array:
    """out[e] = values[t] for the active segment t covering position e.

    starts[t] = first covered position of segment t, strictly increasing
    over active segments; `active` masks zero-length segments. `values`
    must be non-decreasing over active segments (cummax propagation).
    Positions before the first active segment get `fill`.
    """
    pos = jnp.where(active, starts, out_size)
    mark = jnp.full(out_size + 1, fill, values.dtype)
    mark = mark.at[pos].max(values)
    return jax.lax.cummax(mark[:out_size])


def entry_rows(row_ptr: jax.Array, capacity: int) -> jax.Array:
    """Row index of each stored CSR entry (positions past nnz -> last
    nonempty row; callers mask). Replaces
    searchsorted(row_ptr, arange, 'right') - 1."""
    m = row_ptr.shape[0] - 1
    rows = jnp.arange(m, dtype=jnp.int32)
    starts = row_ptr[:-1]
    active = row_ptr[1:] > row_ptr[:-1]
    return segment_broadcast(rows, starts, active, capacity, jnp.int32(0))
