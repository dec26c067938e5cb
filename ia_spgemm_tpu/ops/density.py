"""128x128 density-representation images for MatNet.

Exact reproduction of the reference's histogram (main.cpp:512-643):
each stored entry (i, j) of an m x n matrix increments the cell block

  rows [i*128//m, i*128//m + (128//m if m < 128 else 0)]   (inclusive)
  cols [j*128//n, j*128//n + (128//n if n < 128 else 0)]   (inclusive)

clipped at 128 — i.e. a point when the dimension >= 128, a splat of
(128//dim + 1) cells when smaller. Counts are int64 ('long long' in the
reference). Implemented as one scatter-add over a static
(nnz_cap * max_splat^2) index set.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ia_spgemm_tpu import config as cfg
from ia_spgemm_tpu.formats.types import CSR


def _splat(dim: int, size: int) -> int:
    """Cells covered per entry along one axis (inclusive block length)."""
    return 1 if dim >= size else (size // dim) + 1


@functools.partial(jax.jit, static_argnames=("m", "n", "size"))
def _density_core(row_ptr, col_ind, nnz, *, m: int, n: int, size: int):
    # 'long long' counts in the reference (main.cpp:516); int64 when x64 is
    # on (CPU tests, exactness), int32 otherwise (counts <= nnz always fit
    # there for any matrix whose indices fit int32).
    idt = jnp.int64 if jax.config.jax_enable_x64 else jnp.int32
    cap = col_ind.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    from ia_spgemm_tpu.utils import scans as scan_utils
    row = jnp.clip(scan_utils.entry_rows(row_ptr, cap), 0, m - 1)
    col = jnp.clip(col_ind, 0, n - 1)
    valid = idx < nnz

    # integer cell mapping (main.cpp:527-558): floor(old*128/dim).
    # With x64 off, row * size wraps int32 past dim = 2^31/size
    # (~16.7M rows at size 128) — there, bucket by exact host-built
    # boundaries instead: floor(r*size/dim) == max i with
    # ceil(i*dim/size) <= r.
    i32_dim_max = (2**31 - 1) // size
    if idt == jnp.int32 and max(m, n) > i32_dim_max:
        import numpy as np
        ar = np.arange(size + 1, dtype=np.int64)
        bi = ((ar * m + size - 1) // size).astype(np.int32)
        bj = ((ar * n + size - 1) // size).astype(np.int32)
        i_s = (jnp.searchsorted(jnp.asarray(bi), row, side="right")
               - 1).astype(idt)
        j_s = (jnp.searchsorted(jnp.asarray(bj), col, side="right")
               - 1).astype(idt)
    else:
        i_s = (row.astype(idt) * size) // m
        j_s = (col.astype(idt) * size) // n

    si = _splat(m, size)
    sj = _splat(n, size)
    di = jnp.arange(si, dtype=idt)
    dj = jnp.arange(sj, dtype=idt)
    ii = i_s[:, None, None] + di[None, :, None]      # (cap, si, 1)
    jj = j_s[:, None, None] + dj[None, None, :]      # (cap, 1, sj)
    ok = (valid[:, None, None] & (ii < size) & (jj < size))
    flat = jnp.where(ok, ii * size + jj, size * size)
    img = jnp.zeros(size * size + 1, dtype=idt)
    img = img.at[flat.reshape(-1)].add(1)
    return img[:-1].reshape(size, size)


def density_image(A: CSR, size: int = cfg.DENSITY_IMAGE_SIZE) -> jax.Array:
    """(size, size) int64 histogram (reference: main.cpp:512-643)."""
    return _density_core(A.row_ptr, A.col_ind, A.nnz,
                         m=A.nrows, n=A.ncols, size=size)


def density_image_normalized(A: CSR,
                             size: int = cfg.DENSITY_IMAGE_SIZE) -> jax.Array:
    """Scaled x255/max as MatNet.py does before inference (MatNet.py:31-37)."""
    img = density_image(A, size)
    dt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    img = img.astype(dt)
    mx = jnp.max(img)
    return img * 255.0 / jnp.where(mx > 0, mx, 1.0)


def write_density_image(path: str, img) -> None:
    """One value per line, row-major — the imgs/img{1,2}.txt layout the
    reference's MatNet.py re-reads (main.cpp:567-575, MatNet.py:12-20)."""
    np.savetxt(path, np.asarray(img).reshape(-1), fmt="%d")


def read_density_image(path: str, size: int = cfg.DENSITY_IMAGE_SIZE):
    return np.loadtxt(path).reshape(size, size)
