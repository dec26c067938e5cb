"""Dense matmul reference path.

The reference ships a dense format + CSRtoDENSE it never calls
(dense/common_dense.h:20-40); here the dense path is first-class: for
matrices whose dense footprint fits device memory, densify + a single
matmul is the speed-of-light SpGEMM. Used as the small-matrix reference check and as
a selectable algorithm in the autotuner menu.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ia_spgemm_tpu.formats.convert import csr_to_dense
from ia_spgemm_tpu.formats.types import CSR, Dense


@jax.jit
def _matmul(a: jax.Array, b: jax.Array) -> jax.Array:
    # 'highest' forces true fp32 arithmetic (the default precision may
    # round through reduced-precision matrix-unit passes — TF32 on recent
    # GPUs — which breaks checksum parity vs the fp64 oracle).
    return jnp.dot(a, b, preferred_element_type=jnp.result_type(a, b),
                   precision=jax.lax.Precision.HIGHEST)


def spgemm_dense(A, B) -> Dense:
    """C = A @ B through a dense matmul. Accepts CSR or Dense operands."""
    a = csr_to_dense(A).values if isinstance(A, CSR) else A.values
    b = csr_to_dense(B).values if isinstance(B, CSR) else B.values
    return Dense(values=_matmul(a, b))
