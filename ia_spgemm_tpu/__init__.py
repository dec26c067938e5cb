"""ia_spgemm_tpu — an input-aware SpGEMM framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
hipdac-lab/IA-SpGEMM:

- Sparse storage formats CSR / COO / ELL / DIA as pytrees of jnp arrays
  (reference: IA-SPGEMM-CPU_release/detail/format.h:7-76).
- SpGEMM kernels C = A @ B per format with multiple accumulation strategies
  (global and row-local ESC sort-reduce, dense-row) — the XLA replacement
  for the reference's OpenMP linked-list / Thrust ESC kernels
  (reference: detail/csr/common_csr.h:85-193, csr_dev/common_csr_dev.h:134-254).
- Feature extraction (GetInfo1/2/3) + 128x128 density-representation images
  (reference: detail/csr/common_csr.h:257-287, main.cpp:512-643).
- MatNet: a CNN+MLP format/algorithm selector in plain lax, loading the shipped
  Keras weights (reference: MatNet.py:24-96, NetWeights/*.h5).
- A benchmark harness with per-algorithm timing, timeout policy, memory-size
  accounting, checksum verification, GFLOPS and speedup reporting
  (reference: main.cpp:709-1000).
- Row-partitioned multi-device SpGEMM over a jax.sharding.Mesh — a capability
  the single-process reference lacks.
"""

__version__ = "0.1.0"

from ia_spgemm_tpu.formats.types import (  # noqa: F401
    CSR, COO, ELL, DIA, BlockCSR, Dense)


def __getattr__(name):
    """Lazy top-level API (keeps `import ia_spgemm_tpu` light)."""
    if name == "spgemm":
        # the production CSR @ CSR entry (ops/esc.py plan_csr_auto)
        from ia_spgemm_tpu.ops.esc import spgemm_csr_auto
        return spgemm_csr_auto
    if name == "spgemm_global_sort":
        from ia_spgemm_tpu.ops.esc import spgemm_csr
        return spgemm_csr
    if name == "spgemm_auto":
        from ia_spgemm_tpu.autotune import spgemm_auto
        return spgemm_auto
    if name == "spgemm_bitonic":
        from ia_spgemm_tpu.ops.bitonic import spgemm_bitonic
        return spgemm_bitonic
    if name == "spgemm_compensated":
        from ia_spgemm_tpu.ops.esc import spgemm_csr_compensated
        return spgemm_csr_compensated
    if name == "read_mtx_to_csr":
        from ia_spgemm_tpu.io.mmio import read_mtx_to_csr
        return read_mtx_to_csr
    raise AttributeError(name)
