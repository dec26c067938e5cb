"""Framework-wide constants and configuration.

Every hard-coded constant of the reference becomes a named field here
(reference: IA-SPGEMM-CPU_release/main.cpp:510 time_scale=20;
detail/dia/common_dia.h:56 50x size guard; GPU detail/dia/common_dia.h:51
20x size guard; main.cpp:516 128x128 density image).
"""

from __future__ import annotations

import dataclasses
import functools

# Density-representation image side length (reference: main.cpp:516 `malloc2d(128,128)`).
DENSITY_IMAGE_SIZE: int = 128

# Format viability guard: a format is rejected ("choice=false") when its byte
# footprint exceeds RATIO x the CSR footprint.
# Reference CPU uses 50x (detail/dia/common_dia.h:56, ell/common_ell.h:47,
# coo/common_coo.h:37); reference GPU uses 20x.
SIZE_GUARD_RATIO_CPU: float = 50.0
SIZE_GUARD_RATIO_GPU: float = 20.0

# Benchmark watchdog: an algorithm is cancelled once it exceeds
# TIMEOUT_SCALE x the baseline algorithm's runtime (reference: main.cpp:510
# `time_scale=20`, main.cpp:751 usleep(time_scale*mkl_time)).
TIMEOUT_SCALE: float = 20.0

# Byte sizes used by the reference's memory-size formulas
# (sizeof(int)=4, VALUE_TYPE=double=8; CPU Makefile:5 -DVALUE_TYPE=double).
SIZEOF_INDEX: int = 4
SIZEOF_VALUE: int = 8


@dataclasses.dataclass(frozen=True)
class SpGEMMConfig:
    """Tunables for the SpGEMM planner/kernels."""

    # Pad data-dependent capacities up to the next power of two to bound the
    # number of distinct compiled shapes (the static-shape answer to the
    # reference's exact mallocs, which XLA cannot express).
    bucket_capacities: bool = True
    # Viability guard ratio (reference CPU rule).
    size_guard_ratio: float = SIZE_GUARD_RATIO_CPU
    # Density image side.
    density_image_size: int = DENSITY_IMAGE_SIZE
    # Benchmark timeout scale.
    timeout_scale: float = TIMEOUT_SCALE
    # Watchdog budget when the menu carries no baseline to scale from
    # (20x-baseline is the normal rule) — applies to both the isolated
    # and the in-process benchmark paths.
    default_timeout_s: float = 300.0
    # Device-memory budget for the dense/dense_row routes' materialized
    # dense operands + output (the reference's `choice` guard, adapted to
    # the failure mode that matters on a device: a 65536^2 densify is an
    # out-of-memory error, not a 50x-footprint inefficiency). None derives
    # it from the device's memory (DENSE_FRACTION).
    dense_bytes_budget: float | None = None

    def dense_budget(self) -> float:
        if self.dense_bytes_budget is not None:
            return self.dense_bytes_budget
        return memory_budget(DENSE_FRACTION)


DEFAULT_CONFIG = SpGEMMConfig()

# The CPU backend reports no device-memory limit. Planners there size
# their budgets from this fixed figure, so that a test's route choice
# does not depend on the host it runs on.
CPU_DEVICE_BYTES = 16 * 2**30
# Share of device memory the dense routes may materialize.
DENSE_FRACTION = 3 / 8


@functools.lru_cache(maxsize=None)
def device_memory_bytes() -> int:
    """Memory the first device lets this process allocate: the
    allocator's `bytes_limit` on an accelerator, CPU_DEVICE_BYTES on the
    CPU backend. An accelerator that reports no limit is an error — the
    planners would otherwise size their workspaces blind."""
    import jax
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        return CPU_DEVICE_BYTES
    limit = (dev.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"{dev.device_kind} reports no memory limit; cannot size the "
            "planners' budgets")
    return int(limit)


def memory_budget(fraction: float) -> int:
    """`fraction` of the device's memory, in bytes — the one source of
    every planner budget (workspaces, product grids, dense routes)."""
    return int(device_memory_bytes() * fraction)


def bucket_capacity(n: int, *, enabled: bool = True, minimum: int = 8) -> int:
    """Round a data-dependent capacity up to the next geometric bucket
    {8, 10, 12, 14} x 2^e (at most 25% padding, 4 buckets per octave).

    Keeps the set of compiled XLA program shapes small while guaranteeing
    room for the exact result (the reference instead mallocs exact sizes,
    e.g. main.cpp:357-370). Padding is pure overhead for the sort-based
    kernels, so the bucket granularity directly trades compile count
    against throughput.
    """
    n = int(n)
    if n <= minimum:
        return minimum
    if not enabled:
        return n
    base = 1 << max((n - 1).bit_length() - 4, 0)
    for mant in (8, 10, 12, 14, 16):
        if mant * base >= n:
            return mant * base
    raise AssertionError("unreachable")
