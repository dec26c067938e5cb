"""Per-kernel roofline analysis.

The reference only reports wall-clock + GFLOPS (main.cpp:981-991); here
the roofline against the device's published peaks is a first-class
metric. Each kernel gets an analytic cost model (useful flops + minimum
memory traffic); measured time then yields achieved GFLOPS / GB/s and the
distance to the relevant roof.

SpGEMM is bandwidth-bound almost by definition (O(1) flops per byte), so
the % of HBM peak is the honest "speed-of-light" number. State it beside
the card's power limit: a card set below its maximum cannot reach the
published peak.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbs: float          # HBM bandwidth, GB/s
    peak_f32_gflops: float  # float32 outside the matrix units
    peak_bf16_gflops: float  # bf16 dense matrix rate


# Published peaks keyed by jax's device_kind. Source: NVIDIA H100 data
# sheet, SXM part, dense rates without sparsity, at the full 700 W power
# limit — 3.35 TB/s HBM3, 67 TFLOP/s float32, 989 TFLOP/s bf16.
PEAKS = {
    "NVIDIA H100 80GB HBM3": ChipSpec(
        name="h100_sxm", hbm_gbs=3350.0, peak_f32_gflops=67_000.0,
        peak_bf16_gflops=989_000.0),
}


def detect_chip(kind: Optional[str] = None) -> ChipSpec:
    """Peaks of the first device (or of `kind`). A device kind missing
    from PEAKS is an error, never a default."""
    if kind is None:
        import jax
        kind = jax.devices()[0].device_kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; add them to "
            "bench/roofline.py PEAKS with their source") from None


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """Analytic cost of one kernel invocation."""
    flops: float      # useful flops (2 per intermediate product for SpGEMM)
    bytes: float      # minimum HBM traffic (read + write)


def cost_esc(expansion: int, nnz_a: int, nnz_b: int, nnz_c: int,
             value_bytes: int = 4, index_bytes: int = 4) -> KernelCost:
    """ESC pipeline: reads A, B once; the expanded (key, value) stream is
    written + re-read by the sort passes. Modeled with the minimum: one
    materialization + one sort pass + output write (real sorts make
    several passes — the roofline reports distance to THIS floor, which is
    what a perfect single-pass kernel could hit)."""
    entry = value_bytes + index_bytes
    read_inputs = (nnz_a + nnz_b) * entry
    stream = expansion * entry * 2 * 2          # write+read, expand & sort
    out = nnz_c * entry
    return KernelCost(flops=2.0 * expansion,
                      bytes=read_inputs + stream + out)


def analyze(time_ms: float, cost: KernelCost,
            chip: Optional[ChipSpec] = None,
            dtype_peak: str = "f32") -> Dict:
    """Measured time + cost model -> roofline position."""
    chip = chip or detect_chip()
    secs = time_ms / 1e3
    achieved_gflops = cost.flops / secs / 1e9 if secs > 0 else 0.0
    achieved_gbs = cost.bytes / secs / 1e9 if secs > 0 else 0.0
    peak_gflops = (chip.peak_bf16_gflops if dtype_peak == "bf16"
                   else chip.peak_f32_gflops)
    intensity = cost.flops / cost.bytes if cost.bytes else 0.0
    ridge = peak_gflops / chip.hbm_gbs
    bound = "memory" if intensity < ridge else "compute"
    # speed-of-light time for this cost model
    sol_ms = max(cost.bytes / (chip.hbm_gbs * 1e9),
                 cost.flops / (peak_gflops * 1e9)) * 1e3
    return {
        "chip": chip.name,
        "time_ms": time_ms,
        "achieved_gflops": round(achieved_gflops, 3),
        "achieved_gbs": round(achieved_gbs, 3),
        "pct_hbm_peak": round(100.0 * achieved_gbs / chip.hbm_gbs, 2),
        "pct_compute_peak": round(100.0 * achieved_gflops / peak_gflops, 4),
        "arithmetic_intensity": round(intensity, 4),
        "bound": bound,
        "speed_of_light_ms": round(sol_ms, 4),
        "pct_of_sol": round(100.0 * sol_ms / time_ms, 2) if time_ms else 0.0,
    }
