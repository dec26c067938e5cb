"""Test configuration: run everything on a virtual 8-device CPU mesh with
float64 enabled, so fp64 parity vs the SciPy oracle is exact and
multi-device sharding is exercised without a GPU.

IA_SPGEMM_TEST_GPU=1 keeps the GPU backend (fp32, the real devices):
device code then runs compiled, and the tests marked `gpu` run too.
Elsewhere those skip, decided at run time by the _gpu_only fixture (never
at import, so every xdist worker collects the same tests). The card's
end-to-end checks are `python chip_smoke.py`."""

import os

import jax

if os.environ.get("IA_SPGEMM_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


REFERENCE_INPUTS = "/root/reference/IA-SPGEMM-CPU_release/Inputs"


def reference_input_paths():
    if not os.path.isdir(REFERENCE_INPUTS):
        return []
    return sorted(
        os.path.join(REFERENCE_INPUTS, f)
        for f in os.listdir(REFERENCE_INPUTS) if f.endswith(".mtx"))


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if (request.node.get_closest_marker("gpu") is not None
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs a GPU (IA_SPGEMM_TEST_GPU=1 on the card)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def fp_tol() -> float:
    """Relative tolerance matched to the active compute precision: 1e-12
    under the fp64 CPU oracle config, 1e-5 when x64 is off (the GPU
    test mode)."""
    return 1e-12 if jax.config.jax_enable_x64 else 1e-5
