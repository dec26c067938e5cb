"""Platform contracts: the peaks table, the compile-cache location, the
--isolate parent staying off the device, the package importing without
flax, and the dense-row accumulator against the dense route."""

import os
import subprocess
import sys

import numpy as np
import pytest

from ia_spgemm_tpu.bench import roofline
from tests import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env_extra=None, drop=()):
    """Run python code in a fresh process from the repo root. The code
    must not touch a backend unless env_extra picks JAX_PLATFORMS=cpu."""
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["PYTHONPATH"] = REPO
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_peaks_known_kind():
    chip = roofline.detect_chip("NVIDIA H100 80GB HBM3")
    assert chip.hbm_gbs == 3350.0
    assert chip.peak_f32_gflops == 67_000.0
    assert chip.peak_bf16_gflops == 989_000.0


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_peaks_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        roofline.detect_chip(kind)


def test_compilation_cache_default_is_fixed_inside_checkout():
    from ia_spgemm_tpu.cli import main as cli
    assert cli.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    code = ("import jax\n"
            "from ia_spgemm_tpu.cli.main import enable_compilation_cache\n"
            "print(enable_compilation_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = _run(code, {"JAX_PLATFORMS": "cuda"},
               drop=("JAX_COMPILATION_CACHE_DIR",))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [cli.DEFAULT_CACHE_DIR] * 2


def test_compilation_cache_env_honoured(tmp_path):
    code = ("import jax\n"
            "from ia_spgemm_tpu.cli.main import enable_compilation_cache\n"
            "print(enable_compilation_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = _run(code, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path),
                      "JAX_PLATFORMS": "cuda"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(tmp_path)] * 2
    # on the CPU backend nothing is enabled at all
    out = _run(code, {"JAX_PLATFORMS": "cpu"},
               drop=("JAX_COMPILATION_CACHE_DIR",))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "None"


def test_isolate_parent_stays_on_cpu(tmp_path, monkeypatch):
    """With --isolate the CLI pins itself to the CPU before its first
    backend touch (reading the matrix); the workers get no backend
    override, so they take the default device. Without it nothing is
    pinned."""
    import jax

    from ia_spgemm_tpu.bench import harness
    from ia_spgemm_tpu.cli import main as cli
    from ia_spgemm_tpu.io import mmio

    events = []
    real_update, real_read = jax.config.update, mmio.read_mtx_to_csr

    def update(key, value):
        if key == "jax_platforms":
            events.append((key, value))   # the process is already on CPU
        else:
            real_update(key, value)

    def read(*a, **k):
        events.append("read")
        return real_read(*a, **k)

    seen = {}

    def fake(A, B, algorithms, **kw):
        seen.update(kw)
        return harness.BenchReport("a", "b", A.shape, B.shape, 0, 0, 0)

    monkeypatch.setattr(jax.config, "update", update)
    monkeypatch.setattr(mmio, "read_mtx_to_csr", read)
    monkeypatch.setattr(harness, "run_benchmark", fake)
    path = fixtures.mtx_file(tmp_path, "general_real")
    assert cli.main([path, "--isolate", "--no-matnet", "--mode", "csr"]) == 0
    assert events == [("jax_platforms", "cpu"), "read"]
    assert seen["isolate"] and seen.get("isolate_backend") is None
    events.clear()
    assert cli.main([path, "--no-matnet", "--mode", "csr"]) == 0
    assert events == ["read"] and not seen["isolate"]


def test_package_imports_without_flax():
    code = ("import sys\n"
            "sys.modules['flax'] = None\n"
            "import ia_spgemm_tpu, ia_spgemm_tpu.ops, ia_spgemm_tpu.models\n"
            "import ia_spgemm_tpu.parallel, ia_spgemm_tpu.autotune\n"
            "import ia_spgemm_tpu.ops.slab, ia_spgemm_tpu.ops.bitonic\n"
            "import ia_spgemm_tpu.parallel.ring, ia_spgemm_tpu.models.train\n"
            "import ia_spgemm_tpu.cli.main, chip_smoke, bench\n"
            "print('imported')\n")
    out = _run(code, {"JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


@pytest.mark.parametrize("m,k,n,da,db", [
    (16, 16, 16, 0.3, 0.3),
    (24, 10, 40, 0.25, 0.4),
    (33, 50, 7, 0.1, 0.5),
])
def test_dense_row_matches_dense_route(m, k, n, da, db):
    from ia_spgemm_tpu.formats import convert
    from ia_spgemm_tpu.formats.types import CSR
    from ia_spgemm_tpu.ops import dense, dense_row
    a = fixtures.random_csr(m, k, density=da, seed=m)
    b = fixtures.random_csr(k, n, density=db, seed=n)
    A, B = CSR.from_scipy(a), CSR.from_scipy(b)
    got = dense_row.spgemm_dense_row(
        convert.csr_to_ell(A, check_guard=False), convert.csr_to_dense(B))
    want = dense.spgemm_dense(A, B)
    np.testing.assert_allclose(np.asarray(got.values),
                               np.asarray(want.values), rtol=1e-12,
                               atol=1e-12)
