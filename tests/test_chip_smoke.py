"""chip_smoke.py on the CPU: it refuses to report without a GPU, and its
phase functions run end to end at m=256."""

import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from bench import build_matrix
from ia_spgemm_tpu.formats.types import CSR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small():
    a32 = build_matrix(m=256, seed=0).astype(np.float32)
    ref, absref = cs.references(a32)
    return a32, CSR.from_scipy(a32), ref, absref


def test_refuses_cpu_device():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_compare_catches_wrong_values(small):
    a32, _, ref, absref = small
    assert cs.compare(ref, ref, absref, cs.F32_RTOL) == 0.0
    bad = ref.copy()
    bad.data[0] += 1e-3 * absref.data[0]
    with pytest.raises(cs.PhaseError, match="entry error"):
        cs.compare(bad, ref, absref, cs.F32_RTOL)
    short = ref.copy()
    short.data[0] = 0
    short.eliminate_zeros()
    with pytest.raises(cs.PhaseError, match="structure"):
        cs.compare(short, ref, absref, cs.F32_RTOL)


def test_phase_cli(small, tmp_path):
    a32 = small[0]
    out = cs.phase_cli(a32, str(tmp_path))
    assert out["matnet_pick"]
    assert out["algorithms"]["csr"]["sum_rel_err"] < 1e-4


def test_phase_engines_and_rowsort(small):
    _, A, ref, absref = small
    out, widths = cs.phase_engines(A, ref, absref)
    assert {"global", "tiled", "slab", "hybrid"} <= set(out)
    assert any(k.startswith("auto:") for k in out)
    assert all(v["max_err"] <= cs.F32_RTOL for v in out.values())
    rs = cs.phase_rowsort(widths, seed=0, rows=64)
    assert set(rs) == set(widths["tiled"]) | set(widths["slab"])


def test_phase_precision():
    a15 = build_matrix(m=256, seed=1).astype(np.float32)
    out = cs.phase_precision(a15)
    assert out["compensated_auto"]["max_err"] <= cs.DD_RTOL
    for m in (64, 256):
        for engine in ("auto", "global"):
            got = out[f"cancelling_{m}_{engine}"]
            assert got["normwise_err"] <= cs.DD_NORMWISE_TOL
    assert out["serve"]["checksum_rel_err"] <= out["serve"]["bound"]


def test_phase_matnet(small):
    out = cs.phase_matnet(small[1])
    assert set(out) == {"Intel", "Amd", "P100"}


def test_phase_four_cards(small, tmp_path):
    out = cs.phase_four_cards(small[0], small[2], small[3], str(tmp_path))
    for name in ("dist_replicated_B", "dist_allgather_B", "ring"):
        assert out[name]["devices"] == 4
    assert out["cli_ring"]["checksum_rel_err"] < 1e-4
