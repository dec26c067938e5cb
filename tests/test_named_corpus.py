"""Named SuiteSparse structure replicas.

The reference's workloads are SuiteSparse matrices (README.md:10); this
zero-egress environment replicates the mid-size SpGEMM-paper standards
as deterministic generators. These tests pin each replica to its spec:
exact dimensions, nnz within 10%, and the structural family statistics
(row-length CV, diagonal fill, max row) that drive algorithm selection.
"""

import numpy as np
import pytest

from ia_spgemm_tpu.io import suitesparse as ss

SMALL = ("poisson3Da", "pdb1HYS", "rma10", "cant", "scircuit",
         "m133-b3", "cage12", "2cubes_sphere")


def test_spec_inventory():
    assert len(ss.NAMED_SPECS) >= 20
    for name, spec in ss.NAMED_SPECS.items():
        assert spec["m"] > 0 and spec["n"] > 0 and spec["nnz"] > 0
        assert spec["family"] in ("fem", "stencil", "exactk",
                                  "irregular", "powerlaw")


@pytest.mark.parametrize("name", sorted(ss.NAMED_SPECS))
def test_replica_matches_spec(name):
    spec = ss.NAMED_SPECS[name]
    A = ss.gen_named(name)
    st = ss.replica_stats(A)
    assert st["m"] == spec["m"] and st["n"] == spec["n"]
    assert abs(st["nnz"] - spec["nnz"]) / spec["nnz"] <= 0.10
    if spec.get("diag_fill") is not None:
        assert abs(st["diag_fill"] - spec["diag_fill"]) <= 0.15
    cv = spec.get("row_cv")
    if cv is not None:
        if cv == 0.0:
            assert st["row_cv"] <= 0.05
        else:
            # family-level check: skewed specs must produce skewed
            # replicas and regular specs regular ones
            assert st["row_cv"] <= 3.0 * cv + 0.1
            if cv >= 1.0:
                assert st["row_cv"] >= 0.5 * cv


@pytest.mark.parametrize("name", SMALL)
def test_replica_deterministic(name):
    A = ss.gen_named(name, seed=0)
    B = ss.gen_named(name, seed=0)
    assert A.nnz == B.nnz
    assert np.array_equal(A.indptr, B.indptr)
    assert np.array_equal(A.indices, B.indices)
    assert np.allclose(A.data, B.data)


def test_exactk_rows():
    A = ss.gen_named("m133-b3")
    lens = np.diff(A.indptr)
    # boundary map: every row exactly k (duplicate collapse may lose a
    # handful of entries)
    assert (lens == 4).mean() > 0.999


def test_named_suite_streams():
    got = dict(ss.named_suite(names=["poisson3Da", "scircuit"]))
    assert set(got) == {"poisson3Da", "scircuit"}
    assert got["poisson3Da"].shape == (13514, 13514)
