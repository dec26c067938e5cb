"""bench.py is the one-shot benchmark entry — a smoke test keeps its
route-competition plumbing (every CSR engine) and JSON contract from
drifting between device runs."""

import json
import os
import sys

import numpy as np


def test_bench_smoke_json_contract(capsys, monkeypatch):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench

    monkeypatch.setenv("IA_SPGEMM_BENCH_SMOKE", "1")
    bench.main()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    r = json.loads(line)
    assert r["metric"] == "spgemm_gflops"
    assert r["unit"] == "GFLOPS"
    assert r["value"] > 0 and r["vs_baseline"] > 0
    d = r["detail"]
    # every viable CSR engine was measured and the fastest reported
    assert set(d["routes"]) >= {"global", "tiled", "slab"}
    assert d["algorithm"] in d["routes"]
    assert d["checksum_rel_err"] < 1e-4
    assert d["ours_ms"] > 0 and d["nnz_out"] > 0
    # the device is named; the CPU backend has no roofline
    assert d["device"]["platform"] == "cpu" and d["device"]["count"] >= 1
    assert d["roofline"] is None
