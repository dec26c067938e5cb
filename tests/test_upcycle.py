"""Upcycle pipeline: harvest winners -> retrain -> pick accuracy, plus the
roofline analyzer and synthetic suite generators."""

import numpy as np
import pytest

from ia_spgemm_tpu.bench import roofline
from ia_spgemm_tpu.formats.types import CSR
from ia_spgemm_tpu.io import suitesparse
from ia_spgemm_tpu.models import upcycle


def test_roofline_analyze():
    cost = roofline.cost_esc(expansion=10_000_000, nnz_a=500_000,
                             nnz_b=500_000, nnz_c=7_000_000)
    out = roofline.analyze(100.0, cost,
                           chip=roofline.PEAKS["NVIDIA H100 80GB HBM3"])
    assert out["bound"] == "memory"  # SpGEMM is bandwidth-bound
    assert 0 < out["pct_hbm_peak"] < 100
    assert out["speed_of_light_ms"] < 100.0
    assert out["pct_of_sol"] == pytest.approx(
        100 * out["speed_of_light_ms"] / 100.0, abs=0.01)


def test_synthetic_suite_shapes():
    suite = dict(suitesparse.synthetic_suite(m=64, seeds=(0,)))
    assert len(suite) == 4
    for name, mat in suite.items():
        assert mat.shape == (64, 64)
        assert mat.nnz > 0


def test_local_collection_fetch():
    coll = suitesparse.local_collection()
    if not coll:
        pytest.skip("reference Inputs not mounted")
    A = suitesparse.fetch("dia")
    assert A.shape == (4, 4)
    with pytest.raises(FileNotFoundError, match="egress"):
        suitesparse.fetch("not_a_matrix")


def test_harvest_and_upcycle_roundtrip(tmp_path):
    samples = []
    for name, mat in suitesparse.synthetic_suite(m=48, seeds=(0, 1)):
        A = CSR.from_scipy(mat)
        s = upcycle.harvest_sample(A, A, menu=("baseline", "csr"),
                                   name=name, iters=1)
        assert s is not None
        assert s.winner in ("baseline", "csr")
        samples.append(s)
    assert len(samples) == 8

    # save/load roundtrip
    p = tmp_path / "samples.npz"
    upcycle.save_samples(str(p), samples)
    back = upcycle.load_samples(str(p))
    assert len(back) == len(samples)
    np.testing.assert_array_equal(back[0].img1, samples[0].img1)

    # retraining runs and produces a 2-class head
    params, history, menu = upcycle.upcycle(
        samples, menu=("baseline", "csr"), init_from=None, steps=10,
        batch_size=4)
    assert params["head"]["kernel"].shape[1] == 2
    acc = upcycle.evaluate_pick_accuracy(params, samples,
                                         menu=("baseline", "csr"))
    assert 0.0 <= acc <= 1.0


def test_load_samples_rejects_nonfinite_features(tmp_path):
    """A single inf/nan feature silently destroys training (measured:
    in-sample accuracy 0.97 -> 0.05 with two inf-density samples);
    load_samples must fail loudly naming the bad samples."""
    s = upcycle.Sample(img1=np.zeros((128, 128), np.float32),
                       img2=np.zeros((128, 128), np.float32),
                       feats=np.zeros(26, np.float64),
                       label=0, winner="csr", matrix_name="good")
    bad_feats = np.zeros(26, np.float64)
    bad_feats[3] = np.inf
    b = upcycle.Sample(img1=s.img1, img2=s.img2, feats=bad_feats,
                       label=1, winner="coo", matrix_name="poisoned")
    p = str(tmp_path / "samples.npz")
    upcycle.save_samples(p, [s, b])
    with pytest.raises(ValueError, match="poisoned"):
        upcycle.load_samples(p)


def test_samples_menu_roundtrip(tmp_path):
    """Round-3 checkpoints record the class menu their labels index;
    older checkpoints return None (callers fall back to the v1 menu)."""
    s = upcycle.Sample(img1=np.zeros((128, 128), np.float32),
                       img2=np.zeros((128, 128), np.float32),
                       feats=np.zeros(26, np.float64),
                       label=1, winner="esc", matrix_name="x")
    p = str(tmp_path / "v2.npz")
    menu = ("bitonic", "esc", "hash", "dia", "dense_row")
    upcycle.save_samples(p, [s], menu=menu)
    assert tuple(upcycle.load_samples_menu(p)) == menu
    p1 = str(tmp_path / "v1.npz")
    upcycle.save_samples(p1, [s])
    assert upcycle.load_samples_menu(p1) is None


def test_times_roundtrip_and_relabel(tmp_path):
    """v3 samples carry per-algorithm times so a menu change can relabel
    the harvested corpus offline instead of re-running the chip."""
    base = dict(img1=np.zeros((128, 128), np.float32),
                img2=np.zeros((128, 128), np.float32),
                feats=np.zeros(26, np.float64))
    s1 = upcycle.Sample(**base, label=0, winner="bitonic", matrix_name="a",
                        times={"bitonic": [5.0, 40.0], "esc": [8.0, 45.0],
                               "dense": [1.5, 30.0]})
    s2 = upcycle.Sample(**base, label=1, winner="esc", matrix_name="b",
                        times={"bitonic": [0.0, 50.0], "esc": [0.0, 20.0]})
    s3 = upcycle.Sample(**base, label=0, winner="hash", matrix_name="c",
                        times={"hash": [1.0, 10.0]})
    p = str(tmp_path / "v3.npz")
    upcycle.save_samples(p, [s1, s2, s3], menu=("bitonic", "esc"))
    back = upcycle.load_samples(p)
    assert back[0].times == s1.times

    # relabel to a menu including 'dense': s1 flips to the stored faster
    # dense time; s2 (no device times) falls back to wall; s3 measured
    # nothing on the new menu and is dropped
    menu = ("bitonic", "esc", "dense")
    out = upcycle.relabel(back, menu)
    assert len(out) == 2
    assert out[0].winner == "dense" and out[0].label == 2
    assert out[1].winner == "esc" and out[1].label == 1


def test_load_samples_pre_times_checkpoint(tmp_path):
    """Pre-round-5 checkpoints (no times array) still load."""
    s = upcycle.Sample(img1=np.zeros((128, 128), np.float32),
                       img2=np.zeros((128, 128), np.float32),
                       feats=np.zeros(26, np.float64),
                       label=0, winner="csr", matrix_name="old")
    p = str(tmp_path / "old.npz")
    np.savez_compressed(
        p, img1=s.img1[None], img2=s.img2[None], feats=s.feats[None],
        labels=np.array([0], np.int32), winners='["csr"]',
        names='["old"]')
    back = upcycle.load_samples(p)
    assert back[0].times == {}
