"""Upcycling MatNet: retrain the selector on OUR algorithm menu from
measured device timings.

The reference ships only pretrained weights for its MKL/CSR/DIA/ELL/COO
menu (no training code in the tree); this module closes the loop:

  matrices -> benchmark harness (empirical winner per matrix)
           -> (density images, features, winner label) dataset
           -> fine-tune / retrain MatNet -> new class menu = our algorithms.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence

import numpy as np

from ia_spgemm_tpu.bench import harness
from ia_spgemm_tpu.formats.types import CSR
from ia_spgemm_tpu.models import matnet, train as train_mod, weights
from ia_spgemm_tpu.ops import density, features

DEFAULT_MENU = ("baseline", "csr", "dia", "ell", "coo")


@dataclasses.dataclass
class Sample:
    img1: np.ndarray       # (128, 128) normalized
    img2: np.ndarray
    feats: np.ndarray      # (26,)
    label: int             # index into the menu
    winner: str
    matrix_name: str = ""
    # per-algorithm measured times {name: [device_ms, wall_ms]} — kept so
    # a harvested corpus can be RELABELED offline when the menu changes
    # (round-4 lesson: winner-only checkpoints forced a from-scratch
    # re-harvest every time the class semantics moved). device_ms = 0.0
    # means the harvest ran without device timers; relabeling then falls
    # back to wall.
    times: dict = dataclasses.field(default_factory=dict)


def harvest_sample(A: CSR, B: CSR, menu: Sequence[str] = DEFAULT_MENU,
                   name: str = "", iters: int = 2,
                   progress=None) -> Optional[Sample]:
    """Benchmark all menu algorithms on (A, B); label = empirical winner.

    The scipy baseline is always RUN (it arms the reference's 20x watchdog
    budget, main.cpp:510,751, and verifies every checksum) but is only a
    winner CANDIDATE when the caller's menu includes it — a harvested
    label must name a deployable device algorithm."""
    algos = tuple(menu) if "baseline" in menu \
        else ("baseline",) + tuple(menu)
    rep = harness.run_benchmark(A, B, algos, iters=iters,
                                device_timers=True,
                                matrix_a=name, matrix_b=name,
                                progress=progress)
    ok = [r for r in rep.results
          if r.ok and r.run_time_ms > 0 and not r.error
          and r.name in menu]
    if not ok:
        return None
    # label by DEVICE time when it was recorded: a wall time carries the
    # host's dispatch and sync costs, which can drown small deltas
    # between algorithms on mid-size matrices.
    winner = min(ok, key=lambda r: (r.device_time_ms
                                    if r.device_time_ms > 0
                                    else r.run_time_ms)).name
    times = {r.name: [float(r.device_time_ms), float(r.run_time_ms)]
             for r in rep.results if r.ok and r.run_time_ms > 0}
    fv = np.asarray(features.feature_vector(A, B), dtype=np.float32)
    img1 = np.asarray(density.density_image_normalized(A), dtype=np.float32)
    img2 = np.asarray(density.density_image_normalized(B), dtype=np.float32)
    return Sample(img1=img1, img2=img2, feats=fv,
                  label=list(menu).index(winner), winner=winner,
                  matrix_name=name, times=times)


def relabel(samples: List[Sample], menu: Sequence[str]) -> List[Sample]:
    """Re-derive (label, winner) from each sample's stored per-algorithm
    times against a (possibly different) menu. Samples measuring none of
    the menu's algorithms are dropped. Device time wins over wall when
    recorded (wall carries host dispatch and sync costs)."""
    out = []
    for s in samples:
        cand = {n: t for n, t in s.times.items() if n in menu}
        if not cand:
            continue
        winner = min(cand,
                     key=lambda n: (cand[n][0] if cand[n][0] > 0
                                    else cand[n][1]))
        out.append(dataclasses.replace(
            s, label=list(menu).index(winner), winner=winner))
    return out


def dataset_from_samples(samples: List[Sample], batch_size: int,
                         seed: int = 0):
    """Infinite batch iterator over harvested samples (with replacement)."""
    rng = np.random.default_rng(seed)
    n = len(samples)
    while True:
        idx = rng.integers(0, n, batch_size)
        yield (np.stack([samples[i].img1 for i in idx])[..., None],
               np.stack([samples[i].img2 for i in idx])[..., None],
               np.stack([samples[i].feats for i in idx]),
               np.array([samples[i].label for i in idx], np.int32))


def upcycle(samples: List[Sample],
            menu: Sequence[str] = DEFAULT_MENU,
            init_from: Optional[str] = "Intel",
            steps: int = 200, batch_size: int = 16,
            learning_rate: float = 1e-3, seed: int = 0):
    """Retrain MatNet on harvested samples. Starts from the reference's
    shipped weights when the architecture matches (warm start), else from
    random init. Returns (params, history, menu)."""
    params = None
    if init_from is not None:
        try:
            params, arch = weights.import_reference_weights(init_from)
            if arch["num_classes"] != len(menu) or arch["num_features"] != 26:
                params = None
        except FileNotFoundError:
            params = None
    cfg = train_mod.TrainConfig(num_classes=len(menu), num_features=26,
                                learning_rate=learning_rate,
                                batch_size=batch_size, steps=steps,
                                seed=seed)
    ds = dataset_from_samples(samples, batch_size, seed=seed)
    params, history = train_mod.train(ds, cfg, params=params,
                                      log=lambda *_: None)
    return params, history, tuple(menu)


def evaluate_pick_accuracy(params, samples: List[Sample],
                           menu: Sequence[str] = DEFAULT_MENU) -> float:
    """Fraction of samples where MatNet picks the empirical winner — the
    aggregated version of the reference's per-run Correct/Incorrect verdict
    (main.cpp:994-999)."""
    hits = 0
    for s in samples:
        cls = matnet.predict_class(params, s.img1, s.img2, s.feats,
                                   num_classes=len(menu), num_features=26)
        hits += int(cls == s.label)
    return hits / max(len(samples), 1)


def save_samples(path: str, samples: List[Sample],
                 menu: Optional[Sequence[str]] = None) -> None:
    extra = {"menu": json.dumps(list(menu))} if menu else {}
    np.savez_compressed(
        path,
        img1=np.stack([s.img1 for s in samples]),
        img2=np.stack([s.img2 for s in samples]),
        feats=np.stack([s.feats for s in samples]),
        labels=np.array([s.label for s in samples], np.int32),
        winners=json.dumps([s.winner for s in samples]),
        names=json.dumps([s.matrix_name for s in samples]),
        times=json.dumps([s.times for s in samples]),
        **extra)


def load_samples_menu(path: str) -> Optional[List[str]]:
    """The class menu a checkpoint's labels index, when it recorded one
    (round-3 checkpoints do; older ones used the round-2 MENU_V1)."""
    with np.load(path, allow_pickle=False) as d:
        if "menu" in d:
            return list(json.loads(str(d["menu"])))
    return None


def load_samples(path: str) -> List[Sample]:
    d = np.load(path, allow_pickle=False)
    winners = json.loads(str(d["winners"]))
    names = json.loads(str(d["names"]))
    # A single non-finite feature poisons every gradient step it lands in
    # (measured: two inf-density samples drove in-sample accuracy from
    # 0.97 to 0.05). Fail loudly, naming the samples, instead of training
    # on garbage.
    feats = d["feats"]
    bad = np.nonzero(~np.isfinite(
        feats.reshape(feats.shape[0], -1)).all(axis=1))[0]
    if bad.size:
        raise ValueError(
            "non-finite features in harvest checkpoint "
            f"{path}: samples {[names[i] for i in bad]} — re-extract "
            "(ops/features.py) or drop them before training")
    times = (json.loads(str(d["times"])) if "times" in d
             else [{} for _ in winners])  # pre-round-5 checkpoints
    return [Sample(img1=d["img1"][i], img2=d["img2"][i],
                   feats=feats[i], label=int(d["labels"][i]),
                   winner=winners[i], matrix_name=names[i],
                   times=times[i])
            for i in range(len(winners))]


def stratified_kfold_accuracy(samples: List[Sample],
                              menu: Sequence[str] = DEFAULT_MENU,
                              k: int = 5, steps: int = 300,
                              seed: int = 0,
                              init_from: Optional[str] = "Intel"):
    """Stratified k-fold pick accuracy: samples split per class into k
    folds; each fold held out once against a model trained on the rest.
    Returns (mean_acc, per_fold, majority_baseline). A single holdout on
    a small, imbalanced corpus over-credits the majority class — this is
    the honest aggregate of the reference's per-run verdict
    (main.cpp:994-999)."""
    rng = np.random.default_rng(seed)
    by_class: dict = {}
    for i, s in enumerate(samples):
        by_class.setdefault(s.label, []).append(i)
    folds: List[List[int]] = [[] for _ in range(k)]
    for _, idxs in sorted(by_class.items()):
        idxs = list(idxs)
        rng.shuffle(idxs)
        for j, i in enumerate(idxs):
            folds[j % k].append(i)
    accs = []
    for f in range(k):
        test = [samples[i] for i in folds[f]]
        train_set = [samples[i] for g in range(k) if g != f
                     for i in folds[g]]
        if not test or not train_set:
            continue
        params, _, _ = upcycle(train_set, menu=menu, init_from=init_from,
                               steps=steps, seed=seed + f)
        accs.append(evaluate_pick_accuracy(params, test, menu=menu))
    counts = np.bincount([s.label for s in samples],
                         minlength=len(menu))
    majority = float(counts.max()) / max(len(samples), 1)
    return (float(np.mean(accs)) if accs else 0.0,
            [round(a, 4) for a in accs], majority)
