"""MatNet parity tests: the lax forward vs an independent numpy oracle, with
the shipped reference weights and density-image fixtures, plus (when Keras
can still read the 2017-era h5) a direct Keras cross-check."""

import os

import numpy as np
import pytest

from ia_spgemm_tpu.models import matnet, weights
from tests import matnet_oracle

REF_IMGS = "/root/reference/IA-SPGEMM-CPU_release/imgs"


def _have_reference_weights():
    try:
        weights.find_weights("Intel")
        return True
    except FileNotFoundError:
        return False


needs_weights = pytest.mark.skipif(not _have_reference_weights(),
                                   reason="reference weights not available")


def _fixture_inputs(nf=26, seed=0):
    rng = np.random.default_rng(seed)
    if os.path.isdir(REF_IMGS):
        img1 = np.loadtxt(os.path.join(REF_IMGS, "img1.txt")).reshape(128, 128)
        img2 = np.loadtxt(os.path.join(REF_IMGS, "img2.txt")).reshape(128, 128)
        img1 = img1 * 255 / max(img1.max(), 1)
        img2 = img2 * 255 / max(img2.max(), 1)
    else:
        img1 = rng.random((128, 128)) * 255
        img2 = rng.random((128, 128)) * 255
    feats = rng.random(nf) * 10
    return img1.astype(np.float64), img2.astype(np.float64), feats


def test_flax_matches_numpy_oracle_random_params():
    import jax
    params = matnet.init_params(jax.random.PRNGKey(0))
    img1, img2, feats = _fixture_inputs()
    got = np.asarray(matnet.predict_logits(params, img1, img2, feats))
    want = matnet_oracle.forward(params, img1, img2, feats)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@needs_weights
@pytest.mark.parametrize("name,nf,nc", [("Intel", 26, 5), ("Amd", 26, 5),
                                        ("P100", 18, 3)])
def test_flax_matches_numpy_oracle_reference_weights(name, nf, nc):
    params, arch = weights.import_reference_weights(name)
    assert arch == {"num_features": nf, "num_classes": nc}
    img1, img2, feats = _fixture_inputs(nf=nf, seed=1)
    got = np.asarray(matnet.predict_logits(params, img1, img2, feats,
                                           num_classes=nc, num_features=nf))
    want = matnet_oracle.forward(params, img1, img2, feats)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert int(np.argmax(got)) == int(np.argmax(want))


@needs_weights
def test_predict_class_on_reference_fixture_images():
    """End-to-end Pred() equivalent on the shipped imgs/ fixtures."""
    params, arch = weights.import_reference_weights("Intel")
    img1, img2, feats = _fixture_inputs(seed=2)
    cls = matnet.predict_class(params, img1, img2, feats, **arch)
    assert 0 <= cls < 5
    # numpy oracle agrees on the pick
    want = int(np.argmax(matnet_oracle.forward(params, img1, img2, feats)))
    assert cls == want


@needs_weights
def test_keras_cross_check():
    """Full-stack parity vs Keras itself, when Keras 3 can still load the
    Keras 2.1 h5 (skipped otherwise — the numpy oracle test above is the
    authoritative parity check)."""
    keras = pytest.importorskip("keras")
    try:
        inp1 = keras.layers.Input(shape=(128, 128, 1))
        inp2 = keras.layers.Input(shape=(128, 128, 1))
        inp3 = keras.layers.Input(shape=(26,))

        def br(inp):
            x = keras.layers.Conv2D(16, (3, 3), activation="tanh")(inp)
            x = keras.layers.MaxPooling2D(2, 2)(x)
            x = keras.layers.Conv2D(16, (5, 5), strides=(2, 2),
                                    padding="same", activation="tanh")(x)
            x = keras.layers.MaxPooling2D(2, 2)(x)
            x = keras.layers.Conv2D(16, (5, 5), strides=(2, 2),
                                    padding="same", activation="tanh")(x)
            x = keras.layers.MaxPooling2D(2, 2)(x)
            return keras.layers.Flatten()(x)

        f1, f2 = br(inp1), br(inp2)
        fd = keras.layers.Dense(26, activation="tanh")(inp3)
        d1 = keras.layers.Dense(32, activation="tanh")(f1)
        d2 = keras.layers.Dense(32, activation="tanh")(f2)
        cat = keras.layers.Concatenate()([d1, d2, fd])
        out = keras.layers.Dense(5, activation="softmax")(cat)
        h5 = os.path.join(weights.REFERENCE_WEIGHTS_DIR, "Intel_weights.h5")
        if not os.path.exists(h5):
            pytest.skip("reference h5 not mounted")
        model = keras.models.Model(inputs=[inp1, inp2, inp3], outputs=out)
        model.load_weights(h5)
    except Exception as e:  # legacy h5 not loadable by keras 3
        pytest.skip(f"keras cannot load legacy h5: {e}")

    img1, img2, feats = _fixture_inputs(seed=3)
    kout = model.predict([img1.reshape(1, 128, 128, 1),
                          img2.reshape(1, 128, 128, 1),
                          feats.reshape(1, 26)], verbose=0)[0]
    params, arch = weights.import_reference_weights("Intel")
    logits = np.asarray(matnet.predict_logits(params, img1, img2, feats,
                                              **{"num_classes": 5,
                                                 "num_features": 26}))
    ours = np.exp(logits - logits.max())
    ours = ours / ours.sum()
    np.testing.assert_allclose(ours, kout, rtol=1e-3, atol=1e-4)


def test_npz_roundtrip(tmp_path):
    import jax
    params = matnet.init_params(jax.random.PRNGKey(1))
    p = tmp_path / "matnet.npz"
    weights.save_params_npz(str(p), params)
    back = weights.load_params_npz(str(p))
    img1, img2, feats = _fixture_inputs(seed=4)
    a = np.asarray(matnet.predict_logits(params, img1, img2, feats))
    b = np.asarray(matnet.predict_logits(back, img1, img2, feats))
    np.testing.assert_allclose(a, b)


def test_p100_gpu_menu_selection():
    """GPU weight set: 18 features, 3 classes mapped to (coo, csr, bitonic)
    — the reference's CUSP/cuSPARSE/NSPARSE menu (main.cu:539-544)."""
    from ia_spgemm_tpu import autotune
    from ia_spgemm_tpu.formats.types import CSR
    from tests import fixtures
    a = fixtures.random_csr(24, 24, density=0.2, seed=7)
    A = CSR.from_scipy(a)
    try:
        sel = autotune.select_algorithm(A, A, weight_name="P100")
    except FileNotFoundError:
        import pytest as _pytest
        _pytest.skip("P100 weights not present")
    assert sel.algorithm in autotune.GPU_CLASS_TO_ALGORITHM
    assert len(sel.logits) == 3


def test_spgemm_auto_dispatches_strategy_menu(monkeypatch):
    """The strategy-distinct menu names (esc, dense_row, bitonic, serve,
    compensated) must run through spgemm_auto and produce a correct
    CSR."""
    import numpy as np

    from ia_spgemm_tpu import autotune
    from ia_spgemm_tpu.formats.types import CSR
    from tests import fixtures

    a = fixtures.banded_csr(48, bandwidth=2, seed=8).astype(np.float32)
    A = CSR.from_scipy(a)
    want = (a @ a).toarray()
    for algo in ("esc", "dense_row", "bitonic", "serve", "compensated"):
        monkeypatch.setattr(
            autotune, "select_algorithm",
            lambda *args, _algo=algo, **kw: autotune.AutotuneResult(
                algorithm=_algo, class_index=0, logits=None,
                feature_vector=None))
        C, sel = autotune.spgemm_auto(A, A)
        assert sel.algorithm == algo
        assert type(C).__name__ == "CSR", (algo, type(C))
        got = C.to_scipy().toarray()
        # serve rounds each product to bf16 (documented 2^-9 each)
        tol = 2e-2 if algo == "serve" else 1e-5
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_spgemm_auto_dense_row_guard_falls_back(monkeypatch):
    """A mispredicted dense_row pick on a matrix whose densified B + C
    exceed the memory budget must fall back to the csr route."""
    import dataclasses

    import numpy as np

    from ia_spgemm_tpu import autotune, config as cfg
    from ia_spgemm_tpu.formats.types import CSR
    from tests import fixtures

    a = fixtures.banded_csr(48, bandwidth=2, seed=9).astype(np.float32)
    A = CSR.from_scipy(a)
    want = (a @ a).toarray()
    monkeypatch.setattr(
        autotune, "select_algorithm",
        lambda *args, **kw: autotune.AutotuneResult(
            algorithm="dense_row", class_index=0, logits=None,
            feature_vector=None))
    monkeypatch.setattr(
        cfg, "DEFAULT_CONFIG",
        dataclasses.replace(cfg.DEFAULT_CONFIG, dense_bytes_budget=64.0))
    C, sel = autotune.spgemm_auto(A, A)
    got = C.to_scipy().toarray()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
