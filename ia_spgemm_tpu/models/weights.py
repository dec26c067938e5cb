"""Keras h5 -> MatNet parameter import.

The reference ships pretrained per-architecture weights
(NetWeights/{Intel,Amd,P100}_weights.h5, Keras 2.1 HDF5 layout). Layer
naming, from the Keras creation order in MatNet.py:45-79:

  conv2d_1..3   branch 1 convs      conv2d_4..6   branch 2 convs
  dense_1       feature Dense(nf)   dense_2       branch-1 Dense(256->32)
  dense_3       branch-2 Dense      dense_4       head Dense(-> classes)

Keras Conv2D kernels are HWIO and Dense kernels (in, out) — the layouts
models/matnet.py consumes, so no transposition is needed (verified by
parity tests vs an independent numpy forward).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

REFERENCE_WEIGHTS_DIR = "/root/reference/NetWeights"
LOCAL_WEIGHTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "weights")


def _h5_layer(f, name: str):
    g = f[name][name]
    kernel = np.array(g["kernel:0"])
    bias = np.array(g["bias:0"])
    return {"kernel": kernel, "bias": bias}


def load_keras_h5(path: str) -> Dict:
    """Read a reference weight file into a MatNet `params` dict."""
    import h5py
    with h5py.File(path, "r") as f:
        params = {
            "branch1": {
                "conv1": _h5_layer(f, "conv2d_1"),
                "conv2": _h5_layer(f, "conv2d_2"),
                "conv3": _h5_layer(f, "conv2d_3"),
                "dense": _h5_layer(f, "dense_2"),
            },
            "branch2": {
                "conv1": _h5_layer(f, "conv2d_4"),
                "conv2": _h5_layer(f, "conv2d_5"),
                "conv3": _h5_layer(f, "conv2d_6"),
                "dense": _h5_layer(f, "dense_3"),
            },
            "feature_dense": _h5_layer(f, "dense_1"),
            "head": _h5_layer(f, "dense_4"),
        }
    return _to_jnp(params)


def _to_jnp(tree):
    import jax.numpy as jnp
    if isinstance(tree, dict):
        return {k: _to_jnp(v) for k, v in tree.items()}
    return jnp.asarray(tree, jnp.float32)


def infer_arch(params) -> dict:
    """Recover (num_features, num_classes) from parameter shapes."""
    nf = params["feature_dense"]["kernel"].shape[0]
    nc = params["head"]["kernel"].shape[1]
    return {"num_features": int(nf), "num_classes": int(nc)}


def find_weights(name: str = "Intel") -> str:
    """Locate a weight file: repo-local snapshot first, then the mounted
    reference (MatNet.py:81 hardcodes ./NetWeights/Intel_weights.h5)."""
    for d, ext in ((LOCAL_WEIGHTS_DIR, "_matnet.npz"),
                   (REFERENCE_WEIGHTS_DIR, "_weights.h5")):
        p = os.path.join(d, f"{name}{ext}")
        if os.path.exists(p):
            return p
    raise FileNotFoundError(name)


import functools


@functools.lru_cache(maxsize=8)
def import_reference_weights(name: str = "Intel"):
    """Load a reference weight set -> (params, arch dict). Prefers the
    repo-local npz snapshot (converted once from the shipped h5); falls back
    to parsing the mounted h5 directly. Cached — the reference reloads its
    h5 on EVERY prediction (MatNet.py:81); we pay the parse once."""
    path = find_weights(name)
    if path.endswith(".npz"):
        params = load_params_npz(path)
    else:
        params = load_keras_h5(path)
    return params, infer_arch(params)


def save_params_npz(path: str, params, menu=None) -> None:
    """Flat .npz checkpoint (framework-native, no h5 dependency). `menu`
    optionally records the class->algorithm mapping the weights were
    trained for (upcycled selectors)."""
    flat = {}

    def rec(prefix, tree):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                rec(key, v)
            else:
                flat[key] = np.asarray(v)
    rec("", params)
    if menu is not None:
        flat["__menu__"] = np.asarray(list(menu))
    np.savez(path, **flat)


def load_params_npz(path: str, with_menu: bool = False):
    import jax.numpy as jnp
    data = np.load(path)
    params: Dict = {}
    menu = None
    for key in data.files:
        if key == "__menu__":
            menu = tuple(str(x) for x in data[key])
            continue
        parts = key.split("/")
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(data[key])
    return (params, menu) if with_menu else params
