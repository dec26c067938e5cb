"""MatNet — the input-aware format/algorithm selector, in plain `lax`.

Topology replicated from the reference's Keras graph (MatNet.py:45-79),
verified against the shipped weight shapes (NetWeights/Intel_weights.h5):

per image branch (x2):
  Conv 16@3x3 valid stride1 tanh -> MaxPool 2x2
  Conv 16@5x5 stride2 SAME tanh  -> MaxPool 2x2
  Conv 16@5x5 stride2 SAME tanh  -> MaxPool 2x2
  Flatten (4*4*16 = 256) -> Dense 32 tanh
feature branch:
  Dense(nf -> nf) tanh            (nf=26 CPU / 18 GPU, MatNet.py:70-71)
head:
  Concat(32 + 32 + nf) -> Dense(num_classes) softmax
  (CPU classes: MKL/CSR/DIA/ELL/COO, 5; GPU: CUSP/cuSPARSE/NSPARSE, 3 —
   main.cu:539-544)

Parameters are a nested dict — {branch1, branch2: {conv1, conv2, conv3,
dense}, feature_dense, head}, each {kernel, bias} with Keras's HWIO conv
and (in, out) dense layouts — so the shipped weights load unchanged
(models/weights.py). Every convolution and dense layer runs at
Precision.HIGHEST: a reduced-precision matrix unit (TF32 on recent GPUs)
could otherwise flip the argmax against the reference network.

Unlike the reference, which rebuilds the Keras graph and reloads the h5 on
every prediction (MatNet.py:45-94, K.clear_session), the forward pass is
jitted once and parameters stay resident on device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

# CPU-build class menu (README.md:5-8, main.cpp report order).
CPU_CLASSES = ("mkl", "csr", "dia", "ell", "coo")
# GPU-build class menu (main.cu:539-544).
GPU_CLASSES = ("cusp", "cusparse", "nsparse")

_HIGHEST = lax.Precision.HIGHEST


def _conv(x, p, stride: int, padding: str):
    y = lax.conv_general_dilated(
        x, p["kernel"], (stride, stride), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=_HIGHEST)
    return y + p["bias"]


def _dense(x, p):
    return jnp.dot(x, p["kernel"], precision=_HIGHEST) + p["bias"]


def _max_pool2(x):
    return lax.reduce_window(x, -jnp.inf, lax.max, (1, 2, 2, 1),
                             (1, 2, 2, 1), "VALID")


def _branch(p, x):
    """One density-image CNN branch: (B, 128, 128, 1) -> (B, 32)."""
    x = _max_pool2(jnp.tanh(_conv(x, p["conv1"], 1, "VALID")))
    x = _max_pool2(jnp.tanh(_conv(x, p["conv2"], 2, "SAME")))
    x = _max_pool2(jnp.tanh(_conv(x, p["conv3"], 2, "SAME")))
    x = x.reshape((x.shape[0], -1))  # (B, 256), HWC row-major like TF
    return jnp.tanh(_dense(x, p["dense"]))


def forward(params, img1, img2, feats):
    """Logits. img1/img2: (B, 128, 128, 1) normalized x255/max;
    feats: (B, nf). Class and feature counts follow from params."""
    b1 = _branch(params["branch1"], img1)
    b2 = _branch(params["branch2"], img2)
    f = jnp.tanh(_dense(feats, params["feature_dense"]))
    return _dense(jnp.concatenate([b1, b2, f], axis=-1), params["head"])


_forward = jax.jit(forward)


def predict_logits(params, img1, img2, feats, *, num_classes=5,
                   num_features=26):
    img1 = jnp.asarray(img1, jnp.float32).reshape(1, 128, 128, 1)
    img2 = jnp.asarray(img2, jnp.float32).reshape(1, 128, 128, 1)
    feats = jnp.asarray(feats, jnp.float32).reshape(1, num_features)
    logits = _forward(params, img1, img2, feats)[0]
    if logits.shape != (num_classes,):
        raise ValueError(f"params give {logits.shape[0]} classes, "
                         f"expected {num_classes}")
    return logits


def predict_class(params, img1, img2, feats, *, num_classes=5,
                  num_features=26) -> int:
    """argmax class — the reference's Pred() return (MatNet.py:92-96)."""
    logits = predict_logits(params, img1, img2, feats,
                            num_classes=num_classes,
                            num_features=num_features)
    return int(jnp.argmax(logits))


@functools.partial(jax.jit, static_argnames=("num_classes", "num_features"))
def init_params(key, num_classes=5, num_features=26):
    """Random parameters: LeCun-normal kernels, zero biases."""
    init = jax.nn.initializers.lecun_normal()
    shapes = {
        "conv1": (3, 3, 1, 16), "conv2": (5, 5, 16, 16),
        "conv3": (5, 5, 16, 16), "dense": (256, 32),
    }
    keys = iter(jax.random.split(key, 10))

    def layer(shape):
        return {"kernel": init(next(keys), shape, jnp.float32),
                "bias": jnp.zeros((shape[-1],), jnp.float32)}

    return {
        "branch1": {name: layer(s) for name, s in shapes.items()},
        "branch2": {name: layer(s) for name, s in shapes.items()},
        "feature_dense": layer((num_features, num_features)),
        "head": layer((64 + num_features, num_classes)),
    }
