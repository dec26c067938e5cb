"""Independent pure-numpy forward pass for MatNet, implementing TF/Keras
conv semantics from first principles — the parity oracle for models/matnet.py.
"""

import numpy as np


def _pad_same(x, k, s):
    """TF 'SAME' padding for kernel k, stride s along one spatial dim size."""
    h = x.shape[0]
    out = -(-h // s)
    pad = max((out - 1) * s + k - h, 0)
    return pad // 2, pad - pad // 2


def conv2d(x, kernel, bias, stride=1, padding="VALID"):
    """x: (H, W, Cin); kernel: (kh, kw, Cin, Cout)."""
    kh, kw, cin, cout = kernel.shape
    if padding == "SAME":
        ph = _pad_same(x, kh, stride)
        pw = _pad_same(x.transpose(1, 0, 2), kw, stride)
        x = np.pad(x, (ph, pw, (0, 0)))
    H, W, _ = x.shape
    oh = (H - kh) // stride + 1
    ow = (W - kw) // stride + 1
    out = np.zeros((oh, ow, cout))
    for a in range(oh):
        for b in range(ow):
            patch = x[a * stride:a * stride + kh, b * stride:b * stride + kw]
            out[a, b] = np.tensordot(patch, kernel, axes=([0, 1, 2],
                                                          [0, 1, 2]))
    return out + bias


def maxpool2(x):
    H, W, C = x.shape
    oh, ow = H // 2, W // 2
    x = x[:oh * 2, :ow * 2]
    return x.reshape(oh, 2, ow, 2, C).max(axis=(1, 3))


def branch(img, p):
    """img: (128, 128, 1); p: branch params dict (numpy)."""
    x = np.tanh(conv2d(img, p["conv1"]["kernel"], p["conv1"]["bias"],
                       stride=1, padding="VALID"))
    x = maxpool2(x)
    x = np.tanh(conv2d(x, p["conv2"]["kernel"], p["conv2"]["bias"],
                       stride=2, padding="SAME"))
    x = maxpool2(x)
    x = np.tanh(conv2d(x, p["conv3"]["kernel"], p["conv3"]["bias"],
                       stride=2, padding="SAME"))
    x = maxpool2(x)
    x = x.reshape(-1)  # (256,)
    return np.tanh(x @ p["dense"]["kernel"] + p["dense"]["bias"])


def forward(params, img1, img2, feats):
    """Returns logits (pre-softmax), matching MatNet.predict up to softmax."""
    p = _np(params)
    b1 = branch(img1.reshape(128, 128, 1), p["branch1"])
    b2 = branch(img2.reshape(128, 128, 1), p["branch2"])
    f = np.tanh(feats @ p["feature_dense"]["kernel"]
                + p["feature_dense"]["bias"])
    h = np.concatenate([b1, b2, f])
    return h @ p["head"]["kernel"] + p["head"]["bias"]


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float64)
