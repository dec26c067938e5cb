"""MatNet training — the upcycle path.

The reference ships only inference + pretrained weights (no training code
anywhere in the tree); to retarget the selector at OUR algorithm menu and
measured timings, this module provides a full data-parallel training loop:
softmax cross-entropy over (img1, img2, features) -> winning-algorithm
labels harvested from the benchmark harness.

With a mesh, the batch is sharded over its data axis and gradients are
averaged by jit-inserted collectives (GSPMD).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ia_spgemm_tpu.models.matnet import forward, init_params


@dataclasses.dataclass
class TrainConfig:
    num_classes: int = 5
    num_features: int = 26
    learning_rate: float = 1e-3
    batch_size: int = 32
    steps: int = 200
    seed: int = 0


def make_train_step(tx: optax.GradientTransformation):
    def loss_fn(params, batch):
        img1, img2, feats, labels = batch
        logits = forward(params, img1, img2, feats)
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()
        acc = jnp.mean(jnp.argmax(logits, -1) == labels)
        return loss, acc

    @jax.jit
    def train_step(params, opt_state, batch):
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, batch)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, acc

    return train_step


def train(dataset: Iterator[Tuple], config: TrainConfig = TrainConfig(),
          params=None, mesh: jax.sharding.Mesh | None = None,
          log_every: int = 50, log=print):
    """Train MatNet. `dataset` yields (img1, img2, feats, labels) batches
    with leading batch dim. With a mesh, batches are sharded over its first
    axis (pure data parallelism — the model is tiny, ~56k params)."""
    if params is None:
        params = init_params(jax.random.PRNGKey(config.seed),
                             config.num_classes, config.num_features)
    tx = optax.adam(config.learning_rate)
    opt_state = tx.init(params)
    step_fn = make_train_step(tx)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        axis = mesh.axis_names[0]
        batch_sharding = NamedSharding(mesh, P(axis))
        replicated = NamedSharding(mesh, P())
        params = jax.device_put(params, replicated)
        opt_state = jax.device_put(opt_state, replicated)

    history = []
    for step, batch in enumerate(dataset):
        if step >= config.steps:
            break
        batch = tuple(jnp.asarray(b) for b in batch)
        if mesh is not None:
            batch = tuple(jax.device_put(b, batch_sharding) for b in batch)
        params, opt_state, loss, acc = step_fn(params, opt_state, batch)
        if step % log_every == 0:
            history.append((step, float(loss), float(acc)))
            log(f"step {step}: loss={float(loss):.4f} acc={float(acc):.3f}")
    return params, history


def synthetic_dataset(config: TrainConfig, seed: int = 0):
    """Deterministic synthetic batches for tests: class k's images carry a
    k-dependent block pattern so the task is learnable."""
    rng = np.random.default_rng(seed)
    while True:
        labels = rng.integers(0, config.num_classes, config.batch_size)
        img1 = rng.random((config.batch_size, 128, 128, 1)).astype(np.float32)
        img2 = rng.random((config.batch_size, 128, 128, 1)).astype(np.float32)
        feats = rng.random((config.batch_size,
                            config.num_features)).astype(np.float32)
        for b, k in enumerate(labels):
            img1[b, 16 * k:16 * k + 16, :16, 0] += 4.0
            feats[b, k % config.num_features] += 4.0
        yield img1, img2, feats, labels.astype(np.int32)
