"""Train the differentiable frontend on a synthetic keyword-spotting task.

Demonstrates the models/ story end to end: the trainable PCEN log-mel
frontend + MLP head (models/trainable.py), SpecAugment feature masking
(ops/augment.py), and the data-parallel train step (sharded over every
local device when more than one is present; the same code scales to a multi-GPU
pod via `parallel.make_mesh`).

Usage: python examples/train_kws.py [n_steps] [out_metrics.json]
"""

import json
import sys

import numpy as np

import jax
import jax.numpy as jnp
import optax

from audioflow_tpu import ops
from audioflow_tpu.models import TrainableFrontend, make_train_step
from audioflow_tpu.parallel import make_mesh, shard_batch


def make_dataset(rng, n_per_class=32, sr=16000, dur=4096):
    """Two classes: low warble 'keyword' vs band-limited noise."""
    t = np.arange(dur) / sr
    xs, ys = [], []
    for _ in range(n_per_class):
        f0 = rng.uniform(250, 350)
        kw = 0.4 * np.sin(2 * np.pi * (f0 + 30 * np.sin(2 * np.pi * 3 * t)) * t)
        xs.append(kw + 0.05 * rng.standard_normal(dur))
        ys.append(0)
        xs.append(0.3 * rng.standard_normal(dur))
        ys.append(1)
    order = rng.permutation(len(xs))
    return (
        np.asarray(xs, np.float32)[order],
        np.asarray(ys, np.int32)[order],
    )


def main(n_steps=60, out_path=None):
    rng = np.random.default_rng(0)
    x, y = make_dataset(rng)
    model = TrainableFrontend(n_fft=256, hop=128, n_mels=24, n_classes=2, hidden=16)
    params = model.init_params()

    devices = jax.devices()
    mesh = make_mesh() if len(devices) > 1 else None
    step, optimizer = make_train_step(model, optimizer=optax.adam(2e-2), mesh=mesh)
    opt_state = optimizer.init(params)

    if mesh is not None:
        keep = x.shape[0] // len(devices) * len(devices)
        x, y = x[:keep], y[:keep]
        xb, yb = shard_batch(x, mesh), shard_batch(y, mesh)
    else:
        xb, yb = jnp.asarray(x), jnp.asarray(y)

    losses = []
    for i in range(n_steps):
        params, opt_state, loss = step(params, opt_state, xb, yb)
        losses.append(float(loss))

    logits = jax.jit(model.logits)(params, jnp.asarray(x))
    acc = float((np.argmax(np.asarray(logits), -1) == y).mean())

    # SpecAugment preview: the masking the training loop would apply to the
    # learned features for regularization on real data
    feats = jax.jit(model.features)(params, jnp.asarray(x[:4]))
    masked = ops.spec_augment(feats, jax.random.PRNGKey(0))
    report = {
        "devices": len(devices),
        "sharded": mesh is not None,
        "loss_first": round(losses[0], 4),
        "loss_last": round(losses[-1], 4),
        "train_accuracy": acc,
        "feats_shape": list(np.asarray(feats).shape),
        "masked_fraction": round(float((np.asarray(masked) == 0).mean()), 4),
    }
    print(json.dumps(report))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f)
    assert losses[-1] < losses[0] * 0.5, "training did not converge"
    assert acc > 0.9, f"accuracy {acc}"
    return 0


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 60
    out = sys.argv[2] if len(sys.argv) > 2 else None
    sys.exit(main(n, out))
