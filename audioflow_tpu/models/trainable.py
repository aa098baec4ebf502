"""Trainable feature frontend: differentiable DSP + learned head.

The kernel library is pure-functional jnp, so the whole DSP chain is
differentiable for free. This module puts a small trainable stack on top of
the fixed STFT: learnable per-mel filter gains, PCEN-style compression with
learnable (alpha, delta, r), and a linear classifier head — a standard
trainable audio frontend. Its ``train_step`` is the framework's canonical
multi-chip training path: batch sharded over the mesh's data axis, parameters
replicated, XLA inserting the gradient all-reduce. It needs ``optax``,
which is imported by the functions that use it: the inference path imports
only jax and numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import mel_filterbank, power, stft


@dataclass(frozen=True)
class TrainableFrontend:
    """Static config; parameters live in an explicit pytree."""

    sample_rate: int = 16000
    n_fft: int = 512
    hop: int = 128
    n_mels: int = 64
    n_classes: int = 10
    hidden: int = 0  # > 0: MLP head whose hidden dim is the tensor-parallel
    # axis (Megatron split: w1 column-sharded, w2 row-sharded, one psum)
    smoothing: float = 0.04  # PCEN EMA coefficient (fixed; scan carry-free via conv)
    remat: bool = False  # jax.checkpoint the feature extractor: trade FLOPs
    # for device memory when the frontend feeds a large model

    def init_params(self, seed: int = 0) -> dict:
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        params = {
            "mel_gain": jnp.ones(self.n_mels, jnp.float32),
            "pcen_alpha": jnp.full((self.n_mels,), 0.98, jnp.float32),
            "pcen_delta": jnp.full((self.n_mels,), 2.0, jnp.float32),
            "pcen_r": jnp.full((self.n_mels,), 0.5, jnp.float32),
        }
        if self.hidden > 0:
            params.update(
                w1=jax.random.normal(k1, (self.n_mels, self.hidden), jnp.float32)
                * (1.0 / np.sqrt(self.n_mels)),
                b1=jnp.zeros(self.hidden, jnp.float32),
                w2=jax.random.normal(k2, (self.hidden, self.n_classes), jnp.float32)
                * (1.0 / np.sqrt(self.hidden)),
                b2=jnp.zeros(self.n_classes, jnp.float32),
            )
        else:
            params.update(
                w=jax.random.normal(k1, (self.n_mels, self.n_classes), jnp.float32) * 0.02,
                b=jnp.zeros(self.n_classes, jnp.float32),
            )
        return params

    def features(self, params: dict, x: jnp.ndarray) -> jnp.ndarray:
        """x [batch, T] -> PCEN log-mel features [batch, frames, n_mels]."""
        fb = jnp.asarray(mel_filterbank(self.n_fft // 2 + 1, self.n_mels, self.sample_rate))
        spec = power(stft(x, self.n_fft, self.hop, center=False))
        mels = jnp.matmul(spec, fb, preferred_element_type=jnp.float32)
        mels = mels * jax.nn.softplus(params["mel_gain"])
        # smoother M via EMA over frames expressed as an associative scan
        s = self.smoothing

        def ema(carry, m):
            carry = (1 - s) * carry + s * m
            return carry, carry

        m0 = mels[..., 0, :]
        _, smooth = jax.lax.scan(ema, m0, jnp.moveaxis(mels, -2, 0))
        smooth = jnp.moveaxis(smooth, 0, -2)
        eps = 1e-6
        alpha = jax.nn.sigmoid(params["pcen_alpha"])
        r = jax.nn.sigmoid(params["pcen_r"])
        delta = jax.nn.softplus(params["pcen_delta"])
        pcen = (mels / (eps + smooth) ** alpha + delta) ** r - delta**r
        return pcen

    def logits(self, params: dict, x: jnp.ndarray) -> jnp.ndarray:
        feat_fn = jax.checkpoint(self.features) if self.remat else self.features
        feats = feat_fn(params, x).mean(axis=-2)  # [batch, n_mels]
        if self.hidden > 0:
            # the TP-shardable head: with w1 sharded P(None, "model") and w2
            # P("model", None), GSPMD keeps h local per model shard and
            # inserts exactly one all-reduce for the w2 contraction
            h = jax.nn.relu(feats @ params["w1"] + params["b1"])
            return h @ params["w2"] + params["b2"]
        return feats @ params["w"] + params["b"]

    def loss(self, params: dict, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
        import optax

        lg = self.logits(params, x)
        return optax.softmax_cross_entropy_with_integer_labels(lg, y).mean()


def make_train_step(
    model: TrainableFrontend,
    optimizer=None,
    mesh=None,
    data_axis: str = "data",
    model_axis: str | None = None,
):
    """Build a jitted ``train_step(params, opt_state, x, y)``.

    With ``mesh``, the batch (x, y) is sharded over the data axis and params
    are replicated; the mean-gradient all-reduce is the only collective —
    the framework's canonical multi-chip step (SURVEY §2.6).

    With ``model_axis`` too (requires ``model.hidden > 0`` and a 2-D mesh,
    e.g. ``make_mesh(8, axes=("data", "model"), shape=(4, 2))``), the MLP
    head runs tensor-parallel: ``w1`` column-sharded / ``w2`` row-sharded
    over the model axis (the Megatron split), so each shard computes a
    partial logits contribution and GSPMD inserts one all-reduce; gradients
    of the sharded params stay sharded (their optimizer state too — the
    update is elementwise), giving DP x TP with no manual collectives.
    """
    import optax

    optimizer = optimizer or optax.adam(1e-3)

    def step(params, opt_state, x, y):
        loss, grads = jax.value_and_grad(model.loss)(params, x, y)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    if mesh is None:
        return jax.jit(step), optimizer

    from jax.sharding import NamedSharding, PartitionSpec as P

    repl = NamedSharding(mesh, P())
    data2 = NamedSharding(mesh, P(data_axis, None))
    data1 = NamedSharding(mesh, P(data_axis))

    if model_axis is None:
        jitted = jax.jit(
            step,
            in_shardings=(repl, repl, data2, data1),
            out_shardings=(repl, repl, repl),
        )
        return jitted, optimizer

    if model.hidden <= 0:
        raise ValueError("model_axis sharding requires TrainableFrontend(hidden > 0)")
    tp_spec = {
        "w1": NamedSharding(mesh, P(None, model_axis)),
        "b1": NamedSharding(mesh, P(model_axis)),
        "w2": NamedSharding(mesh, P(model_axis, None)),
    }

    def param_shardings(params):
        return {k: tp_spec.get(k, repl) for k in params}

    def opt_shardings(opt_state, pshard):
        """Optimizer state mirrors the param tree (adam: mu/nu are
        param-shaped dicts): any dict with exactly the param keys gets the
        param shardings; scalars/counters replicate."""

        def walk(node):
            if isinstance(node, dict) and set(node) == set(pshard):
                return dict(pshard)
            if isinstance(node, tuple):
                mapped = [walk(c) for c in node]
                return type(node)(*mapped) if hasattr(node, "_fields") else tuple(mapped)
            if isinstance(node, list):
                return [walk(c) for c in node]
            return jax.tree_util.tree_map(lambda _: repl, node)

        return walk(opt_state)

    # shardings depend on the concrete (params, opt_state) trees, so jit
    # lazily, keyed on the tree STRUCTURES — a later call with a different
    # params layout (e.g. a reloaded checkpoint) re-derives its shardings
    # instead of hitting a stale jit. The returned callable keeps the
    # uniform step(params, opt_state, x, y) signature.
    cache: dict = {}

    def stepper(params, opt_state, x, y):
        key = (
            jax.tree_util.tree_structure(params),
            jax.tree_util.tree_structure(opt_state),
        )
        if key not in cache:
            pshard = param_shardings(params)
            cache[key] = jax.jit(
                step,
                in_shardings=(pshard, opt_shardings(opt_state, pshard), data2, data1),
                out_shardings=(pshard, opt_shardings(opt_state, pshard), repl),
            )
        return cache[key](params, opt_state, x, y)

    return stepper, optimizer
