"""SpecAugment-style feature augmentation (Park et al. 2019) for the
trainable frontend: time and frequency masking over feature tensors.

Formulation: a masked region [t0, t0 + w) with random t0/w is expressed
as a broadcast index compare — static shapes, jit/vmap-clean, PRNG threaded
explicitly (jax convention). No data-dependent slicing anywhere.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["time_mask", "freq_mask", "spec_augment"]


def _mask_axis(x: jnp.ndarray, key, param: int, num_masks: int, axis: int,
               value: float) -> jnp.ndarray:
    if param < 0:
        raise ValueError(f"mask param must be >= 0, got {param}")
    if num_masks < 1:
        return x
    size = x.shape[axis]
    p = min(param, size)
    idx = jnp.arange(size)
    shape = [1] * x.ndim
    shape[axis] = size
    idx = idx.reshape(shape)
    for k in jax.random.split(key, num_masks):
        kw, ks = jax.random.split(k)
        w = jax.random.randint(kw, (), 0, p + 1)
        t0 = jax.random.randint(ks, (), 0, jnp.maximum(size - w, 0) + 1)
        x = jnp.where((idx >= t0) & (idx < t0 + w), value, x)
    return x


def time_mask(feats: jnp.ndarray, key, param: int = 20, num_masks: int = 1,
              value: float = 0.0) -> jnp.ndarray:
    """Zero (or ``value``) out ``num_masks`` random spans of up to ``param``
    frames along the time axis of ``[..., T, F]`` features."""
    return _mask_axis(feats, key, param, num_masks, feats.ndim - 2, value)


def freq_mask(feats: jnp.ndarray, key, param: int = 10, num_masks: int = 1,
              value: float = 0.0) -> jnp.ndarray:
    """Zero (or ``value``) out ``num_masks`` random bands of up to ``param``
    bins along the feature axis of ``[..., T, F]``."""
    return _mask_axis(feats, key, param, num_masks, feats.ndim - 1, value)


def spec_augment(
    feats: jnp.ndarray,
    key,
    time_param: int = 20,
    freq_param: int = 10,
    n_time_masks: int = 2,
    n_freq_masks: int = 2,
    value: float = 0.0,
) -> jnp.ndarray:
    """Standard SpecAugment recipe: ``n_freq_masks`` frequency bands +
    ``n_time_masks`` time spans masked (no time warping — its gather cost
    buys little and the masks are the effective part of the recipe)."""
    kt, kf = jax.random.split(key)
    out = freq_mask(feats, kf, freq_param, n_freq_masks, value)
    return time_mask(out, kt, time_param, n_time_masks, value)
