"""Linear predictive coding: all-pole modeling by the autocorrelation method.

The reference app has no parametric modeling; LPC completes the analysis
stack next to YIN/pYIN (source-filter view: pYIN estimates the source, LPC
the filter) and feeds formant-style work.

Formulation: the autocorrelation rides the same matmul banks as the
pitch trackers (ops/rhythm.py::autocorrelate, zero-collective under batch
sharding), and the Levinson-Durbin recursion is a ``lax.scan`` over the
model order — order+1 steps whose body is a masked gather + fused vector
update over the fixed-size coefficient vector, batched over all leading
axes at once (every frame of every batch element recursed in lockstep).
Conventions: ``a[0] = 1`` and the predictor is ``x[n] ~ -sum a[k] x[n-k]``
(the np.convolve(a, x) residual form); the serial float64 oracle lives in
tests/test_lpc.py.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["lpc", "lpc_from_autocorr", "lpc_residual_energy"]


def lpc_from_autocorr(r: jnp.ndarray, order: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Levinson-Durbin: autocorrelation ``[..., >= order+1]`` -> (a, e).

    Returns the all-pole coefficients ``a`` ``[..., order+1]`` (``a[0] = 1``)
    and the final prediction-error energy ``e`` ``[...]``. Zero-energy input
    (r[0] == 0) yields a = [1, 0, ...], e = 0 — guarded, not NaN.
    """
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    if r.shape[-1] < order + 1:
        raise ValueError(
            f"need at least order+1 = {order + 1} autocorrelation lags, "
            f"got {r.shape[-1]}"
        )
    r = r[..., : order + 1]
    dtype = r.dtype
    jidx = jnp.arange(order + 1)
    a0 = jnp.zeros(r.shape, dtype).at[..., 0].set(1.0)
    e0 = r[..., 0]

    def body(carry, i):
        a, e = carry
        # s = sum_{j=0}^{i-1} a[j] * r[i-j]  (a[0] = 1 supplies the r[i] term)
        idx = jnp.clip(i - jidx, 0, order)
        mask = (jidx < i).astype(dtype)
        s = (a * jnp.take(r, idx, axis=-1) * mask).sum(axis=-1)
        safe_e = jnp.where(e > 0, e, 1.0)
        k = jnp.where(e > 0, -s / safe_e, 0.0)
        # a'[j] = a[j] + k * a[i-j] for j = 1..i (a[i] was 0, so a'[i] = k)
        rev_mask = ((jidx >= 1) & (jidx <= i)).astype(dtype)
        a_rev = jnp.take(a, idx, axis=-1) * rev_mask
        a = a + k[..., None] * a_rev
        e = e * (1.0 - k * k)
        return (a, e), None

    (a, e), _ = jax.lax.scan(body, (a0, e0), jnp.arange(1, order + 1))
    return a, e


def lpc(x: jnp.ndarray, order: int, precision: str | None = None) -> jnp.ndarray:
    """All-pole LPC coefficients of ``x`` ``[..., L]`` -> ``[..., order+1]``.

    Autocorrelation method (Levinson-Durbin on the biased autocorrelation of
    the raw samples — window upstream if desired). Batched over leading
    axes; for framed analysis pass ``frame(x, L, hop)`` output directly.
    """
    from .rhythm import autocorrelate

    r = autocorrelate(x, max_lag=order, precision=precision)
    a, _ = lpc_from_autocorr(r, order)
    return a


def lpc_residual_energy(x: jnp.ndarray, order: int, precision: str | None = None) -> jnp.ndarray:
    """Prediction-error energy per analysis vector ``[..., L]`` -> ``[...]``
    (the Levinson ``e``; the whitened-source power of the all-pole model)."""
    from .rhythm import autocorrelate

    r = autocorrelate(x, max_lag=order, precision=precision)
    _, e = lpc_from_autocorr(r, order)
    return e
