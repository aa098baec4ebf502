"""Framing and overlap-add primitives.

Notes: framing is expressed as k static slices + reshape when
``frame_length % hop == 0`` (the common STFT case), which XLA fuses into the
downstream window-multiply with no gather; otherwise it falls back to one
gather with a trace-time-constant index matrix. All shapes are static under
jit. Replaces the per-chunk Vec copies of the reference's capture path
(reference: src-tauri/src/modules/audio/capture.rs:103-161) with
whole-batch tensor ops.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp


def num_frames(n_samples: int, frame_length: int, hop: int) -> int:
    """Number of full frames that fit (no partial tail frame)."""
    if n_samples < frame_length:
        return 0
    return 1 + (n_samples - frame_length) // hop


def frame(x: jnp.ndarray, frame_length: int, hop: int) -> jnp.ndarray:
    """Slice ``x[..., T]`` into overlapping frames ``[..., n_frames, frame_length]``.

    frames[i] = x[..., i*hop : i*hop + frame_length]. Tail samples that do not
    fill a frame are dropped (pad upstream for `center` semantics).
    """
    t = x.shape[-1]
    n = num_frames(t, frame_length, hop)
    if n <= 0:
        raise ValueError(
            f"signal length {t} shorter than frame_length {frame_length}"
        )
    if frame_length % hop == 0:
        k = frame_length // hop
        # y: [..., n_hops, hop]; frame i = concat(y[i], ..., y[i+k-1])
        n_hops = n + k - 1
        y = x[..., : n_hops * hop].reshape(*x.shape[:-1], n_hops, hop)
        parts = [y[..., j : j + n, :] for j in range(k)]
        return jnp.concatenate(parts, axis=-1)
    idx = np.arange(n)[:, None] * hop + np.arange(frame_length)[None, :]
    return x[..., idx]


def overlap_add(frames: jnp.ndarray, hop: int) -> jnp.ndarray:
    """Inverse of :func:`frame`: out[t] = sum_i frames[..., i, t - i*hop].

    Output length is ``(n_frames - 1) * hop + frame_length``.
    """
    *lead, n, length = frames.shape
    if length % hop == 0:
        k = length // hop
        # split each frame into k hop-chunks; chunk m of frame i lands at hop i+m
        z = jnp.zeros((*lead, n + k - 1, hop), dtype=frames.dtype)
        f = frames.reshape(*lead, n, k, hop)
        for m in range(k):
            z = z.at[..., m : m + n, :].add(f[..., :, m, :])
        return z.reshape(*lead, (n + k - 1) * hop)
    out_len = (n - 1) * hop + length
    z = jnp.zeros((*lead, out_len), dtype=frames.dtype)
    for i in range(n):  # non-divisible hop: rare path, static unroll
        z = z.at[..., i * hop : i * hop + length].add(frames[..., i, :])
    return z
