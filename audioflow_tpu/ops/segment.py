"""Structural analysis: self-similarity, novelty, section boundaries.

The reference app has no structure analysis; this family closes the loop for
music/long-form audio (where are the sections?) on the same substrate as
everything else:

* the recurrence (self-similarity) matrix is one Gram matmul of normalized
  feature frames — one [T, D] @ [D, T] matmul — with
  kNN sparsification done densely (a per-row threshold against the k-th
  sorted value; no data-dependent shapes);
* Foote novelty runs the box-checkerboard kernel EXACTLY in O(T) gathers via
  a 2-D summed-area table (two cumsums over the similarity matrix), instead
  of the O(T * L^2) sliding kernel — the integral-image trick as one fused
  XLA program;
* boundary picking reuses the rhythm family's shifted-slice peak picker.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ._mm import mm

__all__ = [
    "self_similarity",
    "cross_similarity",
    "recurrence_matrix",
    "novelty_curve",
    "segment_boundaries",
]


def _normalize_rows(x: jnp.ndarray, metric: str) -> jnp.ndarray:
    if metric == "cosine":
        return x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    if metric == "dot":
        return x
    raise ValueError(f"unknown metric {metric!r}; known: cosine, dot")


def self_similarity(
    feats: jnp.ndarray, metric: str = "cosine", precision: str | None = None
) -> jnp.ndarray:
    """Frame-by-frame similarity ``[..., T, D] -> [..., T, T]`` (one Gram
    matmul; cosine rows are unit-normalized first)."""
    xn = _normalize_rows(jnp.asarray(feats), metric)
    return mm(xn, jnp.swapaxes(xn, -2, -1), precision)


def cross_similarity(
    a: jnp.ndarray, b: jnp.ndarray, metric: str = "cosine",
    precision: str | None = None,
) -> jnp.ndarray:
    """Similarity between two feature sequences ``[..., Ta, D] x [..., Tb, D]
    -> [..., Ta, Tb]`` (the DTW cost's affinity twin)."""
    an = _normalize_rows(jnp.asarray(a), metric)
    bn = _normalize_rows(jnp.asarray(b), metric)
    return mm(an, jnp.swapaxes(bn, -2, -1), precision)


def recurrence_matrix(
    feats: jnp.ndarray,
    k: int | None = None,
    width: int = 1,
    metric: str = "cosine",
    sym: bool = False,
) -> jnp.ndarray:
    """kNN recurrence matrix ``[..., T, T]`` (float 0/1).

    ``R[i, j] = 1`` iff frame j is among frame i's ``k`` most similar frames
    (default ``k = ceil(sqrt(T))``), excluding the diagonal band
    ``|i - j| < width``. ``sym=True`` keeps only mutual links (R & R.T).
    Dense formulation: one Gram matmul, a per-row sort for the k-th value,
    one broadcast compare — static shapes throughout.
    """
    s = self_similarity(feats, metric)
    t = s.shape[-1]
    if not 1 <= width <= t:
        raise ValueError(f"width must be in [1, {t}], got {width}")
    if k is None:
        k = int(np.ceil(np.sqrt(t)))
    k = min(max(int(k), 1), t)
    idx = jnp.arange(t)
    band = jnp.abs(idx[:, None] - idx[None, :]) < width
    neg = jnp.asarray(-jnp.inf, s.dtype)
    s = jnp.where(band, neg, s)
    # k-th largest per row via a full sort (T is feature-frame scale; the
    # sort is batched and stays on device)
    kth = jnp.sort(s, axis=-1)[..., t - k : t - k + 1]
    r = (s >= kth) & ~band & jnp.isfinite(s)
    if sym:
        r = r & jnp.swapaxes(r, -2, -1)
    return r.astype(feats.dtype)


def novelty_curve(
    s: jnp.ndarray, kernel_width: int = 32, normalize: bool = True
) -> jnp.ndarray:
    """Foote novelty of a self-similarity matrix ``[..., T, T] -> [..., T]``.

    Box checkerboard of half-width ``L = kernel_width // 2`` centered on the
    diagonal: ``nov[t] = sum(past block) + sum(future block) - 2 * sum(cross
    block)``, each block sum read from a 2-D summed-area table in O(1) —
    exact, and the whole curve is gathers over two cumsums. Edges (t < L or
    t > T - L) use the truncated blocks that fit (the kernel shrinks, it
    does not wrap). ``normalize=True`` divides by the actual block area so
    edge values stay on the same scale.
    """
    s = jnp.asarray(s)
    t = s.shape[-1]
    l = max(1, int(kernel_width) // 2)
    # summed-area table with a zero guard row/col: sat[i, j] = sum s[:i, :j]
    sat = jnp.cumsum(jnp.cumsum(s, axis=-1), axis=-2)
    pads = [(0, 0)] * (s.ndim - 2) + [(1, 0), (1, 0)]
    sat = jnp.pad(sat, pads)

    ts = jnp.arange(t)
    lo = jnp.maximum(ts - l, 0)
    hi = jnp.minimum(ts + l, t)

    def block(r0, r1, c0, c1):
        """sum s[r0:r1, c0:c1] per t (vectors of indices)."""
        return (
            sat[..., r1, c1] - sat[..., r0, c1] - sat[..., r1, c0] + sat[..., r0, c0]
        )

    past = block(lo, ts, lo, ts)
    future = block(ts, hi, ts, hi)
    cross = block(lo, ts, ts, hi)
    nov = past + future - 2.0 * cross
    area = ((ts - lo) * (hi - ts)).astype(s.dtype)
    if normalize:
        nov = nov / jnp.maximum(area, 1.0)
    # an empty past or future block (first/last frame) has no contrast to
    # measure — zero, not a spurious edge spike
    return jnp.where(area > 0, jnp.maximum(nov, 0.0), 0.0)


def segment_boundaries(
    feats: jnp.ndarray,
    kernel_width: int = 32,
    metric: str = "cosine",
    pre: int | None = None,
    post: int | None = None,
    delta: float = 0.05,
    wait: int | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Section boundaries from feature frames ``[T, D]``.

    Self-similarity -> Foote novelty -> shifted-slice peak picking
    (ops/rhythm.py::peak_pick). Returns ``(boundary_mask [T] bool,
    novelty [T])``. Peak-picker windows default to the kernel half-width.
    """
    from .rhythm import peak_pick

    s = self_similarity(feats, metric)
    nov = novelty_curve(s, kernel_width)
    half = max(1, kernel_width // 2)
    pre_w = half if pre is None else pre
    post_w = half if post is None else post
    mask = peak_pick(
        nov,
        pre_max=pre_w,
        post_max=post_w,
        pre_avg=pre_w,
        post_avg=post_w,
        delta=delta,
        wait=half if wait is None else wait,
    )
    # the first/last half-kernel frames see a badly truncated checkerboard
    # (tiny noisy blocks) — a "boundary" there is an edge artifact
    t = nov.shape[-1]
    idx = jnp.arange(t)
    interior = (idx >= half) & (idx < t - half)
    return mask & interior, nov
