"""Sequence decoding: Viterbi (dense + banded max-plus) and DTW alignment.

The reference app has no sequence models (its only temporal decision logic is
the 3-state VAD machine, vad.rs:120-199); this module supplies the decoding
layer that probabilistic trackers need — the pYIN pitch tracker
(ops/pitch.py) rides the banded max-plus helper, and dense Viterbi / DTW are
exposed for general feature-sequence work (alignment, segmentation).

Formulations:

* Viterbi is a ``lax.scan`` over time whose body is one max-plus contraction
  ``delta'[j] = obs[j] + max_i (delta[i] + logA[i, j])``. For dense
  transitions that is a broadcast [S, S] max-reduce per step; backpointers
  are recorded as int32 and the decode is a second (reverse) scan — no
  per-frame Python, static shapes throughout, batched over leading axes.
* Band-structured transitions (local pitch/state movement) never build the
  [S, S] matrix: ``max_plus_band`` evaluates the banded max-plus as
  2w+1 shifted adds + a max tree, which XLA fuses into one vector pass —
  the HPSS shifted-slice lesson applied to decoding.
* DTW runs as a wavefront ``lax.scan`` over anti-diagonals with static
  padded diagonal vectors (no data-dependent shapes), then a host-side
  backtrace over the recorded step choices (the path is ragged by nature
  and leaves the device once, as one int8 array).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "transition_local",
    "viterbi",
    "max_plus_band",
    "max_plus_band_argmax",
    "dtw",
]

_NEG = -1e30  # effective -inf that survives f32 adds without NaN


def transition_local(n_states: int, width: int) -> np.ndarray:
    """Row-stochastic local-movement transition matrix ``[n, n]``.

    Row i is a triangular window of ``width`` bins centered on i (width is
    forced odd), truncated at the edges and renormalized — transitions move
    at most ``width // 2`` states per step. float64, built on host (it is a
    constant of the decode, not traced).
    """
    if n_states < 1:
        raise ValueError(f"n_states must be >= 1, got {n_states}")
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    w = int(width) | 1  # odd
    half = w // 2
    tri = 1.0 - np.abs(np.arange(-half, half + 1, dtype=np.float64)) / (half + 1.0)
    a = np.zeros((n_states, n_states))
    for i in range(n_states):
        lo, hi = max(0, i - half), min(n_states, i + half + 1)
        a[i, lo:hi] = tri[lo - (i - half) : hi - (i - half)]
        a[i] /= a[i].sum()
    return a


def max_plus_band(delta: jnp.ndarray, log_kernel: jnp.ndarray) -> jnp.ndarray:
    """Banded max-plus product ``out[j] = max_k delta[j + k - half] + lk[k]``.

    ``delta`` is ``[..., S]``, ``log_kernel`` a length-(2*half+1) vector of
    log-transition weights for offsets ``-half..+half`` (out-of-range source
    states read -inf). This is the inner step of a banded Viterbi: 2w+1
    shifted adds folded by a max tree, fuseable, no [S, S] materialization.

    Note the index convention: ``out[j]`` maxes over *source* states
    ``i = j + k - half``, so ``log_kernel[k]`` weights the move from state
    ``j + (k - half)`` to ``j`` — for symmetric kernels (the usual local-
    movement window) direction does not matter.
    """
    k = log_kernel.shape[0]
    if k % 2 != 1:
        raise ValueError(f"log_kernel length must be odd, got {k}")
    half = k // 2
    s = delta.shape[-1]
    pads = [(0, 0)] * (delta.ndim - 1) + [(half, half)]
    dp = jnp.pad(delta, pads, constant_values=_NEG)
    out = dp[..., 0:s] + log_kernel[0]
    for i in range(1, k):
        out = jnp.maximum(out, dp[..., i : i + s] + log_kernel[i])
    return out


def max_plus_band_argmax(
    delta: jnp.ndarray, log_kernel: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Like :func:`max_plus_band` but also returns the winning kernel offset
    index (int16, 0..2*half; source state = j + offset - half). Ties keep the
    lowest offset — the convention the serial oracle in the tests mirrors.
    Doubles the elementwise work of the plain band; used where a decode needs
    backpointers (the pYIN Viterbi, ops/pitch.py)."""
    k = log_kernel.shape[0]
    if k % 2 != 1:
        raise ValueError(f"log_kernel length must be odd, got {k}")
    half = k // 2
    s = delta.shape[-1]
    pads = [(0, 0)] * (delta.ndim - 1) + [(half, half)]
    dp = jnp.pad(delta, pads, constant_values=_NEG)
    best = dp[..., 0:s] + log_kernel[0]
    arg = jnp.zeros(best.shape, jnp.int16)
    for i in range(1, k):
        cand = dp[..., i : i + s] + log_kernel[i]
        take = cand > best
        best = jnp.where(take, cand, best)
        arg = jnp.where(take, jnp.int16(i), arg)
    return best, arg


def viterbi(
    log_obs: jnp.ndarray,
    log_trans: jnp.ndarray,
    log_init: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Most-likely state path through a dense-transition HMM.

    Args:
      log_obs: ``[..., T, S]`` per-frame log observation likelihoods.
      log_trans: ``[S, S]`` log transition matrix, ``log_trans[i, j]`` =
        log P(j at t+1 | i at t).
      log_init: ``[S]`` log initial distribution (uniform if None).

    Returns:
      ``(states, log_prob)``: the decoded path ``[..., T]`` (int32) and the
      path log-probability ``[...]``.
    """
    log_obs = jnp.asarray(log_obs)
    s = log_obs.shape[-1]
    log_trans = jnp.asarray(log_trans, log_obs.dtype)
    if log_trans.shape != (s, s):
        raise ValueError(f"log_trans must be [{s}, {s}], got {log_trans.shape}")
    if log_init is None:
        log_init = jnp.full((s,), -np.log(s), log_obs.dtype)
    delta0 = log_init + log_obs[..., 0, :]

    obs_rest = jnp.moveaxis(log_obs[..., 1:, :], -2, 0)  # [T-1, ..., S]

    def fwd(delta, obs_t):
        # scores[..., i, j] = delta[..., i] + A[i, j]
        scores = delta[..., :, None] + log_trans
        bp = jnp.argmax(scores, axis=-2).astype(jnp.int32)  # [..., S]
        delta_new = jnp.max(scores, axis=-2) + obs_t
        return delta_new, bp

    delta_t, bps = jax.lax.scan(fwd, delta0, obs_rest)  # bps: [T-1, ..., S]
    last = jnp.argmax(delta_t, axis=-1).astype(jnp.int32)  # [...]
    log_prob = jnp.max(delta_t, axis=-1)

    def back(state, bp_t):
        prev = jnp.take_along_axis(bp_t, state[..., None], axis=-1)[..., 0]
        return prev, state

    # reverse scan: y at index m is the state at time m+1; the final carry is
    # the state at time 0
    first, states_rev = jax.lax.scan(back, last, bps, reverse=True)  # [T-1, ...]
    states = jnp.concatenate(
        [first[..., None], jnp.moveaxis(states_rev, 0, -1)], axis=-1
    )
    return states, log_prob


def _dtw_cost(cost: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Accumulated-cost matrix + step choices by anti-diagonal wavefront.

    ``cost`` is ``[N, M]`` (one pair; vmap for batches). Steps are the
    classic (1,1), (1,0), (0,1) with unit weights. Returns ``(acc, steps)``
    where ``steps[i, j]`` in {0: diag, 1: up (i-1,j), 2: left (i, j-1)}.
    """
    n, m = cost.shape
    big = jnp.asarray(1e30, cost.dtype)
    # diag k holds cells (i, j) with i + j == k, indexed by i in [0, n)
    n_diag = n + m - 1

    # padded diagonal carrier of length n; cell i valid iff 0 <= k - i < m
    def body(carry, k):
        prev, prev2 = carry  # acc along diagonals k-1, k-2
        i = jnp.arange(n)
        j = k - i
        valid = (j >= 0) & (j < m)
        c = jnp.where(valid, cost[i, jnp.clip(j, 0, m - 1)], big)
        # neighbors: (i-1, j-1) -> prev2[i-1]; (i-1, j) -> prev[i-1];
        #            (i, j-1)   -> prev[i]
        shift = jnp.concatenate([jnp.full((1,), big, cost.dtype), prev[:-1]])
        shift2 = jnp.concatenate([jnp.full((1,), big, cost.dtype), prev2[:-1]])
        d_diag = jnp.where((i >= 1) & (j >= 1), shift2, big)
        d_up = jnp.where((i >= 1) & (j >= 0), shift, big)
        d_left = jnp.where(j >= 1, prev, big)
        # origin cell (0, 0): no predecessor, bare cost
        base = jnp.minimum(jnp.minimum(d_diag, d_up), d_left)
        step = jnp.where(
            d_diag <= jnp.minimum(d_up, d_left),
            0,
            jnp.where(d_up <= d_left, 1, 2),
        ).astype(jnp.int8)
        acc = jnp.where((i == 0) & (k == 0), c, c + base)
        acc = jnp.where(valid, acc, big)
        return (acc, prev), (acc, step)

    init = (jnp.full((n,), big, cost.dtype), jnp.full((n,), big, cost.dtype))
    _, (acc_d, steps_d) = jax.lax.scan(body, init, jnp.arange(n_diag))
    # scatter diagonals back to [N, M]
    i = jnp.arange(n)[:, None]
    j = jnp.arange(m)[None, :]
    acc = acc_d[i + j, jnp.broadcast_to(i, (n, m))]
    steps = steps_d[i + j, jnp.broadcast_to(i, (n, m))]
    return acc, steps


def dtw(
    x: jnp.ndarray | None = None,
    y: jnp.ndarray | None = None,
    *,
    cost: jnp.ndarray | None = None,
    metric: str = "euclidean",
) -> tuple[jnp.ndarray, np.ndarray]:
    """Dynamic time warping between feature sequences.

    Either pass ``x`` ``[N, D]`` and ``y`` ``[M, D]`` (pairwise cost computed
    with ``metric``: "euclidean" or "cosine"), or a precomputed ``cost``
    ``[N, M]``. Returns ``(acc, path)``: the accumulated cost matrix (device
    array, ``acc[-1, -1]`` is the alignment cost) and the optimal path as a
    host int array ``[L, 2]`` of (i, j) pairs from (0, 0) to (N-1, M-1) —
    the backtrace is inherently sequential/ragged, so it runs on host over
    the one int8 step array the device produced.
    """
    if cost is None:
        if x is None or y is None:
            raise ValueError("pass either (x, y) or cost=")
        x = jnp.asarray(x)
        y = jnp.asarray(y)
        if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
            raise ValueError(f"x [N, D] and y [M, D] required, got {x.shape}, {y.shape}")
        if metric == "euclidean":
            d2 = (
                (x * x).sum(-1)[:, None]
                + (y * y).sum(-1)[None, :]
                - 2.0 * x @ y.T
            )
            cost = jnp.sqrt(jnp.maximum(d2, 0.0))
        elif metric == "cosine":
            xn = x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
            yn = y / jnp.maximum(jnp.linalg.norm(y, axis=-1, keepdims=True), 1e-12)
            # clamp: f32 rounding can push |cos| past 1, going (slightly)
            # negative — a distance must not reward the aligner for length
            cost = jnp.maximum(1.0 - xn @ yn.T, 0.0)
        else:
            raise ValueError(f"unknown metric {metric!r}")
    cost = jnp.asarray(cost)
    if cost.ndim != 2:
        raise ValueError(f"cost must be [N, M], got {cost.shape}")
    acc, steps = jax.jit(_dtw_cost)(cost)
    steps_h = np.asarray(steps)
    n, m = steps_h.shape
    i, j = n - 1, m - 1
    path = [(i, j)]
    while i > 0 or j > 0:
        s = steps_h[i, j]
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        elif s == 0:
            i, j = i - 1, j - 1
        elif s == 1:
            i -= 1
        else:
            j -= 1
        path.append((i, j))
    return acc, np.asarray(path[::-1], dtype=np.int64)
