"""Time-based effects: feedback delay/echo, tremolo, vibrato, chorus, flanger.

The reference app has no effects engine; this family covers the classic
delay-line effects on the framework's substrate. Formulations:

* the feedback comb ``w[n] = x[n-D] + g*w[n-D]`` has no dependency shorter
  than D samples, so it runs as a ``lax.scan`` over D-sample blocks — each
  step one fused multiply-add on a [.., D] block (the biquad blocked-
  recurrence idea with block size = the delay itself). Arbitrary chunk
  lengths are exact: the tail block is computed on zero-padding and the
  streaming carry is cut from the true positions.
* LFO-modulated delays (vibrato/chorus/flanger) are one batched gather with
  linear interpolation — the modulation depth is bounded, so the read
  window is a static left-pad and the whole effect is gather + lerp + mix,
  no recurrence at all. Phases take an absolute sample offset ``t0`` so
  streaming chunks reproduce the offline LFO exactly (the graph nodes wire
  ``first_index`` into it).

All effects are causal with bounded history -> exact streaming with O(D)
carries; serial float64 oracles live in tests/test_effects.py.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "feedback_delay",
    "tremolo",
    "vibrato",
    "chorus",
    "flanger",
]


def feedback_delay(
    x: jnp.ndarray,
    delay_samples: int,
    feedback: float = 0.4,
    mix: float = 0.5,
    carry: tuple[jnp.ndarray, jnp.ndarray] | None = None,
) -> tuple[jnp.ndarray, tuple[jnp.ndarray, jnp.ndarray]]:
    """Echo: ``y = x + mix * w`` with ``w[n] = x[n-D] + g * w[n-D]``.

    ``carry = (x_tail, w_tail)`` holds the last D samples of input and wet
    line (zeros = silence prehistory, the offline convention). Returns
    ``(y, carry')`` — chunk length is arbitrary and streamed == offline
    exactly. |feedback| must be < 1 (the comb is unstable otherwise).
    """
    d = int(delay_samples)
    if d < 1:
        raise ValueError(f"delay_samples must be >= 1, got {d}")
    if not -1.0 < feedback < 1.0:
        raise ValueError(f"|feedback| must be < 1, got {feedback}")
    x = jnp.asarray(x)
    t = x.shape[-1]
    lead = x.shape[:-1]
    if carry is None:
        carry = (
            jnp.zeros((*lead, d), x.dtype),
            jnp.zeros((*lead, d), x.dtype),
        )
    x_tail, w_tail = carry
    k = -(-t // d)  # blocks covering the chunk
    pad = k * d - t
    # xs[i] is x at offline offset i - d relative to the chunk start
    xs = jnp.concatenate(
        [x_tail, jnp.pad(x, [(0, 0)] * len(lead) + [(0, pad)])], axis=-1
    )
    x_blocks = jnp.moveaxis(
        xs[..., : k * d].reshape(*lead, k, d), -2, 0
    )  # [K, ..., D]

    def body(w_prev, x_del):
        w = x_del + feedback * w_prev
        return w, w

    _, w_blocks = jax.lax.scan(body, w_tail, x_blocks)
    w = jnp.moveaxis(w_blocks, 0, -2).reshape(*lead, k * d)[..., :t]
    y = x + mix * w
    # carries read the true last-D positions (pad region never enters them:
    # with pad > 0 the tail spans the last real samples of x and w)
    full_x = jnp.concatenate([x_tail, x], axis=-1)
    full_w = jnp.concatenate([w_tail, w], axis=-1)
    return y, (full_x[..., -d:], full_w[..., -d:])


def _lfo_delay_samples(
    pos: jnp.ndarray, sample_rate: float, rate_hz: float,
    base_s: float, depth_s: float, phase: float,
) -> jnp.ndarray:
    lfo = 0.5 * (1.0 + jnp.sin(2.0 * np.pi * rate_hz * pos / sample_rate + phase))
    return (base_s + depth_s * lfo) * sample_rate


def _modulated_tap(
    x: jnp.ndarray, sample_rate: float, rate_hz: float, base_s: float,
    depth_s: float, phase: float, t0, history: jnp.ndarray | None,
) -> jnp.ndarray:
    """One modulated fractional-delay read ``tap[n] = x[n - d(n)]`` (linear
    interpolation). ``history`` is the last Dmax samples of the previous
    chunk (zeros offline); ``t0`` is the absolute offset of sample 0."""
    t = x.shape[-1]
    lead = x.shape[:-1]
    dmax = int(np.ceil((base_s + depth_s) * sample_rate)) + 1
    if history is None:
        history = jnp.zeros((*lead, dmax), x.dtype)
    elif history.shape[-1] != dmax:
        raise ValueError(
            f"history must be the last {dmax} samples, got {history.shape[-1]}"
        )
    xp = jnp.concatenate([history, x], axis=-1)  # index n + dmax == x[n]
    pos = jnp.arange(t) + t0
    d = _lfo_delay_samples(pos, sample_rate, rate_hz, base_s, depth_s, phase)
    idx = jnp.arange(t) + dmax - d  # read position in xp, fractional
    lo = jnp.clip(jnp.floor(idx).astype(jnp.int32), 0, xp.shape[-1] - 1)
    hi = jnp.clip(lo + 1, 0, xp.shape[-1] - 1)
    frac = (idx - lo.astype(idx.dtype)).astype(x.dtype)
    x_lo = jnp.take(xp, lo, axis=-1)
    x_hi = jnp.take(xp, hi, axis=-1)
    return x_lo * (1.0 - frac) + x_hi * frac


def tremolo(
    x: jnp.ndarray,
    sample_rate: float,
    rate_hz: float = 5.0,
    depth: float = 0.5,
    phase: float = 0.0,
    t0=0,
) -> jnp.ndarray:
    """Amplitude LFO: ``y = x * (1 - depth/2 * (1 + sin(2 pi f t + phase)))``
    — gain sweeps [1 - depth, 1]. ``t0`` is the absolute sample offset of
    ``x[0]`` (streaming chunks pass their position; 0 offline)."""
    if not 0.0 <= depth <= 1.0:
        raise ValueError(f"depth must be in [0, 1], got {depth}")
    pos = (jnp.arange(x.shape[-1]) + t0).astype(jnp.float32)
    gain = 1.0 - 0.5 * depth * (
        1.0 + jnp.sin(2.0 * np.pi * rate_hz * pos / sample_rate + phase)
    )
    return x * gain


def vibrato(
    x: jnp.ndarray,
    sample_rate: float,
    rate_hz: float = 5.0,
    depth_s: float = 0.002,
    phase: float = 0.0,
    t0=0,
    history: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Pitch LFO: read ``x[n - d(n)]`` with ``d`` sweeping [0, depth_s] —
    periodic resampling that bends pitch up/down around unison."""
    return _modulated_tap(x, sample_rate, rate_hz, 0.0, depth_s, phase, t0, history)


def chorus(
    x: jnp.ndarray,
    sample_rate: float,
    rate_hz: float = 0.8,
    depth_s: float = 0.003,
    base_delay_s: float = 0.02,
    voices: int = 3,
    mix: float = 0.5,
    t0=0,
    history: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Ensemble effect: ``voices`` modulated taps at phase offsets
    ``2 pi k / voices`` around a ~20 ms base delay, averaged and mixed:
    ``y = (1 - mix) x + mix * mean(taps)``."""
    if voices < 1:
        raise ValueError(f"voices must be >= 1, got {voices}")
    taps = [
        _modulated_tap(
            x, sample_rate, rate_hz, base_delay_s, depth_s,
            2.0 * np.pi * k / voices, t0, history,
        )
        for k in range(voices)
    ]
    wet = sum(taps) / voices
    return (1.0 - mix) * x + mix * wet


def flanger(
    x: jnp.ndarray,
    sample_rate: float,
    rate_hz: float = 0.25,
    depth_s: float = 0.002,
    base_delay_s: float = 0.001,
    mix: float = 0.5,
    t0=0,
    history: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Swept comb: one short modulated tap mixed with the dry signal
    (``y = (1 - mix) x + mix * x[n - d(n)]``, d sweeping ~1-3 ms). Shipped
    feedback-free (the feedback variant's sub-millisecond recurrence has no
    blocked form; the documented convention)."""
    tap = _modulated_tap(
        x, sample_rate, rate_hz, base_delay_s, depth_s, 0.0, t0, history
    )
    return (1.0 - mix) * x + mix * tap
