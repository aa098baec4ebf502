"""Phase-vocoder time-stretch and pitch-shift (north-star config 4).

The per-output-frame phase increments (expected advance + wrapped
deviation) are computed in parallel and combined with one ``cumsum``, so the
path is gather + elementwise + cumsum + ISTFT with static shapes (the
stretch ``rate`` is a trace-time constant). An equivalent trig-free *phasor*
formulation exists — ``exp(i*increment) == s_hi*conj(s_lo)/(|s_hi||s_lo|)``
with a cumulative complex product (see :func:`increment_phasors`); under
XLA its extra complex intermediates cost more memory passes than the
atan2/sincos they save, so the angle form is the one shipped.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .resample import resample
from .stft import istft, stft


def _wrap_phase(p: jnp.ndarray) -> jnp.ndarray:
    """Wrap to [-pi, pi)."""
    two_pi = 2.0 * np.pi
    return p - two_pi * jnp.round(p / two_pi)


def increment_phasors(
    s_lo: jnp.ndarray, s_hi: jnp.ndarray, m_lo: jnp.ndarray, m_hi: jnp.ndarray
) -> jnp.ndarray:
    """Unit phasor of the per-step phase increment between two analysis
    frames: ``exp(i*(angle(s_hi)-angle(s_lo)))`` without any trig (the
    expected advance and the wrap both cancel inside exp). Zero-magnitude
    frames contribute a unit phasor (the angle(0)==0 convention). Exposed
    for tests/oracles."""
    denom = m_hi * m_lo
    ok = denom > 0
    return jnp.where(ok, s_hi * jnp.conj(s_lo) / jnp.where(ok, denom, 1.0), 1.0 + 0.0j)


def cumulative_phasor(u: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Inclusive cumulative product of unit phasors along ``axis``."""
    return jax.lax.associative_scan(jnp.multiply, u, axis=axis % u.ndim)


def phase_vocoder(spec: jnp.ndarray, rate: float, hop: int, n_fft: int) -> jnp.ndarray:
    """Stretch a complex spectrogram ``[..., T, F]`` in time by ``1/rate``.

    rate > 1 speeds up (fewer output frames); rate < 1 slows down.
    """
    t_in = spec.shape[-2]
    steps = np.arange(0, t_in, rate)  # fractional analysis positions
    lo = np.minimum(steps.astype(np.int64), t_in - 1)
    hi = np.minimum(lo + 1, t_in - 1)
    frac = jnp.asarray((steps - lo).astype(np.float32))[..., None]

    s_lo = spec[..., lo, :]
    s_hi = spec[..., hi, :]
    mag = (1.0 - frac) * jnp.abs(s_lo) + frac * jnp.abs(s_hi)

    # expected per-hop phase advance of each bin
    n_bins = spec.shape[-1]
    phi_adv = jnp.asarray(
        (2.0 * np.pi * hop / n_fft) * np.arange(n_bins, dtype=np.float32)
    )
    dphase = _wrap_phase(jnp.angle(s_hi) - jnp.angle(s_lo) - phi_adv)
    increments = phi_adv + dphase  # [..., T_out, F]

    phase0 = jnp.angle(s_lo[..., :1, :])
    phase = phase0 + jnp.concatenate(
        [jnp.zeros_like(increments[..., :1, :]), jnp.cumsum(increments[..., :-1, :], axis=-2)],
        axis=-2,
    )
    return mag * jnp.exp(1j * phase)


_IMPLS = ("matmul", "fft")


def time_stretch(
    x: jnp.ndarray,
    rate: float,
    n_fft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    impl: str = "matmul",
    precision: str | None = None,
) -> jnp.ndarray:
    """Stretch audio duration by 1/rate at constant pitch (ISTFT round-trip).

    ``impl`` picks the DFT of the round trip: ``"matmul"`` (default; DFT
    banks as matrix products, sharding-clean) or ``"fft"`` (XLA's FFT).
    ``precision`` overrides the matmul precision of the DFT banks only
    (None = the stft module default, see ops/_mm.py).
    """
    if rate <= 0:
        raise ValueError("rate must be positive")
    if impl not in _IMPLS:
        raise ValueError(f"unknown time_stretch impl {impl!r}; known: {', '.join(_IMPLS)}")
    spec = stft(x, n_fft=n_fft, hop=hop, window=window, impl=impl, precision=precision)
    out = phase_vocoder(spec, rate, hop, n_fft)
    length = int(round(x.shape[-1] / rate))
    return istft(
        out, n_fft=n_fft, hop=hop, window=window, length=length, impl=impl, precision=precision
    )


def pitch_shift(
    x: jnp.ndarray,
    semitones: float,
    sample_rate: int = 16000,
    n_fft: int = 1024,
    hop: int = 256,
    resample_mode: str = "kaiser",
) -> jnp.ndarray:
    """Shift pitch by ``semitones`` at constant duration: stretch then resample.

    The resample step reuses the polyphase-matmul kernel with a small
    rational approximation of 2^(semitones/12) (denominator <= 64, pitch
    error < 1 cent): only the RATIO matters to the resampler, and a
    numerator like ``int(sample_rate * factor)`` is usually coprime with the
    sample rate, which would explode the polyphase bank to ``sample_rate``
    phases (a multi-minute host-side plan build at 16 kHz).
    """
    from fractions import Fraction

    factor = 2.0 ** (semitones / 12.0)
    stretched = time_stretch(x, rate=1.0 / factor, n_fft=n_fft, hop=hop)
    # resample stretched (duration *factor) back to original length
    fr = Fraction(factor).limit_denominator(64)
    y = resample(stretched, fr.numerator, fr.denominator, mode=resample_mode)
    t = x.shape[-1]
    if y.shape[-1] < t:
        pads = [(0, 0)] * (y.ndim - 1) + [(0, t - y.shape[-1])]
        y = jnp.pad(y, pads)
    return y[..., :t]
