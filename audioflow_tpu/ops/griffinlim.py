"""Griffin-Lim phase reconstruction (magnitude spectrogram -> waveform).

Fast Griffin-Lim (momentum-accelerated alternating projections): each
iteration is one ISTFT + one STFT — both matmul-DFT banks by default, so
the whole loop is a ``lax.fori_loop`` over batched matmuls with static
shapes (no data-dependent control flow; jit-clean, shard-clean on the batch
axis). Completes the spectral family: analysis (stft/spectrogram/mel),
modification (phase_vocoder), and now inversion from magnitude-only
features — what a user of a mel/magnitude pipeline needs to get audio back.

Convention follows librosa.griffinlim (momentum update of Perraudin et al.,
"A fast Griffin-Lim algorithm", WASPAA 2013) for oracle-checkability.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .stft import istft, stft


_IMPLS = ("matmul", "fft")


def griffin_lim(
    mag: jnp.ndarray,
    n_fft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    n_iter: int = 32,
    momentum: float = 0.99,
    center: bool = True,
    length: int | None = None,
    impl: str = "matmul",
    precision: str | None = "default",
    init_phase: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Reconstruct a waveform whose STFT magnitude approximates ``mag``.

    Args:
      mag: magnitude spectrogram ``[..., F, n_fft//2 + 1]`` (NOT power).
      n_iter: projection iterations; 32 is the librosa default.
      momentum: fast-GL acceleration in [0, 1); 0 = classic Griffin-Lim.
      length: output sample count (defaults to the istft natural length).
      impl: DFT implementation for the inner stft/istft: "matmul"
        (default; DFT banks as matrix products) or "fft" (XLA's FFT).
      precision: matmul precision of the DFT banks. Defaults to "default":
        the magnitude-replacement projection renormalizes every iteration,
        so dot rounding does not accumulate (gated by the
        ``griffinlim_tone_err`` validate row). Pass None for the stft
        module default ("high") or "highest" for full float32 banks.
      init_phase: optional initial phase angles (same shape as ``mag``);
        zeros by default — deterministic, and on typical audio converges
        comparably to random init without threading a PRNG key through.

    Returns:
      waveform ``[..., T]`` with T = ``length`` or the istft natural length.
    """
    if not 0.0 <= momentum < 1.0:
        raise ValueError(f"momentum must be in [0, 1), got {momentum}")
    if impl not in _IMPLS:
        raise ValueError(f"unknown griffin_lim impl {impl!r}; known: {', '.join(_IMPLS)}")
    mag = jnp.asarray(mag).astype(jnp.float32)
    if init_phase is None:
        spec = jax.lax.complex(mag, jnp.zeros_like(mag))
    else:
        p = jnp.asarray(init_phase, jnp.float32)
        spec = jax.lax.complex(mag * jnp.cos(p), mag * jnp.sin(p))

    def project(s):
        """istft -> stft round trip (projection onto consistent spectrograms)."""
        x = istft(s, n_fft, hop, window=window, center=center, impl=impl,
                  precision=precision)
        r = stft(x, n_fft, hop, window=window, center=center, impl=impl,
                 precision=precision)
        # stft of the istft can gain/lose a trailing frame when lengths
        # don't divide; clamp to the magnitude's frame count
        f = mag.shape[-2]
        if r.shape[-2] < f:
            pad = [(0, 0)] * (r.ndim - 2) + [(0, f - r.shape[-2]), (0, 0)]
            r = jnp.pad(r, pad)
        return r[..., :f, :]

    def body(_, carry):
        spec, prev = carry
        rebuilt = project(spec)
        # momentum extrapolation, then magnitude replacement
        accel = rebuilt + momentum * (rebuilt - prev)
        phase = accel / jnp.maximum(jnp.abs(accel), 1e-16)
        return mag * phase, rebuilt

    zeros = jax.lax.complex(jnp.zeros_like(mag), jnp.zeros_like(mag))
    spec, _ = jax.lax.fori_loop(0, n_iter, body, (spec, zeros))
    return istft(spec, n_fft, hop, window=window, center=center, length=length,
                 impl=impl, precision=precision)
