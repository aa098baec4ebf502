"""Mel filterbank, log-mel features, and DCT/MFCC.

The filterbank matrix is built host-side in float64 and baked into the graph
as an ``[n_freqs, n_mels]`` constant, so the mel projection is a single
``[frames, freqs] @ [freqs, mels]`` matmul (``preferred_element_type=float32`` keeps the accumulation in f32 even under
bf16 inputs). Supports HTK and Slaney mel scales and Slaney area
normalization, matching the conventions of librosa/torchaudio so outputs are
oracle-checkable.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ._mm import mm


def hz_to_mel(f, htk: bool = False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log above
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = f >= min_log_hz
    mels = np.where(above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def mel_to_hz(m, htk: bool = False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(
    n_freqs: int,
    n_mels: int = 128,
    sample_rate: int = 16000,
    f_min: float = 0.0,
    f_max: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape ``[n_freqs, n_mels]`` (matmul-ready)."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    n_fft = 2 * (n_freqs - 1)
    fft_freqs = np.arange(n_freqs, dtype=np.float64) * sample_rate / n_fft
    mel_pts = np.linspace(hz_to_mel(f_min, htk), hz_to_mel(f_max, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)

    # vectorized triangle construction
    lower = hz_pts[:-2][None, :]  # [1, n_mels]
    center = hz_pts[1:-1][None, :]
    upper = hz_pts[2:][None, :]
    f = fft_freqs[:, None]  # [n_freqs, 1]
    up = (f - lower) / np.maximum(center - lower, 1e-10)
    down = (upper - f) / np.maximum(upper - center, 1e-10)
    fb = np.maximum(0.0, np.minimum(up, down))

    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
        fb *= enorm[None, :]
    elif norm not in (None, "none"):
        raise ValueError(f"unknown mel norm {norm!r}")
    return fb.astype(dtype)


def apply_mel(spec_power: jnp.ndarray, fb: jnp.ndarray) -> jnp.ndarray:
    """Project a power/magnitude spectrogram ``[..., frames, freqs]`` onto mel bins.

    One matmul; f32 accumulation regardless of input dtype.
    """
    return mm(spec_power, jnp.asarray(fb))


def log_mel(
    spec_power: jnp.ndarray,
    fb: jnp.ndarray,
    floor: float = 1e-10,
    log_base: str = "ln",
) -> jnp.ndarray:
    """log(max(mel, floor)) — 'ln' (natural), 'log10', or 'db' (10*log10)."""
    m = jnp.maximum(apply_mel(spec_power, fb), floor)
    if log_base == "ln":
        return jnp.log(m)
    if log_base == "log10":
        return jnp.log10(m)
    if log_base == "db":
        return 10.0 * jnp.log10(m)
    raise ValueError(f"unknown log_base {log_base!r}")


def log_mel_fused(
    x: jnp.ndarray,
    fb: np.ndarray,
    n_fft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    win_length: int | None = None,
    center: bool = False,
    floor: float = 1e-10,
    log_base: str = "ln",
    dft_precision: str | None = None,
    fb_precision: str = "highest",
) -> jnp.ndarray:
    """Log-mel features as exactly two zero-pad-waste dots.

    The combined cos|sin DFT bank (ops/stft.py::_combined_banks) produces
    ``y = [re 0..N/2 | im 1..N/2-1]`` packed into n_fft lanes; because
    ``mel = fb.T @ (re^2 + im^2)``, stacking ``[fb ; fb[1:n_fft//2]]`` row-
    wise makes ``mel = (y*y) @ fb_stacked`` — the re/im unpack (the
    513-boundary pad/slice that breaks XLA's power->mel fusion) never
    happens; log-mel max|delta| vs the two-stage path is 1e-5 at the same
    precisions. Requires even n_fft (callers fall back).
    """
    if n_fft % 2:
        raise ValueError("log_mel_fused requires even n_fft")
    from .framing import frame as _frame
    from .stft import DFT_PRECISION_DEFAULT, _combined_banks

    if center:
        widths = [(0, 0)] * (x.ndim - 1) + [(n_fft // 2, n_fft // 2)]
        x = jnp.pad(x, widths, mode="reflect")
    fr = _frame(x, n_fft, hop)
    cb = jnp.asarray(_combined_banks(n_fft, window, win_length))
    y = mm(fr, cb, dft_precision or DFT_PRECISION_DEFAULT)
    fb64 = np.asarray(fb, np.float64)
    fbc = np.concatenate([fb64, fb64[1 : n_fft // 2]], axis=0).astype(np.float32)
    m = jnp.maximum(mm(y * y, jnp.asarray(fbc), fb_precision), floor)
    if log_base == "ln":
        return jnp.log(m)
    if log_base == "log10":
        return jnp.log10(m)
    if log_base == "db":
        return 10.0 * jnp.log10(m)
    if log_base in (None, "none"):
        return m
    raise ValueError(f"unknown log_base {log_base!r}")


def dct_matrix(n_in: int, n_out: int, norm: str | None = "ortho", dtype=np.float32) -> np.ndarray:
    """DCT-II basis ``[n_in, n_out]`` for MFCC as a matmul."""
    k = np.arange(n_out, dtype=np.float64)[None, :]
    n = np.arange(n_in, dtype=np.float64)[:, None]
    basis = 2.0 * np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * n_in))
    if norm == "ortho":
        basis[:, 0] *= 1.0 / np.sqrt(4.0 * n_in)
        basis[:, 1:] *= 1.0 / np.sqrt(2.0 * n_in)
    return basis.astype(dtype)


def mfcc(log_mels: jnp.ndarray, n_mfcc: int = 13) -> jnp.ndarray:
    """MFCC from log-mel features: one more matmul (DCT-II, ortho)."""
    d = dct_matrix(log_mels.shape[-1], n_mfcc)
    return mm(log_mels, jnp.asarray(d))


# ---------------------------------------------------------------------------
# Feature inversion: mel/MFCC back to spectrogram and audio.
#
# The reference app is analysis-only; inversion completes the feature story
# (a mel/MFCC pipeline user can hear what their features preserve).
# Formulation: the NNLS mel->spectrogram solve is Lee-Seung multiplicative
# updates — a fixed-count fori_loop whose body is two matmuls and one
# elementwise ratio (no data-dependent control flow); audio then comes from
# griffin_lim (itself matmul-DFT projections).
# ---------------------------------------------------------------------------


def mel_to_stft(
    m: jnp.ndarray,
    fb: np.ndarray,
    n_iter: int = 32,
    precision: str | None = "high",
    eps: float = 1e-10,
) -> jnp.ndarray:
    """Nonnegative least-squares inverse of :func:`apply_mel`.

    Recovers a power spectrogram ``s`` ``[..., F, n_freqs]`` with
    ``s @ fb ~ m`` and ``s >= 0`` by ``n_iter`` multiplicative updates
    ``s <- s * (m @ fb.T) / (s @ fb @ fb.T)`` from the adjoint init
    ``s0 = m @ fb.T`` (scale self-corrects — the update is ratio-based).
    ``precision`` defaults to 'high' (ops/_mm.py): unlike griffin_lim's
    magnitude replacement, the NNLS *fixpoint itself* shifts with dot
    rounding — a single bf16 pass lands ~6e-3 off in mel space where three
    passes stay near 1e-4 (gated by the mel_nnls_rel validate row; 4.3e-4
    on an H100); pass "default" to trade that for speed.
    """
    import jax

    fb = np.asarray(fb, np.float64)
    fbt = jnp.asarray(fb.T.astype(np.float32))
    fbj = jnp.asarray(fb.astype(np.float32))
    m = jnp.maximum(jnp.asarray(m), 0.0)
    target = mm(m, fbt, precision)  # [..., F, n_freqs], constant across iters
    s0 = target

    def body(_, s):
        denom = mm(mm(s, fbj, precision), fbt, precision)
        return s * target / jnp.maximum(denom, eps)

    return jax.lax.fori_loop(0, n_iter, body, s0)


def mfcc_to_log_mel(coeffs: jnp.ndarray, n_mels: int = 128) -> jnp.ndarray:
    """Inverse of :func:`mfcc` (orthonormal DCT-II columns: the adjoint is
    the pseudo-inverse): ``[..., n_mfcc]`` -> ``[..., n_mels]``. Exact on the
    retained coefficients; the discarded ones are irrecoverably smoothed."""
    d = dct_matrix(n_mels, coeffs.shape[-1])
    return mm(coeffs, jnp.asarray(d.T))


def mel_to_audio(
    m: jnp.ndarray,
    fb: np.ndarray,
    n_fft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    center: bool = True,
    length: int | None = None,
    nnls_iter: int = 32,
    gl_iter: int = 32,
    power: float = 2.0,
) -> jnp.ndarray:
    """Mel (power, ``power=2.0``, or magnitude, ``power=1.0``) spectrogram
    ``[..., F, n_mels]`` -> waveform: NNLS inversion to the linear
    spectrogram, then Griffin-Lim phase reconstruction."""
    s = mel_to_stft(m, fb, n_iter=nnls_iter)
    mag = jnp.sqrt(jnp.maximum(s, 0.0)) if power == 2.0 else jnp.maximum(s, 0.0)
    from .griffinlim import griffin_lim

    return griffin_lim(mag, n_fft, hop, window=window, n_iter=gl_iter,
                       center=center, length=length)


def mfcc_to_audio(
    coeffs: jnp.ndarray,
    fb: np.ndarray,
    n_fft: int = 1024,
    hop: int = 256,
    log_base: str = "ln",
    **kwargs,
) -> jnp.ndarray:
    """MFCC ``[..., F, n_mfcc]`` -> waveform via inverse DCT, exp (undoing
    :func:`log_mel` at ``log_base``), and :func:`mel_to_audio`."""
    lm = mfcc_to_log_mel(coeffs, n_mels=np.asarray(fb).shape[-1])
    if log_base == "ln":
        m = jnp.exp(lm)
    elif log_base == "log10":
        m = jnp.power(10.0, lm)
    elif log_base == "db":
        m = jnp.power(10.0, lm / 10.0)
    else:
        raise ValueError(f"unknown log_base {log_base!r}")
    return mel_to_audio(m, fb, n_fft, hop, **kwargs)
