"""ITU-R BS.1770-4 loudness: K-weighting, gated LUFS, LRA, true peak.

Production loudness measurement/normalization (EBU R128 workflow) built on
the framework's own primitives: K-weighting is two biquads through the
blocked state-space engine (ops/biquad.py), block energies are one framed
mean-square (matmul-friendly reductions), gating is masked means (static
shapes, data-dependent masks — jit-clean), and true peak rides the
polyphase resampler. Mono lanes ``[..., T]``; multichannel content should be
downmixed upstream or measured per lane and combined with the channel
weights by the caller.

The reference app has no loudness metering; this extends the framework's
dynamics family (SURVEY §2.2 maps gain/normalize; the north star's
"gain/normalize" stage) with the broadcast-standard meter. Formulas follow
ITU-R BS.1770-4 / EBU TECH 3342; the parameterized K-weighting filter
design reproduces the spec's 48 kHz coefficient tables at any sample rate.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from .biquad import Biquad, biquad_chain
from .framing import frame, num_frames

#: absolute gating threshold (LKFS), BS.1770-4 §4.7.1
ABS_GATE_LUFS = -70.0
#: the spec's calibration offset: -0.691 makes a 997 Hz 0 dBFS sine read
#: -3.01 LKFS (it cancels the K-weighting shelf's gain at 997 Hz)
_OFFSET = -0.691


def k_weighting(sample_rate: float) -> tuple[Biquad, Biquad]:
    """K-weighting prefilter pair (high shelf + RLB high-pass).

    Parameterized continuous-time design mapped through the bilinear
    transform at ``sample_rate``; at 48 kHz this reproduces the BS.1770-4
    Table 1/2 coefficients to ~1e-6 (the tables are themselves rounded).
    """
    # stage 1: +4 dB high shelf (head effects)
    f0, g_db, q = 1681.974450955533, 3.999843853973347, 0.7071752369554196
    k = math.tan(math.pi * f0 / sample_rate)
    vh = 10.0 ** (g_db / 20.0)
    vb = vh ** 0.4996667741545416
    a0 = 1.0 + k / q + k * k
    shelf = Biquad(
        (vh + vb * k / q + k * k) / a0,
        2.0 * (k * k - vh) / a0,
        (vh - vb * k / q + k * k) / a0,
        2.0 * (k * k - 1.0) / a0,
        (1.0 - k / q + k * k) / a0,
    )
    # stage 2: RLB high-pass (revised low-frequency B-curve)
    f0, q = 38.13547087602444, 0.5003270373238773
    k = math.tan(math.pi * f0 / sample_rate)
    a0 = 1.0 + k / q + k * k
    hp = Biquad(
        1.0,
        -2.0,
        1.0,
        2.0 * (k * k - 1.0) / a0,
        (1.0 - k / q + k * k) / a0,
    )
    return shelf, hp


def k_weight(x: jnp.ndarray, sample_rate: float) -> jnp.ndarray:
    """Apply the K-weighting prefilter to ``x [..., T]``."""
    y, _ = biquad_chain(x, k_weighting(sample_rate))
    return y


def _block_power(z: jnp.ndarray, sample_rate: float, window_s: float, step_s: float):
    """Mean-square power of K-weighted ``z`` over overlapping gating blocks.

    Returns ``[..., n_blocks]``; block i covers
    ``[i*step, i*step + window)`` samples (75% overlap at the spec's
    0.4 s / 0.1 s). Tail samples not filling a block are dropped (spec
    behavior: only complete blocks are gated).
    """
    win = int(round(window_s * sample_rate))
    hop = int(round(step_s * sample_rate))
    if z.shape[-1] < win:
        raise ValueError(
            f"signal too short for a {window_s} s gating block "
            f"({z.shape[-1]} < {win} samples)"
        )
    blocks = frame(z, win, hop)  # [..., n_blocks, win]
    return jnp.mean(blocks * blocks, axis=-1)


def _lufs(power: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    return _OFFSET + 10.0 * jnp.log10(jnp.maximum(power, eps))


def momentary_loudness(x: jnp.ndarray, sample_rate: float) -> jnp.ndarray:
    """Momentary loudness (400 ms blocks, 100 ms step), LKFS ``[..., n]``."""
    return _lufs(_block_power(k_weight(x, sample_rate), sample_rate, 0.4, 0.1))


def shortterm_loudness(x: jnp.ndarray, sample_rate: float) -> jnp.ndarray:
    """Short-term loudness (3 s blocks, 100 ms step), LKFS ``[..., n]``."""
    return _lufs(_block_power(k_weight(x, sample_rate), sample_rate, 3.0, 0.1))


def integrated_loudness(x: jnp.ndarray, sample_rate: float) -> jnp.ndarray:
    """Gated integrated loudness (BS.1770-4 §4.7), LKFS per lane ``[...]``.

    Two-stage gating: blocks below -70 LKFS absolute are dropped; the mean
    power of the survivors sets a relative threshold 10 LU lower; the
    final loudness is the mean power of blocks above it. Implemented as
    masked means so the whole meter jits with static shapes.
    """
    p = _block_power(k_weight(x, sample_rate), sample_rate, 0.4, 0.1)
    l_blk = _lufs(p)
    m_abs = l_blk > ABS_GATE_LUFS
    n_abs = jnp.maximum(m_abs.sum(axis=-1), 1)
    p_abs = jnp.where(m_abs, p, 0.0).sum(axis=-1) / n_abs
    rel_thresh = _lufs(p_abs) - 10.0
    m_rel = m_abs & (l_blk > rel_thresh[..., None])
    n_rel = jnp.maximum(m_rel.sum(axis=-1), 1)
    p_rel = jnp.where(m_rel, p, 0.0).sum(axis=-1) / n_rel
    # all-gated (silence): report -inf-ish floor rather than the eps floor
    silent = m_rel.sum(axis=-1) == 0
    return jnp.where(silent, -jnp.inf, _lufs(p_rel))


def _masked_percentile(v: jnp.ndarray, mask: jnp.ndarray, q: float) -> jnp.ndarray:
    """Percentile of ``v`` where ``mask`` (same shape), lower-value gather
    semantics on the sorted survivor prefix; jit-clean static shapes."""
    big = jnp.asarray(jnp.finfo(v.dtype).max, v.dtype)
    sv = jnp.sort(jnp.where(mask, v, big), axis=-1)
    n = mask.sum(axis=-1)
    idx = jnp.clip((q * (n - 1)).astype(jnp.int32), 0, v.shape[-1] - 1)
    return jnp.take_along_axis(sv, idx[..., None], axis=-1)[..., 0]


def loudness_range(x: jnp.ndarray, sample_rate: float) -> jnp.ndarray:
    """Loudness range LRA (EBU TECH 3342), LU per lane ``[...]``.

    Distribution of short-term loudness, gated at -70 LKFS absolute and
    -20 LU relative to the gated mean; LRA = p95 - p10 of the survivors.
    """
    p = _block_power(k_weight(x, sample_rate), sample_rate, 3.0, 0.1)
    l_blk = _lufs(p)
    m_abs = l_blk > ABS_GATE_LUFS
    n_abs = jnp.maximum(m_abs.sum(axis=-1), 1)
    p_abs = jnp.where(m_abs, p, 0.0).sum(axis=-1) / n_abs
    rel = _lufs(p_abs) - 20.0
    m = m_abs & (l_blk > rel[..., None])
    hi = _masked_percentile(l_blk, m, 0.95)
    lo = _masked_percentile(l_blk, m, 0.10)
    out = hi - lo
    return jnp.where(m.sum(axis=-1) == 0, 0.0, out)


def true_peak(x: jnp.ndarray, sample_rate: float, oversample: int = 4) -> jnp.ndarray:
    """True-peak level, dBTP per lane ``[...]`` (BS.1770-4 Annex 2).

    Inter-sample peaks estimated by polyphase upsampling (the framework's
    kaiser-sinc resampler) at ``oversample``x — the spec's method, with a
    longer/cleaner interpolation filter than the spec's minimal 48-tap
    example. ``oversample=1`` degenerates to sample peak.
    """
    if oversample > 1:
        from .resample import resample

        up = resample(x, int(sample_rate), int(sample_rate) * oversample)
        peak = jnp.max(jnp.abs(up), axis=-1)
        # inter-sample estimate can only raise the peak
        peak = jnp.maximum(peak, jnp.max(jnp.abs(x), axis=-1))
    else:
        peak = jnp.max(jnp.abs(x), axis=-1)
    return 20.0 * jnp.log10(jnp.maximum(peak, 1e-12))


def normalize_loudness(
    x: jnp.ndarray,
    sample_rate: float,
    target_lufs: float = -23.0,
    max_true_peak_db: float | None = -1.0,
    oversample: int = 4,
) -> jnp.ndarray:
    """Scale each lane to ``target_lufs`` integrated loudness (EBU R128).

    A pure gain (no dynamics processing, the standard loudness-normalize
    operation). If ``max_true_peak_db`` is set, the gain is capped so the
    normalized true peak stays at/below it (the R128 -1 dBTP ceiling).
    Silent lanes (integrated loudness fully gated) pass through unscaled.
    """
    l_int = integrated_loudness(x, sample_rate)
    gain_db = target_lufs - l_int
    if max_true_peak_db is not None:
        tp = true_peak(x, sample_rate, oversample)
        gain_db = jnp.minimum(gain_db, max_true_peak_db - tp)
    gain = jnp.where(jnp.isfinite(gain_db), 10.0 ** (gain_db / 20.0), 1.0)
    return x * gain[..., None]


def gating_block_count(n_samples: int, sample_rate: float, window_s: float = 0.4, step_s: float = 0.1) -> int:
    """Number of complete gating blocks a signal yields (host-side helper)."""
    return num_frames(n_samples, int(round(window_s * sample_rate)), int(round(step_s * sample_rate)))
