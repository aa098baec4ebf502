"""Gain, normalization, limiter, and channel ops.

All ops are elementwise/reduction work that XLA fuses into neighbors.
The limiter's envelope follower — an inherently sequential recurrence — is
recast as an associative max-plus scan in the log domain (O(log T) depth on
the device instead of a length-T serial loop); see :func:`envelope_peak_release`.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def gain_db(x: jnp.ndarray, db: float | jnp.ndarray) -> jnp.ndarray:
    return x * (10.0 ** (jnp.asarray(db, x.dtype) / 20.0))


def to_mono(x: jnp.ndarray, channels: int) -> jnp.ndarray:
    """Average interleaved channels, parity with AudioFrame::to_mono
    (reference: src-tauri/src/modules/audio/capture.rs:30-42)."""
    if channels == 1:
        return x
    t = x.shape[-1] // channels * channels
    return x[..., :t].reshape(*x.shape[:-1], -1, channels).mean(axis=-1)


def peak_normalize(x: jnp.ndarray, target_peak: float = 1.0, eps: float = 1e-9) -> jnp.ndarray:
    peak = jnp.max(jnp.abs(x), axis=-1, keepdims=True)
    return x * (target_peak / jnp.maximum(peak, eps))


def rms_normalize(x: jnp.ndarray, target_db: float = -20.0, eps: float = 1e-12) -> jnp.ndarray:
    """Scale so RMS (true root-mean-square) hits ``target_db`` dBFS."""
    rms = jnp.sqrt(jnp.mean(x * x, axis=-1, keepdims=True) + eps)
    target = 10.0 ** (target_db / 20.0)
    return x * (target / jnp.maximum(rms, eps))


def mean_square_energy(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Reference 'RMS' energy: mean of squares, *no sqrt*
    (reference: src-tauri/src/modules/audio/vad.rs:157-168)."""
    return jnp.mean(x * x, axis=axis)


def energy_to_dbfs(energy: jnp.ndarray) -> jnp.ndarray:
    """20*log10(mean-square), -inf for <= 0 (vad.rs:171-176 parity)."""
    return jnp.where(energy > 0.0, 20.0 * jnp.log10(jnp.maximum(energy, 1e-38)), -jnp.inf)


#: samples per block of :func:`log_envelope_from_rest`: the ramp it adds
#: stays below ``ENV_BLOCK * |log r|`` (5.1 for a 50 ms release at 16 kHz),
#: where float32 keeps ~1e-6 of absolute precision
ENV_BLOCK = 4096
_LOG_FLOOR = float(np.log(1e-30))


def log_envelope_from_rest(labs: jnp.ndarray, log_r: float, block: int = ENV_BLOCK) -> jnp.ndarray:
    """``log e[n]`` of the peak-release envelope from rest, given
    ``labs = log|x|`` along the last axis and ``log_r = log(release_coeff)``.

    ``e[n] = max_k |x[k]| r^(n-k)`` is a running max of ``log|x[k]| -
    k log r`` — an associative cummax. That ramp grows with the length, and
    in float32 its rounding (1/128 at ramp 72000, one hour at 16 kHz with a
    50 ms release) lands on the envelope. So the cummax runs within blocks
    of ``block`` samples, and the blocks' end values are composed by a
    max-plus doubling scan over the block axis, ``E[b] = max(E[b], E[b-s] +
    s block log r)`` for s = 1, 2, 4, ..., whose terms that can win carry a
    decay of at most ~70 nats. (An ``associative_scan`` of the same pairs
    runs as fast on an H100 but compiles 2-4x slower.)
    """
    t = labs.shape[-1]
    ax = labs.ndim - 1
    if t <= block:
        ramp = jnp.arange(t, dtype=labs.dtype) * (-log_r)
        return jax.lax.cummax(labs + ramp, axis=ax) - ramp
    nb = -(-t // block)
    lead = labs.shape[:-1]
    lp = jnp.pad(labs, [(0, 0)] * ax + [(0, nb * block - t)], constant_values=_LOG_FLOOR)
    lb = lp.reshape(*lead, nb, block)
    ramp = jnp.arange(block, dtype=labs.dtype) * (-log_r)
    le0 = jax.lax.cummax(lb + ramp, axis=ax + 1) - ramp  # each block from rest
    ends = le0[..., -1]
    shift = 1
    while shift < nb:
        prev = jnp.pad(ends[..., :-shift], [(0, 0)] * ax + [(shift, 0)], constant_values=-1e30)
        ends = jnp.maximum(ends, prev + shift * block * log_r)
        shift *= 2
    # envelope entering block b: block b-1's end, decaying through block b
    e_in = jnp.concatenate([jnp.full((*lead, 1), _LOG_FLOOR, labs.dtype), ends[..., :-1]], ax)
    steps = jnp.arange(1, block + 1, dtype=labs.dtype) * log_r
    le = jnp.maximum(le0, e_in[..., None] + steps)
    return le.reshape(*lead, nb * block)[..., :t]


def envelope_peak_release(x_abs: jnp.ndarray, release_coeff: float) -> jnp.ndarray:
    """Instant-attack / exponential-release peak envelope.

    Serial form: ``e[n] = max(|x[n]|, r * e[n-1])``, computed in log space
    by :func:`log_envelope_from_rest` (associative, so XLA parallelizes it).
    """
    if not (0.0 < release_coeff < 1.0):
        raise ValueError("release_coeff must be in (0, 1)")
    labs = jnp.log(jnp.maximum(x_abs, 1e-30))
    return jnp.exp(log_envelope_from_rest(labs, float(np.log(release_coeff))))


def limiter(
    x: jnp.ndarray,
    threshold_db: float = -1.0,
    release_ms: float = 50.0,
    sample_rate: int = 16000,
) -> jnp.ndarray:
    """Hard peak limiter: gain = min(1, T/envelope), envelope as above."""
    thresh = 10.0 ** (threshold_db / 20.0)
    r = float(np.exp(-1.0 / (release_ms * 1e-3 * sample_rate)))
    env = envelope_peak_release(jnp.abs(x), r)
    g = jnp.minimum(1.0, thresh / jnp.maximum(env, 1e-30))
    return x * g


def compressor_gain(
    env: jnp.ndarray, threshold_db: float, ratio: float, knee_db: float = 0.0
) -> jnp.ndarray:
    """Linear gain for a peak envelope under a downward compressor curve
    (hard or quadratic soft knee). Shared by the offline op and the
    streaming node so the two can never diverge."""
    level_db = 20.0 * jnp.log10(jnp.maximum(env, 1e-30))
    over = level_db - threshold_db
    if knee_db > 0.0:
        soft = jnp.square(jnp.clip(over + knee_db / 2, 0.0, knee_db)) / (2.0 * knee_db)
        over = jnp.where(over > knee_db / 2, over, soft)
    else:
        over = jnp.maximum(over, 0.0)
    gain_reduction_db = over * (1.0 / ratio - 1.0)
    return 10.0 ** (gain_reduction_db / 20.0)


def compressor(
    x: jnp.ndarray,
    threshold_db: float = -20.0,
    ratio: float = 4.0,
    release_ms: float = 100.0,
    sample_rate: int = 16000,
    knee_db: float = 0.0,
) -> jnp.ndarray:
    """Downward compressor with the same associative envelope follower."""
    r = float(np.exp(-1.0 / (release_ms * 1e-3 * sample_rate)))
    env = envelope_peak_release(jnp.abs(x), r)
    return x * compressor_gain(env, threshold_db, ratio, knee_db)


def noise_gate(
    x: jnp.ndarray,
    threshold_db: float = -60.0,
    release_ms: float = 100.0,
    sample_rate: int = 16000,
    floor_db: float = -80.0,
) -> jnp.ndarray:
    """Downward expander/gate: attenuate by ``floor_db`` below threshold.

    Gate decisions follow the same instant-attack/exponential-release peak
    envelope as the limiter/compressor, so brief inter-word gaps shorter
    than the release stay open (no chatter) — the level-domain sibling of
    the VAD-gated egress (graph.VadGate / vad.rs:97-154)."""
    r = float(np.exp(-1.0 / (release_ms * 1e-3 * sample_rate)))
    env = envelope_peak_release(jnp.abs(x), r)
    return x * gate_gain(env, threshold_db, floor_db)


def gate_gain(env: jnp.ndarray, threshold_db: float, floor_db: float = -80.0) -> jnp.ndarray:
    """Linear gain for a peak envelope under a hard noise gate."""
    thresh = 10.0 ** (threshold_db / 20.0)
    floor = 10.0 ** (floor_db / 20.0)
    return jnp.where(env >= thresh, 1.0, floor)


def agc(
    x: jnp.ndarray,
    target_db: float = -20.0,
    block: int = 1024,
    max_gain_db: float = 30.0,
    up_db_per_s: float = 6.0,
    down_db_per_s: float = 60.0,
    sample_rate: int = 16000,
    floor_db: float = -55.0,
    gain0: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Automatic gain control (slow leveler): track block RMS toward
    ``target_db`` with asymmetric slew limits (fast down to duck sudden
    loudness, slow up so pauses don't pump the noise floor).

    The gain recurrence is nonlinear (clip of a log-domain error), so it
    runs as a control-rate ``lax.scan`` — one step per ``block`` samples
    (64 Hz at the defaults), negligible serial cost. Blocks whose level is
    below ``floor_db`` hold the gain (silence must not trigger gain-up).
    Within a block the gain ramps linearly in dB to the new value (no
    zipper noise). Returns ``(y, final_gain_db)``; ``gain0`` (dB, shape
    ``lead``) is the streaming carry. Trailing samples beyond the last
    full block pass at the final gain.
    """
    if block < 1:
        raise ValueError("block must be >= 1")
    lead = x.shape[:-1]
    t = x.shape[-1]
    n_blk = t // block
    g0 = jnp.zeros(lead, x.dtype) if gain0 is None else jnp.asarray(gain0, x.dtype)
    up = up_db_per_s * block / sample_rate
    down = down_db_per_s * block / sample_rate

    if n_blk == 0:
        return x * 10.0 ** (g0[..., None] / 20.0), g0

    blocks = jnp.moveaxis(
        x[..., : n_blk * block].reshape(*lead, n_blk, block), -2, 0
    )  # [n_blk, ..., block]

    def step(g, xb):
        rms_db = 10.0 * jnp.log10(jnp.mean(xb * xb, axis=-1) + 1e-12)
        err = target_db - (rms_db + g)  # dB still needed after current gain
        delta = jnp.clip(err, -down, up)
        g_new = jnp.clip(g + delta, 0.0 - max_gain_db, max_gain_db)
        g_new = jnp.where(rms_db > floor_db, g_new, g)  # hold on silence
        # linear-in-dB ramp from g to g_new across the block
        ramp = (jnp.arange(1, block + 1, dtype=xb.dtype) / block)[
            (None,) * (xb.ndim - 1) + (slice(None),)
        ]
        gains_db = g[..., None] + (g_new - g)[..., None] * ramp
        return g_new, xb * 10.0 ** (gains_db / 20.0)

    g_end, ys = jax.lax.scan(step, g0, blocks)
    y = jnp.moveaxis(ys, 0, -2).reshape(*lead, n_blk * block)
    tail = t - n_blk * block
    if tail:
        y = jnp.concatenate([y, x[..., n_blk * block :] * 10.0 ** (g_end[..., None] / 20.0)], axis=-1)
    return y, g_end


def preemphasis(x: jnp.ndarray, coeff: float = 0.97) -> jnp.ndarray:
    """First-order high-pass FIR y[n] = x[n] - coeff*x[n-1] (ASR-standard).

    Kaldi convention: y[0] = x[0] - coeff*x[0]. Pure elementwise+shift — XLA
    fuses it into neighbors.
    """
    prev = jnp.concatenate([x[..., :1], x[..., :-1]], axis=-1)
    return x - coeff * prev


def cmvn(feats: jnp.ndarray, norm_var: bool = False, eps: float = 1e-8) -> jnp.ndarray:
    """Cepstral mean (and optional variance) normalization over the time axis.

    feats [..., T, F]; per-utterance statistics (offline whole-signal op).
    """
    mean = feats.mean(axis=-2, keepdims=True)
    out = feats - mean
    if norm_var:
        var = feats.var(axis=-2, keepdims=True)
        out = out / jnp.sqrt(var + eps)
    return out


def deemphasis(x: jnp.ndarray, coeff: float = 0.97) -> jnp.ndarray:
    """One-pole inverse of :func:`preemphasis`: y[n] = x[n] + coeff*y[n-1].

    Runs through the blocked state-space IIR engine (ops/biquad.py) — no
    per-sample loop. Round-trip note: preemphasis' Kaldi edge convention
    (y[0] = (1-k)x[0]) is not exactly invertible at the first sample; the
    deviation decays as coeff^n (tests pin it).
    """
    from .biquad import Biquad, biquad_chain

    y, _ = biquad_chain(x, (Biquad(1.0, 0.0, 0.0, -float(coeff), 0.0),))
    return y


def trim_silence(
    x: jnp.ndarray,
    top_db: float = 60.0,
    frame_length: int = 2048,
    hop: int = 512,
) -> tuple[jnp.ndarray, tuple[int, int]]:
    """Trim leading/trailing silence from a 1-D signal.

    A frame is silent when its RMS is more than ``top_db`` below the
    signal's peak RMS. Returns ``(x[start:end], (start, end))`` in samples.
    The output length is data-dependent, so the boundary decision runs on
    host over one device-computed [frames] energy vector (utility
    semantics, not a jittable graph node — the documented convention).
    """
    mask = np.asarray(_nonsilent_mask(x, top_db, frame_length, hop))
    t = x.shape[-1]
    if not mask.any():
        return x[..., :0], (0, 0)
    idx = np.where(mask)[0]
    start = int(idx[0]) * hop
    end = min(int(idx[-1]) * hop + frame_length, t)
    return x[..., start:end], (start, end)


def split_silence(
    x: jnp.ndarray,
    top_db: float = 60.0,
    frame_length: int = 2048,
    hop: int = 512,
) -> list[tuple[int, int]]:
    """Sample intervals of non-silent runs (same criterion as
    :func:`trim_silence`); host-side boundary extraction."""
    mask = np.asarray(_nonsilent_mask(x, top_db, frame_length, hop))
    t = x.shape[-1]
    out: list[tuple[int, int]] = []
    start = None
    for i, m in enumerate(mask):
        if m and start is None:
            start = i
        elif not m and start is not None:
            out.append((start * hop, min(i * hop + frame_length, t)))
            start = None
    if start is not None:
        out.append((start * hop, t))
    return out


def _nonsilent_mask(
    x: jnp.ndarray, top_db: float, frame_length: int, hop: int
) -> jnp.ndarray:
    """Per-frame bool: within top_db of the peak frame RMS (device-side)."""
    from .framing import frame as _frame

    if x.ndim != 1:
        raise ValueError(f"trim/split operate on 1-D signals, got {x.shape}")
    if x.shape[-1] < frame_length:
        pad = frame_length - x.shape[-1]
        x = jnp.pad(x, (0, pad))
    fr = _frame(x, frame_length, hop)
    rms_db = 10.0 * jnp.log10(jnp.maximum((fr * fr).mean(axis=-1), 1e-20))
    return rms_db > rms_db.max() - top_db
