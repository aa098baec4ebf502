"""Rhythm analysis: onset strength/detection, tempogram, tempo, beat tracking.

The reference app has no rhythm analysis (its only envelope follower is the
VAD energy, vad.rs:157-176); this family extends the framework's per-frame
descriptor set (ops/features.py) with the standard onset/tempo/beat stack
(Ellis 2007 dynamic-programming beat tracker; librosa-style conventions so
the outputs are comparable to the common tooling).

Formulations:

* onset strength is a rectified log-spectral difference — one fused
  elementwise pass over a mel spectrogram;
* peak picking is shifted-slice sliding max/mean (static windows, fused)
  plus one O(T) ``lax.scan`` for the sequential "wait" constraint, batched
  over lanes;
* the tempogram is framed autocorrelation (``autocorrelate``'s impl
  ladder: shifted sums for few lags, the rFFT correlation otherwise);
* the beat tracker is the Ellis DP as a ``lax.scan`` over frames whose
  carry is a fixed window of cumulative scores (static window = the slowest
  trackable period), then a reverse scan for the backtrace — beats come out
  as a fixed-shape boolean mask, not a ragged index list, so the whole
  pipeline stays jittable.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp

from .framing import frame


def onset_strength(
    mel_power: jnp.ndarray, lag: int = 1, eps: float = 1e-10
) -> jnp.ndarray:
    """Spectral-flux onset envelope ``[..., T]`` from a mel power
    spectrogram ``[..., T, M]``: per-band rectified dB increase over ``lag``
    frames, averaged across bands. The first ``lag`` frames are 0 (nothing
    to difference against — the librosa padding convention)."""
    if lag < 1:
        raise ValueError(f"lag must be >= 1, got {lag}")
    s_db = 10.0 * jnp.log10(jnp.maximum(mel_power, eps))
    d = jnp.maximum(s_db[..., lag:, :] - s_db[..., :-lag, :], 0.0).mean(axis=-1)
    pads = [(0, 0)] * (d.ndim - 1) + [(lag, 0)]
    return jnp.pad(d, pads)


def _sliding_extremum(x: jnp.ndarray, pre: int, post: int, fill: float) -> jnp.ndarray:
    """max over the window ``x[t-pre : t+post+1]`` for every t, out-of-range
    positions reading ``fill`` — an unrolled max over pre+post+1 shifted
    slices (static, small), which XLA fuses into one pass."""
    t = x.shape[-1]
    pads = [(0, 0)] * (x.ndim - 1) + [(pre, post)]
    xp = jnp.pad(x, pads, constant_values=fill)
    out = xp[..., 0:t]
    for k in range(1, pre + post + 1):
        out = jnp.maximum(out, xp[..., k : k + t])
    return out


def _sliding_mean(x: jnp.ndarray, pre: int, post: int) -> jnp.ndarray:
    """mean over ``x[t-pre : t+post+1]`` clipped to the valid range (edge
    windows average fewer samples, not padding values) — two cumsums."""
    t = x.shape[-1]
    c = jnp.cumsum(x, axis=-1)
    pads = [(0, 0)] * (x.ndim - 1) + [(1, 0)]
    c = jnp.pad(c, pads)  # c[k] = sum of x[:k]
    idx = jnp.arange(t)
    hi = jnp.minimum(idx + post + 1, t)
    lo = jnp.maximum(idx - pre, 0)
    return (c[..., hi] - c[..., lo]) / (hi - lo).astype(x.dtype)


def peak_pick(
    env: jnp.ndarray,
    pre_max: int = 3,
    post_max: int = 3,
    pre_avg: int = 10,
    post_avg: int = 10,
    delta: float = 0.07,
    wait: int = 3,
) -> jnp.ndarray:
    """Boolean onset mask ``[..., T]`` over an onset envelope.

    A frame is an onset iff (1) it is the maximum of
    ``env[t-pre_max : t+post_max+1]``, (2) it exceeds the mean of
    ``env[t-pre_avg : t+post_avg+1]`` by ``delta`` (edge windows clip to
    the valid range), and (3) at least ``wait`` frames passed since the
    previously *accepted* onset (the one sequential condition — an O(T)
    scan with an integer carry, batched over lanes)."""
    is_max = env >= _sliding_extremum(env, pre_max, post_max, -jnp.inf)
    over_avg = env >= _sliding_mean(env, pre_avg, post_avg) + delta
    cand = jnp.logical_and(is_max, over_avg)
    cand_t = jnp.moveaxis(cand, -1, 0)  # [T, ...]

    def body(since, c):
        ok = jnp.logical_and(c, since >= wait)
        since = jnp.where(ok, 0, since + 1)
        return since, ok

    init = jnp.full(cand_t.shape[1:], wait, dtype=jnp.int32)
    _, picked = jax.lax.scan(body, init, cand_t)
    return jnp.moveaxis(picked, 0, -1)


def autocorrelate(
    x: jnp.ndarray,
    max_lag: int | None = None,
    impl: str = "auto",
    precision: str | None = None,
) -> jnp.ndarray:
    """Linear (non-circular) autocorrelation along the last axis, truncated
    to ``max_lag + 1`` lags.

    Three implementations; ``"auto"`` picks by problem shape:

    * ``"direct"`` — max_lag+1 shifted elementwise mul-sums, O(n * lags).
      The right form when few lags are needed (LPC orders): no transform,
      no bank, shards trivially. Auto when ``max_lag <= 64``.
    * ``"matmul"`` — real cos|sin DFT banks at the minimal no-wraparound
      length, O(n^2) in the transform length; it shards without the GSPMD
      all-gather the FFT op forces. On an H100 (400 W limit) it took 13.8
      ms against the FFT's 3.64 ms over [64, 384, 4096] frames at 384 lags.
    * ``"fft"`` — the zero-padded rFFT power-spectrum route; auto above 64
      lags.

    ``precision`` follows ops/pitch.py::ACF_PRECISION_DEFAULT.
    """
    from .pitch import ACF_PRECISION_DEFAULT, _resolve_acf_impl
    from ._mm import mm

    n = x.shape[-1]
    if max_lag is None:
        max_lag = n - 1
    if impl == "auto":
        impl = "direct" if max_lag <= 64 else "fft"
    if impl == "direct":
        out = [(x * x).sum(axis=-1, keepdims=True)]
        for lag in range(1, max_lag + 1):
            out.append((x[..., :-lag] * x[..., lag:]).sum(axis=-1, keepdims=True))
        return jnp.concatenate(out, axis=-1)
    if _resolve_acf_impl(impl) == "matmul":
        fwd, inv = _auto_acf_banks(n, max_lag)
        p = precision or ACF_PRECISION_DEFAULT
        k_count = fwd.shape[1] // 2
        spec = mm(x, jnp.asarray(fwd), p)  # [..., 2K] (Re | Im)
        power = spec[..., :k_count] ** 2 + spec[..., k_count:] ** 2
        return mm(power, jnp.asarray(inv), p)
    nfft = 1
    while nfft < n + max_lag + 1:
        nfft *= 2
    f = jnp.fft.rfft(x, n=nfft, axis=-1)
    ac = jnp.fft.irfft(jnp.real(f) ** 2 + jnp.imag(f) ** 2, n=nfft, axis=-1)
    return ac[..., : max_lag + 1]


@lru_cache(maxsize=16)
def _auto_acf_banks(n_in: int, max_lag: int) -> tuple[np.ndarray, np.ndarray]:
    """Autocorrelation packing of ops/pitch.py::_dft_corr_parts (the shared
    bank builder): forward real DFT [n_in, 2K] at the minimal even no-wrap
    length n >= n_in + max_lag (sin sign-free — only the power spectrum is
    consumed), inverse = the Hermitian-weighted irfft cos of the power
    [K, T+1]."""
    from .pitch import _dft_corr_parts, min_even_length

    n = min_even_length(n_in + max_lag)
    cosb, sinb, icos, _ = _dft_corr_parts(n_in, n, max_lag)
    return np.concatenate([cosb, sinb], axis=1), icos


def tempogram(
    env: jnp.ndarray, win_length: int = 384, window: str = "hann"
) -> jnp.ndarray:
    """Local autocorrelation tempogram ``[..., T, win_length]``: hop-1
    centered frames of the onset envelope, windowed, autocorrelated, and
    max-normalized per frame (lag axis last; lag 0 normalizes to 1)."""
    from .windows import get_window

    half = win_length // 2
    pads = [(0, 0)] * (env.ndim - 1) + [(half, half)]
    ep = jnp.pad(env, pads)
    fr = frame(ep, win_length, 1)[..., : env.shape[-1], :]  # [..., T, W]
    w = get_window(window, win_length)
    ac = autocorrelate(fr * w, max_lag=win_length - 1)
    return ac / jnp.maximum(ac[..., :1], 1e-10)


def tempo_frequencies(n_lags: int, sample_rate: float, hop: int) -> np.ndarray:
    """BPM corresponding to each autocorrelation lag (host-side; lag 0 maps
    to +inf, suppressed by the prior)."""
    lags = np.arange(n_lags, dtype=np.float64)
    with np.errstate(divide="ignore"):
        return 60.0 * sample_rate / (hop * lags)


def tempo(
    env: jnp.ndarray,
    sample_rate: float,
    hop: int,
    start_bpm: float = 120.0,
    std_bpm: float = 1.0,
    max_tempo: float = 320.0,
    ac_size: float = 8.0,
) -> jnp.ndarray:
    """Global tempo estimate in BPM, shape ``env.shape[:-1]``.

    Autocorrelate the onset envelope out to ``ac_size`` seconds of lag,
    weight by a log-normal prior over BPM centered at ``start_bpm`` (width
    ``std_bpm`` octaves), zero out lags faster than ``max_tempo``, and take
    the best lag."""
    max_lag = min(int(round(ac_size * sample_rate / hop)), env.shape[-1] - 1)
    ac = autocorrelate(env, max_lag=max_lag)
    bpms = tempo_frequencies(max_lag + 1, sample_rate, hop)
    with np.errstate(divide="ignore"):
        prior = np.exp(-0.5 * ((np.log2(bpms) - np.log2(start_bpm)) / std_bpm) ** 2)
    prior[0] = 0.0
    prior[bpms > max_tempo] = 0.0
    best = jnp.argmax(ac * jnp.asarray(prior.astype(np.float32)), axis=-1)
    lut = bpms.copy()
    lut[0] = start_bpm  # all-zero envelope -> argmax 0 -> sane fallback
    return jnp.asarray(lut.astype(np.float32))[best]


@lru_cache(maxsize=16)
def make_online_beat_plan(
    sample_rate: float,
    hop: int,
    start_bpm: float = 120.0,
    std_bpm: float = 1.0,
    max_tempo: float = 320.0,
    max_lag: int = 256,
    ac_seconds: float = 8.0,
    pre: int = 3,
    post: int = 3,
    delta: float = 0.07,
    warmup_seconds: float = 2.0,
) -> "OnlineBeatPlan":
    """Static plan for the causal tracker: the lag prior (the same
    log-normal BPM prior as :func:`tempo`), the exponential-forgetting
    factor sized so the running autocorrelation window matches the offline
    tracker's ``ac_size`` seconds, and the peak/warmup knobs."""
    fr = sample_rate / hop  # envelope frame rate
    bpms = tempo_frequencies(max_lag + 1, sample_rate, hop)
    with np.errstate(divide="ignore"):
        prior = np.exp(-0.5 * ((np.log2(bpms) - np.log2(start_bpm)) / std_bpm) ** 2)
    prior[0] = 0.0
    prior[bpms > max_tempo] = 0.0
    rho = float(np.exp(-1.0 / (ac_seconds * fr)))
    start_period = float(60.0 * fr / start_bpm)
    return OnlineBeatPlan(
        frame_rate=float(fr),
        max_lag=max_lag,
        prior=prior.astype(np.float32),
        rho=rho,
        pre=pre,
        post=post,
        delta=delta,
        warmup=int(round(warmup_seconds * fr)),
        start_period=start_period,
    )


@dataclass(frozen=True, eq=False)
class OnlineBeatPlan:
    frame_rate: float
    max_lag: int
    prior: np.ndarray = field(repr=False)
    rho: float
    pre: int
    post: int
    delta: float
    warmup: int
    start_period: float

    @property
    def latency(self) -> int:
        """Decision lookahead in envelope frames (= the streaming latency)."""
        return self.post


def online_beat_init(plan: OnlineBeatPlan, lead_shape=(), dtype=jnp.float32) -> dict:
    """Zero streaming state (== the offline start-of-signal state)."""
    return {
        "ring": jnp.zeros((*lead_shape, plan.max_lag + 1), dtype),
        "acf": jnp.zeros((*lead_shape, plan.max_lag + 1), dtype),
        "peak": jnp.zeros((*lead_shape, plan.pre + plan.post + 1), dtype),
        "emean": jnp.zeros(lead_shape, dtype),
        "since": jnp.full(lead_shape, 1 << 20, jnp.int32),
        "period": jnp.full(lead_shape, plan.start_period, dtype),
    }


def online_beat_step(
    plan: OnlineBeatPlan,
    carry: dict,
    env_chunk: jnp.ndarray,
    first_index: int | jnp.ndarray = 0,
) -> tuple[dict, tuple[jnp.ndarray, jnp.ndarray]]:
    """Causal chunk step: onset envelope ``[..., F]`` -> ``(carry,
    (beat [..., F] bool, bpm [..., F]))``.

    Emission at chunk frame ``j`` refers to envelope frame ``j - post``
    (the ``plan.latency``-frame lookahead of the peak test); streamed
    output == the offline :func:`online_beat_track` shifted by exactly
    that whole-unit latency, the framework streaming invariant. The
    offline position of chunk frame ``j`` is ``j - first_index`` (the
    graph-layer ``wants_first_index`` convention) — it gates warmup so a
    zeroed upstream preroll is a state fixpoint and never counts toward
    the warmup clock.
    """
    prior = jnp.asarray(plan.prior)
    rho = env_chunk.dtype.type(plan.rho)
    pos0 = -first_index  # offline position of chunk frame 0
    env_t = jnp.moveaxis(env_chunk, -1, 0)  # [F, ...]

    def body(c, inp):
        e, pos = inp
        ring = jnp.concatenate([e[..., None], c["ring"][..., :-1]], axis=-1)
        acf = rho * c["acf"] + e[..., None] * ring
        score = acf * prior
        best = score.max(axis=-1)
        lag = score.argmax(axis=-1).astype(env_chunk.dtype)
        period = jnp.where(best > 0.0, lag, c["period"])
        peak = jnp.concatenate([e[..., None], c["peak"][..., :-1]], axis=-1)
        cand = peak[..., plan.post]
        is_peak = jnp.logical_and(
            cand >= peak.max(axis=-1), cand > c["emean"] + plan.delta
        )
        emean = 0.95 * c["emean"] + 0.05 * e
        since = jnp.minimum(c["since"] + 1, 1 << 20)
        sincef = since.astype(env_chunk.dtype)
        dec_pos = pos - plan.post  # offline frame this step decides about
        live = dec_pos >= plan.warmup
        beat = jnp.logical_and(is_peak, sincef >= 0.72 * period)
        forced = jnp.logical_and(sincef >= 1.6 * period, best > 0.0)
        beat = jnp.logical_and(jnp.logical_or(beat, forced), live)
        since = jnp.where(beat, 0, since)
        bpm = 60.0 * plan.frame_rate / jnp.maximum(period, 1.0)
        new = {
            "ring": ring, "acf": acf, "peak": peak, "emean": emean,
            "since": since, "period": period,
        }
        return new, (beat, bpm)

    pos = pos0 + jnp.arange(env_t.shape[0], dtype=jnp.int32)
    carry, (beat_t, bpm_t) = jax.lax.scan(body, carry, (env_t, pos))
    return carry, (jnp.moveaxis(beat_t, 0, -1), jnp.moveaxis(bpm_t, 0, -1))


def online_beat_track(
    env: jnp.ndarray,
    sample_rate: float,
    hop: int,
    **plan_kwargs,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Causal/streaming beat tracker (the online counterpart of the
    whole-signal Ellis DP :func:`beat_track`).

    One O(T * max_lag) ``lax.scan`` over envelope frames, batched over
    lanes; the carry is a running exponentially-forgotten autocorrelation
    (the "running tempogram" — same lag prior as :func:`tempo`), a
    ``pre+post+1``-frame peak window, and a predict/correct beat clock:
    a beat fires at a local envelope peak once >= 0.72 of the current
    period has elapsed, or is forced at 1.6 periods (the causal analog of
    the DP's gap penalty). Decisions lag ``post`` frames (the only
    lookahead — the declared streaming latency); the first
    ``warmup_seconds`` emit no beats while the autocorrelation fills.

    Returns ``(beat_mask [..., T] bool, bpm_track [..., T])`` aligned to
    the envelope (the trailing ``post`` frames are undecided = False).
    Agreement with the offline DP on steady-tempo material is tested in
    tests/test_music.py (F-measure + tempo match).
    """
    plan = make_online_beat_plan(sample_rate, hop, **plan_kwargs)
    carry = online_beat_init(plan, env.shape[:-1], env.dtype)
    _, (beat, bpm) = online_beat_step(plan, carry, env)
    if plan.post:
        # emission j decides frame j - post: shift left into alignment
        beat = jnp.concatenate(
            [beat[..., plan.post:], jnp.zeros_like(beat[..., :plan.post])], axis=-1
        )
        bpm = jnp.concatenate(
            [bpm[..., plan.post:], bpm[..., -1:] * jnp.ones_like(bpm[..., :plan.post])],
            axis=-1,
        )
    return beat, bpm


def beat_track(
    env: jnp.ndarray,
    sample_rate: float,
    hop: int,
    bpm: jnp.ndarray | float | None = None,
    tightness: float = 100.0,
    max_period: int = 256,
    start_bpm: float = 120.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Ellis (2007) dynamic-programming beat tracker.

    Returns ``(beat_mask [..., T] bool, bpm [...])``. ``bpm`` may be given
    (static or traced, per-lane) or is estimated with :func:`tempo`. The
    target beat period in frames is ``p = 60*sr/(hop*bpm)``; the DP rewards
    onset energy at beats and penalizes inter-beat gaps ``g`` by
    ``-tightness * ln(g/p)^2`` over the search window ``g in [p/2, 2p]``.

    The recurrence ``score[t] = local[t] + max(0, max_g score[t-g] + cost)``
    is a ``lax.scan`` whose carry is the last ``2*max_period`` scores
    (static window; the traced period only *masks* it, so one compiled
    program serves any tempo up to ``60*sr/(hop*max_period/2)`` BPM slow).
    The backtrace is a reverse scan over the recorded backlinks, emitting a
    fixed-shape boolean mask. Gaussian-smoothed ``local`` score as in the
    original (sigma = period/32)."""
    t_frames = env.shape[-1]
    if bpm is None:
        bpm = tempo(env, sample_rate, hop, start_bpm=start_bpm)
    bpm = jnp.asarray(bpm, jnp.float32)
    period = 60.0 * sample_rate / (hop * bpm)  # traced, frames
    period = jnp.clip(period, 1.0, max_period)

    # local score: gaussian blur of the envelope. Static kernel sized for
    # max_period; the traced sigma = period/32 enters through the weights.
    kh = int(max_period) // 16  # covers sigma up to max_period/32 at 2 sigma
    k = jnp.arange(-kh, kh + 1, dtype=jnp.float32)
    sigma = period[..., None] / 32.0
    kern = jnp.exp(-0.5 * (k / jnp.maximum(sigma, 1e-3)) ** 2)
    kern = kern / kern.sum(axis=-1, keepdims=True)
    pads = [(0, 0)] * (env.ndim - 1) + [(kh, kh)]
    ep = jnp.pad(env, pads)
    win = frame(ep, 2 * kh + 1, 1)[..., :t_frames, :]  # [..., T, K]
    local = (win * kern[..., None, :]).sum(axis=-1)

    w = 2 * int(max_period)
    gaps = jnp.arange(w, 0, -1, dtype=jnp.float32)  # carry[j] is t - gaps[j]
    valid = jnp.logical_and(
        gaps[..., :] >= (period[..., None] / 2.0), gaps <= 2.0 * period[..., None]
    )
    cost = -tightness * jnp.log(gaps / period[..., None]) ** 2
    cost = jnp.where(valid, cost, -jnp.inf)  # [..., W]

    local_t = jnp.moveaxis(local, -1, 0)  # [T, ...]
    neg = jnp.float32(-jnp.inf)

    def body(carry, lt):
        # carry: [..., W] cumulative scores for frames t-W .. t-1
        prev = carry + cost
        best = prev.max(axis=-1)
        arg = prev.argmax(axis=-1)
        score = lt + jnp.maximum(best, 0.0)
        has_pred = best > 0.0
        backgap = jnp.where(has_pred, w - arg, 0).astype(jnp.int32)  # 0 = first beat
        carry = jnp.concatenate([carry[..., 1:], score[..., None]], axis=-1)
        return carry, (score, backgap)

    init = jnp.full((*env.shape[:-1], w), neg)
    _, (scores_t, backgap_t) = jax.lax.scan(body, init, local_t)
    scores = jnp.moveaxis(scores_t, 0, -1)  # [..., T]
    backgaps = jnp.moveaxis(backgap_t, 0, -1)

    last = jnp.argmax(scores, axis=-1)  # best-scoring final beat

    # reverse scan: walk the backlinks from `last`, marking beats
    idx_t = jnp.arange(t_frames - 1, -1, -1)  # scan visits T-1 .. 0
    bg_rev = jnp.moveaxis(backgaps, -1, 0)[::-1]  # aligned with idx_t

    def back(carry, inp):
        nxt = carry  # index of the next beat to mark (or -1: done)
        t_i, bg = inp
        mark = t_i == nxt
        gap = bg  # 0 means this was a chain head
        nxt = jnp.where(mark, jnp.where(gap > 0, t_i - gap, -1), nxt)
        return nxt, mark

    _, marks_rev = jax.lax.scan(back, last, (idx_t, bg_rev))
    mask = jnp.moveaxis(marks_rev[::-1], 0, -1)
    return mask, bpm
