"""YIN fundamental-frequency estimation (de Cheveigné & Kawahara 2002).

Formulation: the difference function d(tau) over all frames at once via
one batched autocorrelation (d(tau) = e0 + e(tau) - 2*acf(tau), the
energies from a cumulative sum), cumulative-mean normalization as a cumsum
along the lag axis, and the trough search as masked argmax/argmin with
static shapes — no per-frame Python, the whole tracker is one jittable
expression. Conventions follow librosa.yin (win = frame//2, lag range from
fmin/fmax, trough threshold 0.1, parabolic interpolation) so results are
oracle-checkable; the serial float64 oracle lives in the tests.

The ACF itself has two implementations (``impl=``): ``"fft"`` (the rFFT
correlation trick) and ``"matmul"`` — real cos|sin DFT banks as matrix
products at the *minimal* no-wraparound transform length n = win +
max_lag. ``"auto"`` is :data:`ACF_IMPL_DEFAULT` on every platform.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp

from ._mm import mm
from .framing import frame

#: the ACF of ``impl="auto"``: on an H100 (400 W limit) YIN at its defaults
#: over 64 x 10 s at 16 kHz took 2.92 ms with the rFFT correlation and
#: 5.05 ms with the matmul banks (p99 f0 agreement 0.003 Hz)
ACF_IMPL_DEFAULT = "fft"
#: precision tier of the matmul banks (ops/_mm.py; ~1e-5 acf error)
ACF_PRECISION_DEFAULT = "high"

# Lag-axis scan unroll: the candidate scans carry [.., F, M] (and the
# histogram scan [.., F, n_bins]) through device memory once per scan step;
# unrolling fuses UNROLL steps into one XLA loop body so the carry
# round-trips once per UNROLL lags instead of per lag. Results identical per
# step (XLA may re-fuse across the unrolled chain: <= 1 ulp on voiced_prob).
_CAND_UNROLL = 8

#: half-width of the matmul histogram's deviation window (see the histogram
#: comment in _pyin_observations): host analysis proves |bin - base| <= 2
#: for the matmul-group lags in float64, +1 margin for device f32 rounding
#: at .5 boundaries
_BIN_SPLIT_D = 3


@lru_cache(maxsize=32)
def _pyin_bin_split(sample_rate, fmin, n_bins, nbps, l_grid, dmax):
    """Host split of the candidate-histogram lag grid: (l_star, base,
    s0ext). ``base[l]`` is the pitch bin of INTEGER lag l; ``l_star`` is
    the smallest lag index such that every lag >= l_star keeps its whole
    parabolic-refinement bin interval (endpoints lag -/+ 0.5, clipping
    included, float64) within ``dmax - 1`` of base — the -1 is the safety
    margin for device f32 rounding at .5 boundaries. ``s0ext`` is the
    one-hot lag->bin bank ``[l_grid - l_star, n_bins + 2*dmax]`` with
    ``s0ext[j, dmax + base[l_star + j]] = 1``."""
    ls = np.arange(l_grid, dtype=np.float64)

    def bin_of(f):
        return np.clip(
            np.round(12.0 * nbps * np.log2(np.maximum(f, 1e-9) / fmin)),
            0, n_bins - 1,
        ).astype(np.int64)

    base = bin_of(sample_rate / np.maximum(ls, 1.0))
    lo = bin_of(sample_rate / np.maximum(ls + 0.5, 1.0))
    hi = bin_of(sample_rate / np.maximum(ls - 0.5, 1.0))
    ok = (np.abs(lo - base) <= dmax - 1) & (np.abs(hi - base) <= dmax - 1)
    bad = np.nonzero(~ok)[0]
    l_star = int(bad.max()) + 1 if len(bad) else 0
    s0 = np.zeros((l_grid - l_star, n_bins + 2 * dmax), np.float32)
    if l_star < l_grid:
        s0[np.arange(l_grid - l_star), dmax + base[l_star:]] = 1.0
    return l_star, base.astype(np.int32), s0


@lru_cache(maxsize=32)
def _dft_corr_parts(
    n_rows: int, n: int, t_max: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Shared host-side pieces of every matmul correlation bank: forward
    cos/sin matrices [n_rows, K] at transform length ``n`` and the
    Hermitian-weighted truncated-irfft cos/sin [K, t_max + 1] (weights
    already folded). float64 design, f32 ship (f32-representable to ~1e-8;
    the dots run at the configured precision tier). Both the cross-
    correlation packing (this module) and the autocorrelation packing
    (ops/rhythm.py) build from these, so the minimal-even-length /
    Nyquist-weight logic lives exactly once."""
    k_count = n // 2 + 1
    j = np.arange(n_rows, dtype=np.float64)[:, None]
    k = np.arange(k_count, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * j * k / n
    cosb, sinb = np.cos(ang), np.sin(ang)
    tau = np.arange(t_max + 1, dtype=np.float64)[None, :]
    wk = np.full((k_count, 1), 2.0)
    wk[0, 0] = 1.0
    if n % 2 == 0:
        wk[-1, 0] = 1.0
    angi = 2.0 * np.pi * np.arange(k_count, dtype=np.float64)[:, None] * tau / n
    icos, isin = wk * np.cos(angi) / n, wk * np.sin(angi) / n
    return (cosb.astype(np.float32), sinb.astype(np.float32),
            icos.astype(np.float32), isin.astype(np.float32))


def min_even_length(m: int) -> int:
    """Minimal even no-wraparound transform length >= m."""
    return m + (m & 1)


@lru_cache(maxsize=16)
def _acf_banks(w: int, t_max: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Cross-correlation packing of :func:`_dft_corr_parts`: forward bank
    [w + t_max, 2K] -> (Re | Im) DFT, inverse bank [2K, t_max + 1] = the
    truncated irfft of a packed (Re | Im) product."""
    m = w + t_max
    n = min_even_length(m)
    cosb, sinb, icos, isin = _dft_corr_parts(m, n, t_max)
    fwd = np.concatenate([cosb, -sinb], axis=1)  # [m, 2K]
    inv = np.concatenate([icos, -isin], axis=0)  # [2K, T+1]
    return fwd, inv, n // 2 + 1


def _acf_fft(fr: jnp.ndarray, w: int, t_max: int) -> jnp.ndarray:
    """acf(tau) = sum_{j<w} x_j x_{j+tau} via zero-padded rFFT correlation."""
    n = 1 << (w + 2 * t_max).bit_length()
    spec_full = jnp.fft.rfft(fr, n=n, axis=-1)
    spec_win = jnp.fft.rfft(fr[..., :w], n=n, axis=-1)
    return jnp.fft.irfft(spec_full * jnp.conj(spec_win), n=n, axis=-1)[
        ..., : t_max + 1
    ]


def _acf_matmul(
    fr: jnp.ndarray, w: int, t_max: int, precision: str | None
) -> jnp.ndarray:
    """Same correlation as :func:`_acf_fft`, as three matrix products."""
    fwd, inv, k_count = _acf_banks(w, t_max)
    p = precision or ACF_PRECISION_DEFAULT
    f_spec = mm(fr, jnp.asarray(fwd), p)  # [..., 2K] (Re | Im)
    w_spec = mm(fr[..., :w], jnp.asarray(fwd[:w]), p)
    re_f, im_f = f_spec[..., :k_count], f_spec[..., k_count:]
    re_w, im_w = w_spec[..., :k_count], w_spec[..., k_count:]
    # F * conj(W), packed (Re | Im) to feed one inverse dot
    prod = jnp.concatenate(
        [re_f * re_w + im_f * im_w, im_f * re_w - re_f * im_w], axis=-1
    )
    return mm(prod, jnp.asarray(inv), p)


_VITERBI_IMPLS = ("auto", "xla")


def _check_viterbi_impl(impl: str) -> None:
    """The banded Viterbi runs as one ``lax.scan``; "auto" and "xla" both
    name it."""
    if impl not in _VITERBI_IMPLS:
        raise ValueError(
            f"unknown viterbi impl {impl!r}; known: {', '.join(_VITERBI_IMPLS)}"
        )


def _resolve_acf_impl(impl: str) -> str:
    if impl == "auto":
        return ACF_IMPL_DEFAULT
    if impl not in ("fft", "matmul"):
        raise ValueError(f"unknown acf impl {impl!r}; known: auto, fft, matmul")
    return impl


def _parabolic_refine(prev, cur, nxt):
    """Vertex offset in [-0.5, 0.5] of the parabola through three equally
    spaced samples (flat/degenerate curvature guarded to 0) — shared by the
    yin/pyin trough refinement and the piptrack peak refinement."""
    denom = prev - 2.0 * cur + nxt
    delta = jnp.where(
        jnp.abs(denom) > 1e-12,
        0.5 * (prev - nxt) / jnp.where(denom == 0, 1.0, denom),
        0.0,
    )
    return jnp.clip(delta, -0.5, 0.5)


def cmnd_frames(
    frames: jnp.ndarray,
    win: int | None = None,
    max_lag: int | None = None,
    impl: str = "auto",
    precision: str | None = None,
) -> jnp.ndarray:
    """Cumulative-mean-normalized difference d'(tau) for frames [..., F, L].

    Lags 0..T inclusive (T = ``max_lag`` or W = win or L//2); d'(0) = 1 by
    definition. The difference function d(tau) = sum_{j<W} (x_j - x_{j+tau})^2
    expands to e0 + e(tau) - 2*acf(tau); acf rides one batched correlation
    (``impl``: "auto"/"fft"/"matmul" — see the module docstring; ``precision``
    is the matmul form's tier, default ``ACF_PRECISION_DEFAULT``).
    Truncating to ``max_lag`` (the pitch search never looks past sr/fmin)
    shrinks the correlated frames to W + max_lag samples.
    """
    l = frames.shape[-1]
    w = win or l // 2
    t_max = w if max_lag is None else min(int(max_lag), w)
    if w + t_max > l:
        raise ValueError(
            f"win {w} + max_lag {t_max} needs frame_length >= {w + t_max}, got {l}"
        )
    frames = frames[..., : w + t_max]  # samples beyond W + max_lag never used
    if _resolve_acf_impl(impl) == "matmul":
        acf = _acf_matmul(frames, w, t_max, precision)
    else:
        acf = _acf_fft(frames, w, t_max)
    sq = frames * frames
    cs = jnp.cumsum(sq, axis=-1)
    zero = jnp.zeros_like(cs[..., :1])
    cs = jnp.concatenate([zero, cs], axis=-1)  # cs[k] = sum of first k squares
    e0 = cs[..., w : w + 1]
    # e(tau) = sum_{j=tau}^{tau+w-1} x_j^2, tau = 0..t_max
    e_tau = cs[..., w : w + t_max + 1] - cs[..., 0 : t_max + 1]
    # acf(0) over the full window == e0 by construction; d(0) == 0 exactly
    d = jnp.maximum(e0 + e_tau - 2.0 * acf, 0.0)
    # cumulative mean normalization: d'(tau) = d(tau) * tau / sum_{1..tau} d
    csd = jnp.cumsum(d[..., 1:], axis=-1)
    tau = jnp.arange(1, t_max + 1, dtype=frames.dtype)
    dn = jnp.where(csd > 0, d[..., 1:] * tau / jnp.maximum(csd, 1e-30), 1.0)
    return jnp.concatenate([jnp.ones_like(d[..., :1]), dn], axis=-1)


def yin_frames(
    frames: jnp.ndarray,
    sample_rate: float,
    fmin: float = 65.0,
    fmax: float = 2093.0,
    threshold: float = 0.1,
    win: int | None = None,
    impl: str = "auto",
    precision: str | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-frame (f0_hz, aperiodicity) from frames ``[..., F, L]``.

    Picks the first CMND trough below ``threshold`` within the lag range
    [sr/fmax, sr/fmin] (else the range's global minimum), refines the lag by
    parabolic interpolation, and reports the CMND value there as the
    aperiodicity (0 = perfectly periodic; > ~0.3 is effectively unvoiced —
    thresholding is left to the caller, librosa-style).
    """
    l = frames.shape[-1]
    w = win or l // 2
    tau_lo = max(int(np.floor(sample_rate / fmax)), 2)
    tau_hi = min(int(np.ceil(sample_rate / fmin)), w - 1)
    if tau_lo >= tau_hi:
        raise ValueError(
            f"empty lag range for fmin={fmin}, fmax={fmax} at sr={sample_rate} "
            f"(win={w}); need sr/fmax < sr/fmin within [2, win-1]"
        )
    # one lag past tau_hi so the trough test and parabolic refinement at the
    # range edge see a real neighbor
    dn = cmnd_frames(frames, w, min(tau_hi + 1, w), impl, precision)  # [..., F, T+1]
    lags = jnp.arange(dn.shape[-1])
    in_range = (lags >= tau_lo) & (lags <= tau_hi)
    prev = jnp.concatenate([dn[..., :1], dn[..., :-1]], axis=-1)
    nxt = jnp.concatenate([dn[..., 1:], dn[..., -1:]], axis=-1)
    trough = (dn < prev) & (dn <= nxt) & (dn < threshold) & in_range
    has_trough = trough.any(axis=-1)
    first_trough = jnp.argmax(trough, axis=-1)
    big = jnp.asarray(jnp.finfo(dn.dtype).max, dn.dtype)
    global_min = jnp.argmin(jnp.where(in_range, dn, big), axis=-1)
    tau_star = jnp.where(has_trough, first_trough, global_min)

    # parabolic interpolation around tau_star (guarded at flat/edge cases)
    def at(idx):
        return jnp.take_along_axis(dn, idx[..., None], axis=-1)[..., 0]

    d0 = at(tau_star)
    dm = at(jnp.maximum(tau_star - 1, 0))
    dp = at(jnp.minimum(tau_star + 1, dn.shape[-1] - 1))
    tau_ref = tau_star.astype(dn.dtype) + _parabolic_refine(dm, d0, dp)
    f0 = sample_rate / jnp.maximum(tau_ref, 1.0)
    # aperiodicity: the (uninterpolated) CMND depth at the chosen lag
    return f0, d0


def yin(
    x: jnp.ndarray,
    sample_rate: float,
    fmin: float = 65.0,
    fmax: float = 2093.0,
    frame_length: int = 2048,
    hop: int = 256,
    threshold: float = 0.1,
    center: bool = True,
    impl: str = "auto",
    precision: str | None = None,
) -> jnp.ndarray:
    """Frame-wise f0 (Hz) of a signal ``[..., T]`` -> ``[..., F]``.

    ``center=True`` reflect-pads by frame_length//2 so frame i is centered
    on sample i*hop (librosa convention).
    """
    f0, _ = yin_voicing(
        x, sample_rate, fmin, fmax, frame_length, hop, threshold, center,
        impl, precision,
    )
    return f0


def yin_voicing(
    x: jnp.ndarray,
    sample_rate: float,
    fmin: float = 65.0,
    fmax: float = 2093.0,
    frame_length: int = 2048,
    hop: int = 256,
    threshold: float = 0.1,
    center: bool = True,
    impl: str = "auto",
    precision: str | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Like :func:`yin` but also returns the per-frame aperiodicity."""
    if center:
        pads = [(0, 0)] * (x.ndim - 1) + [(frame_length // 2, frame_length // 2)]
        x = jnp.pad(x, pads, mode="reflect")
    fr = frame(x, frame_length, hop)
    return yin_frames(fr, sample_rate, fmin, fmax, threshold, None, impl, precision)


# ---------------------------------------------------------------------------
# pYIN (Mauch & Dixon 2014): probabilistic YIN with HMM smoothing.
#
# Formulation: every stage is batched over frames with static shapes —
# the per-threshold candidate weighting is a lax.scan over the threshold
# grid (each step one fused elementwise pass over [.., F, lags]), candidate
# probabilities land in pitch bins through one batched scatter-add, and the
# voiced/unvoiced HMM decode is a banded max-plus Viterbi (2w+1 shifted
# adds per step, ops/sequence.py::max_plus_band_argmax) — the [2N, 2N]
# transition matrix is never materialized. Conventions follow the paper and
# the common tooling (beta-distributed thresholds, truncated-geometric
# trough prior, local triangular pitch transitions, a global switch
# probability between voiced and unvoiced tracks); the serial float64
# oracle lives in tests/test_pitch.py. Two documented deviations from the
# row-renormalized convention: (a) edge pitch bins use the truncated
# (substochastic) triangular kernel so the decode stays a pure banded
# max-plus; (b) trough depths are thresholded raw (without parabolic
# height refinement).
# ---------------------------------------------------------------------------


def _beta_interval_masses(a: float, b: float, n_thresholds: int) -> np.ndarray:
    """Probability mass of Beta(a, b) on each of ``n_thresholds`` equal
    intervals of [0, 1] — host-side numpy quadrature (no scipy in the
    package); dense trapezoid integration, exact to ~1e-8 for the smooth
    shapes used here (endpoint-singular pdfs with a < 1 or b < 1 are
    clipped at the singular sample, a documented approximation)."""
    grid = np.linspace(0.0, 1.0, 1 << 17)
    with np.errstate(divide="ignore", invalid="ignore"):
        pdf = grid ** (a - 1.0) * (1.0 - grid) ** (b - 1.0)
    pdf[~np.isfinite(pdf)] = 0.0
    cdf = np.concatenate(
        [[0.0], np.cumsum(0.5 * (pdf[1:] + pdf[:-1]) * np.diff(grid))]
    )
    cdf /= cdf[-1]
    edges = np.linspace(0.0, 1.0, n_thresholds + 1)
    return np.diff(np.interp(edges, grid, cdf))


def pyin_frames(
    frames: jnp.ndarray,
    sample_rate: float,
    fmin: float = 65.0,
    fmax: float = 2093.0,
    *,
    hop: int = 256,
    win: int | None = None,
    n_thresholds: int = 100,
    beta_parameters: tuple[float, float] = (2.0, 18.0),
    boltzmann_parameter: float = 2.0,
    resolution: float = 0.1,
    switch_prob: float = 0.01,
    no_trough_prob: float = 0.01,
    max_transition_rate: float = 35.92,
    impl: str = "auto",
    precision: str | None = None,
    viterbi_impl: str = "auto",
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """pYIN from frames ``[..., F, L]`` -> ``(f0_hz, voiced_flag, voiced_prob)``.

    Every CMND trough in the lag range becomes a pitch candidate whose
    probability sums, over a beta-distributed grid of ``n_thresholds`` YIN
    thresholds, a truncated-geometric prior (``boltzmann_parameter``) on the
    trough's rank among those below each threshold; thresholds no trough
    clears route ``no_trough_prob`` of their mass to the globally deepest
    trough. Candidates are histogrammed into pitch bins of ``resolution``
    semitones and smoothed by a voiced/unvoiced HMM (local triangular pitch
    movement capped at ``max_transition_rate`` octaves/s, voicing switch
    probability ``switch_prob``) decoded exactly by a banded Viterbi.
    ``f0_hz`` is reported for every frame (the unvoiced track still carries
    a pitch bin — mask with ``voiced_flag`` as needed), refined to the
    winning candidate's parabolic lag when the decoded bin has one.

    ``hop`` is the analysis hop in samples — it scales the per-frame pitch
    transition width; pass the hop the frames were cut with.

    ``viterbi_impl``: "auto" or "xla" (the banded max-plus scan).
    """
    _check_viterbi_impl(viterbi_impl)
    if not 0.0 < switch_prob < 1.0:
        raise ValueError(f"switch_prob must be in (0, 1), got {switch_prob}")
    (obs_v, voiced_prob, trough, prob, f0_lag, bins, n_bins, nbps) = (
        _pyin_observations(
            frames, sample_rate, fmin, fmax, win=win,
            n_thresholds=n_thresholds, beta_parameters=beta_parameters,
            boltzmann_parameter=boltzmann_parameter, resolution=resolution,
            no_trough_prob=no_trough_prob, impl=impl, precision=precision,
        )
    )
    dtype = obs_v.dtype
    log_obs_v, log_obs_u = _pyin_log_obs(obs_v, voiced_prob, n_bins)

    # --- banded two-track Viterbi ---
    # Forward pass records per-state backpointers (offset + track picks);
    # the backtrace reads one state per step. The delta-emitting variant
    # (forward stores the max-plus messages, the backtrace recomputes the
    # ONE visited state's argmax from a 139-wide window gather) trades the
    # backpointer memory for a [B, 2*half+1] gather per step; the wide work
    # stays in the forward band here and the backtrace reads width-1.
    from .sequence import max_plus_band_argmax

    half, log_kernel, log_stay, log_switch = _pyin_hmm_consts(
        sample_rate, hop, nbps, max_transition_rate, switch_prob, dtype
    )

    ov = jnp.moveaxis(log_obs_v, -2, 0)  # [F, ..., N]
    ou = jnp.moveaxis(log_obs_u, -2, 0)
    log_init = jnp.asarray(-np.log(2 * n_bins), dtype)

    dv0 = log_init + ov[0]
    du0 = log_init + ou[0]

    def vit_step(carry, obs_t):
        dv, du = carry
        lv, lu = obs_t
        bv, av = max_plus_band_argmax(dv, log_kernel)
        bu, au = max_plus_band_argmax(du, log_kernel)
        sv, su = bv + log_stay, bu + log_switch
        pick_v = su > sv  # source is the unvoiced track
        new_v = lv + jnp.where(pick_v, su, sv)
        off_v = jnp.where(pick_v, au, av)
        sv2, su2 = bv + log_switch, bu + log_stay
        pick_u = su2 > sv2
        new_u = lu + jnp.where(pick_u, su2, sv2)
        off_u = jnp.where(pick_u, au, av)
        return (new_v, new_u), (off_v, pick_v, off_u, pick_u)

    # unroll=4: the message carries round-trip device memory once per 4
    # frames instead of every frame
    (dv, du), bps = jax.lax.scan(
        vit_step, (dv0, du0), (ov[1:], ou[1:]), unroll=4
    )
    both = jnp.concatenate([dv, du], axis=-1)
    last = jnp.argmax(both, axis=-1).astype(jnp.int32)

    ngrid_b = jnp.arange(n_bins, dtype=jnp.int32)

    def back(state, bp):
        off_v, pick_v, off_u, pick_u = bp
        unvoiced = state >= n_bins
        b = state - n_bins * unvoiced.astype(jnp.int32)
        # gather-free width-1 reads: a one-hot masked reduce over the N
        # bins instead of four [B, N] single-element gathers per step
        hot = ngrid_b == b[..., None]  # [.., N]
        offs = jnp.where(unvoiced[..., None], off_u, off_v).astype(jnp.int32)
        picks = jnp.where(unvoiced[..., None], pick_u, pick_v)
        off = jnp.sum(jnp.where(hot, offs, 0), axis=-1)
        src_u = jnp.sum(jnp.where(hot & picks, 1, 0), axis=-1) > 0
        prev_bin = jnp.clip(b + off - half, 0, n_bins - 1)
        prev = prev_bin + n_bins * src_u.astype(jnp.int32)
        return prev, state

    first, states_rev = jax.lax.scan(back, last, bps, reverse=True)
    states = jnp.concatenate(
        [first[..., None], jnp.moveaxis(states_rev, 0, -1)], axis=-1
    )  # [..., F]

    voiced_flag = states < n_bins
    bin_dec = states - n_bins * (~voiced_flag).astype(jnp.int32)

    # refine: the decoded bin's best candidate (if any) carries the f0 —
    # first-max one-hot reduce instead of argmax + take_along_axis (same
    # gather-avoidance as the backtrace; identical tie rule)
    cand_mask = trough & (bins == bin_dec[..., None])
    score = jnp.where(cand_mask, prob, -1.0)
    mx = jnp.max(score, axis=-1)
    found = mx > 0.0
    hit = score == mx[..., None]
    hit = hit & (jnp.cumsum(hit, axis=-1) == 1)
    f0_cand = jnp.sum(jnp.where(hit, f0_lag, 0.0), axis=-1)
    centers = _pitch_bin_centers(fmin, n_bins, nbps, dtype)
    f0 = jnp.where(found, f0_cand, centers[bin_dec])
    return f0, voiced_flag, voiced_prob


def _pitch_bin_centers(fmin, n_bins, nbps, dtype):
    return jnp.asarray(
        (fmin * 2.0 ** (np.arange(n_bins, dtype=np.float64) / (12.0 * nbps))).astype(
            np.float32
        ),
        dtype,
    )


def _pyin_log_obs(obs_v, voiced_prob, n_bins):
    """(log_obs_voiced, log_obs_unvoiced) [.., F, N] from the linear bin
    observations — the unvoiced track spreads 1 - P(voiced) uniformly."""
    dtype = obs_v.dtype
    log_floor = jnp.asarray(np.log(1e-30), dtype)
    log_obs_v = jnp.log(jnp.maximum(obs_v, 1e-30))
    log_obs_u = jnp.maximum(
        jnp.log(jnp.maximum((1.0 - voiced_prob) / n_bins, 1e-30)), log_floor
    )[..., None] * jnp.ones((n_bins,), dtype)
    return log_obs_v, log_obs_u


def _pyin_hmm_consts(sample_rate, hop, nbps, max_transition_rate, switch_prob, dtype):
    """Banded two-track HMM constants: (half, log_kernel, log_stay,
    log_switch). ``half`` is the max pitch movement in bins per frame."""
    half = max(1, int(round(max_transition_rate * 12.0 * nbps * hop / sample_rate)))
    tri = 1.0 - np.abs(np.arange(-half, half + 1, dtype=np.float64)) / (half + 1.0)
    log_kernel = jnp.asarray(np.log(tri / tri.sum()).astype(np.float32), dtype)
    log_stay = jnp.asarray(np.log1p(-switch_prob), dtype)
    log_switch = jnp.asarray(np.log(switch_prob), dtype)
    return half, log_kernel, log_stay, log_switch


def _pyin_observations(
    frames,
    sample_rate,
    fmin,
    fmax,
    *,
    win=None,
    n_thresholds=100,
    beta_parameters=(2.0, 18.0),
    boltzmann_parameter=2.0,
    resolution=0.1,
    no_trough_prob=0.01,
    impl="auto",
    precision=None,
):
    """Frame-local pYIN candidate stage: frames ``[..., F, L]`` ->
    ``(obs_v [.., F, N], voiced_prob [.., F], trough, prob, f0_lag, bins
    [.., F, T+1], n_bins, nbps)`` — everything up to (and excluding) the
    HMM decode; shared by the offline tracker and the fixed-lag streaming
    tracker, which differ only in how they decode these observations."""
    if not 0.0 < resolution <= 12.0:
        raise ValueError(f"resolution (semitones/bin) must be in (0, 12], got {resolution}")
    l = frames.shape[-1]
    w = win or l // 2
    tau_lo = max(int(np.floor(sample_rate / fmax)), 2)
    tau_hi = min(int(np.ceil(sample_rate / fmin)), w - 1)
    if tau_lo >= tau_hi:
        raise ValueError(
            f"empty lag range for fmin={fmin}, fmax={fmax} at sr={sample_rate} "
            f"(win={w}); need sr/fmax < sr/fmin within [2, win-1]"
        )
    dn = cmnd_frames(frames, w, min(tau_hi + 1, w), impl, precision)  # [..., F, T+1]
    dtype = dn.dtype
    lags = jnp.arange(dn.shape[-1])
    in_range = (lags >= tau_lo) & (lags <= tau_hi)
    prev = jnp.concatenate([dn[..., :1], dn[..., :-1]], axis=-1)
    nxt = jnp.concatenate([dn[..., 1:], dn[..., -1:]], axis=-1)
    trough = (dn < prev) & (dn <= nxt) & in_range  # all local minima, no cap

    # parabolic refinement at every lag (only trough lags are ever read)
    delta = _parabolic_refine(prev, dn, nxt)
    f0_lag = sample_rate / jnp.maximum(lags.astype(dtype) + delta, 1.0)

    # --- per-threshold candidate weighting, as LAG-axis scans ---
    # The direct form scans the threshold grid: n_thresholds passes over
    # [.., F, lags], each with a lag cumsum. Scanning the LAG axis instead
    # with a per-threshold count carry [.., F, M] does the same math in two
    # passes over the candidate tensor (counts, then rank-weighted
    # emission), max |prob delta| 2.4e-7 (same gate: pyin_220_rel).
    lam = float(boltzmann_parameter)
    m_count = int(n_thresholds)
    masses = jnp.asarray(
        _beta_interval_masses(*beta_parameters, m_count), dtype
    )
    thresholds = jnp.asarray(
        np.linspace(0.0, 1.0, m_count + 1)[1:].astype(np.float64), dtype
    )
    geo = dtype.type(1.0) - jnp.exp(jnp.asarray(-lam, dtype))
    # trough l qualifies at threshold m iff dn[l] < thresholds[m] — compare
    # against the actual grid everywhere (a floor(dn*M)-index formulation
    # needs gather-based boundary corrections at this shape).
    # The rank normalizer needs the FINAL per-threshold counts before any
    # weight is computed, so pass 1 is a count-only lag scan: the one-shot
    # broadcast compare-reduce would materialize [.., F, L, M] (~1e9
    # elements at the benchmark config), while the scan carries only the
    # [.., F, M] counts from step to step.
    tr_t = jnp.moveaxis(trough, -1, 0)  # [L, .., F]
    dn_t = jnp.moveaxis(dn, -1, 0)

    def count_step(cnt, inp):
        tr, dnl = inp
        return cnt + (tr[..., None] & (dnl[..., None] < thresholds)).astype(dtype), None

    cnt0 = jnp.zeros((*dn.shape[:-1], m_count), dtype)
    n_q, _ = jax.lax.scan(count_step, cnt0, (tr_t, dn_t), unroll=_CAND_UNROLL)
    norm_inv = jnp.where(n_q > 0, 1.0 / (1.0 - jnp.exp(-lam * n_q)), 1.0)
    cmn = masses * norm_inv * geo  # [.., F, M]
    nt_mass = (masses * (n_q <= 0)).sum(axis=-1)

    # pass 2 carries the rank weight exp(-lam * cnt) MULTIPLICATIVELY
    # (w *= exp(-lam) at each qualifying trough) instead of re-exponentiating
    # the count every step: removes 245 x [.., F, M] transcendental passes
    # from the scan body. Rounding drift vs the direct form is <= ~1e-5
    # relative over the <= M qualifying ranks (oracle/gate budgets 5e-3).
    decay = jnp.exp(jnp.asarray(-lam, dtype))

    def lag_step(wgt, inp):
        tr, dnl = inp
        q_m = tr[..., None] & (dnl[..., None] < thresholds)  # [.., F, M]
        prob_l = jnp.where(q_m, wgt * cmn, 0.0).sum(axis=-1)
        return jnp.where(q_m, wgt * decay, wgt), prob_l

    _, prob_t = jax.lax.scan(
        lag_step, jnp.ones_like(cnt0), (tr_t, dn_t), unroll=_CAND_UNROLL
    )
    prob = jnp.moveaxis(prob_t, 0, -1)  # [.., F, L]

    # thresholds nothing cleared: no_trough_prob of their mass goes to the
    # globally deepest trough (frames with no troughs at all keep prob 0)
    big = jnp.asarray(jnp.finfo(dtype).max, dtype)
    depth_masked = jnp.where(trough, dn, big)
    gmin = jnp.argmin(depth_masked, axis=-1)
    has_any = trough.any(axis=-1)
    gmin_hot = (lags == gmin[..., None]) & has_any[..., None]
    prob = prob + gmin_hot * (no_trough_prob * nt_mass)[..., None]

    voiced_prob = jnp.clip(prob.sum(axis=-1), 0.0, 1.0)

    # --- candidate probabilities -> pitch-bin observations ---
    nbps = max(1, int(round(1.0 / resolution)))
    n_bins = int(np.floor(12.0 * nbps * np.log2(fmax / fmin))) + 1
    bins = jnp.clip(
        jnp.round(12.0 * nbps * jnp.log2(f0_lag / fmin)).astype(jnp.int32),
        0,
        n_bins - 1,
    )
    # histogram candidates into bins without a per-row scatter-add
    # (.at[rows, bins].add) or a full lag-axis one-hot scan (L x n_bins
    # compares). The bins split by deviation:
    # a candidate's bin is the STATIC bin of its integer lag plus a small
    # data-dependent offset d (the parabolic delta moves frequency by at
    # most +/-0.5 lag), and for all but the shortest lags |d| <= 2 — so
    # that lag range reduces to 5 masked matmuls against a fixed
    # one-hot lag->bin bank (sum reordered: f32 reassociation ~1e-7, far
    # inside the 5e-3 oracle budget), and only the short-lag head keeps
    # the compare scan.
    ngrid = jnp.arange(n_bins, dtype=jnp.int32)
    l_grid = dn.shape[-1]
    l_star, base_np, s0ext = _pyin_bin_split(
        float(sample_rate), float(fmin), n_bins, nbps, l_grid, _BIN_SPLIT_D
    )
    acc0 = jnp.zeros((*dn.shape[:-1], n_bins), dtype)
    if l_star < l_grid:
        base_t = jnp.asarray(base_np[l_star:], jnp.int32)
        prob_g = prob[..., l_star:]
        dev = bins[..., l_star:] - base_t
        parts = []
        for d in range(-_BIN_SPLIT_D, _BIN_SPLIT_D + 1):
            pg = jnp.where(dev == d, prob_g, 0.0)
            yd = mm(pg, jnp.asarray(s0ext), precision or ACF_PRECISION_DEFAULT)
            parts.append(
                jax.lax.slice_in_dim(
                    yd, _BIN_SPLIT_D - d, _BIN_SPLIT_D - d + n_bins, axis=-1
                )
            )
        obs_m = parts[0]
        for p_d in parts[1:]:
            obs_m = obs_m + p_d
        acc0 = acc0 + obs_m
    if l_star > 0:
        prob_l_t = jnp.moveaxis(prob[..., :l_star], -1, 0)  # [Lh, .., F]
        bins_t = jnp.moveaxis(bins[..., :l_star], -1, 0)

        def bin_step(acc, inp):
            p, b = inp
            return acc + jnp.where(b[..., None] == ngrid, p[..., None], 0.0), None

        obs_v, _ = jax.lax.scan(
            bin_step, acc0, (prob_l_t, bins_t), unroll=_CAND_UNROLL
        )
    else:
        obs_v = acc0
    f0_lag = f0_lag * jnp.ones_like(dn)  # broadcast to the full lag grid
    return obs_v, voiced_prob, trough, prob, f0_lag, bins, n_bins, nbps


def pyin(
    x: jnp.ndarray,
    sample_rate: float,
    fmin: float = 65.0,
    fmax: float = 2093.0,
    frame_length: int = 2048,
    hop: int = 256,
    center: bool = True,
    **kwargs,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """pYIN over a signal ``[..., T]`` -> ``(f0 [..., F], voiced_flag,
    voiced_prob)``; see :func:`pyin_frames` for the knobs. ``center=True``
    reflect-pads so frame i is centered on sample i*hop."""
    if center:
        pads = [(0, 0)] * (x.ndim - 1) + [(frame_length // 2, frame_length // 2)]
        x = jnp.pad(x, pads, mode="reflect")
    fr = frame(x, frame_length, hop)
    return pyin_frames(fr, sample_rate, fmin, fmax, hop=hop, **kwargs)


# ---------------------------------------------------------------------------
# Streaming pYIN: fixed-lag Viterbi smoothing.
#
# The offline tracker's whole-sequence decode has no streaming form (the
# backtrace starts at the LAST frame), so the streaming variant bounds the
# decode delay instead: at every consumed frame t it backtracks ``lag``
# steps from the current best state and emits the decision for frame
# t - lag (classic fixed-lag smoothing — the OnlineBeats precedent of a
# causal counterpart algorithm, ops/rhythm.py:293-362). State is the pair
# of max-plus messages plus lag-deep rings of prev-state maps and of the
# frame-local candidate tables the f0 refinement needs. Streamed == the
# offline run of the SAME algorithm exactly (one scan, chunk-invariant);
# agreement with the whole-sequence decode outside the lag window is a
# quality property tested on steady-pitch material (tests/test_pitch.py).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OnlinePyinPlan:
    """Static configuration of the fixed-lag streaming pYIN tracker."""

    sample_rate: float
    fmin: float
    fmax: float
    frame_length: int
    hop: int
    lag: int
    n_thresholds: int = 100
    beta_parameters: tuple = (2.0, 18.0)
    boltzmann_parameter: float = 2.0
    resolution: float = 0.1
    switch_prob: float = 0.01
    no_trough_prob: float = 0.01
    max_transition_rate: float = 35.92
    impl: str = "auto"
    precision: str | None = None

    @property
    def nbps(self) -> int:
        return max(1, int(round(1.0 / self.resolution)))

    @property
    def n_bins(self) -> int:
        return int(np.floor(12.0 * self.nbps * np.log2(self.fmax / self.fmin))) + 1

    @property
    def t_max(self) -> int:
        w = self.frame_length // 2
        tau_hi = min(int(np.ceil(self.sample_rate / self.fmin)), w - 1)
        return min(tau_hi + 1, w)


def make_online_pyin_plan(
    sample_rate: float,
    fmin: float = 65.0,
    fmax: float = 2093.0,
    frame_length: int = 2048,
    hop: int = 256,
    lag: int = 25,
    **kwargs,
) -> OnlinePyinPlan:
    """Validated :class:`OnlinePyinPlan`; ``lag`` is the decode delay in
    frames (latency = lag * hop samples on top of the framing overlap)."""
    if lag < 1:
        raise ValueError(f"lag must be >= 1 frame, got {lag}")
    plan = OnlinePyinPlan(
        sample_rate, fmin, fmax, int(frame_length), int(hop), int(lag), **kwargs
    )
    if not 0.0 < plan.resolution <= 12.0:
        raise ValueError(
            f"resolution (semitones/bin) must be in (0, 12], got {plan.resolution}"
        )
    if not 0.0 < plan.switch_prob < 1.0:
        raise ValueError(f"switch_prob must be in (0, 1), got {plan.switch_prob}")
    return plan


def online_pyin_init(
    plan: OnlinePyinPlan, lead_shape=(), dtype=jnp.float32
) -> dict:
    """Zero streaming state: uniform max-plus messages (re-seeded at the
    first consumed frame), empty prev-state / candidate rings, frame clock."""
    n, t1, lag = plan.n_bins, plan.t_max + 1, plan.lag
    return {
        "dv": jnp.zeros((*lead_shape, n), dtype),
        "du": jnp.zeros((*lead_shape, n), dtype),
        "prev": jnp.zeros((*lead_shape, lag, 2 * n), jnp.int32),
        "score": jnp.full((*lead_shape, lag + 1, t1), -1.0, dtype),
        "f0r": jnp.zeros((*lead_shape, lag + 1, t1), dtype),
        "bins": jnp.zeros((*lead_shape, lag + 1, t1), jnp.int32),
        "vp": jnp.zeros((*lead_shape, lag + 1), dtype),
        "seen": jnp.zeros((), jnp.int32),
    }


def online_pyin_step(
    plan: OnlinePyinPlan,
    state: dict,
    frames: jnp.ndarray,
    skip_first: int = 0,
) -> tuple[dict, tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]:
    """Consume frames ``[..., F, L]`` -> ``(state, (f0, voiced_flag,
    voiced_prob))`` each ``[..., F]``.

    The emission at frame index j is the fixed-lag decode of consumed frame
    ``j - plan.lag``. ``skip_first`` ignores the first ``skip_first``
    frames the STATE ever sees (a streaming node's zero-prehistory framing
    tail, which the offline timeline does not contain) — tracked across
    chunks by the state's frame clock, so the caller passes a constant.

    Raw-API caveat: callers MUST discard the first ``skip_first + lag``
    emissions — they are warm-up garbage by construction (decodes of
    skipped or not-yet-seen frames; the :class:`~..graph.nodes.OnlinePyin`
    node does this via its declared ``latency()``). The decode work for
    those frames still runs (static shapes under jit — gating them would
    cost a select, not save the compute).
    """
    from .sequence import max_plus_band_argmax

    dtype = frames.dtype
    lag, n_bins = plan.lag, plan.n_bins
    (obs_v, voiced_prob, trough, prob, f0_lag, bins, n_bins_o, nbps) = (
        _pyin_observations(
            frames, plan.sample_rate, plan.fmin, plan.fmax,
            n_thresholds=plan.n_thresholds,
            beta_parameters=plan.beta_parameters,
            boltzmann_parameter=plan.boltzmann_parameter,
            resolution=plan.resolution, no_trough_prob=plan.no_trough_prob,
            impl=plan.impl, precision=plan.precision,
        )
    )
    assert n_bins_o == n_bins, (n_bins_o, n_bins)
    log_obs_v, log_obs_u = _pyin_log_obs(obs_v, voiced_prob, n_bins)
    half, log_kernel, log_stay, log_switch = _pyin_hmm_consts(
        plan.sample_rate, plan.hop, nbps, plan.max_transition_rate,
        plan.switch_prob, dtype,
    )
    centers = _pitch_bin_centers(plan.fmin, n_bins, nbps, dtype)
    log_init = jnp.asarray(-np.log(2 * n_bins), dtype)
    score = jnp.where(trough, prob, -1.0)
    bin_grid = jnp.arange(n_bins, dtype=jnp.int32)

    seq = tuple(
        jnp.moveaxis(a, -2, 0)
        for a in (log_obs_v, log_obs_u, score, f0_lag, bins)
    ) + (jnp.moveaxis(voiced_prob, -1, 0),)

    def body(c, inp):
        lv, lu, sc, f0r, bn, vp_f = inp
        live = c["seen"] >= skip_first
        is_first = c["seen"] == skip_first

        # forward max-plus step (uniform-init form at the first consumed
        # frame — matches the offline tracker's delta_0)
        bv, av = max_plus_band_argmax(c["dv"], log_kernel)
        bu, au = max_plus_band_argmax(c["du"], log_kernel)
        sv, su = bv + log_stay, bu + log_switch
        pick_v = su > sv
        new_v = lv + jnp.where(pick_v, su, sv)
        off_v = jnp.where(pick_v, au.astype(jnp.int32), av.astype(jnp.int32))
        prev_v = jnp.clip(bin_grid + off_v - half, 0, n_bins - 1) + (
            n_bins * pick_v.astype(jnp.int32)
        )
        sv2, su2 = bv + log_switch, bu + log_stay
        pick_u = su2 > sv2
        new_u = lu + jnp.where(pick_u, su2, sv2)
        off_u = jnp.where(pick_u, au.astype(jnp.int32), av.astype(jnp.int32))
        prev_u = jnp.clip(bin_grid + off_u - half, 0, n_bins - 1) + (
            n_bins * pick_u.astype(jnp.int32)
        )
        dv = jnp.where(is_first, log_init + lv, new_v)
        du = jnp.where(is_first, log_init + lu, new_u)
        prev_map = jnp.concatenate([prev_v, prev_u], axis=-1)  # [.., 2N]

        # rings (newest at index 0; the map pushed at the first consumed
        # frame is never walked — valid emissions stop at frame >= 1)
        prev_ring = jnp.concatenate(
            [prev_map[..., None, :], c["prev"][..., :-1, :]], axis=-2
        )
        score_ring = jnp.concatenate(
            [sc[..., None, :], c["score"][..., :-1, :]], axis=-2
        )
        f0_ring = jnp.concatenate(
            [f0r[..., None, :], c["f0r"][..., :-1, :]], axis=-2
        )
        bins_ring = jnp.concatenate(
            [bn[..., None, :].astype(jnp.int32), c["bins"][..., :-1, :]], axis=-2
        )
        vp_ring = jnp.concatenate([vp_f[..., None], c["vp"][..., :-1]], axis=-1)

        # fixed-lag decode: argmax now, walk `lag` prev maps back. The
        # walk's width-1 reads are one-hot masked REDUCES, not
        # take_along_axis gathers (as in the offline backtrace)
        s = jnp.argmax(jnp.concatenate([dv, du], axis=-1), axis=-1).astype(
            jnp.int32
        )
        grid2 = jnp.arange(2 * n_bins, dtype=jnp.int32)
        for k in range(lag):
            hot = grid2 == s[..., None]
            s = jnp.sum(jnp.where(hot, prev_ring[..., k, :], 0), axis=-1)
        unvoiced = s >= n_bins
        b = s - n_bins * unvoiced.astype(jnp.int32)
        sc_e = score_ring[..., lag, :]
        cand = jnp.where(
            (bins_ring[..., lag, :] == b[..., None]) & (sc_e > 0.0), sc_e, -1.0
        )
        mx = jnp.max(cand, axis=-1)
        found = mx > 0.0
        hit = cand == mx[..., None]
        hit = hit & (jnp.cumsum(hit, axis=-1) == 1)  # first max == argmax tie rule
        f0_cand = jnp.sum(jnp.where(hit, f0_ring[..., lag, :], 0.0), axis=-1)
        f0 = jnp.where(found, f0_cand, centers[b])
        out = (f0, ~unvoiced, vp_ring[..., lag])

        new_c = {
            "dv": dv, "du": du, "prev": prev_ring, "score": score_ring,
            "f0r": f0_ring, "bins": bins_ring, "vp": vp_ring,
        }
        kept = {k: jnp.where(live, new_c[k], c[k]) for k in new_c}
        kept["seen"] = c["seen"] + 1
        return kept, out

    state, (f0_t, vf_t, vp_t) = jax.lax.scan(body, state, seq)
    return state, (
        jnp.moveaxis(f0_t, 0, -1),
        jnp.moveaxis(vf_t, 0, -1),
        jnp.moveaxis(vp_t, 0, -1),
    )


def pyin_online(
    x: jnp.ndarray,
    sample_rate: float,
    fmin: float = 65.0,
    fmax: float = 2093.0,
    frame_length: int = 2048,
    hop: int = 256,
    lag: int = 25,
    **kwargs,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Fixed-lag streaming pYIN over a whole signal ``[..., T]`` ->
    ``(f0, voiced_flag, voiced_prob)`` each ``[..., F]`` on the EMISSION
    timeline: index j decodes frame j - ``lag`` (the first ``lag`` outputs
    are warm-up). This is the offline run of exactly the algorithm the
    :class:`~audioflow_tpu.graph.nodes.OnlinePyin` node streams
    (center=False framing, zero initial state) — the streamed form equals
    it at the node's declared whole-unit latency."""
    plan = make_online_pyin_plan(
        sample_rate, fmin, fmax, frame_length, hop, lag, **kwargs
    )
    fr = frame(x, frame_length, hop)
    state = online_pyin_init(plan, x.shape[:-1], fr.dtype)
    _, out = online_pyin_step(plan, state, fr, skip_first=0)
    return out


def piptrack(
    spec_mag: jnp.ndarray,
    sample_rate: float,
    n_fft: int,
    fmin: float = 150.0,
    fmax: float = 4000.0,
    threshold: float = 0.1,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Spectral-peak pitch candidates (the parabolic-interpolation
    'piptrack' convention) from a magnitude spectrogram ``[..., T, bins]``.

    A bin is a candidate iff it is a local max across frequency, within
    [fmin, fmax], and above ``threshold * frame_max``. Returns
    ``(pitches, mags)`` the same shape as the input — zero except at
    candidate bins, where ``pitches`` holds the parabolic-refined frequency
    in Hz and ``mags`` the interpolated magnitude. Complements the lag-
    domain trackers (yin/pyin): cheap, polyphonic, but octave-blind — one
    fused elementwise pass, batched and shard-clean.
    """
    s = jnp.asarray(spec_mag)
    bins = s.shape[-1]
    freqs = np.arange(bins) * sample_rate / n_fft
    prev = jnp.concatenate([s[..., :1], s[..., :-1]], axis=-1)
    nxt = jnp.concatenate([s[..., 1:], s[..., -1:]], axis=-1)
    shift = _parabolic_refine(prev, s, nxt)
    in_band = jnp.asarray((freqs >= fmin) & (freqs <= fmax))
    frame_max = s.max(axis=-1, keepdims=True)
    peak = (s > prev) & (s >= nxt) & in_band & (s >= threshold * frame_max)
    bin_idx = jnp.arange(bins, dtype=s.dtype)
    pitches = jnp.where(peak, (bin_idx + shift) * (sample_rate / n_fft), 0.0)
    mags = jnp.where(peak, s - 0.25 * (prev - nxt) * shift, 0.0)
    return pitches, mags
