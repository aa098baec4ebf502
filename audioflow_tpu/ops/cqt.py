"""Constant-Q transform (CQT) as matmuls against precomputed kernels.

The reference app has no CQT (its analysis stops at VAD energy); this is
part of the framework's music-analysis family (chroma, tonnetz, rhythm).
The classic CPU algorithm (Brown/Puckette via recursive downsampling +
sparse FFT kernels) is replaced by a matmul formulation:

* every CQT bin is a windowed complex sinusoid kernel; a frame of signal
  dotted with the kernel bank IS the transform — the same matmul-DFT
  pattern as ops/stft.py::spectrogram, which shards with zero collectives
  (XLA's FFT op does not partition; these dots do);
* kernels are designed host-side in float64, cached, and shipped as
  cos/sin banks (no complex arithmetic on device);
* ``impl="onedot"`` (default) concatenates every octave's kernels —
  zero-padded to the full frame span — into ONE ``[F0, 2*n_bins]`` bank:
  one framing, one dot. The op is bound by the framed-signal read, not by
  MACs, so the "wasted" zero MACs cost little and the single-dot form
  compiles fastest. ``impl="split"`` (per-octave frame
  lengths, ~12x fewer MACs) and ``impl="direct"`` (per-octave dots at full
  length) are kept for the exact-equality tests — all three are
  bit-identical up to f32 summation of exact zeros;
* every frame length is rounded up to a multiple of ``hop`` so framing
  takes ops/framing.py's static-slice fast path. The raw odd kernel length
  (8229 at fmin=C1/16 kHz) would force the gather fallback — a [frames,
  8229] index gather materializing ~32x the signal in device memory.

Geometry: frame t's kernels are centered at sample ``t * hop`` when
``center=True`` (zero-padded edges — kernels of several thousand samples
make reflect padding meaningless), and at ``t * hop + F0 // 2`` when
``center=False``, where ``F0 = hop * ceil((N_max + 1) / hop)`` is the
lowest octave's frame length. ``n_frames`` is ``T // hop + 1`` centered,
``(T - F0) // hop + 1`` otherwise.

Normalization: each kernel is scaled by ``2 / sum(window)``, so a
unit-amplitude sinusoid at a bin's center frequency reads ~1.0 in that
bin — the natural "amplitude spectrum" convention (documented here
because CQT normalizations differ across libraries).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ._mm import mm
from .framing import frame
from .stft import DFT_PRECISION_DEFAULT
from .windows import get_window

#: C1 in the A440 12-TET tuning — the conventional CQT floor.
FMIN_C1 = 32.70319566257483

from ..utils.cache import BoundedCache

# per-config analysis banks, ~F0*2*n_bins*4 B each (~6 MB at 84 bins/16 kHz)
_KERNEL_CACHE = BoundedCache(maxsize=16)


def cqt_frequencies(
    n_bins: int = 84, fmin: float = FMIN_C1, bins_per_octave: int = 12
) -> np.ndarray:
    """Bin center frequencies [n_bins], geometrically spaced (host, f64)."""
    return fmin * 2.0 ** (np.arange(n_bins, dtype=np.float64) / bins_per_octave)


def cqt_lengths(
    sample_rate: float,
    n_bins: int = 84,
    fmin: float = FMIN_C1,
    bins_per_octave: int = 12,
    filter_scale: float = 1.0,
) -> np.ndarray:
    """Kernel length in samples per bin (odd-forced; host, int).

    ``N_k = ceil(Q * sr / f_k)`` with ``Q = filter_scale / (2^(1/B) - 1)``.
    Odd lengths give every kernel an exact integer center.
    """
    q = filter_scale / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    freqs = cqt_frequencies(n_bins, fmin, bins_per_octave)
    n = np.ceil(q * sample_rate / freqs).astype(np.int64)
    return n + (1 - n % 2)


def _design(
    sample_rate: float,
    hop: int,
    n_bins: int,
    fmin: float,
    bins_per_octave: int,
    window: str,
    filter_scale: float,
):
    """Host-side kernel design. Returns (f0, groups); each group is
    (frame_len, cos_bank [frame_len, nb], sin_bank) for one octave. Frame
    lengths are hop multiples (framing fast path); kernel k is centered at
    row ``frame_len // 2``."""
    key = (sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale)
    if key in _KERNEL_CACHE:
        return _KERNEL_CACHE[key]
    freqs = cqt_frequencies(n_bins, fmin, bins_per_octave)
    if freqs[-1] > sample_rate / 2:
        raise ValueError(
            f"top CQT bin {freqs[-1]:.1f} Hz exceeds Nyquist "
            f"{sample_rate / 2:.1f} Hz; reduce n_bins or raise fmin"
        )
    lengths = cqt_lengths(sample_rate, n_bins, fmin, bins_per_octave, filter_scale)
    groups = []
    for lo in range(0, n_bins, bins_per_octave):
        hi = min(lo + bins_per_octave, n_bins)
        n_max = int(lengths[lo:hi].max())
        flen = hop * -(-(n_max + 1) // hop)  # kernel fits centered at flen//2
        cos_b = np.zeros((flen, hi - lo), np.float64)
        sin_b = np.zeros((flen, hi - lo), np.float64)
        for j, k in enumerate(range(lo, hi)):
            nk = int(lengths[k])
            w = get_window(window, nk, periodic=False).astype(np.float64)
            t = (np.arange(nk, dtype=np.float64) - (nk - 1) / 2.0) / sample_rate
            ang = 2.0 * np.pi * freqs[k] * t
            g = 2.0 / w.sum()
            start = flen // 2 - (nk - 1) // 2
            cos_b[start : start + nk, j] = g * w * np.cos(ang)
            sin_b[start : start + nk, j] = -g * w * np.sin(ang)
        groups.append((flen, cos_b.astype(np.float32), sin_b.astype(np.float32)))
    f0 = groups[0][0]
    # the onedot bank: [F0, 2*n_bins] = [cos octaves... | sin octaves...],
    # each octave zero-padded so its kernels stay centered at F0//2
    cos_full, sin_full = [], []
    for flen, cb, sb in groups:
        pr = f0 // 2 - flen // 2  # both are hop multiples -> exact
        cos_full.append(np.pad(cb, ((pr, f0 - flen - pr), (0, 0))))
        sin_full.append(np.pad(sb, ((pr, f0 - flen - pr), (0, 0))))
    onedot_bank = np.concatenate(cos_full + sin_full, axis=1)
    _KERNEL_CACHE[key] = (f0, groups, onedot_bank)
    return _KERNEL_CACHE[key]


def cqt_window_length(
    sample_rate: float,
    hop: int = 256,
    n_bins: int = 84,
    fmin: float = FMIN_C1,
    bins_per_octave: int = 12,
    filter_scale: float = 1.0,
) -> int:
    """The analysis frame span F0 (lowest octave's frame length, a hop
    multiple) — the streaming carry is ``F0 - hop``."""
    n_max = int(
        cqt_lengths(sample_rate, n_bins, fmin, bins_per_octave, filter_scale)[0]
    )
    return hop * -(-(n_max + 1) // hop)


def cqt(
    x: jnp.ndarray,
    sample_rate: float,
    hop: int = 256,
    n_bins: int = 84,
    fmin: float = FMIN_C1,
    bins_per_octave: int = 12,
    window: str = "hann",
    filter_scale: float = 1.0,
    center: bool = True,
    output: str = "magnitude",
    impl: str = "onedot",
    precision: str | None = None,
    multirate: bool = False,
) -> jnp.ndarray:
    """Constant-Q spectrogram ``[..., n_frames, n_bins]``.

    See the module docstring for the frame geometry and normalization.

    ``output``: "magnitude" | "power" | "complex".
    ``impl``: "onedot" (one concatenated bank, one dot; default — the op is
    bound by memory, not MACs), "split" (per-octave frame lengths) or
    "direct" (per-octave dots at the full frame length) — identical
    results.
    ``precision``: matmul precision (None -> ops/stft.py
    ``DFT_PRECISION_DEFAULT`` = 'high'; gated by the cqt_440_mag_err
    validate row).
    ``multirate=True`` returns the invertible per-octave-hop variant (a
    :class:`MultirateCqt` pytree, one array per octave at its own hop —
    see :func:`cqt_multirate`; requires center=True). Use it when the
    coefficients must round-trip through :func:`icqt` on arbitrary
    broadband signals; the fixed-hop transform at coarse hops only
    reconstructs them approximately (tones well, noise poorly — numbers in
    the :func:`icqt` docstring).
    """
    if multirate:
        if not center:
            raise ValueError("cqt(multirate=True) supports center=True only")
        if impl != "onedot":
            raise ValueError(
                "cqt(multirate=True) has its own per-octave implementation; "
                f"impl={impl!r} does not apply"
            )
        return cqt_multirate(
            x, sample_rate, hop, n_bins, fmin, bins_per_octave, window,
            filter_scale, output, precision,
        )
    if output not in ("magnitude", "power", "complex"):
        raise ValueError(
            f"unknown cqt output {output!r}; known: magnitude, power, complex"
        )
    if impl not in ("onedot", "split", "direct"):
        raise ValueError(f"unknown cqt impl {impl!r}; known: onedot, split, direct")
    f0, groups, onedot_bank = _design(
        sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale
    )
    prec = precision or DFT_PRECISION_DEFAULT
    if center:
        half = f0 // 2
        pads = [(0, 0)] * (x.ndim - 1) + [(half, f0 - half)]
        x = jnp.pad(x, pads)
    n_frames = (x.shape[-1] - f0) // hop + 1
    if n_frames < 1:
        raise ValueError(
            f"signal too short for CQT: {x.shape[-1]} samples < frame span {f0}"
        )
    if impl == "onedot":
        fr = frame(x, f0, hop)[..., :n_frames, :]
        y = mm(fr, jnp.asarray(onedot_bank), prec)
        re, im = y[..., :n_bins], y[..., n_bins:]
    else:
        res, ims = [], []
        for flen, cos_b, sin_b in groups:
            if impl == "direct":
                pad_rows = f0 // 2 - flen // 2  # both are hop multiples / even
                cos_b = np.pad(cos_b, ((pad_rows, f0 - flen - pad_rows), (0, 0)))
                sin_b = np.pad(sin_b, ((pad_rows, f0 - flen - pad_rows), (0, 0)))
                off, flen = 0, f0
            else:
                off = f0 // 2 - flen // 2  # same center sample t*hop + f0//2
            fr = frame(x[..., off:], flen, hop)[..., :n_frames, :]
            res.append(mm(fr, jnp.asarray(cos_b), prec))
            ims.append(mm(fr, jnp.asarray(sin_b), prec))
        re = jnp.concatenate(res, axis=-1)
        im = jnp.concatenate(ims, axis=-1)
    if output == "complex":
        return jax.lax.complex(re, im)
    p = re * re + im * im
    return jnp.sqrt(p) if output == "magnitude" else p


# per-config synthesis banks, ~2*n_bins*nd*4 B each (~11 MB at 84 bins/16 kHz)
_DUAL_CACHE = BoundedCache(maxsize=8)


def icqt_max_hop(
    sample_rate: float,
    n_bins: int = 84,
    fmin: float = FMIN_C1,
    bins_per_octave: int = 12,
    filter_scale: float = 1.0,
) -> int:
    """Largest analysis hop at which :func:`icqt` reconstruction holds.

    The hop-sampled CQT is only invertible while every kernel still covers
    the gaps between frames (the "painless" condition): once ``hop``
    exceeds ~1/3 of the SHORTEST kernel, the top bins' content between
    frame centers is simply never measured and no dual bank can bring it
    back (time aliasing — fundamental, not numerical; measured 33.8 dB
    worst-bin tone SNR at exactly N_min/3, collapsing to negative dB by
    N_min). Analysis-only uses (chroma, descriptors) are unaffected and
    keep the usual hop=256.
    """
    n_min = int(
        cqt_lengths(sample_rate, n_bins, fmin, bins_per_octave, filter_scale)[-1]
    )
    return max(1, n_min // 3)


def _dual_design(
    sample_rate: float,
    hop: int,
    n_bins: int,
    fmin: float,
    bins_per_octave: int,
    window: str,
    filter_scale: float,
    nd_mult: int = 2,
    eps: float = 1e-2,
    mask_db: float = 40.0,
):
    """Host-side synthesis (dual) bank design, float64 -> f32.

    The analysis kernels ``psi_k = g w exp(i ang)`` (the onedot bank's
    columns) form a frame at hop ``hop``; the painless-case canonical dual
    is diagonal in frequency: ``d_hat_k = psi_hat_k / W`` with the total
    response ``W(w) = (1/hop) sum_k (|psi_hat_k(w)|^2 + |psi_hat_k(-w)|^2)``.
    Two corrections make it work in practice (both measured, see tests):

    * **band mask**: each dual is zeroed where ``|psi_hat_k|`` is more than
      ``mask_db`` below its peak. Without it, a kernel's far sidelobes get
      amplified by 1/W in the uncovered regions (below fmin / above the top
      bin), and the hop-sampling alias images of any tone excite them —
      measured as a ~20 dB error floor localized at ``f - j*sr/hop``;
    * **regularization**: W is floored at ``eps * max(W)`` so the rolloff
      at the band edges (half-covered first/last bins) cannot blow up.

    The duals are designed on an ``nd = nd_mult * F0`` circular grid
    (``nd_mult=2``): the division by W widens the lowest bin's dual beyond
    its F0 kernel span, and at nd = F0 it wraps — measured as a low-bin SNR
    collapse. Returns ``(nd, bank [2*n_bins, nd] f32)`` where a synthesis
    frame is ``[Re X | Im X] @ bank`` (the 2*Re{X d} expansion).
    """
    key = (
        sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale,
        nd_mult, eps, mask_db,
    )
    if key in _DUAL_CACHE:
        return _DUAL_CACHE[key]
    f0, _groups, onedot = _design(
        sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale
    )
    # forward bank columns: cos_b = g w cos(ang), sin_b = -g w sin(ang), so
    # X = x@cos_b + i x@sin_b = <x, conj(psi)> with psi = g w exp(i ang)
    psi = (
        onedot[:, :n_bins].T.astype(np.float64)
        - 1j * onedot[:, n_bins:].T.astype(np.float64)
    )
    nd = f0 * nd_mult
    psi_p = np.zeros((n_bins, nd), complex)
    off = nd // 2 - f0 // 2  # keep kernels centered on the design grid
    psi_p[:, off : off + f0] = psi
    ph = np.fft.fft(psi_p, axis=1)
    w_pos = (np.abs(ph) ** 2).sum(0)
    w_neg = np.empty_like(w_pos)  # |psi_hat(-w)|^2: index -j mod nd
    w_neg[0] = w_pos[0]
    w_neg[1:] = w_pos[1:][::-1]
    w_tot = (w_pos + w_neg) / hop
    amp = np.abs(ph)
    mask = amp >= amp.max(axis=1, keepdims=True) * 10.0 ** (-mask_db / 20.0)
    d_hat = ph * mask / np.maximum(w_tot, eps * w_tot.max())[None, :]
    d = np.fft.ifft(d_hat, axis=1)  # complex duals, centered at nd//2
    bank = np.concatenate(
        [2.0 * d.real, -2.0 * d.imag], axis=0
    ).astype(np.float32)  # [2*n_bins, nd]
    _DUAL_CACHE[key] = (nd, bank)
    return _DUAL_CACHE[key]


def icqt(
    c: jnp.ndarray,
    sample_rate: float | None = None,
    hop: int = 256,
    n_bins: int = 84,
    fmin: float = FMIN_C1,
    bins_per_octave: int = 12,
    window: str = "hann",
    filter_scale: float = 1.0,
    center: bool = True,
    length: int | None = None,
    precision: str | None = None,
    method: str = "auto",
) -> jnp.ndarray:
    """Inverse CQT: complex coefficients (the output of
    ``cqt(..., output="complex")`` at the SAME parameters, or a
    :class:`MultirateCqt` from ``cqt(..., multirate=True)``) back to a
    waveform ``[..., T]``.

    A :class:`MultirateCqt` input dispatches to :func:`icqt_multirate` —
    the TRUE broadband inverse (>= ~40 dB worst-case design SNR on noise
    bands, harmonic complexes, and tones at the framework default; gated
    by ``icqt_multirate_noise_snr_db``). For fixed-hop ``[..., n_frames,
    n_bins]`` coefficients, two synthesis methods picked by
    ``method="auto"``:

    * ``"painless"`` (``hop <= icqt_max_hop``): one dot of ``[Re | Im]``
      against the diagonal dual bank (:func:`_dual_design`) plus an
      overlap-add — the classic painless-frame inverse, a true inverse for
      any in-band signal, measured >= 33 dB worst-bin / ~70 dB mid-band
      tone SNR (``icqt_painless_snr_db`` validate row).
    * ``"hybrid"`` (any larger hop, including the framework default
      hop=256 / 84 bins / 16 kHz where the top octaves are past the
      painless cliff): per-coset least-squares duals for the covered low
      bins + sinusoidal-model synthesis for the rest, crossfaded in a
      taper band (:func:`_hybrid_design` / :func:`_icqt_hybrid`).
      **Signal-model restriction — read before using**: above the painless
      cliff (bins past ``k_last`` ~ bin 40 / ~350 Hz at the default
      config) the sinusoidal branch reconstructs PEAKY, tonal content
      only; non-peak energy there is discarded by construction. Measured
      at the default config (steady-state): bin-center tones >= ~35 dB
      (``icqt_tone_snr_db`` validate row) — but 800-2000 Hz band-limited
      noise **-10.1 dB** (more error energy than signal) and a 150 Hz
      harmonic complex **7.9 dB** (``icqt_hybrid_broadband_db`` validate
      row records both). Noise fully inside the LS-dual branch (100-250
      Hz) is fine: ~48 dB, degrading to ~19 dB for a band touching the
      ~300-330 Hz crossfade rolloff. For broadband-faithful inversion use
      ``cqt(..., multirate=True)``.

    The reference app has no CQT at all; this completes the framework's
    analysis families so each one has an inversion story (stft->istft,
    mel/mfcc->audio, cqt->icqt).

    ``length``: output sample count; defaults to ``(n_frames - 1) * hop``
    (the forward's T is only known to hop resolution). ``precision``
    follows the forward's default (ops/stft.py DFT_PRECISION_DEFAULT).
    """
    if isinstance(c, MultirateCqt):
        if sample_rate is not None and sample_rate != c.meta.sample_rate:
            raise ValueError(
                f"icqt sample_rate {sample_rate} != the MultirateCqt's "
                f"{c.meta.sample_rate} (the coefficients carry their own "
                "analysis parameters; pass none)"
            )
        # the coefficients carry their parameters; explicitly-conflicting
        # args are caller bugs (function defaults can't be told apart from
        # explicit values, so only non-default conflicts are catchable)
        mism = [
            (name, got, want)
            for name, got, want, dflt in (
                ("hop", hop, c.meta.hop, 256),
                ("n_bins", n_bins, c.meta.n_bins, 84),
                ("fmin", fmin, c.meta.fmin, FMIN_C1),
                ("bins_per_octave", bins_per_octave, c.meta.bins_per_octave, 12),
                ("window", window, c.meta.window, "hann"),
            )
            if got != want and got != dflt
        ]
        if mism:
            raise ValueError(
                "icqt arguments conflict with the MultirateCqt's analysis "
                f"parameters: {mism} (pass none — the pytree carries them)"
            )
        if method not in ("auto",):
            raise ValueError(
                f"icqt method={method!r} does not apply to MultirateCqt input"
            )
        return icqt_multirate(c, length=length, precision=precision)
    if sample_rate is None:
        raise ValueError(
            "icqt needs sample_rate for fixed-hop coefficients (it is only "
            "optional for MultirateCqt input)"
        )
    from .framing import overlap_add

    if method not in ("auto", "painless", "hybrid"):
        raise ValueError(
            f"unknown icqt method {method!r}; known: auto, painless, hybrid"
        )
    max_hop = icqt_max_hop(sample_rate, n_bins, fmin, bins_per_octave, filter_scale)
    if method == "auto":
        method = "painless" if hop <= max_hop else "hybrid"
    if method == "hybrid":
        return _icqt_hybrid(
            c, sample_rate, hop, n_bins, fmin, bins_per_octave, window,
            filter_scale, center, length, precision,
        )
    if hop > max_hop:
        import warnings

        warnings.warn(
            f"icqt method='painless' at hop={hop} exceeds icqt_max_hop="
            f"{max_hop}"
            " — top-octave content is not recoverable at this frame spacing "
            "(see icqt_max_hop); expect degraded reconstruction "
            "(method='hybrid' handles coarse hops)",
            stacklevel=2,
        )
    nd, bank = _dual_design(
        sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale
    )
    f0 = cqt_window_length(
        sample_rate, hop, n_bins, fmin, bins_per_octave, filter_scale
    )
    if c.shape[-1] != n_bins:
        raise ValueError(f"expected [..., frames, {n_bins}] coefficients, got {c.shape}")
    n_frames = c.shape[-2]
    if length is None:
        length = (n_frames - 1) * hop
    prec = precision or DFT_PRECISION_DEFAULT
    ri = jnp.concatenate([jnp.real(c), jnp.imag(c)], axis=-1)  # [..., T_f, 2K]
    frames = mm(ri, jnp.asarray(bank), prec)  # [..., T_f, nd]
    y = overlap_add(frames, hop)  # sample i = sum_t frames[t, i - t*hop]
    # frame t's dual is centered at t*hop (center=True) or t*hop + f0//2
    # (center=False); OLA index i = t*hop + j with kernel center j = nd//2
    start = nd // 2 - (0 if center else f0 // 2)
    if start < 0:
        pads = [(0, 0)] * (y.ndim - 1) + [(-start, 0)]
        y, start = jnp.pad(y, pads), 0
    need = start + length
    if y.shape[-1] < need:
        pads = [(0, 0)] * (y.ndim - 1) + [(0, need - y.shape[-1])]
        y = jnp.pad(y, pads)
    return y[..., start:need]


# hybrid designs are large (~12 MB dual bank at 84 bins / 16 kHz)
_HYBRID_CACHE = BoundedCache(maxsize=4)


def _window_cos_coeffs(window: str, n_terms: int = 6) -> np.ndarray:
    """Cosine-sum coefficients ``a_j`` of the analysis window
    (``w[n] = sum_j a_j cos(2 pi j n' / (N-1))``), fit by least squares on a
    long instance. The hybrid inverse's sinusoid estimator needs the window
    spectrum ``|W(u)|/W(0)`` EVERYWHERE on device; a table + ``jnp.interp``
    is a large gather, while the cosine-sum form gives the closed expression
    ``sum_j (a_j/2)(sinc(u-j) + sinc(u+j))`` — pure elementwise. Raises for
    windows that are not cosine sums (residual > 1e-5)."""
    n_w = 4096
    w = get_window(window, n_w, periodic=False).astype(np.float64)
    n = np.arange(n_w, dtype=np.float64) - (n_w - 1) / 2.0
    basis = np.cos(2.0 * np.pi * np.arange(n_terms)[:, None] * n / (n_w - 1))
    a, *_ = np.linalg.lstsq(basis.T, w, rcond=None)
    resid = np.abs(basis.T @ a - w).max()
    if resid > 1e-5:
        raise ValueError(
            f"icqt hybrid needs a cosine-sum analysis window; {window!r} "
            f"fit residual {resid:.2e} (use hann/hamming/blackman)"
        )
    return a  # a[0] is the DC term == W(0)/N-normalized peak


def _hybrid_design(
    sample_rate: float,
    hop: int,
    n_bins: int,
    fmin: float,
    bins_per_octave: int,
    window: str,
    filter_scale: float,
    nd_mult: int = 4,
    lam_rel: float = 1e-3,
):
    """Host-side design for the hybrid (coarse-hop) inverse CQT.

    **Dual branch — per-coset least squares.** At hop ``h`` the analysis is
    shift-invariant in steps of ``h``, so on an ``nd``-point design circle
    the frame operator block-diagonalizes over frequency cosets
    ``{w : w ≡ mu (mod nd/h)}`` (the Walnut representation): the T-point
    DFT of bin k's coefficient sequence at index mu is
    ``C_k(mu) = (T/nd) sum_{w in coset} X(w) conj(Psi_k(w))``, and the
    conjugate sequence gives a second row ``Psi_k(-w)``. Solving each
    coset's Tikhonov-regularized min-norm least squares yields dual spectra
    that are exact wherever the coset system has rank — including the
    bottom bins, whose +/- frequency lobes collide under hop-rate aliasing
    (``2f mod sr/hop`` inside the bin bandwidth, e.g. 2.9 Hz vs a ~4 Hz
    mainlobe for C1 at hop 256/16 kHz): the diagonal painless formula
    cannot separate the lobes (measured 15 dB) but the LS resolves them
    through the neighbor bin's differing response (measured 36 dB).
    ``nd_mult=4`` matters: at nd_mult=2 the 0.95 Hz design grid is too
    coarse for that cancellation off-grid (measured 0.1 dB -> 36.3 dB at
    nd_mult=4 in a float64 design sweep).

    **Crossfade.** Duals are kept for bins up to ``k_last + 5`` (k_last =
    last bin with ``N_k >= 3*hop``) and tapered to zero over
    ``[freqs[k_last-1], freqs[k_last+2]]``; the sinusoidal branch weights
    by ``1 - rho(f_hat)`` so the two branches sum to one copy in the band.

    Returns a dict of f32 arrays + static ints (see keys below).
    """
    key = (
        sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale,
        nd_mult, lam_rel,
    )
    if key in _HYBRID_CACHE:
        return _HYBRID_CACHE[key]
    freqs = cqt_frequencies(n_bins, fmin, bins_per_octave)
    lengths = cqt_lengths(
        sample_rate, n_bins, fmin, bins_per_octave, filter_scale
    ).astype(np.float64)
    painless = lengths >= 3 * hop
    if not painless[:3].all():
        raise ValueError(
            f"icqt hybrid needs the lowest 3 CQT bins painless at hop={hop} "
            f"(kernel lengths {lengths[:3].astype(int).tolist()} < 3*hop); "
            "reduce hop or raise fmin"
        )
    k_last = int(np.nonzero(painless)[0].max())
    k_dual = min(k_last + 5, n_bins)
    f_lo = freqs[max(k_last - 1, 0)]
    f_hi = freqs[min(k_last + 2, n_bins - 1)]
    f0, _groups, onedot = _design(
        sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale
    )
    psi = (
        onedot[:, :k_dual].T.astype(np.float64)
        - 1j * onedot[:, n_bins : n_bins + k_dual].T.astype(np.float64)
    )
    nd = f0 * nd_mult
    t_cosets = nd // hop
    psi_p = np.zeros((k_dual, nd), complex)
    off = nd // 2 - f0 // 2
    psi_p[:, off : off + f0] = psi
    ph = np.fft.fft(psi_p, axis=1)
    d_hat = np.zeros((k_dual, nd), complex)
    e_hat = np.zeros((k_dual, nd), complex)
    scale = t_cosets / nd  # C_k(mu) carries a 1/hop vs the coset sum
    lam = lam_rel * (np.abs(ph).max() * scale) ** 2
    for mu in range(t_cosets):
        w_idx = (mu + t_cosets * np.arange(hop)) % nd
        a1 = np.conj(ph[:, w_idx])
        a2 = ph[:, (nd - w_idx) % nd]  # conj-coefficient rows
        a = scale * np.concatenate([a1, a2], axis=0)  # [2K, hop]
        g = a @ a.conj().T
        g.flat[:: g.shape[0] + 1] += lam
        b = np.linalg.solve(g, a).conj().T  # min-norm LS: A^H (AA^H+lam)^-1
        d_hat[:, w_idx] += b[:, :k_dual].T
        e_hat[:, w_idx] += b[:, k_dual:].T
    # realness: e_hat == reflected-conj of d_hat (checked to ~1e-13 in the
    # prototype); average so y = sum_k 2 Re{c_k d_k} is exactly real-paired
    refl = np.conj(e_hat[:, (nd - np.arange(nd)) % nd])
    d_sym = 0.5 * (d_hat + refl)
    fgrid = np.abs(np.fft.fftfreq(nd, d=1.0 / sample_rate))
    t = np.clip(
        (np.log(np.maximum(fgrid, 1e-9)) - np.log(f_lo))
        / (np.log(f_hi) - np.log(f_lo)),
        0.0,
        1.0,
    )
    d_sym *= (0.5 * (1.0 + np.cos(np.pi * t)))[None, :]
    d = np.fft.ifft(d_sym, axis=1)
    bank = np.concatenate([2.0 * d.real, -2.0 * d.imag], axis=0)  # [2K, nd]
    # conv kernel: out hop-block s, in-feature f, spatial tap j (reversed):
    # y_block[s, r] = sum_q ri[s-q] @ bank[:, q*hop+r]  ->  rhs[r, f, j] =
    # bank[f, (Tb-1-j)*hop + r]
    kern = bank.reshape(2 * k_dual, t_cosets, hop)[:, ::-1, :]
    kern = np.ascontiguousarray(np.transpose(kern, (2, 0, 1)))  # [hop, 2K, Tb]
    wcos = _window_cos_coeffs(window)
    n_cand = max(
        4, int(np.ceil(freqs[-1] * (2.0 ** (1.0 / (2 * bins_per_octave)) - 1.0)
                       / (sample_rate / hop))) + 1
    )
    out = dict(
        nd=nd,
        f0=f0,
        k_dual=k_dual,
        k_min=max(k_last - 2, 0),
        n_cand=n_cand,
        f_lo=float(f_lo),
        f_hi=float(f_hi),
        kern=kern.astype(np.float32),
        freqs=freqs.astype(np.float32),
        lengths=lengths.astype(np.float32),
        wcos=wcos.astype(np.float32),
    )
    _HYBRID_CACHE[key] = out
    return out


def _icqt_hybrid(
    c: jnp.ndarray,
    sample_rate: float,
    hop: int,
    n_bins: int,
    fmin: float,
    bins_per_octave: int,
    window: str,
    filter_scale: float,
    center: bool,
    length: int | None,
    precision: str | None,
    score_gate: float = 0.5,
    mag_floor: float = 1e-3,
    max_components: int = 16,
) -> jnp.ndarray:
    """Hybrid inverse CQT for coarse hops (see :func:`_hybrid_design`).

    Device side, all static shapes:

    * **dual branch**: the overlap-add of ``nd``-long dual frames is a
      ``Tb = nd/hop``-tap feature conv over the coefficient sequence
      (``lax.conv_general_dilated``, [2K] -> [hop] features) — no
      [T, nd] frame tensor is ever materialized;
    * **sin branch**: per (frame, bin >= k_min) local magnitude peaks,
      frequency from one-hop phase advance with the harmonic number picked
      by candidate scoring (predicted-vs-observed log-magnitude ratios to
      the two neighbor bins through the window-spectrum table — spurious
      sidelobe peaks score badly and are gated out), amplitude calibrated
      by the same table, synthesized as hann bursts of ``2*hop`` OLA'd at
      50% (two-slab add).

    Measured at the framework default (hop 256 / 84 bins / 16 kHz, f64
    prototype): >= ~35 dB tone SNR at every bin center, 38-78 dB at
    quarter/half-bin offsets, 61 dB two-tone; the float32 figure is gated
    by the ``icqt_tone_snr_db`` validate row. Steady-state figures — edge
    transients span the dual support (``nd/2`` samples each side).
    """
    from ._mm import conv_precision

    if c.shape[-1] != n_bins:
        raise ValueError(
            f"expected [..., frames, {n_bins}] coefficients, got {c.shape}"
        )
    dz = _hybrid_design(
        sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale
    )
    nd, f0, k_dual, k_min = dz["nd"], dz["f0"], dz["k_dual"], dz["k_min"]
    n_frames = c.shape[-2]
    if length is None:
        length = (n_frames - 1) * hop
    prec = conv_precision(precision or DFT_PRECISION_DEFAULT)
    re = jnp.real(c).astype(jnp.float32)
    im = jnp.imag(c).astype(jnp.float32)
    lead = re.shape[:-2]
    # ---- dual branch: Tb-tap conv over the coefficient sequence
    ri = jnp.concatenate([re[..., :k_dual], im[..., :k_dual]], axis=-1)
    t_cosets = nd // hop
    lhs = ri.reshape(-1, n_frames, 2 * k_dual).transpose(0, 2, 1)  # [B, 2K, T]
    y_blk = jax.lax.conv_general_dilated(
        lhs,
        jnp.asarray(dz["kern"]),  # [hop(out), 2K(in), Tb(spatial)]
        window_strides=(1,),
        padding=[(t_cosets - 1, t_cosets - 1)],
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=prec,
    )  # [B, hop, T + Tb - 1]
    y = y_blk.transpose(0, 2, 1).reshape(lead + (-1,))  # OLA coords, len (T-1)h+nd
    # ---- sin branch
    mag = jnp.sqrt(re * re + im * im)
    gmax = jnp.max(mag, axis=(-2, -1), keepdims=True)
    neg = jnp.full(mag.shape[:-1] + (1,), -1.0, mag.dtype)
    padm = jnp.concatenate([neg, mag, neg], axis=-1)
    is_peak = (
        (mag > padm[..., :-2])
        & (mag >= padm[..., 2:])
        & (mag > mag_floor * gmax)
        & (jnp.arange(n_bins) >= k_min)
    )
    lm = jnp.log(jnp.maximum(mag, 1e-12))
    # one-hop phase advance in cycles/frame (real arithmetic; c_t conj(c_t-1))
    if n_frames > 1:
        pr = re[..., 1:, :] * re[..., :-1, :] + im[..., 1:, :] * im[..., :-1, :]
        pi = im[..., 1:, :] * re[..., :-1, :] - re[..., 1:, :] * im[..., :-1, :]
        dphi = jnp.arctan2(pi, pr) / (2.0 * np.pi)
        dphi = jnp.concatenate([dphi, dphi[..., -1:, :]], axis=-2)
    else:
        dphi = jnp.zeros_like(mag)
    freqs = jnp.asarray(dz["freqs"])
    lens = jnp.asarray(dz["lengths"])
    # closed-form window spectrum |W(u)|/W(0) from the cosine-sum fit —
    # elementwise sincs, NO table gather
    wcos = dz["wcos"]

    def h_of(u):
        acc = 0.0
        for j, aj in enumerate(wcos):
            acc = acc + (float(aj) / (2.0 * float(wcos[0]))) * (
                jnp.sinc(u - j) + jnp.sinc(u + j)
            )
        return jnp.maximum(jnp.abs(acc), 1e-7)

    fr_rate = sample_rate / hop
    m0 = jnp.round(freqs / fr_rate - dphi)
    offs = jnp.arange(-dz["n_cand"], dz["n_cand"] + 1, dtype=jnp.float32)
    f_cand = (m0[..., None] + offs + dphi[..., None]) * fr_rate  # [.., T, K, C]
    ks = np.arange(n_bins)
    k_lo, k_up = np.maximum(ks - 1, 0), np.minimum(ks + 1, n_bins - 1)

    def l_h(fc, idx):
        u = (fc - freqs[idx][:, None]) * lens[idx][:, None] / sample_rate
        return jnp.log(h_of(u))

    r_pred_lo = l_h(f_cand, ks) - l_h(f_cand, k_lo)
    r_pred_up = l_h(f_cand, ks) - l_h(f_cand, k_up)
    r_obs_lo = (lm - lm[..., k_lo])[..., None]
    r_obs_up = (lm - lm[..., k_up])[..., None]
    has_lo = jnp.asarray((ks > 0)[:, None], jnp.float32)
    has_up = jnp.asarray((ks < n_bins - 1)[:, None], jnp.float32)
    score = (
        has_lo * (r_pred_lo - r_obs_lo) ** 2
        + has_up * (r_pred_up - r_obs_up) ** 2
    )
    s_best = jnp.min(score, axis=-1)
    # first-minimum one-hot select instead of a take_along_axis gather
    hit = score == s_best[..., None]
    hit = hit & (jnp.cumsum(hit, axis=-1) == 1)
    f_hat = jnp.sum(jnp.where(hit, f_cand, 0.0), axis=-1)
    f_hat = jnp.clip(f_hat, 1.0, sample_rate / 2 - 1.0)
    u_best = (f_hat - freqs) * lens / sample_rate
    amp = mag / jnp.maximum(h_of(u_best), 0.1)
    lf_lo, lf_hi = np.log(dz["f_lo"]), np.log(dz["f_hi"])
    tt = jnp.clip((jnp.log(f_hat) - lf_lo) / (lf_hi - lf_lo), 0.0, 1.0)
    rho = 0.5 * (1.0 + jnp.cos(np.pi * tt))
    wgt = (1.0 - rho) * (s_best < score_gate) * is_peak * amp
    phase0 = jnp.arctan2(im, re)
    n_rel = jnp.arange(2 * hop, dtype=jnp.float32) - hop
    win = 0.5 - 0.5 * jnp.cos(2.0 * np.pi * jnp.arange(2 * hop) / (2 * hop))
    # top-P component selection: the burst cos over [.., T, K, 2h] is the
    # stage's hot spot; per frame only a handful of peaks
    # survive the score gate, so synthesize the `max_components` largest
    # weights only. EXACT whenever <= P components have wgt > 0 (every
    # tonal case — the transform's signal model); dense noise frames drop
    # their smallest components (their sin-branch output is documented
    # garbage either way, see the icqt docstring). Selection is iterative
    # first-max one-hot masking — no gathers, ties handled one per pass.
    p_sel = min(int(max_components), n_bins)
    cur = wgt
    sel = []
    for _ in range(p_sel):
        mx = jnp.max(cur, axis=-1, keepdims=True)
        hit = (cur == mx) & (mx > 0.0)
        hit = hit & (jnp.cumsum(hit, axis=-1) == 1)
        sel.append((
            jnp.sum(jnp.where(hit, cur, 0.0), axis=-1),
            jnp.sum(jnp.where(hit, f_hat, 0.0), axis=-1),
            jnp.sum(jnp.where(hit, phase0, 0.0), axis=-1),
        ))
        cur = jnp.where(hit, -1.0, cur)
    wgt_p = jnp.stack([s[0] for s in sel], axis=-1)  # [.., T, P]
    f_p = jnp.stack([s[1] for s in sel], axis=-1)
    ph0_p = jnp.stack([s[2] for s in sel], axis=-1)
    phase = (
        (2.0 * np.pi / sample_rate) * f_p[..., None] * n_rel + ph0_p[..., None]
    )  # [.., T, P, 2h]  (XLA fuses the reduction below; never materialized)
    burst = jnp.sum(wgt_p[..., None] * jnp.cos(phase), axis=-2) * win  # [.., T, 2h]
    # 50% OLA: true-coords block s = burst[s][h:] + burst[s+1][:h]
    half1, half2 = burst[..., :hop], burst[..., hop:]
    half1_next = jnp.concatenate(
        [half1[..., 1:, :], jnp.zeros_like(half1[..., :1, :])], axis=-2
    )
    y_sin = (half2 + half1_next).reshape(lead + (n_frames * hop,))
    # sin true coords start at 0 == OLA coord nd//2 (a hop multiple)
    y = y.at[..., nd // 2 : nd // 2 + n_frames * hop].add(y_sin)
    start = nd // 2 - (0 if center else f0 // 2)
    need = start + length
    if y.shape[-1] < need:
        pads = [(0, 0)] * (y.ndim - 1) + [(0, need - y.shape[-1])]
        y = jnp.pad(y, pads)
    return y[..., start:need]


# multirate designs: per-octave analysis + truncated dual banks (~8 MB at
# 84 bins / 16 kHz)
_MULTIRATE_CACHE = BoundedCache(maxsize=4)


def multirate_hops(
    sample_rate: float,
    hop: int = 256,
    n_bins: int = 84,
    fmin: float = FMIN_C1,
    bins_per_octave: int = 12,
    filter_scale: float = 1.0,
    top_divisor: int = 6,
) -> tuple[int, ...]:
    """Per-octave analysis hops of the multirate CQT: each octave's hop is
    the largest power-of-two division of ``hop`` inside that octave's
    painless bound ``h_o <= N_min_o // 3`` (:func:`icqt_max_hop` applied
    per octave — the shortest kernel IN the octave, not globally) — except
    the TOP octave, whose bound is ``N_min // 6`` (one extra halving):
    interior octaves' upper spectral skirts are covered by the octave
    above (their hop-alias images land where W is honest and cancel), but
    the top octave's skirt faces the uncovered band beyond the last bin,
    where W is regularization-floored while the duals' band mask is still
    open inside the mainlobe — at the N/3 hop a tone at bin 80 of the
    default config synthesized a clean alias image at f + sr/16 (measured
    16.5 dB round-trip; the tighter hop clears the skirt and a full 84-bin
    sweep reads >= ~54 dB).
    At the framework default (hop 256 / 84 bins / 16 kHz) the hops are
    ``(256, 256, 256, 128, 64, 32, 8)``."""
    from ..errors import AudioError, ErrorCode

    lengths = cqt_lengths(sample_rate, n_bins, fmin, bins_per_octave, filter_scale)
    n_oct = -(-n_bins // bins_per_octave)
    hops = []
    for o, lo in enumerate(range(0, n_bins, bins_per_octave)):
        hi = min(lo + bins_per_octave, n_bins)
        div = top_divisor if o == n_oct - 1 else 3
        bound = max(1, int(lengths[lo:hi].min()) // div)
        h = hop
        while h > bound:
            if h % 2:
                raise AudioError(
                    f"multirate CQT needs hop={hop} halvable down to the "
                    f"octave painless bound {bound} (odd factor hit at {h}); "
                    "use a power-of-two hop",
                    code=ErrorCode.CONFIG_VALIDATION_ERROR,
                )
            h //= 2
        hops.append(h)
    return tuple(hops)


def _multirate_design(
    sample_rate: float,
    hop: int,
    n_bins: int,
    fmin: float,
    bins_per_octave: int,
    window: str,
    filter_scale: float,
    eps: float = 1e-2,
    mask_db: float = 40.0,
):
    """Host-side design of the multirate CQT and its inverse (float64->f32).

    Forward: per octave o, a bank ``[flen_o, 2*nb_o]`` of cos|sin kernels
    (same kernels/normalization as :func:`cqt`) framed at the octave's own
    hop ``h_o`` (:func:`multirate_hops`), ``flen_o`` an ``h_o`` multiple so
    framing takes the static-slice fast path.

    Inverse: ONE joint painless diagonal dual with per-bin hop weighting —
    ``W(w) = sum_k (1/h_k)(|psi_hat_k(w)|^2 + |psi_hat_k(-w)|^2)``,
    ``d_hat_k = psi_hat_k * mask_k / max(W, eps*max W)`` (same band mask +
    regularization as :func:`_dual_design`, which this generalizes: at
    uniform hops the two designs coincide). Because every octave sits
    inside its own painless bound the formula is a true inverse for
    BROADBAND signals, not just tones — the f64 prototype at the framework
    default measures 60.0 dB on 800-2000 Hz band noise and 57.3 dB on a
    150 Hz harmonic complex, the two signals where the fixed-hop hybrid
    measured -10.1 dB / 7.9 dB.

    Each octave's dual is truncated to a centered span
    ``min(nd, max(4*flen_o, 32*h_o))`` with a raised-cosine edge taper over
    the outer half (the hard mask's sharp spectral edges make the full-nd
    duals ring ~1/t; tapered truncation at these spans measures >= 40 dB
    worst case, full-span low octaves unchanged) — this is what keeps the
    top octaves' synthesis cheap (the top octave frames 16x more often but
    its dual is 576 samples, not nd = 16896).

    Returns a dict: ``octs`` = [(h, flen, fwd_bank [flen, 2nb])], ``nd``,
    ``duals`` = [(lo0, bank [2nb, span])], ``hops``.
    """
    key = (
        sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale,
        eps, mask_db,
    )
    if key in _MULTIRATE_CACHE:
        return _MULTIRATE_CACHE[key]
    freqs = cqt_frequencies(n_bins, fmin, bins_per_octave)
    if freqs[-1] > sample_rate / 2:
        raise ValueError(
            f"top CQT bin {freqs[-1]:.1f} Hz exceeds Nyquist "
            f"{sample_rate / 2:.1f} Hz; reduce n_bins or raise fmin"
        )
    lengths = cqt_lengths(sample_rate, n_bins, fmin, bins_per_octave, filter_scale)
    hops = multirate_hops(
        sample_rate, hop, n_bins, fmin, bins_per_octave, filter_scale
    )
    octs = []  # (h, flen, cos [flen, nb], sin [flen, nb]) in float64
    for o, lo in enumerate(range(0, n_bins, bins_per_octave)):
        hi = min(lo + bins_per_octave, n_bins)
        h = hops[o]
        n_max = int(lengths[lo:hi].max())
        flen = h * -(-(n_max + 1) // h)
        cos_b = np.zeros((flen, hi - lo))
        sin_b = np.zeros((flen, hi - lo))
        for j, k in enumerate(range(lo, hi)):
            nk = int(lengths[k])
            w = get_window(window, nk, periodic=False).astype(np.float64)
            t = (np.arange(nk, dtype=np.float64) - (nk - 1) / 2.0) / sample_rate
            ang = 2.0 * np.pi * freqs[k] * t
            g = 2.0 / w.sum()
            start = flen // 2 - (nk - 1) // 2
            cos_b[start : start + nk, j] = g * w * np.cos(ang)
            sin_b[start : start + nk, j] = -g * w * np.sin(ang)
        octs.append((h, flen, cos_b, sin_b))
    nd = octs[0][1] * 2
    # joint frame response with per-bin hop weighting. TWO weightings: the
    # division uses the TRUE hops; the regularization floor is referenced
    # to the PAINLESS (N/3) hops — the top octave's extra halving (skirt
    # aliasing, see multirate_hops) doubles W's peak, and a floor tracking
    # that rescale over-regularizes the fmin band edge (bin 0 measured
    # 40.5 dB at the N/3-referenced floor vs 23.4 dB tracking the
    # tightened hop, in a float64 design study).
    ref_hops = multirate_hops(
        sample_rate, hop, n_bins, fmin, bins_per_octave, filter_scale,
        top_divisor=3,
    )
    w_pos = np.zeros(nd)
    w_ref = np.zeros(nd)
    phs = []
    for (h, flen, cos_b, sin_b), h_ref in zip(octs, ref_hops):
        psi = cos_b.T - 1j * sin_b.T  # [nb, flen]; psi = g w exp(i ang)
        psi_p = np.zeros((psi.shape[0], nd), complex)
        off = nd // 2 - flen // 2
        psi_p[:, off : off + flen] = psi
        ph = np.fft.fft(psi_p, axis=1)
        phs.append(ph)
        e2 = (np.abs(ph) ** 2).sum(0)
        w_pos += e2 / h
        w_ref += e2 / h_ref
    w_neg = np.empty_like(w_pos)
    w_neg[0] = w_pos[0]
    w_neg[1:] = w_pos[1:][::-1]
    w_tot = w_pos + w_neg
    w_ref_tot = w_ref.copy()
    w_ref_tot[1:] += w_ref[1:][::-1]
    w_ref_tot[0] += w_ref[0]
    floor = eps * w_ref_tot.max()
    duals = []
    for (h, flen, _cb, _sb), ph in zip(octs, phs):
        amp = np.abs(ph)
        mask = amp >= amp.max(axis=1, keepdims=True) * 10.0 ** (-mask_db / 20.0)
        d_hat = ph * mask / np.maximum(w_tot, floor)[None, :]
        d = np.fft.ifft(d_hat, axis=1)
        bank = np.concatenate([2.0 * d.real, -2.0 * d.imag], axis=0)  # [2nb, nd]
        span = min(nd, max(4 * flen, 32 * h))
        span = h * -(-span // h)
        lo0 = nd // 2 - span // 2
        sub = bank[:, lo0 : lo0 + span]
        if span < nd:  # raised-cosine edge taper over the outer half
            t = np.abs(np.arange(span) - (span - 1) / 2.0)
            u = np.clip((t - span / 4.0) / (span / 4.0), 0.0, 1.0)
            sub = sub * (0.5 * (1.0 + np.cos(np.pi * u)))[None, :]
        # synthesis as a Tb-tap hop-block feature conv (the _hybrid_design
        # kern trick): y_blk[S, r] = sum_q ri[S-q] @ sub[:, q*h + r] — no
        # [T_o, span] frame tensor is materialized
        tb = span // h
        nb2 = sub.shape[0]
        kern = sub.reshape(nb2, tb, h)[:, ::-1, :]
        kern = np.ascontiguousarray(np.transpose(kern, (2, 0, 1)))  # [h, 2nb, Tb]
        duals.append((lo0, sub.astype(np.float32), kern.astype(np.float32)))
    fwd = [
        (h, flen, np.concatenate([cb, sb], axis=1).astype(np.float32))
        for h, flen, cb, sb in octs
    ]
    out = dict(octs=fwd, nd=nd, duals=duals, hops=hops)
    _MULTIRATE_CACHE[key] = out
    return out


class _MrMeta:
    """Hashable static metadata of a :class:`MultirateCqt` (pytree aux)."""

    __slots__ = ("sample_rate", "hop", "n_bins", "fmin", "bins_per_octave",
                 "window", "filter_scale", "hops", "length")

    def __init__(self, sample_rate, hop, n_bins, fmin, bins_per_octave,
                 window, filter_scale, hops, length):
        self.sample_rate = sample_rate
        self.hop = hop
        self.n_bins = n_bins
        self.fmin = fmin
        self.bins_per_octave = bins_per_octave
        self.window = window
        self.filter_scale = filter_scale
        self.hops = tuple(hops)
        self.length = length  # the forward's input sample count (static)

    def _key(self):
        return (self.sample_rate, self.hop, self.n_bins, self.fmin,
                self.bins_per_octave, self.window, self.filter_scale,
                self.hops, self.length)

    def __eq__(self, other):
        return isinstance(other, _MrMeta) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"_MrMeta{self._key()!r}"


@jax.tree_util.register_pytree_node_class
class MultirateCqt:
    """Multirate CQT coefficients: one array per octave, each at its own
    analysis hop (``meta.hops``) — octave o is ``[..., T_o, nb_o]`` with
    ``T_o = T // hops[o] + 1`` frames centered at ``t * hops[o]``.

    A registered pytree (jit in/out transparent). ``to_grid()`` resamples
    onto the common-hop frame grid for analysis use; :func:`icqt` /
    :func:`icqt_multirate` invert it exactly in the painless sense (see
    :func:`_multirate_design` for measured broadband figures)."""

    __slots__ = ("octaves", "meta")

    def __init__(self, octaves, meta: _MrMeta):
        self.octaves = tuple(octaves)
        self.meta = meta

    def tree_flatten(self):
        return self.octaves, self.meta

    @classmethod
    def tree_unflatten(cls, meta, children):
        return cls(tuple(children), meta)

    @property
    def hops(self) -> tuple[int, ...]:
        return self.meta.hops

    def to_grid(self) -> jnp.ndarray:
        """Fold onto the common ``meta.hop`` grid: stride-sample each octave
        (every ``hop // hops[o]``-th frame — exact, the grids nest) and
        concatenate bins -> ``[..., n_frames, n_bins]``, frame t centered at
        ``t * hop`` like :func:`cqt`. Lossy for inversion (use the octaves
        themselves); exact for analysis at the common frame rate."""
        hop = self.meta.hop
        strides = [hop // h for h in self.meta.hops]
        n = min(
            (c.shape[-2] - 1) // s + 1
            for c, s in zip(self.octaves, strides)
        )
        parts = [
            c[..., ::s, :][..., :n, :] for c, s in zip(self.octaves, strides)
        ]
        return jnp.concatenate(parts, axis=-1)


def cqt_multirate(
    x: jnp.ndarray,
    sample_rate: float,
    hop: int = 256,
    n_bins: int = 84,
    fmin: float = FMIN_C1,
    bins_per_octave: int = 12,
    window: str = "hann",
    filter_scale: float = 1.0,
    output: str = "complex",
    precision: str | None = None,
) -> MultirateCqt:
    """Invertible multirate CQT: every octave analyzed
    at its own hop inside its painless bound (:func:`multirate_hops`), so
    — unlike the fixed-hop :func:`cqt` at coarse hops — the transform has a
    TRUE linear inverse for arbitrary in-band signals, gated broadband by
    the ``icqt_multirate_noise_snr_db`` validate row (design figures in
    :func:`_multirate_design`). Same kernels, normalization, and center
    geometry as :func:`cqt` (center=True only; octave o's frame t is
    centered at ``t * hops[o]``).

    Returns a :class:`MultirateCqt` pytree; ``output`` "complex" (default —
    required for inversion) | "magnitude" | "power" applies per octave.
    The reference app has no CQT (SURVEY: analysis stops at VAD energy);
    this completes the cqt family with an inversion-grade analysis mode.
    """
    if output not in ("magnitude", "power", "complex"):
        raise ValueError(
            f"unknown cqt output {output!r}; known: magnitude, power, complex"
        )
    dz = _multirate_design(
        sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale
    )
    prec = precision or DFT_PRECISION_DEFAULT
    t = x.shape[-1]
    outs = []
    for h, flen, bank in dz["octs"]:
        half = flen // 2
        pads = [(0, 0)] * (x.ndim - 1) + [(half, flen - half)]
        xp = jnp.pad(x, pads)
        n_frames = t // h + 1
        fr = frame(xp, flen, h)[..., :n_frames, :]
        y = mm(fr, jnp.asarray(bank), prec)
        nb = bank.shape[1] // 2
        re, im = y[..., :nb], y[..., nb:]
        if output == "complex":
            outs.append(jax.lax.complex(re, im))
        else:
            p = re * re + im * im
            outs.append(jnp.sqrt(p) if output == "magnitude" else p)
    meta = _MrMeta(
        sample_rate, hop, n_bins, fmin, bins_per_octave, window, filter_scale,
        dz["hops"], t,
    )
    return MultirateCqt(outs, meta)


def icqt_multirate(
    c: MultirateCqt,
    length: int | None = None,
    precision: str | None = None,
) -> jnp.ndarray:
    """Inverse of :func:`cqt_multirate` (complex output): per-octave
    synthesis dot against the truncated joint duals + overlap-add at each
    octave's own hop, summed — a true painless inverse, broadband (see
    :func:`_multirate_design`; 57-68 dB design SNR on noise bands,
    harmonic complexes, and bin-center tones at the framework default
    where the fixed-hop hybrid only reconstructs tones).

    ``length`` defaults to the forward's exact input sample count (carried
    in the pytree's static meta). Edge transients span ``nd/2`` samples
    each side.
    """
    from ._mm import conv_precision

    if not isinstance(c, MultirateCqt):
        raise TypeError(
            f"icqt_multirate takes a MultirateCqt (cqt_multirate output), "
            f"got {type(c).__name__}"
        )
    if not jnp.iscomplexobj(c.octaves[0]):
        raise ValueError(
            "icqt_multirate needs complex coefficients "
            "(cqt_multirate(..., output='complex'))"
        )
    m = c.meta
    dz = _multirate_design(
        m.sample_rate, m.hop, m.n_bins, m.fmin, m.bins_per_octave, m.window,
        m.filter_scale,
    )
    prec = conv_precision(precision or DFT_PRECISION_DEFAULT)
    if length is None:
        length = m.length
    y = None
    for (h, _flen, _bank), (_lo0, dual, kern), co in zip(
        dz["octs"], dz["duals"], c.octaves
    ):
        span = dual.shape[1]
        tb = span // h
        ri = jnp.concatenate([jnp.real(co), jnp.imag(co)], axis=-1)
        lead = ri.shape[:-2]
        t_o = ri.shape[-2]
        # hop-block feature conv (see _multirate_design): OLA coord i of the
        # result <-> output sample i - span//2 (frame t's dual is centered
        # at t*h for center=True)
        lhs = ri.reshape(-1, t_o, ri.shape[-1]).transpose(0, 2, 1)
        y_blk = jax.lax.conv_general_dilated(
            lhs,
            jnp.asarray(kern),  # [h(out), 2nb(in), Tb(spatial)]
            window_strides=(1,),
            padding=[(tb - 1, tb - 1)],
            dimension_numbers=("NCH", "OIH", "NCH"),
            precision=prec,
        )  # [B, h, T_o + Tb - 1]
        ola = y_blk.transpose(0, 2, 1).reshape(lead + (-1,))
        seg = ola[..., span // 2 :]
        if seg.shape[-1] < length:
            pads = [(0, 0)] * (seg.ndim - 1) + [(0, length - seg.shape[-1])]
            seg = jnp.pad(seg, pads)
        seg = seg[..., :length]
        y = seg if y is None else y + seg
    return y


def chroma_cqt(
    x: jnp.ndarray,
    sample_rate: float,
    hop: int = 256,
    n_octaves: int = 7,
    fmin: float = FMIN_C1,
    bins_per_octave: int = 12,
    norm: bool = True,
    **kwargs,
) -> jnp.ndarray:
    """Pitch-class chromagram folded from the constant-Q transform
    ``[..., n_frames, 12]`` — octave-robust chroma (every octave of a pitch
    class contributes to the same bin, unlike the STFT chroma filterbank
    whose triangular weights blur at low frequencies).

    ``bins_per_octave`` must be a multiple of 12; sub-semitone bins fold
    into their nearest pitch class. ``norm=True`` L-inf-normalizes each
    frame (librosa convention); extra kwargs pass through to :func:`cqt`.
    """
    if bins_per_octave % 12:
        raise ValueError(f"bins_per_octave must be a multiple of 12, got {bins_per_octave}")
    n_bins = n_octaves * bins_per_octave
    c = cqt(x, sample_rate, hop, n_bins, fmin, bins_per_octave, **kwargs)
    # fold octaves: [..., F, n_octaves, bins_per_octave] summed over octaves
    folded = c.reshape(*c.shape[:-1], n_octaves, bins_per_octave).sum(axis=-2)
    if bins_per_octave > 12:
        sub = bins_per_octave // 12
        folded = folded.reshape(*folded.shape[:-1], 12, sub).sum(axis=-1)
    if norm:
        folded = folded / jnp.maximum(
            folded.max(axis=-1, keepdims=True), 1e-10
        )
    return folded
