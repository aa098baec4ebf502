"""Frame-level spectral/time-domain descriptors.

The classic analysis feature family (librosa conventions, so outputs are
oracle-checkable): spectral centroid / bandwidth / rolloff / flatness /
flux, zero-crossing rate, frame RMS. All are cheap reductions over a
spectrogram already produced — XLA fuses them into the spectrogram
consumer, so a features tap costs almost nothing on top of a log-mel
pipeline.

Spectral inputs are magnitude (not power) spectrograms ``[..., F, bins]``
unless noted; time-domain inputs are signals ``[..., T]``. The reference app
computes only VAD energy (vad.rs:157-176); these extend the same
"per-frame descriptor" idea to the standard analysis set.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from .framing import frame


def fft_frequencies(sample_rate: float, n_fft: int) -> np.ndarray:
    """Bin center frequencies [n_fft//2 + 1] (host-side, f64)."""
    return np.arange(n_fft // 2 + 1, dtype=np.float64) * sample_rate / n_fft


def spectral_centroid(
    mag: jnp.ndarray, sample_rate: float, n_fft: int, eps: float = 1e-10
) -> jnp.ndarray:
    """First spectral moment per frame, Hz ``[..., F]``."""
    f = jnp.asarray(fft_frequencies(sample_rate, n_fft), mag.dtype)
    norm = jnp.maximum(mag.sum(axis=-1), eps)
    return (mag * f).sum(axis=-1) / norm


def spectral_bandwidth(
    mag: jnp.ndarray, sample_rate: float, n_fft: int, p: float = 2.0, eps: float = 1e-10
) -> jnp.ndarray:
    """p-th order spectral moment about the centroid, Hz ``[..., F]``."""
    f = jnp.asarray(fft_frequencies(sample_rate, n_fft), mag.dtype)
    c = spectral_centroid(mag, sample_rate, n_fft, eps)
    norm = jnp.maximum(mag.sum(axis=-1), eps)
    dev = jnp.abs(f - c[..., None]) ** p
    return ((mag * dev).sum(axis=-1) / norm) ** (1.0 / p)


def spectral_rolloff(
    mag: jnp.ndarray, sample_rate: float, n_fft: int, roll_percent: float = 0.85
) -> jnp.ndarray:
    """Frequency below which ``roll_percent`` of spectral energy lies,
    Hz ``[..., F]`` (lowest bin whose cumulative magnitude crosses the
    threshold — librosa's definition)."""
    f = jnp.asarray(fft_frequencies(sample_rate, n_fft), mag.dtype)
    cum = jnp.cumsum(mag, axis=-1)
    thresh = roll_percent * cum[..., -1:]
    hit = cum >= thresh  # monotone: first True stays True
    # index of first crossing = argmax over the boolean mask
    idx = jnp.argmax(hit, axis=-1)
    return f[idx]


def spectral_flatness(mag: jnp.ndarray, eps: float = 1e-10, power: float = 2.0) -> jnp.ndarray:
    """Geometric/arithmetic mean ratio of the power spectrum, ``[..., F]``
    in (0, 1]; 1 = white noise, -> 0 = pure tone. ``power=2`` matches
    librosa (flatness of ``mag**2``)."""
    s = jnp.maximum(mag, eps) ** power
    gmean = jnp.exp(jnp.mean(jnp.log(s), axis=-1))
    amean = jnp.mean(s, axis=-1)
    return gmean / amean


def spectral_flux(
    mag: jnp.ndarray,
    norm: bool = True,
    rectify: bool = False,
    prev: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """L2 distance between consecutive frames ``[..., F]`` (frame 0 fluxes
    against itself = 0). ``rectify=True`` keeps only increases (the onset-
    detection convention); ``norm`` L1-normalizes each frame first so flux
    measures shape change, not level change. ``prev [..., 1, bins]`` gives
    frame -1 for chunked processing (pass the previous chunk's last frame
    so chunk boundaries flux correctly)."""
    if norm:
        mag = mag / jnp.maximum(mag.sum(axis=-1, keepdims=True), 1e-10)
    if prev is None:
        head = mag[..., :1, :]
    else:
        head = prev / jnp.maximum(prev.sum(axis=-1, keepdims=True), 1e-10) if norm else prev
    prev = jnp.concatenate([head, mag[..., :-1, :]], axis=-2)
    d = mag - prev
    if rectify:
        d = jnp.maximum(d, 0.0)
    return jnp.sqrt(jnp.sum(d * d, axis=-1))


def zero_crossing_rate(x: jnp.ndarray, frame_length: int = 2048, hop: int = 512) -> jnp.ndarray:
    """Fraction of sign changes per frame ``[..., F]`` (librosa convention:
    zero counts as positive side via >= 0)."""
    fr = frame(x, frame_length, hop)
    pos = fr >= 0.0
    changes = pos[..., 1:] != pos[..., :-1]
    return changes.mean(axis=-1)


def frame_rms(x: jnp.ndarray, frame_length: int = 2048, hop: int = 512) -> jnp.ndarray:
    """Root-mean-square level per frame ``[..., F]`` (true RMS, with sqrt —
    unlike the reference VAD's mean-square 'RMS', ops/vad.py)."""
    fr = frame(x, frame_length, hop)
    return jnp.sqrt(jnp.mean(fr * fr, axis=-1))


def chroma_filterbank(
    sample_rate: float,
    n_fft: int,
    n_chroma: int = 12,
    tuning: float = 0.0,
    ctroct: float = 5.0,
    octwidth: float = 2.0,
    base_c: bool = True,
) -> np.ndarray:
    """Chroma (pitch-class) filterbank ``[n_freqs, n_chroma]``, matmul-ready.

    librosa.filters.chroma conventions (Gaussian bleed across fractional
    pitch classes, per-bin L2 normalization, Gaussian octave weighting
    centered at ``ctroct``, C-based class ordering), built host-side in
    float64 like the mel bank.
    """
    freqs = np.linspace(0, sample_rate, n_fft, endpoint=False)[1:]
    a440 = 440.0 * 2.0 ** (tuning / n_chroma)
    frqbins = n_chroma * np.log2(freqs / (a440 / 16.0))
    frqbins = np.concatenate(([frqbins[0] - 1.5 * n_chroma], frqbins))
    binwidth = np.concatenate((np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1.0]))
    d = np.subtract.outer(frqbins, np.arange(n_chroma, dtype=np.float64)).T  # [C, n_fft]
    half = round(n_chroma / 2)
    d = np.remainder(d + half + 10 * n_chroma, n_chroma) - half
    wts = np.exp(-0.5 * (2 * d / np.tile(binwidth, (n_chroma, 1))) ** 2)
    wts /= np.maximum(np.sqrt((wts**2).sum(axis=0)), 1e-10)  # per-bin L2
    if octwidth:
        wts *= np.tile(
            np.exp(-0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2)),
            (n_chroma, 1),
        )
    if base_c:
        wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)
    return np.ascontiguousarray(wts[:, : n_fft // 2 + 1].T.astype(np.float32))


def chroma(
    power_spec: jnp.ndarray,
    sample_rate: float,
    n_fft: int,
    n_chroma: int = 12,
    norm: bool = True,
    tuning: float = 0.0,
) -> jnp.ndarray:
    """Chromagram from a power spectrogram ``[..., F, bins]`` ->
    ``[..., F, n_chroma]`` (one matmul + optional per-frame max-norm,
    the librosa.feature.chroma_stft convention)."""
    from ._mm import mm

    fb = chroma_filterbank(sample_rate, n_fft, n_chroma, tuning)
    c = mm(power_spec, jnp.asarray(fb))
    if norm:
        c = c / jnp.maximum(c.max(axis=-1, keepdims=True), 1e-10)
    return c


def delta(feats: jnp.ndarray, width: int = 9, order: int = 1) -> jnp.ndarray:
    """Kaldi/HTK-style regression deltas along the time axis (-2).

    ``d[t] = sum_{n=1..N} n * (c[t+n] - c[t-n]) / (2 * sum n^2)`` with
    edge-replicated padding, ``N = width // 2``; ``order=2`` gives
    delta-deltas (the regression applied twice). Expressed as one FIR
    conv along time — static weights, fuses into the feature pipeline.
    """
    if width < 3 or width % 2 != 1:
        raise ValueError(f"width must be odd and >= 3, got {width}")
    if order < 1:
        raise ValueError("order must be >= 1")
    n = width // 2
    taps = np.arange(-n, n + 1, dtype=np.float64)
    taps = taps / (2.0 * np.sum(np.arange(1, n + 1, dtype=np.float64) ** 2))
    w = jnp.asarray(taps.astype(np.float32))
    out = feats
    for _ in range(order):
        m = jnp.moveaxis(out, -2, -1)  # [..., F, T]
        pads = [(0, 0)] * (m.ndim - 1) + [(n, n)]
        mp = jnp.pad(m, pads, mode="edge")
        win = frame(mp, width, 1)  # [..., F, T, width]
        out = jnp.moveaxis((win * w).sum(axis=-1), -1, -2)
    return out


def add_deltas(feats: jnp.ndarray, width: int = 9, orders: tuple[int, ...] = (1, 2)) -> jnp.ndarray:
    """Concatenate base features with their deltas along the feature axis
    (the standard ASR [static, delta, delta-delta] layout)."""
    cols = [feats] + [delta(feats, width, o) for o in orders]
    return jnp.concatenate(cols, axis=-1)


def pcen_smoother(
    energy: jnp.ndarray,
    smooth: float,
    m_prev: jnp.ndarray | None = None,
    first_index=None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """The PCEN time smoother ``M[t] = (1-s) M[t-1] + s E[t]`` as an affine
    associative scan (O(log T) depth). Returns ``(M, M[last])``.

    ``m_prev [..., F]`` carries M across chunks (None = offline: seed so
    that M[0] == E[0], the standard warm start). ``first_index`` (traced
    int, chunk-relative time index of the stream's offline frame 0) reseeds
    M = E at that frame, reproducing the offline warm start mid-stream —
    the same position-dependent-edge mechanism as Preemphasis
    (graph/nodes.py ``wants_first_index``).
    """
    import jax

    s = float(smooth)
    e_t = jnp.moveaxis(energy, -2, 0)  # [T, ..., F]
    a = jnp.full_like(e_t, 1.0 - s)
    b = s * e_t
    if m_prev is None:
        # offline warm start: M[0] = (1-s) E[0] + s E[0] = E[0]
        b = b.at[0].add((1.0 - s) * e_t[0])
    else:
        b = b.at[0].add((1.0 - s) * m_prev)
    a = a.at[0].set(0.0)
    if first_index is not None:
        shape = [-1] + [1] * (e_t.ndim - 1)
        mask = (jnp.arange(e_t.shape[0]) == first_index).reshape(shape)
        a = jnp.where(mask, 0.0, a)
        b = jnp.where(mask, e_t, b)

    def compose(l, rgt):
        al, bl = l
        ar, br = rgt
        return al * ar, br + ar * bl

    _, m = jax.lax.associative_scan(compose, (a, b), axis=0)
    return jnp.moveaxis(m, 0, -2), m[-1]


def pcen(
    energy: jnp.ndarray,
    smooth: float = 0.025,
    alpha: float = 0.98,
    delta_bias: float = 2.0,
    r: float = 0.5,
    eps: float = 1e-6,
    initial: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Per-channel energy normalization (Wang et al., 2017) of a mel/linear
    energy spectrogram ``[..., T, F]``.

    ``M[t] = (1-s) M[t-1] + s E[t]`` (first-order IIR along time, evaluated
    as an associative scan — O(log T) depth), then
    ``PCEN = (E / (eps + M)^alpha + delta)^r - delta^r``. ``initial`` seeds
    M[-1] (defaults to the E[0] warm start that avoids the transient of a
    zero seed).
    """
    m, _ = pcen_smoother(energy, smooth, m_prev=initial, first_index=None)
    return (energy / (eps + m) ** alpha + delta_bias) ** r - delta_bias**r


def contrast_bands(
    sample_rate: float, n_fft: int, n_bands: int = 6, fmin: float = 200.0
) -> list[tuple[int, int]]:
    """Octave sub-band bin ranges for spectral contrast (host-side).

    Band 0 is [0, fmin); band k >= 1 is [fmin*2^(k-1), fmin*2^k); the top
    band extends to Nyquist. Returns ``n_bands + 1`` half-open contiguous
    ``(lo, hi)`` bin index ranges covering all ``n_fft//2 + 1`` bins."""
    freqs = fft_frequencies(sample_rate, n_fft)
    edges = fmin * 2.0 ** np.arange(0, n_bands + 1, dtype=np.float64)
    if edges[-2] >= sample_rate / 2:
        raise ValueError(
            f"top contrast band start {edges[-2]:.0f} Hz >= Nyquist "
            f"{sample_rate / 2:.0f} Hz; lower n_bands or fmin"
        )
    bounds = [0] + [int(np.searchsorted(freqs, e)) for e in edges]
    bounds[-1] = len(freqs)  # top band always extends to Nyquist
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi <= lo:
            raise ValueError(
                f"empty contrast sub-band [{lo},{hi}); n_fft={n_fft} too "
                f"small for n_bands={n_bands}, fmin={fmin}"
            )
        out.append((lo, hi))
    return out


def spectral_contrast(
    mag: jnp.ndarray,
    sample_rate: float,
    n_fft: int,
    n_bands: int = 6,
    fmin: float = 200.0,
    quantile: float = 0.02,
    eps: float = 1e-10,
) -> jnp.ndarray:
    """Octave-band spectral contrast ``[..., F, n_bands + 1]`` in dB:
    ``20*log10(peak/valley)`` per sub-band, where peak/valley are the means
    of the top/bottom ``quantile`` fraction of magnitude bins in the band
    (at least one bin). The peak-vs-valley-per-octave design follows
    Jiang et al. 2002 (the librosa feature); sub-bands are contiguous bin
    ranges, so each band is one static slice + small sort — the band loop
    unrolls at trace time.
    """
    bands = contrast_bands(sample_rate, n_fft, n_bands, fmin)
    cols = []
    for lo, hi in bands:
        sub = jnp.sort(mag[..., lo:hi], axis=-1)
        k = max(int(round(quantile * (hi - lo))), 1)
        valley = sub[..., :k].mean(axis=-1)
        peak = sub[..., hi - lo - k :].mean(axis=-1)
        cols.append(20.0 * (jnp.log10(peak + eps) - jnp.log10(valley + eps)))
    return jnp.stack(cols, axis=-1)


def tonnetz_basis(n_chroma: int = 12) -> np.ndarray:
    """Tonal-centroid projection basis ``[n_chroma, 6]`` (host-side, f64).

    Harte/Sandler 2006 tonnetz: three circles — fifths (r=7 semitone step),
    minor thirds (r=3), major thirds (r=4) — each contributing a (sin, cos)
    pair, with radii (1, 1, 0.5)."""
    dim = np.linspace(0, 12, num=n_chroma, endpoint=False)
    scale = np.array([7.0 / 6, 7.0 / 6, 3.0 / 2, 3.0 / 2, 2.0 / 3, 2.0 / 3])
    v = np.multiply.outer(scale, dim)  # [6, n_chroma]
    v[::2] -= 0.5  # sin rows lead cos rows by a quarter turn
    radii = np.array([1.0, 1.0, 1.0, 1.0, 0.5, 0.5])
    return np.ascontiguousarray((radii[:, None] * np.cos(np.pi * v)).T)


def tonnetz(chroma_frames: jnp.ndarray, eps: float = 1e-10) -> jnp.ndarray:
    """Tonal centroid features ``[..., F, 6]`` from a chromagram
    ``[..., F, n_chroma]``: L1-normalize each frame, project onto the
    fifths/minor-third/major-third circles (one tiny matmul)."""
    from ._mm import mm

    basis = jnp.asarray(tonnetz_basis(chroma_frames.shape[-1]).astype(np.float32))
    c = chroma_frames / jnp.maximum(
        jnp.abs(chroma_frames).sum(axis=-1, keepdims=True), eps
    )
    return mm(c, basis)


_FEATURES = ("centroid", "bandwidth", "rolloff", "flatness", "flux")


def spectral_features(
    mag: jnp.ndarray,
    sample_rate: float,
    n_fft: int,
    features: tuple[str, ...] = _FEATURES,
) -> jnp.ndarray:
    """Stack named spectral descriptors -> ``[..., F, len(features)]``.

    One fused elementwise/reduction pass over a magnitude spectrogram;
    the feature axis ordering follows ``features``.
    """
    cols = []
    for name in features:
        if name == "centroid":
            cols.append(spectral_centroid(mag, sample_rate, n_fft))
        elif name == "bandwidth":
            cols.append(spectral_bandwidth(mag, sample_rate, n_fft))
        elif name == "rolloff":
            cols.append(spectral_rolloff(mag, sample_rate, n_fft))
        elif name == "flatness":
            cols.append(spectral_flatness(mag))
        elif name == "flux":
            cols.append(spectral_flux(mag))
        else:
            raise ValueError(f"unknown spectral feature {name!r}; known: {_FEATURES}")
    return jnp.stack(cols, axis=-1)


def stack_memory(feats: jnp.ndarray, n_steps: int = 2, delay: int = 1) -> jnp.ndarray:
    """Time-lagged feature stacking ``[..., T, F] -> [..., T, F * n_steps]``:
    the feature vector concatenated with its ``delay``-frame history
    (zero-padded at the edge) — short-term memory for frame classifiers.
    ``delay`` may be negative for lookahead stacking."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if delay == 0:
        raise ValueError("delay must be nonzero")
    feats = jnp.asarray(feats)
    t = feats.shape[-2]
    outs = [feats]
    for k in range(1, n_steps):
        d = k * delay
        pads = [(0, 0)] * (feats.ndim - 2)
        if abs(d) >= t:  # lag past the clip: the whole copy is edge fill
            shifted = jnp.zeros_like(feats)
        elif d > 0:
            shifted = jnp.pad(feats[..., : t - d, :], pads + [(d, 0), (0, 0)])
        else:
            shifted = jnp.pad(feats[..., -d:, :], pads + [(0, -d), (0, 0)])
        outs.append(shifted)
    return jnp.concatenate(outs, axis=-1)
