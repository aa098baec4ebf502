"""Spectral decomposition effects: HPSS and spectral-gate denoising.

Harmonic/percussive source separation (Fitzgerald 2010, the librosa
convention): median-filter the power spectrogram along time (harmonic
ridges) and along frequency (percussive spikes), build p-power Wiener soft
masks, apply to the complex STFT, resynthesize. The median filters are the
only non-matmul work: they lower to sliding-window sorts (VPU), everything
else rides the existing matmul-DFT STFT/ISTFT.

Spectral gating (the classic "noisereduce" denoiser): estimate a per-bin
noise floor (from a noise clip, or the quietest frames of the signal
itself), threshold the magnitude spectrogram above it, smooth the
binary decision over time/frequency into a soft mask, and attenuate.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp

from .framing import frame
from .stft import istft, stft


@functools.lru_cache(maxsize=64)
def median_network(n: int) -> tuple[tuple[int, int], ...]:
    """Comparator schedule that routes the median of ``n`` values to wire
    ``n // 2``.

    Built from an odd-even transposition sort (n passes of adjacent
    compare-exchanges — correct for any n by the 0-1 principle), then
    dead-code-eliminated backwards from the single output wire we read:
    a comparator whose two output wires feed nothing downstream is dropped.
    For n=17 this keeps 79 of the 136 comparators. Each comparator lowers
    to one ``minimum`` + one ``maximum`` on whole arrays, so the filter is
    a pure elementwise chain over shifted views that XLA fuses into one
    pass — no ``[..., N, size]`` window tensor, no sort (the sort-based
    form materializes size× the input in device memory both ways)."""
    comps = []
    for p in range(n):
        for i in range(p % 2, n - 1, 2):
            comps.append((i, i + 1))
    needed = {n // 2}
    kept: list[tuple[int, int]] = []
    for i, j in reversed(comps):
        if i in needed or j in needed:
            kept.append((i, j))
            needed.add(i)
            needed.add(j)
    return tuple(reversed(kept))


def median_filter(
    x: jnp.ndarray, size: int, axis: int = -1, impl: str = "auto"
) -> jnp.ndarray:
    """Sliding-window median along ``axis`` (odd ``size``), reflect-padded —
    matches scipy.ndimage.median_filter(mode='reflect') on that axis.

    ``impl``: "network" (default for size <= 33) computes the median with a
    pruned min/max comparator network over ``size`` shifted slices — a fused
    elementwise pass; "sort" materializes ``[..., N, size]`` windows and
    sorts (O(size log size) per element, kept for large windows where the
    O(size^2) network no longer pays).
    """
    if size % 2 != 1 or size < 1:
        raise ValueError(f"median size must be odd and >= 1, got {size}")
    if impl not in ("auto", "network", "sort"):
        raise ValueError(f"median impl must be auto|network|sort, got {impl!r}")
    if size == 1:
        return x
    x = jnp.moveaxis(x, axis, -1)
    h = size // 2
    pads = [(0, 0)] * (x.ndim - 1) + [(h, h)]
    # scipy.ndimage's 'reflect' includes the edge sample (a b c -> b a|a b c)
    # — that's numpy/jnp 'symmetric', not jnp 'reflect'
    xp = jnp.pad(x, pads, mode="symmetric")
    n = x.shape[-1]
    if impl == "network" or (impl == "auto" and size <= 33):
        vals = [xp[..., k : k + n] for k in range(size)]
        for i, j in median_network(size):
            lo = jnp.minimum(vals[i], vals[j])
            vals[j] = jnp.maximum(vals[i], vals[j])
            vals[i] = lo
        med = vals[h]
    else:
        win = frame(xp, size, 1)  # [..., N, size]
        med = jnp.sort(win, axis=-1)[..., h]
    return jnp.moveaxis(med, -1, axis)


def hpss_mask(
    power_spec: jnp.ndarray,
    kernel_time: int = 17,
    kernel_freq: int = 17,
    power: float = 2.0,
    margin: float = 1.0,
    eps: float = 1e-10,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Soft harmonic/percussive masks for a power spectrogram
    ``[..., T, F]`` (time axis -2, frequency axis -1).

    ``power`` is the Wiener exponent (2 = power-spectrogram Wiener masks);
    ``margin`` > 1 sharpens the split (librosa's margin semantics: a
    component must beat the other by the margin factor to claim energy).
    """
    harm = median_filter(power_spec, kernel_time, axis=-2)
    perc = median_filter(power_spec, kernel_freq, axis=-1)
    hp = harm**power
    pp = (margin * perc) ** power
    mask_h = hp / jnp.maximum(hp + pp, eps)
    hp2 = (margin * harm) ** power
    pp2 = perc**power
    mask_p = pp2 / jnp.maximum(hp2 + pp2, eps)
    return mask_h, mask_p


def hpss(
    x: jnp.ndarray,
    n_fft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    kernel_time: int = 17,
    kernel_freq: int = 17,
    power: float = 2.0,
    margin: float = 1.0,
    impl: str = "matmul",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Split a waveform into (harmonic, percussive) components.

    STFT -> median masks -> masked ISTFT, both components from one analysis
    pass. Output length matches the input.
    """
    t = x.shape[-1]
    spec = stft(x, n_fft, hop, window=window, impl=impl)
    p = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
    mask_h, mask_p = hpss_mask(p, kernel_time, kernel_freq, power, margin)
    y_h = istft(spec * mask_h, n_fft, hop, window=window, length=t, impl=impl)
    y_p = istft(spec * mask_p, n_fft, hop, window=window, length=t, impl=impl)
    return y_h, y_p


def noise_profile(
    mag: jnp.ndarray, quantile: float = 0.1, eps: float = 1e-10
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-bin noise floor (mean, std) in log-magnitude from the quietest
    ``quantile`` of frames (energy-ranked) — the self-noise estimate used
    when no explicit noise clip is given. mag ``[..., T, F]``."""
    logm = jnp.log10(jnp.maximum(mag, eps))
    energy = mag.sum(axis=-1)  # [..., T]
    t = mag.shape[-2]
    k = max(int(round(t * quantile)), 2)
    idx = jnp.argsort(energy, axis=-1)[..., :k]  # quietest k frames
    quiet = jnp.take_along_axis(logm, idx[..., None], axis=-2)
    return quiet.mean(axis=-2), quiet.std(axis=-2)


def _smooth(mask: jnp.ndarray, size: int, axis: int) -> jnp.ndarray:
    """Boxcar smoothing along ``axis`` (reflect-padded moving average)."""
    if size <= 1:
        return mask
    m = jnp.moveaxis(mask, axis, -1)
    h = size // 2
    pads = [(0, 0)] * (m.ndim - 1) + [(h, size - 1 - h)]
    mp = jnp.pad(m, pads, mode="reflect")
    win = frame(mp, size, 1)
    return jnp.moveaxis(win.mean(axis=-1), -1, axis)


def spectral_gate(
    x: jnp.ndarray,
    n_fft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    noise: jnp.ndarray | None = None,
    n_std: float = 1.5,
    prop_decrease: float = 1.0,
    time_smooth: int = 5,
    freq_smooth: int = 5,
    quantile: float = 0.1,
    impl: str = "matmul",
) -> jnp.ndarray:
    """Stationary-noise spectral gating (the noisereduce recipe).

    A per-bin threshold is set at ``mean + n_std * std`` of the noise's
    log-magnitude — estimated from ``noise`` (a noise-only clip ``[..., T]``)
    when given, else from the quietest ``quantile`` of the signal's own
    frames. Bins below threshold are attenuated by ``prop_decrease``
    (1.0 = fully gated to the mask floor); the binary decision is boxcar-
    smoothed over ``time_smooth`` frames and ``freq_smooth`` bins to avoid
    musical noise.
    """
    t = x.shape[-1]
    spec = stft(x, n_fft, hop, window=window, impl=impl)
    mag = jnp.abs(spec)
    if noise is not None:
        nmag = jnp.abs(stft(noise, n_fft, hop, window=window, impl=impl))
        logn = jnp.log10(jnp.maximum(nmag, 1e-10))
        mean, std = logn.mean(axis=-2), logn.std(axis=-2)
    else:
        mean, std = noise_profile(mag, quantile)
    thresh = mean + n_std * std  # [..., F]
    keep = (jnp.log10(jnp.maximum(mag, 1e-10)) > thresh[..., None, :]).astype(mag.dtype)
    keep = _smooth(_smooth(keep, time_smooth, axis=-2), freq_smooth, axis=-1)
    gain = 1.0 - prop_decrease * (1.0 - keep)
    return istft(spec * gain, n_fft, hop, window=window, length=t, impl=impl)


def nmf(
    s: jnp.ndarray,
    n_components: int,
    n_iter: int = 200,
    loss: str = "frobenius",
    seed: int = 0,
    eps: float = 1e-10,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Nonnegative matrix factorization of a magnitude/power spectrogram.

    ``s [..., T, F] ~ h @ w`` with activations ``h [..., T, K]`` and
    spectral templates ``w [..., K, F]``, both nonnegative — the standard
    audio source-separation decomposition (each template a note/source
    spectrum, each activation its gain envelope).

    Formulation: Lee-Seung multiplicative updates (``"frobenius"`` or
    ``"kl"``) as a ``lax.fori_loop`` whose body is four matmuls and two
    elementwise ratios — no data-dependent control flow, batched over
    leading axes, same machinery as the mel NNLS inverse (ops/mel.py).
    Initialization is deterministic uniform-random from ``seed`` (jax PRNG),
    scaled so the first reconstruction matches ``s`` in total energy.
    """
    import jax

    if n_components < 1:
        raise ValueError(f"n_components must be >= 1, got {n_components}")
    if loss not in ("frobenius", "kl"):
        raise ValueError(f"unknown loss {loss!r}; known: frobenius, kl")
    s = jnp.maximum(jnp.asarray(s), 0.0)
    t, f = s.shape[-2], s.shape[-1]
    lead = s.shape[:-2]
    kh, kw = jax.random.split(jax.random.PRNGKey(seed))
    h = jax.random.uniform(kh, (*lead, t, n_components), s.dtype, 0.1, 1.0)
    w = jax.random.uniform(kw, (*lead, n_components, f), s.dtype, 0.1, 1.0)
    # energy-matched init keeps the first ratios O(1)
    scale = s.sum(axis=(-2, -1), keepdims=True) / jnp.maximum(
        (h @ w).sum(axis=(-2, -1), keepdims=True), eps
    )
    h = h * jnp.sqrt(scale)
    w = w * jnp.sqrt(scale)
    wt = lambda m: jnp.swapaxes(m, -2, -1)

    if loss == "frobenius":

        def body(_, hw):
            h, w = hw
            h = h * (s @ wt(w)) / jnp.maximum(h @ w @ wt(w), eps)
            w = w * (wt(h) @ s) / jnp.maximum(wt(h) @ h @ w, eps)
            return h, w

    else:  # KL divergence

        def body(_, hw):
            h, w = hw
            r = jnp.maximum(h @ w, eps)
            # denominators are rank-1: ones @ w.T == broadcast row sums of w
            # (computing them as full [T, F] matmuls would double the
            # per-iteration matmul cost)
            h = h * ((s / r) @ wt(w)) / jnp.maximum(
                w.sum(axis=-1)[..., None, :], eps
            )
            r = jnp.maximum(h @ w, eps)
            w = w * (wt(h) @ (s / r)) / jnp.maximum(
                h.sum(axis=-2)[..., :, None], eps
            )
            return h, w

    h, w = jax.lax.fori_loop(0, n_iter, body, (h, w))
    return h, w


def nmf_separate(
    x: jnp.ndarray,
    n_components: int = 2,
    n_fft: int = 1024,
    hop: int = 256,
    n_iter: int = 200,
    loss: str = "frobenius",
    seed: int = 0,
    power: float = 1.0,
    eps: float = 1e-10,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Blind source separation of ``x [T]`` into ``n_components`` waveforms.

    STFT -> NMF of the magnitude (``power=1``; 2 factorizes the power
    spectrogram) -> per-component Wiener-style soft masks
    ``V_k / sum_j V_j`` applied to the complex spectrogram -> ISTFT. The
    masks sum to 1, so the components sum to the (ISTFT-consistent) input.
    Returns ``(components [K, T'], activations [F, K], templates [K, bins])``.
    """
    x = jnp.asarray(x)
    if x.ndim != 1:
        raise ValueError(f"nmf_separate takes a 1-D signal, got {x.shape}")
    spec = stft(x, n_fft, hop)
    mag = jnp.abs(spec) ** power
    h, w = nmf(mag, n_components, n_iter=n_iter, loss=loss, seed=seed, eps=eps)
    # per-component magnitude models [K, frames, bins] via outer products
    v = jnp.maximum(jnp.swapaxes(h, 0, 1)[:, :, None] * w[:, None, :], 0.0)
    total = jnp.maximum(v.sum(axis=0, keepdims=True), eps)
    masks = v / total  # sum to 1 across components
    comp_spec = masks * spec[None]
    comps = istft(comp_spec, n_fft, hop, length=x.shape[-1])
    return comps, h, w
