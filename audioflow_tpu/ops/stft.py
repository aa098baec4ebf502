"""STFT / ISTFT via XLA's rFFT or windowed DFT banks as matrix products.

Design: frame (static slices) -> window multiply (fused) -> ``jnp.fft.rfft``.
Magnitude/power stay fused into the consumer. ISTFT is irfft ->
synthesis window -> overlap-add -> COLA window-square normalization.

This is the on-device counterpart of what the reference never had:
its DSP stops at resample+VAD; the STFT/mel stages come from the north star
(BASELINE.json config 1). Framing semantics follow the widely used
center/reflect convention so results are oracle-checkable against
scipy.signal.stft-style references.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ._mm import mm
from .framing import frame, overlap_add
from .windows import get_window


def stft(
    x: jnp.ndarray,
    n_fft: int = 1024,
    hop: int = 256,
    win_length: int | None = None,
    window: str = "hann",
    center: bool = True,
    pad_mode: str = "reflect",
    dtype=jnp.float32,
    impl: str = "fft",
    precision: str | None = None,
) -> jnp.ndarray:
    """Short-time Fourier transform.

    Args:
      x: real signal ``[..., T]``.
      impl: "fft" (XLA FFT) or "matmul" (two dots against windowed
        cos/sin banks — unlike the FFT op, they partition cleanly under
        batch sharding).
      precision: matmul precision override for impl="matmul" (None = the
        framework default in ops/_mm.py).
    Returns:
      complex64 spectrogram ``[..., n_frames, n_fft // 2 + 1]``
      (time-major: frame axis before frequency axis, the natural layout for
      downstream [frames, freqs] @ [freqs, mels] matmuls).
    """
    win_length = win_length or n_fft
    if win_length > n_fft:
        raise ValueError("win_length must be <= n_fft")
    if center:
        widths = [(0, 0)] * (x.ndim - 1) + [(n_fft // 2, n_fft // 2)]
        x = jnp.pad(x, widths, mode=pad_mode)
    frames = frame(x.astype(dtype), n_fft, hop)
    if impl == "matmul":
        p = precision or DFT_PRECISION_DEFAULT
        if p == "highest":  # folded banks win at bf16x6 (see spectrogram)
            out = _rdft_folded(frames, n_fft, window, win_length, p, dtype)
            if out is not None:
                return jax.lax.complex(*out)
        cosb, sinb = _dft_banks(n_fft, window, win_length)
        re = mm(frames, jnp.asarray(cosb, dtype), p)
        im = mm(frames, jnp.asarray(sinb, dtype), p)
        return jax.lax.complex(re, im)
    if impl == "onedot":
        p = precision or DFT_PRECISION_DEFAULT
        if n_fft % 2 == 0:
            re, im = _rdft_onedot(frames, n_fft, window, win_length, p, dtype)
        else:  # odd n_fft: the zero sin columns don't exist; plain banks
            cosb, sinb = _dft_banks(n_fft, window, win_length)
            re = mm(frames, jnp.asarray(cosb, dtype), p)
            im = mm(frames, jnp.asarray(sinb, dtype), p)
        return jax.lax.complex(re, im)
    if impl == "fourstep":
        p = precision or DFT_PRECISION_DEFAULT
        re, im = _rdft_fourstep(frames, n_fft, window, win_length, p)
        return jax.lax.complex(re, im)
    if impl == "folded":
        p = precision or DFT_PRECISION_DEFAULT
        out = _rdft_folded(frames, n_fft, window, win_length, p, dtype)
        if out is None:  # asymmetric window: plain banks, same result
            cosb, sinb = _dft_banks(n_fft, window, win_length)
            out = (mm(frames, jnp.asarray(cosb, dtype), p),
                   mm(frames, jnp.asarray(sinb, dtype), p))
        return jax.lax.complex(*out)
    if impl != "fft":
        raise ValueError(
            f"unknown stft impl {impl!r}; known: fft, matmul, onedot, folded, fourstep"
        )
    w = get_window(window, win_length, periodic=True)
    if win_length < n_fft:  # center-pad window to n_fft
        pad = n_fft - win_length
        w = np.pad(w, (pad // 2, pad - pad // 2))
    w = jnp.asarray(w, dtype=dtype)
    return jnp.fft.rfft(frames * w, n=n_fft, axis=-1)


def magnitude(spec: jnp.ndarray) -> jnp.ndarray:
    return jnp.abs(spec)


def power(spec: jnp.ndarray) -> jnp.ndarray:
    return jnp.real(spec) ** 2 + jnp.imag(spec) ** 2


power_fn = power  # alias (the `power=` kwarg of spectrogram shadows the name)


from ..utils.cache import BoundedCache

# windowed-DFT bank variants, ~n_fft*(n_fft//2+1)*4 B each (8 MB at 2048)
_BANK_CACHE = BoundedCache(maxsize=64)

# Per-op precision tier of the DFT banks (ops/_mm.py; DESIGN.md §6b): the
# spectrogram is compute-bound, and "high" keeps the float64-oracle error
# inside the 1e-4 budget (the spectrogram_matmul validate row: 4.2e-6 on an
# H100). Resample/mel stay at the framework default. Pass
# precision="highest" to override per call.
DFT_PRECISION_DEFAULT = "high"


def _dft_banks(n_fft: int, window: str, win_length: int | None):
    """Windowed real-DFT banks: cos/sin matrices [n_fft, n_fft//2+1], f64-designed.

    Folding the analysis window into the banks makes the whole spectrogram
    two matmuls — no separate window multiply, no complex arithmetic.
    """
    key = (n_fft, window, win_length)
    if key not in _BANK_CACHE:
        wl = win_length or n_fft
        w = get_window(window, wl, periodic=True)
        if wl < n_fft:
            pad = n_fft - wl
            w = np.pad(w, (pad // 2, pad - pad // 2))
        n_bins = n_fft // 2 + 1
        k = np.arange(n_fft, dtype=np.float64)[:, None] * np.arange(n_bins)[None, :]
        ang = 2.0 * np.pi * k / n_fft
        _BANK_CACHE[key] = (
            (np.cos(ang) * w[:, None]).astype(np.float32),
            (-np.sin(ang) * w[:, None]).astype(np.float32),
        )
    return _BANK_CACHE[key]


def _folded_banks(n_fft: int, window: str, win_length: int | None):
    """Symmetry-folded windowed rDFT banks — half the MACs of `_dft_banks`.

    cos(2*pi*n*k/N) = cos(2*pi*(N-n)*k/N) and sin is antisymmetric, so pairing
    sample n with N-n turns the [N, n_bins] cos/sin dots into
      re = [x0, e, xh] @ CE   with e[n] = x[n] + x[N-n], n = 1..N/2-1
      im =       o  @ SE   with o[n] = x[n] - x[N-n]
    where CE is [N/2+1, n_bins] (rows: n=0, the pairs, n=N/2) and SE is
    [N/2-1, n_bins] — N*n_bins MACs total vs 2*N*n_bins unfolded. The
    analysis window folds into the banks only when symmetric (w[n] == w[N-n];
    every periodic cosine-sum window is); returns None for asymmetric
    windows (odd center-padding of win_length < n_fft) so callers fall back.
    """
    key = ("folded", n_fft, window, win_length)
    if key not in _BANK_CACHE:
        if n_fft % 2:
            _BANK_CACHE[key] = None
        else:
            wl = win_length or n_fft
            w = get_window(window, wl, periodic=True)
            if wl < n_fft:
                pad = n_fft - wl
                w = np.pad(w, (pad // 2, pad - pad // 2))
            half = n_fft // 2
            hi, lo = w[1:half], w[half + 1 :][::-1]
            if not np.allclose(hi, lo, rtol=0.0, atol=1e-12):
                _BANK_CACHE[key] = None
            else:
                ws = 0.5 * (hi + lo)  # exact symmetrization (<= 1 ulp)
                n_bins = half + 1
                k = np.arange(n_bins, dtype=np.float64)[None, :]
                n = np.arange(1, half, dtype=np.float64)[:, None]
                ang = 2.0 * np.pi * n * k / n_fft
                ce = np.empty((half + 1, n_bins), np.float64)
                ce[0] = w[0]
                ce[1:half] = np.cos(ang) * ws[:, None]
                ce[half] = w[half] * np.where(np.arange(n_bins) % 2 == 0, 1.0, -1.0)
                se = -np.sin(ang) * ws[:, None]
                _BANK_CACHE[key] = (ce.astype(np.float32), se.astype(np.float32))
    return _BANK_CACHE[key]


def _rdft_folded(frames, n_fft, window, win_length, precision, dtype=jnp.float32):
    """Windowed real DFT of frames [..., F, n_fft] -> (re, im) via the
    symmetry-folded banks; None if the window cannot fold (caller falls
    back to the plain matmul form)."""
    banks = _folded_banks(n_fft, window, win_length)
    if banks is None:
        return None
    ce, se = banks
    half = n_fft // 2
    head = frames[..., 1:half]
    tail = frames[..., half + 1 :][..., ::-1]
    even = jnp.concatenate(
        [frames[..., 0:1], head + tail, frames[..., half : half + 1]], axis=-1
    )
    re = mm(even, jnp.asarray(ce, dtype), precision)
    im = mm(head - tail, jnp.asarray(se, dtype), precision)
    return re, im


def _combined_banks(n_fft: int, window: str, win_length: int | None):
    """Concatenated cos|sin windowed rDFT bank, shape [n_fft, n_fft] exactly.

    The plain form runs two [.., n_fft] @ [n_fft, n_fft//2+1] dots; a
    matrix unit that tiles columns in 128s pads each 513-column output to
    640, so the two dots execute 2x640 effective columns. The sin bank's k=0 and
    k=n_fft/2 columns are identically zero, so cos (513 cols) | sin (511
    cols, k=1..511) concatenate to exactly n_fft columns: ONE dot with zero
    pad waste and half the dispatches — 1.25x fewer effective MACs for the
    identical result. Requires n_fft even.
    """
    key = ("onedot", n_fft, window, win_length)
    if key not in _BANK_CACHE:
        cosb, sinb = _dft_banks(n_fft, window, win_length)
        _BANK_CACHE[key] = np.concatenate([cosb, sinb[:, 1 : n_fft // 2]], axis=1)
    return _BANK_CACHE[key]


def _rdft_onedot(frames, n_fft, window, win_length, precision, dtype=jnp.float32):
    """Windowed real DFT of frames [..., F, n_fft] -> (re, im) via the single
    combined-bank dot (see :func:`_combined_banks`)."""
    cb = _combined_banks(n_fft, window, win_length)
    y = mm(frames, jnp.asarray(cb, dtype), precision)
    half = n_fft // 2
    re = y[..., : half + 1]
    pad = [(0, 0)] * (y.ndim - 1) + [(1, 1)]
    im = jnp.pad(y[..., half + 1 :], pad)
    return re, im


def _radix2_banks(n_fft: int, window: str, win_length: int | None):
    """Even/odd decimation-in-time banks: two [n_fft/2, n_fft/2] combined
    rDFT banks (window folded per parity) + twiddle vectors c,s [n_fft/2+1].

    X[k] = E[k] + t_k O[k], t_k = exp(-2j*pi*k/n_fft), where E/O are the
    rDFT-(n_fft/2) of the even/odd samples — HALF the MACs of the direct
    bank at the price of an elementwise combine on output-sized data. Each
    half bank is itself the combined cos|sin layout (n_fft/2 columns, zero
    pad waste). Requires n_fft % 4 == 0.
    """
    key = ("radix2", n_fft, window, win_length)
    if key not in _BANK_CACHE:
        wl = win_length or n_fft
        w = get_window(window, wl, periodic=True)
        if wl < n_fft:
            pad = n_fft - wl
            w = np.pad(w, (pad // 2, pad - pad // 2))
        h = n_fft // 2
        nb = h // 2 + 1
        k = np.arange(h, dtype=np.float64)[:, None] * np.arange(nb)[None, :]
        ang = 2.0 * np.pi * k / h
        cos_, sin_ = np.cos(ang), -np.sin(ang)

        def bank(wp):
            b = np.concatenate([cos_ * wp[:, None], (sin_ * wp[:, None])[:, 1 : nb - 1]], axis=1)
            return b.astype(np.float32)

        th = 2.0 * np.pi * np.arange(h + 1, dtype=np.float64) / n_fft
        _BANK_CACHE[key] = (
            bank(w[0::2]),
            bank(w[1::2]),
            np.cos(th).astype(np.float32),
            np.sin(th).astype(np.float32),
        )
    return _BANK_CACHE[key]


def _halfspec_full(y, h):
    """Expand a combined-layout rDFT-h output [..., h] = [re 0..h/2 | im
    1..h/2-1] to (re, im) over bins 0..h via conjugate symmetry
    (E[k] = conj(E[h-k]); bins h/2..h wrap periodically for the radix-2
    combine, which indexes E at k mod h)."""
    q = h // 2
    re = y[..., : q + 1]
    imc = y[..., q + 1 :]  # bins 1..q-1
    z = jnp.zeros_like(y[..., :1])
    re_f = jnp.concatenate([re, jnp.flip(re[..., 1:q], -1), re[..., :1]], axis=-1)
    im_f = jnp.concatenate([z, imc, z, -jnp.flip(imc, -1), z], axis=-1)
    return re_f, im_f


def _rdft_radix2(x, n_fft, hop, window, win_length, precision, dtype=jnp.float32):
    """Windowed real DFT of all frames of signal x [..., T] -> (re, im)
    [..., F, n_fft//2+1] via even/odd decimation (see :func:`_radix2_banks`).

    Deinterleaves the SIGNAL (input-sized traffic), then frames each parity
    half at (n_fft/2, hop/2) — frames_e[i] are exactly the even samples of
    frame i, so the 4x frame materialization never touches duplicated data
    beyond what the plain path already materializes.
    """
    be, bo, c, s = (jnp.asarray(b, dtype) for b in _radix2_banks(n_fft, window, win_length))
    h = n_fft // 2
    fe = frame(x[..., 0::2], h, hop // 2)
    fo = frame(x[..., 1::2], h, hop // 2)
    ye = mm(fe, be, precision)
    yo = mm(fo, bo, precision)
    re_e, im_e = _halfspec_full(ye, h)
    re_o, im_o = _halfspec_full(yo, h)
    re = re_e + c * re_o + s * im_o
    im = im_e + c * im_o - s * re_o
    return re, im


def _fourstep_factor(n_fft: int) -> int:
    """Inner factor N1 for the four-step DFT: the power of two nearest
    sqrt(n_fft) that divides it (balanced factors minimize total flops)."""
    n1 = 1
    while n1 * n1 < n_fft:
        n1 *= 2
    while n_fft % n1:
        n1 //= 2
    return max(n1, 2)


def _fourstep_banks(n_fft: int, n1: int, window: str, win_length: int | None):
    """Banks for the four-step (Bailey) real DFT of size N = N1*N2.

    With n = n1*N2 + n2 and k = k1 + N1*k2:
      X[k] = sum_n2 [ W_N^(n2 k1) * sum_n1 x[n1,n2] W_N1^(n1 k1) ] W_N2^(n2 k2)
    i.e. inner DFT over n1 (bank [N1, N1]) -> twiddle [N2, N1] -> outer DFT
    over n2 (bank [N2, N2//2+1], k2 truncated to cover k <= N/2). Cuts DFT
    flops ~8x at n_fft=1024 vs the direct [N, N/2+1] banks, and the short
    K=32 contractions lose far less to bf16 accumulation than K=1024.
    All three banks are f64-designed. The analysis window depends on
    n = n1*N2+n2 jointly, so it cannot fold into any single bank; it is
    returned separately for the elementwise pre-multiply (VPU, fused).
    """
    key = ("4step", n_fft, n1, window, win_length)
    if key not in _BANK_CACHE:
        n2 = n_fft // n1
        if n1 * n2 != n_fft:
            raise ValueError(f"n1 {n1} does not divide n_fft {n_fft}")
        k2sel = n2 // 2 + 1
        a1 = 2.0 * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1
        tw = 2.0 * np.pi * np.outer(np.arange(n2), np.arange(n1)) / n_fft
        a2 = 2.0 * np.pi * np.outer(np.arange(n2), np.arange(k2sel)) / n2
        wl = win_length or n_fft
        w = get_window(window, wl, periodic=True)
        if wl < n_fft:
            pad = n_fft - wl
            w = np.pad(w, (pad // 2, pad - pad // 2))
        _BANK_CACHE[key] = (
            w.astype(np.float32),
            np.cos(a1).astype(np.float32), -np.sin(a1).astype(np.float32),
            np.cos(tw).astype(np.float32), -np.sin(tw).astype(np.float32),
            np.cos(a2).astype(np.float32), -np.sin(a2).astype(np.float32),
        )
    return _BANK_CACHE[key]


def _rdft_fourstep(
    frames: jnp.ndarray,
    n_fft: int,
    window: str,
    win_length: int | None,
    precision: str | None,
    n1: int | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Windowed real DFT of frames [..., F, n_fft] -> (re, im) [..., F, n_bins]
    via the four-step factorization (see :func:`_fourstep_banks`)."""
    from ._mm import em

    n1 = n1 or _fourstep_factor(n_fft)
    n2 = n_fft // n1
    w, c1, s1, tc, ts, c2, s2 = (
        jnp.asarray(b) for b in _fourstep_banks(n_fft, n1, window, win_length)
    )
    x = (frames * w).reshape(*frames.shape[:-1], n1, n2)
    # stage 1: inner DFT over n1 -> [..., F, n2, k1]
    re = em("...ab,ak->...bk", x, c1, precision=precision)
    im = em("...ab,ak->...bk", x, s1, precision=precision)
    # stage 2: twiddle (complex elementwise, [n2, k1] broadcast over frames)
    re, im = re * tc - im * ts, re * ts + im * tc
    # stage 3+4: outer DFT over n2 -> [..., F, k2, k1]; k2-major layout makes
    # the flattened last axis the bins 0..(k2sel*n1 - 1) in order
    ro = em("...bk,bc->...ck", re, c2, precision=precision) - em(
        "...bk,bc->...ck", im, s2, precision=precision
    )
    io = em("...bk,bc->...ck", re, s2, precision=precision) + em(
        "...bk,bc->...ck", im, c2, precision=precision
    )
    n_bins = n_fft // 2 + 1
    k2sel = n2 // 2 + 1
    ro = ro.reshape(*ro.shape[:-2], k2sel * n1)[..., :n_bins]
    io = io.reshape(*io.shape[:-2], k2sel * n1)[..., :n_bins]
    return ro, io


def spectrogram(
    x: jnp.ndarray,
    n_fft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    win_length: int | None = None,
    center: bool = True,
    pad_mode: str = "reflect",
    power: bool = True,
    impl: str = "matmul",
    dtype=jnp.float32,
    precision: str | None = None,
) -> jnp.ndarray:
    """Power (or magnitude) spectrogram ``[..., frames, n_fft//2+1]``.

    ``impl="matmul"`` evaluates the windowed real DFT as two matmuls
    against precomputed cos/sin banks (O(N^2) on the matrix units against
    the FFT's O(N log N), and shardable without collectives).
    ``impl="fft"`` routes through :func:`stft`.
    """
    if impl == "fft":
        spec = stft(x, n_fft, hop, win_length, window, center, pad_mode, dtype)
        return power_fn(spec) if power else magnitude(spec)
    if impl not in ("matmul", "folded", "fourstep", "onedot", "radix2"):
        raise ValueError(
            f"unknown spectrogram impl {impl!r}; "
            "known: matmul, folded, fourstep, onedot, radix2, fft"
        )
    if center:
        widths = [(0, 0)] * (x.ndim - 1) + [(n_fft // 2, n_fft // 2)]
        x = jnp.pad(x, widths, mode=pad_mode)
    prec = precision or DFT_PRECISION_DEFAULT
    if impl == "radix2" and n_fft % 4 == 0 and hop % 2 == 0 and x.shape[-1] % 2 == 0:
        re, im = _rdft_radix2(x.astype(dtype), n_fft, hop, window, win_length, prec, dtype)
        p = re * re + im * im
        return p if power else jnp.sqrt(p)
    frames = frame(x.astype(dtype), n_fft, hop)
    out = None
    if impl == "fourstep":
        out = _rdft_fourstep(frames, n_fft, window, win_length, prec)
    elif impl == "folded" or (impl == "matmul" and prec == "highest"):
        # at "highest" the DFT is the most compute-bound and the folded
        # banks halve its MACs; at "high"/"default" the fold's extra
        # reverse+add traffic is not repaid, so the plain banks stay the
        # default there
        out = _rdft_folded(frames, n_fft, window, win_length, prec, dtype)
    if (
        out is None
        and (impl in ("onedot", "radix2") or (impl == "matmul" and not power))
        and n_fft % 2 == 0
    ):
        # "onedot" (and "radix2"'s fallback when its divisibility
        # preconditions fail): one combined-bank dot, zero pad waste
        # (see _combined_banks). Auto-selected for power=False under
        # impl="matmul" (bit-identical, faster to compile). power=True
        # keeps the two-dot form: when a mel matmul consumes the output,
        # the onedot 513-boundary pad/slice breaks XLA's power->mel fusion.
        if power:
            # square in the packed [.., n_fft] layout first: the mis-aligned
            # 513-boundary slice then touches squared (output) data only
            cb = _combined_banks(n_fft, window, win_length)
            y = mm(frames, jnp.asarray(cb, dtype), prec)
            ysq = y * y
            half = n_fft // 2
            pad = [(0, 0)] * (y.ndim - 1) + [(1, 1)]
            p = ysq[..., : half + 1] + jnp.pad(ysq[..., half + 1 :], pad)
            return p
        out = _rdft_onedot(frames, n_fft, window, win_length, prec, dtype)
    if out is None:  # odd n_fft, or folded's asymmetric-window fallback
        cosb, sinb = _dft_banks(n_fft, window, win_length)
        out = (mm(frames, jnp.asarray(cosb, dtype), prec),
               mm(frames, jnp.asarray(sinb, dtype), prec))
    re, im = out
    p = re * re + im * im
    return p if power else jnp.sqrt(p)


def _idft_banks(n_fft: int):
    """Inverse real-DFT banks: irfft(X) == Re(X) @ ci + Im(X) @ si."""
    key = ("idft", n_fft)
    if key not in _BANK_CACHE:
        n_bins = n_fft // 2 + 1
        k = np.arange(n_bins, dtype=np.float64)[:, None]
        n = np.arange(n_fft, dtype=np.float64)[None, :]
        ang = 2.0 * np.pi * k * n / n_fft
        weights = np.full((n_bins, 1), 2.0)
        weights[0] = 1.0
        if n_fft % 2 == 0:
            weights[-1] = 1.0
        ci = (weights * np.cos(ang) / n_fft).astype(np.float32)
        si = (-weights * np.sin(ang) / n_fft).astype(np.float32)
        _BANK_CACHE[key] = (ci, si)
    return _BANK_CACHE[key]


def frames_from_spec(
    spec: jnp.ndarray, n_fft: int, impl: str = "fft", dtype=jnp.float32,
    precision: str | None = None,
) -> jnp.ndarray:
    """Inverse real DFT of spectral frames (shared by istft and the streaming
    Istft node so the two paths can never diverge numerically)."""
    if impl == "matmul":
        ci, si = _idft_banks(n_fft)
        p = precision or DFT_PRECISION_DEFAULT  # same compute-bound cap as forward
        frames = mm(jnp.real(spec).astype(dtype), jnp.asarray(ci), p) + mm(
            jnp.imag(spec).astype(dtype), jnp.asarray(si), p
        )
        return frames.astype(dtype)
    if impl == "fft":
        return jnp.fft.irfft(spec, n=n_fft, axis=-1).astype(dtype)
    raise ValueError(f"unknown istft impl {impl!r}; known: fft, matmul")


def istft(
    spec: jnp.ndarray,
    n_fft: int = 1024,
    hop: int = 256,
    win_length: int | None = None,
    window: str = "hann",
    center: bool = True,
    length: int | None = None,
    dtype=jnp.float32,
    impl: str = "fft",
    precision: str | None = None,
) -> jnp.ndarray:
    """Inverse STFT with synthesis-window (WOLA) normalization.

    ``length`` trims/defines the output sample count; defaults to
    ``n_frames * hop`` for center=True. ``impl="matmul"`` evaluates the
    inverse real DFT as two dots (see :func:`stft`).
    """
    win_length = win_length or n_fft
    w = get_window(window, win_length, periodic=True)
    if win_length < n_fft:
        pad = n_fft - win_length
        w = np.pad(w, (pad // 2, pad - pad // 2))
    w = jnp.asarray(w, dtype=dtype)
    n = spec.shape[-2]
    frames = frames_from_spec(spec, n_fft, impl, dtype, precision)
    y = overlap_add(frames * w, hop)
    # the window-square normalizer is identical for every batch lane: compute
    # it once on a single [n, n_fft] row instead of a full-batch overlap-add
    wsq = overlap_add(jnp.broadcast_to(w * w, (n, n_fft)), hop)
    y = y / jnp.maximum(wsq, 1e-11)
    if not center:
        return y if length is None else y[..., :length]
    if length is None:
        length = n * hop
    return y[..., n_fft // 2 : n_fft // 2 + length]
