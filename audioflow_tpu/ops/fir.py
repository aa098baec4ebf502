"""FIR filtering: windowed-sinc design + causal convolution.

Complements the IIR biquad engine (ops/biquad.py) with linear-phase FIR:
design is host-side float64 windowed-sinc (scipy.signal.firwin conventions,
oracle-checkable), application is either an XLA 1-D convolution (short/medium
kernels) or FFT fast convolution (long kernels, e.g.
convolution reverb with impulse responses of 10k+ taps). Causal semantics
with explicit prehistory state make streaming exact with zero latency:
``zf`` is the last ``K-1`` input samples — the carry and the checkpoint.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .windows import get_window


def fir_design(
    num_taps: int,
    cutoff: float | tuple[float, float],
    sample_rate: float,
    kind: str = "lowpass",
    window: str = "hamming",
) -> np.ndarray:
    """Windowed-sinc FIR design (scipy.signal.firwin semantics), float64.

    kind: "lowpass" | "highpass" | "bandpass" | "bandstop". Odd ``num_taps``
    required for highpass/bandstop (type-I linear phase). Gain is normalized
    at DC (lowpass/bandstop) or at the passband center (highpass/bandpass).
    """
    if num_taps < 3:
        raise ValueError("num_taps must be >= 3")
    nyq = sample_rate / 2.0
    edges = np.atleast_1d(np.asarray(cutoff, dtype=np.float64)) / nyq
    if np.any(edges <= 0) or np.any(edges >= 1):
        raise ValueError(f"cutoff must lie strictly inside (0, {nyq}) Hz")
    if kind in ("highpass", "bandstop") and num_taps % 2 == 0:
        raise ValueError(f"{kind} needs odd num_taps (type-I linear phase)")
    m = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0

    def sinc_lp(fc):  # ideal lowpass with cutoff fc (normalized to Nyquist)
        return fc * np.sinc(fc * m)

    if kind == "lowpass":
        h = sinc_lp(edges[0])
    elif kind == "highpass":
        h = -sinc_lp(edges[0])
        h[(num_taps - 1) // 2] += 1.0
    elif kind == "bandpass":
        if edges.size != 2:
            raise ValueError("bandpass needs (low, high) cutoff")
        h = sinc_lp(edges[1]) - sinc_lp(edges[0])
    elif kind == "bandstop":
        if edges.size != 2:
            raise ValueError("bandstop needs (low, high) cutoff")
        h = sinc_lp(edges[0]) - sinc_lp(edges[1])
        h[(num_taps - 1) // 2] += 1.0
    else:
        raise ValueError(f"unknown FIR kind {kind!r}")
    w = get_window(window, num_taps, periodic=False)
    h = h * w
    # normalize gain: DC for lowpass/bandstop, band center for the others
    if kind in ("lowpass", "bandstop"):
        h /= h.sum()
    elif kind == "highpass":
        h /= np.abs((h * np.cos(np.pi * m)).sum())  # gain at Nyquist
    else:
        fc = 0.5 * (edges[0] + edges[1])  # scipy.firwin's scale frequency
        h /= np.abs((h * np.exp(-1j * np.pi * fc * m)).sum())
    return h


def fir_apply(
    x: jnp.ndarray,
    h: jnp.ndarray | np.ndarray,
    zi: jnp.ndarray | None = None,
    impl: str = "auto",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Causal FIR: ``y[n] = sum_k h[k] x[n-k]``, same-length output.

    ``zi [..., K-1]`` is the input prehistory (zeros if None); returns
    ``(y, zf)`` with ``zf`` = the last K-1 inputs — feed it back in for
    exact chunked/streaming processing. ``impl``: "direct" (XLA conv),
    "fft" (fast convolution), "auto" (fft above 192 taps).
    """
    h = jnp.asarray(h, x.dtype)
    k = h.shape[-1]
    if k == 1:
        return x * h[0], (zi if zi is not None else jnp.zeros((*x.shape[:-1], 0), x.dtype))
    lead = x.shape[:-1]
    if zi is None:
        zi = jnp.zeros((*lead, k - 1), x.dtype)
    xx = jnp.concatenate([zi, x], axis=-1)
    zf = xx[..., xx.shape[-1] - (k - 1) :]
    if impl == "auto":
        impl = "fft" if k > 192 else "direct"
    if impl == "direct":
        # XLA 1-D convolution (correlation semantics -> flip the kernel).
        # A reduced-precision conv (bf16 or TF32 passes) is audible (~3e-3
        # relative) on filter outputs, so the conv inherits the
        # framework's fidelity-critical matmul precision (ops/_mm.py), the
        # same rule every DFT/resample bank follows.
        from ._mm import conv_precision

        b = int(np.prod(lead)) if lead else 1
        lhs = xx.reshape(b, 1, xx.shape[-1])
        rhs = jnp.flip(h, -1).reshape(1, 1, k)
        y = jax.lax.conv_general_dilated(
            lhs, rhs, (1,), "VALID",
            precision=conv_precision(),
        )
        y = y.reshape(*lead, -1)
    elif impl == "fft":
        t = xx.shape[-1]
        n = 1 << (t + k - 1).bit_length()
        spec = jnp.fft.rfft(xx, n=n, axis=-1) * jnp.fft.rfft(h, n=n)
        y = jnp.fft.irfft(spec, n=n, axis=-1)[..., k - 1 : t].astype(x.dtype)
    else:
        raise ValueError(f"unknown fir impl {impl!r}; known: direct, fft, auto")
    return y, zf


def convolve(x: jnp.ndarray, ir: jnp.ndarray, mode: str = "full") -> jnp.ndarray:
    """Linear convolution with an impulse response (convolution reverb).

    ``mode``: "full" (length T+K-1) or "same" (length T, zero-latency head —
    equivalent to the causal :func:`fir_apply` output).
    """
    ir = jnp.asarray(ir, x.dtype)
    k = ir.shape[-1]
    if mode == "same":
        y, _ = fir_apply(x, ir, impl="fft" if k > 192 else "direct")
        return y
    if mode != "full":
        raise ValueError(f"unknown mode {mode!r}; known: full, same")
    pads = [(0, 0)] * (x.ndim - 1) + [(0, k - 1)]
    y, _ = fir_apply(jnp.pad(x, pads), ir, impl="fft" if k > 192 else "direct")
    return y
