import numpy as np
import pytest

import jax.numpy as jnp

from audioflow_tpu.ops import get_window, phase_vocoder, pitch_shift, stft, time_stretch


def _dominant_freq(y, sr):
    spec = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    return np.argmax(spec) * sr / len(y)


def test_identity_rate_round_trip():
    sr = 16000
    t = np.arange(sr) / sr
    x = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    y = np.asarray(time_stretch(jnp.asarray(x), rate=1.0))
    assert y.shape == x.shape
    m = 2048
    np.testing.assert_allclose(y[m:-m], x[m:-m], atol=5e-3)


@pytest.mark.parametrize("rate", [0.5, 2.0])
def test_stretch_length_and_pitch_preserved(rate):
    sr, f0 = 16000, 523.0
    t = np.arange(sr) / sr
    x = (0.5 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)
    y = np.asarray(time_stretch(jnp.asarray(x), rate=rate))
    assert abs(len(y) - int(round(len(x) / rate))) <= 1
    assert abs(_dominant_freq(y[2048:-2048], sr) - f0) < 8.0


def test_pitch_shift_moves_frequency():
    sr, f0 = 16000, 440.0
    t = np.arange(sr) / sr
    x = (0.5 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)
    up = np.asarray(pitch_shift(jnp.asarray(x), 12.0, sample_rate=sr))
    assert up.shape == x.shape
    got = _dominant_freq(up[2048:-2048], sr)
    assert abs(got - 2 * f0) < 15.0


def test_pitch_shift_irrational_factor_small_bank():
    # 2^(7/12) is irrational: the resample ratio must come from a small
    # rational approximation (denominator <= 64), not int(sr * factor) vs sr
    # (coprime with 16000 -> a 16000-phase polyphase bank and a multi-minute
    # host-side plan build). Accuracy bar: < 1 cent pitch error end to end.
    sr, f0 = 16000, 440.0
    t = np.arange(sr) / sr
    x = (0.5 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)
    up = np.asarray(pitch_shift(jnp.asarray(x), 7.0, sample_rate=sr))
    assert up.shape == x.shape
    got = _dominant_freq(up[2048:-2048], sr)
    want = f0 * 2 ** (7 / 12)
    assert abs(got - want) < 15.0


def test_phase_vocoder_spec_shape(rng):
    x = jnp.asarray(rng.standard_normal(8192).astype(np.float32))
    spec = stft(x, n_fft=1024, hop=256)
    out = phase_vocoder(spec, rate=2.0, hop=256, n_fft=1024)
    assert out.shape[-1] == spec.shape[-1]
    assert out.shape[-2] == int(np.ceil(spec.shape[-2] / 2.0))


def test_invalid_rate_raises():
    with pytest.raises(ValueError):
        time_stretch(jnp.zeros(4096), rate=0.0)


def _stretch_f64(x, rate, n_fft=1024, hop=256):
    """float64 numpy phase vocoder with time_stretch's conventions: centered
    hann STFT, magnitude interpolation between the two nearest analysis
    frames, phase advanced by the wrapped per-hop increment, WOLA ISTFT."""
    x = np.asarray(x, np.float64)
    w = get_window("hann", n_fft).astype(np.float64)
    xp = np.pad(x, (n_fft // 2, n_fft // 2), mode="reflect")
    nf = 1 + (len(xp) - n_fft) // hop
    spec = np.fft.rfft(xp[np.arange(nf)[:, None] * hop + np.arange(n_fft)] * w, axis=-1)
    steps = np.arange(0, nf, rate)
    lo = np.minimum(steps.astype(np.int64), nf - 1)
    hi = np.minimum(lo + 1, nf - 1)
    frac = (steps - lo)[:, None]
    mag = (1 - frac) * np.abs(spec[lo]) + frac * np.abs(spec[hi])
    adv = 2 * np.pi * hop / n_fft * np.arange(n_fft // 2 + 1)
    dev = np.angle(spec[hi]) - np.angle(spec[lo]) - adv
    inc = adv + dev - 2 * np.pi * np.round(dev / (2 * np.pi))
    phase = np.angle(spec[0]) + np.concatenate(
        [np.zeros((1, inc.shape[1])), np.cumsum(inc[:-1], axis=0)]
    )
    frames = np.fft.irfft(mag * np.exp(1j * phase), n=n_fft, axis=-1) * w
    y = np.zeros((len(frames) - 1) * hop + n_fft)
    wsq = np.zeros_like(y)
    for i, f in enumerate(frames):
        y[i * hop : i * hop + n_fft] += f
        wsq[i * hop : i * hop + n_fft] += w * w
    y /= np.maximum(wsq, 1e-11)
    return y[n_fft // 2 : n_fft // 2 + int(round(len(x) / rate))]


def _tone_noise(seconds=2.0, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    return (0.5 * np.sin(2 * np.pi * 523.0 * t) + 0.1 * rng.standard_normal(t.size)).astype(
        np.float32
    )


@pytest.mark.parametrize("rate", [1.25, 2.0, 1.5, 0.8, 2.0 / 3.0, 0.5])
def test_time_stretch_matches_float64_reference(rate):
    x = _tone_noise()
    got = np.asarray(time_stretch(jnp.asarray(x), rate))
    want = _stretch_f64(x, rate)
    assert got.shape == want.shape
    rel = np.abs(got - want).max() / np.abs(want).max()
    # float32 phase accumulates over the output frames (~1e-3 at 2 s),
    # so the budget grows with the output length
    assert rel < 2.5e-3 * max(1.0, 1.0 / rate), rel


def test_time_stretch_1d_input_length_and_batch_rows():
    x = _tone_noise(1.0)
    y1 = np.asarray(time_stretch(jnp.asarray(x), 1.25))
    assert y1.ndim == 1 and y1.shape[-1] == int(round(len(x) / 1.25))
    y3 = np.asarray(time_stretch(jnp.asarray(x[:-7]), 1.5))
    assert y3.shape == (int(round((len(x) - 7) / 1.5)),)
    x2 = _tone_noise(1.0, seed=1)
    yb = np.asarray(time_stretch(jnp.asarray(np.stack([x, x2])), 1.25))
    np.testing.assert_allclose(yb[0], y1, rtol=0, atol=1e-5)
    y2 = np.asarray(time_stretch(jnp.asarray(x2), 1.25))
    np.testing.assert_allclose(yb[1], y2, rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", ["pallas", "auto", "nope"])
def test_time_stretch_unknown_impl_raises(impl):
    with pytest.raises(ValueError, match="known: matmul, fft"):
        time_stretch(jnp.zeros(4096), 1.25, impl=impl)
