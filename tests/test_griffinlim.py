"""Griffin-Lim phase reconstruction: convergence, contracts, batching."""

import numpy as np
import pytest

import jax.numpy as jnp

from audioflow_tpu import ops

FS, NFFT, HOP = 16000, 512, 128


def _mag(x):
    return jnp.abs(ops.stft(jnp.asarray(x), NFFT, HOP, impl="fft"))


def _spec_err(y, target_mag):
    r = _mag(np.asarray(y))
    n = min(r.shape[-2], target_mag.shape[-2])
    d = np.asarray(r)[..., :n, :] - np.asarray(target_mag)[..., :n, :]
    return np.sqrt((d**2).mean()) / np.sqrt((np.asarray(target_mag) ** 2).mean() + 1e-12)


def test_griffin_lim_converges_on_harmonic_signal(rng):
    t = np.arange(FS) / FS
    x = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.25 * np.sin(2 * np.pi * 880 * t + 1.0)).astype(
        np.float32
    )
    mag = _mag(x)
    y1 = ops.griffin_lim(mag, NFFT, HOP, n_iter=1, length=FS)
    y32 = ops.griffin_lim(mag, NFFT, HOP, n_iter=32, length=FS)
    e1, e32 = _spec_err(y1, mag), _spec_err(y32, mag)
    assert e32 < e1, (e1, e32)  # iterating improves spectral consistency
    assert e32 < 0.15, e32  # and lands close on a harmonic signal
    assert y32.shape == (FS,)


def test_griffin_lim_batched_and_momentum_zero(rng):
    x = rng.standard_normal((3, FS // 2)).astype(np.float32) * 0.2
    mag = _mag(x)
    y = ops.griffin_lim(mag, NFFT, HOP, n_iter=4, momentum=0.0)
    assert y.shape[0] == 3 and y.ndim == 2
    assert np.isfinite(np.asarray(y)).all()


def test_griffin_lim_matmul_matches_fft_path(rng):
    """The iteration is chaotic (tiny DFT rounding differences amplify
    through the phase nonlinearity), so waveforms are NOT comparable after
    several iterations; both paths must instead reach the same spectral
    consistency, and one iteration must still agree sample-wise."""
    t = np.arange(FS // 2) / FS
    x = (0.5 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)
    mag = _mag(x)
    ym1 = ops.griffin_lim(mag, NFFT, HOP, n_iter=1, impl="matmul", precision="highest")
    yf1 = ops.griffin_lim(mag, NFFT, HOP, n_iter=1, impl="fft")
    np.testing.assert_allclose(np.asarray(ym1), np.asarray(yf1), atol=5e-4)
    em = _spec_err(ops.griffin_lim(mag, NFFT, HOP, n_iter=16, impl="matmul"), mag)
    ef = _spec_err(ops.griffin_lim(mag, NFFT, HOP, n_iter=16, impl="fft"), mag)
    assert abs(em - ef) < 0.03, (em, ef)


def test_griffin_lim_init_phase_and_validation(rng):
    x = rng.standard_normal(FS // 2).astype(np.float32) * 0.1
    mag = _mag(x)
    true_phase = jnp.angle(ops.stft(jnp.asarray(x), NFFT, HOP, impl="fft"))
    # seeding with the true phase: one projection stays near-perfect
    y = ops.griffin_lim(mag, NFFT, HOP, n_iter=1, init_phase=true_phase, length=FS // 2)
    assert _spec_err(y, mag) < 0.02
    with pytest.raises(ValueError):
        ops.griffin_lim(mag, NFFT, HOP, momentum=1.0)


# --- the 1024/256 configuration of the validate row, on the default
# (matmul-DFT) path ---------------------------------------------------------


def _signal(batch=2, seconds=1.5, sr=FS, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    rows = [
        0.5 * np.sin(2 * np.pi * 440.0 * t)
        + 0.2 * np.sin(2 * np.pi * 880.0 * t + 0.7)
        + 0.02 * rng.standard_normal(t.size)
    ]
    for b in range(1, batch):
        rows.append(0.4 * np.sin(2 * np.pi * (200.0 + 60 * b) * t))
    return np.stack(rows).astype(np.float32)


def _mag1024(xb):
    return jnp.abs(ops.stft(jnp.asarray(xb), 1024, 256, impl="matmul", precision="highest"))


def test_griffin_lim_tone_reconstruction_1024():
    """GL recovers a tone only up to a global phase: the target magnitude
    is matched (spectral convergence, the validate-row metric) and the
    dominant frequency is right."""
    t = np.arange(FS) / FS
    x = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    mag = _mag1024(x[None])
    y = np.asarray(ops.griffin_lim(mag, 1024, 256, n_iter=8, length=FS))[0]
    m2 = np.asarray(_mag1024(y[None]))[:, : mag.shape[-2]]
    sc = np.linalg.norm(m2 - np.asarray(mag)) / np.linalg.norm(np.asarray(mag))
    assert sc < 0.25, sc
    sp = np.abs(np.fft.rfft(y * np.hanning(y.size)))
    assert abs(np.argmax(sp) * FS / y.size - 440.0) < 3.0


def test_griffin_lim_init_phase_oracle_is_kept_1024():
    """Seeded with the true phase, two projections keep the waveform."""
    xb = _signal(batch=1)
    spec = ops.stft(jnp.asarray(xb), 1024, 256, impl="matmul", precision="highest")
    y = np.asarray(
        ops.griffin_lim(jnp.abs(spec), 1024, 256, n_iter=2, init_phase=jnp.angle(spec),
                        length=xb.shape[-1], precision="highest")
    )
    sl = slice(2048, xb.shape[-1] - 2048)
    assert np.abs(y[:, sl] - xb[:, sl]).max() / np.abs(xb).max() < 1e-3


def test_griffin_lim_momentum_zero_and_length_1024():
    mag = _mag1024(_signal(batch=1, seconds=1.0))
    y = np.asarray(ops.griffin_lim(mag, 1024, 256, n_iter=2, momentum=0.0, length=12345))
    assert y.shape == (1, 12345)
    assert np.isfinite(y).all()


def test_griffin_lim_lead_dims_match_flat_batch():
    mag = _mag1024(_signal(batch=4, seconds=1.0))
    y = np.asarray(ops.griffin_lim(jnp.reshape(mag, (2, 2, *mag.shape[1:])), 1024, 256, n_iter=1))
    assert y.shape[:2] == (2, 2)
    y2 = np.asarray(ops.griffin_lim(mag, 1024, 256, n_iter=1))
    np.testing.assert_allclose(y.reshape(4, -1), y2, rtol=0, atol=1e-6)


@pytest.mark.parametrize(
    "kwargs, match",
    [({"momentum": 1.0}, "momentum"), ({"momentum": -0.1}, "momentum"),
     ({"impl": "pallas"}, "known: matmul, fft"), ({"impl": "auto"}, "known: matmul, fft")],
)
def test_griffin_lim_validation_errors(kwargs, match):
    with pytest.raises(ValueError, match=match):
        ops.griffin_lim(jnp.zeros((2, 16, 513)), 1024, 256, **kwargs)
