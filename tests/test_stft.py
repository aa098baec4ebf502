import numpy as np
import pytest

import jax.numpy as jnp

from audioflow_tpu.ops import istft, magnitude, power, stft
from audioflow_tpu.ops.framing import num_frames
from audioflow_tpu.ops.windows import get_window


def _stft_oracle(x, n_fft, hop, center=True):
    """Independent float64 numpy STFT with the same conventions."""
    w = get_window("hann", n_fft, periodic=True)
    if center:
        x = np.pad(x, n_fft // 2, mode="reflect")
    n = num_frames(len(x), n_fft, hop)
    out = np.empty((n, n_fft // 2 + 1), dtype=np.complex128)
    for i in range(n):
        out[i] = np.fft.rfft(x[i * hop : i * hop + n_fft] * w)
    return out


@pytest.mark.parametrize("center", [True, False])
def test_stft_matches_oracle(rng, center):
    x = rng.standard_normal(4096).astype(np.float32)
    got = np.asarray(stft(jnp.asarray(x), n_fft=1024, hop=256, center=center))
    want = _stft_oracle(x.astype(np.float64), 1024, 256, center)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-4 * scale)


def test_stft_batched_shape(rng):
    x = rng.standard_normal((4, 4096)).astype(np.float32)
    got = stft(jnp.asarray(x), n_fft=512, hop=128)
    assert got.shape == (4, 4096 // 128 + 1, 257)


def test_magnitude_power(rng):
    x = rng.standard_normal(2048).astype(np.float32)
    spec = stft(jnp.asarray(x), n_fft=512, hop=128)
    np.testing.assert_allclose(
        np.asarray(power(spec)), np.asarray(magnitude(spec)) ** 2, rtol=2e-5, atol=1e-5
    )


@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (512, 128), (400, 100)])
def test_istft_round_trip(rng, n_fft, hop):
    t = 8192
    x = rng.standard_normal(t).astype(np.float32) * 0.5
    spec = stft(jnp.asarray(x), n_fft=n_fft, hop=hop)
    y = np.asarray(istft(spec, n_fft=n_fft, hop=hop, length=t))
    # edges lose window coverage; compare interior
    m = n_fft
    np.testing.assert_allclose(y[m:-m], x[m:-m], atol=1e-4)


def test_istft_round_trip_batched(rng):
    x = rng.standard_normal((3, 4096)).astype(np.float32)
    spec = stft(jnp.asarray(x), n_fft=512, hop=128)
    y = np.asarray(istft(spec, n_fft=512, hop=128, length=4096))
    np.testing.assert_allclose(y[:, 512:-512], x[:, 512:-512], atol=1e-4)


def test_win_length_padding(rng):
    x = rng.standard_normal(4096).astype(np.float32)
    spec = stft(jnp.asarray(x), n_fft=1024, hop=256, win_length=512)
    assert spec.shape[-1] == 513


# ---------------------------------------------------------- matmul spectrogram

@pytest.mark.parametrize("power_flag", [True, False])
@pytest.mark.parametrize("center", [True, False])
def test_spectrogram_matmul_matches_fft(rng, power_flag, center):
    from audioflow_tpu.ops import spectrogram

    x = rng.standard_normal(8192).astype(np.float32)
    got = np.asarray(
        spectrogram(jnp.asarray(x), 1024, 256, center=center, power=power_flag, impl="matmul")
    )
    want = np.asarray(
        spectrogram(jnp.asarray(x), 1024, 256, center=center, power=power_flag, impl="fft")
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4 * want.max())


def test_spectrogram_bad_impl():
    from audioflow_tpu.ops import spectrogram

    with pytest.raises(ValueError):
        spectrogram(jnp.zeros(4096), impl="bogus")


def test_spectrogram_node_streaming_matches_offline(rng):
    from audioflow_tpu.graph import Spectrogram, chain

    g = chain(Spectrogram(512, 128, center=False), input_rate=16000)
    x = rng.standard_normal(8192).astype(np.float32)
    streamed = np.asarray(g.scan_stream(jnp.asarray(x), 1024))
    lat = g.stream_latency(1024)
    offline = np.asarray(g.chain(jnp.asarray(x)))
    n = min(len(streamed) - lat, len(offline))
    np.testing.assert_allclose(streamed[lat : lat + n], offline[:n], atol=2e-4 * offline.max())


@pytest.mark.parametrize("center", [True, False])
def test_stft_matmul_impl_matches_fft(rng, center):
    x = rng.standard_normal(8192).astype(np.float32)
    a = np.asarray(stft(jnp.asarray(x), 1024, 256, center=center, impl="matmul"))
    b = np.asarray(stft(jnp.asarray(x), 1024, 256, center=center, impl="fft"))
    np.testing.assert_allclose(a, b, atol=2e-4 * np.abs(b).max())


@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (512, 128), (400, 160)])
def test_stft_fourstep_impl_matches_fft(rng, n_fft, hop):
    """Four-step factored DFT (N = N1 x N2, two short-K matmul stages + twiddle,
    ~8x fewer flops at n_fft=1024) agrees with the FFT — and the short
    contractions accumulate LESS error than the direct [N, N/2+1] banks."""
    x = rng.standard_normal(8192).astype(np.float32)
    a = np.asarray(stft(jnp.asarray(x), n_fft, hop, impl="fourstep"))
    b = np.asarray(stft(jnp.asarray(x), n_fft, hop, impl="fft"))
    np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("power_flag", [True, False])
def test_spectrogram_fourstep_matches_matmul(rng, power_flag):
    from audioflow_tpu.ops import spectrogram

    x = rng.standard_normal((3, 8192)).astype(np.float32)
    got = np.asarray(
        spectrogram(jnp.asarray(x), 1024, 256, power=power_flag, impl="fourstep")
    )
    want = np.asarray(
        spectrogram(jnp.asarray(x), 1024, 256, power=power_flag, impl="matmul")
    )
    np.testing.assert_allclose(got, want, atol=2e-4 * want.max())


@pytest.mark.parametrize("n_fft,hop,window", [(1024, 256, "hann"), (512, 128, "blackman"), (400, 160, "hamming")])
def test_stft_folded_impl_matches_fft(rng, n_fft, hop, window):
    """Symmetry-folded rDFT (pair n with N-n; half the MACs) == the FFT."""
    x = rng.standard_normal(8192).astype(np.float32)
    a = np.asarray(stft(jnp.asarray(x), n_fft, hop, window=window, impl="folded"))
    b = np.asarray(stft(jnp.asarray(x), n_fft, hop, window=window, impl="fft"))
    np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("power_flag", [True, False])
def test_spectrogram_folded_matches_matmul(rng, power_flag):
    from audioflow_tpu.ops import spectrogram

    x = rng.standard_normal((3, 8192)).astype(np.float32)
    got = np.asarray(
        spectrogram(jnp.asarray(x), 1024, 256, power=power_flag, impl="folded")
    )
    want = np.asarray(
        spectrogram(jnp.asarray(x), 1024, 256, power=power_flag, impl="matmul")
    )
    np.testing.assert_allclose(got, want, atol=2e-4 * want.max())


def test_folded_asymmetric_window_falls_back(rng):
    """win_length < n_fft with odd padding breaks w[n] == w[N-n]; the folded
    impl must detect it and produce plain-matmul results, not garbage."""
    from audioflow_tpu.ops.stft import _folded_banks

    # 1024 - 511 = 513 pad -> (256, 257): asymmetric
    assert _folded_banks(1024, "hann", 511) is None
    assert _folded_banks(1023, "hann", None) is None  # odd n_fft
    x = rng.standard_normal(8192).astype(np.float32)
    a = np.asarray(stft(jnp.asarray(x), 1024, 256, win_length=511, impl="folded"))
    b = np.asarray(stft(jnp.asarray(x), 1024, 256, win_length=511, impl="fft"))
    np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max())


def test_fourstep_factor_balanced_and_divides():
    from audioflow_tpu.ops.stft import _fourstep_factor

    assert _fourstep_factor(1024) == 32
    assert _fourstep_factor(512) == 32  # 32x16
    assert _fourstep_factor(400) == 16  # 16x25
    assert _fourstep_factor(2048) == 64  # 64x32
    for n in (256, 400, 512, 1024, 2048):
        assert n % _fourstep_factor(n) == 0


def test_istft_matmul_impl_matches_fft(rng):
    x = rng.standard_normal(8192).astype(np.float32)
    spec = stft(jnp.asarray(x), 512, 128)
    a = np.asarray(istft(spec, 512, 128, length=8192, impl="matmul"))
    b = np.asarray(istft(spec, 512, 128, length=8192, impl="fft"))
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_istft_matmul_odd_nfft(rng):
    """Nyquist weighting differs for odd n_fft; irfft parity check."""
    spec = jnp.asarray((rng.standard_normal((5, 251)) + 1j * rng.standard_normal((5, 251))).astype(np.complex64))
    from audioflow_tpu.ops.stft import _idft_banks

    ci, si = _idft_banks(500)
    got = np.real(np.asarray(spec)) @ ci + np.imag(np.asarray(spec)) @ si
    want = np.fft.irfft(np.asarray(spec), n=500, axis=-1)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_stft_bad_impl():
    with pytest.raises(ValueError):
        stft(jnp.zeros(4096), impl="nope")
    with pytest.raises(ValueError):
        istft(jnp.zeros((4, 513), jnp.complex64), impl="nope")


@pytest.mark.parametrize("power_flag", [True, False])
@pytest.mark.parametrize("center", [True, False])
def test_spectrogram_onedot_matches_fft(rng, power_flag, center):
    """Combined cos|sin bank (sin's identically-zero k=0 / k=N/2 columns
    dropped -> exactly n_fft columns, one zero-pad-waste dot) == FFT."""
    from audioflow_tpu.ops import spectrogram

    x = rng.standard_normal((3, 8192)).astype(np.float32)
    got = np.asarray(
        spectrogram(jnp.asarray(x), 1024, 256, power=power_flag, center=center, impl="onedot")
    )
    want = np.asarray(
        spectrogram(jnp.asarray(x), 1024, 256, power=power_flag, center=center, impl="fft")
    )
    np.testing.assert_allclose(got, want, atol=2e-4 * want.max())


@pytest.mark.parametrize("n_fft,hop,window", [(1024, 256, "hann"), (512, 128, "hamming"), (256, 64, "blackman")])
@pytest.mark.parametrize("power_flag", [True, False])
def test_spectrogram_radix2_matches_fft(rng, n_fft, hop, window, power_flag):
    """Even/odd decimation-in-time (two half-size combined-bank dots + an
    elementwise twiddle combine; half the MACs) == FFT."""
    from audioflow_tpu.ops import spectrogram

    x = rng.standard_normal((3, 8192)).astype(np.float32)
    got = np.asarray(
        spectrogram(jnp.asarray(x), n_fft, hop, window=window, power=power_flag, impl="radix2")
    )
    want = np.asarray(
        spectrogram(jnp.asarray(x), n_fft, hop, window=window, power=power_flag, impl="fft")
    )
    np.testing.assert_allclose(got, want, atol=2e-4 * want.max())


def test_spectrogram_radix2_falls_back_when_indivisible(rng):
    """Odd hop (or odd signal length) can't split by parity; radix2 must
    fall back to the onedot form, same results."""
    from audioflow_tpu.ops import spectrogram

    x = rng.standard_normal((2, 8191)).astype(np.float32)  # odd length
    got = np.asarray(spectrogram(jnp.asarray(x), 1024, 256, center=False, impl="radix2"))
    want = np.asarray(spectrogram(jnp.asarray(x), 1024, 256, center=False, impl="fft"))
    np.testing.assert_allclose(got, want, atol=2e-4 * want.max())


def test_spectrogram_radix2_win_length(rng):
    """The analysis window folds into the per-parity banks (w[2n] / w[2n+1]);
    a center-padded shorter window must fold correctly too."""
    from audioflow_tpu.ops import spectrogram

    x = rng.standard_normal(8192).astype(np.float32)
    got = np.asarray(
        spectrogram(jnp.asarray(x), 1024, 256, win_length=768, impl="radix2")
    )
    want = np.asarray(
        spectrogram(jnp.asarray(x), 1024, 256, win_length=768, impl="fft")
    )
    np.testing.assert_allclose(got, want, atol=2e-4 * want.max())
