import numpy as np
import pytest

import jax
import jax.numpy as jnp

from audioflow_tpu import ops
from audioflow_tpu.errors import AudioError, ConfigError
from audioflow_tpu.graph import (
    BiquadChain,
    Gain,
    Graph,
    Istft,
    Limiter,
    Magnitude,
    MelProject,
    Power,
    Resample,
    Stft,
    ToMono,
    Vad,
    chain,
)


def _logmel_graph(in_rate=48000):
    return chain(
        Resample(in_rate, 16000, "kaiser"),
        Stft(512, 128, center=False),
        Power(),
        MelProject(n_mels=64),
        input_rate=in_rate,
    )


def test_graph_matches_manual_chain(rng):
    g = _logmel_graph()
    x = jnp.asarray(rng.standard_normal(48000).astype(np.float32))
    got = np.asarray(g.compile()(x))
    y = ops.resample(x, 48000, 16000)
    spec = ops.power(ops.stft(y, 512, 128, center=False))
    want = np.asarray(ops.log_mel(spec, ops.mel_filterbank(257, 64, 16000)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_rate_binding_propagates():
    g = _logmel_graph()
    assert g.output_rate == 16000
    # MelProject picked up the post-resample rate
    assert g.nodes[-1].sample_rate == 16000
    lim = chain(Limiter(), input_rate=44100)
    assert lim.nodes[0].sample_rate == 44100


def test_rate_mismatch_raises():
    with pytest.raises(AudioError):
        chain(Resample(48000, 16000), input_rate=44100)


def test_domain_mismatch_raises():
    with pytest.raises(ConfigError):
        chain(Power(), input_rate=16000)  # frames node fed samples
    with pytest.raises(ConfigError):
        chain(Stft(), Gain(), input_rate=16000)  # samples node fed frames


def test_empty_graph_raises():
    with pytest.raises(ConfigError):
        Graph(())


def test_graph_is_one_jitted_program(rng):
    g = _logmel_graph()
    lowered = jax.jit(g.chain).lower(jnp.zeros(48000, jnp.float32))
    hlo = lowered.as_text()
    # one entry computation; sanity that fft + dot are both in the program
    assert "fft" in hlo.lower()
    assert "dot" in hlo.lower()


def test_batched_graph(rng):
    g = _logmel_graph()
    x = jnp.asarray(rng.standard_normal((3, 48000)).astype(np.float32))
    out = g.compile()(x)
    assert out.shape[0] == 3
    one = g.compile()(x[1])
    np.testing.assert_allclose(np.asarray(out[1]), np.asarray(one), atol=1e-5)


# ---------------------------------------------------------------- streaming

def test_stream_step_iir_matches_offline(rng):
    g = chain(BiquadChain((ops.highpass(100.0, 16000.0), ops.peaking(1000.0, 16000.0, 4.0))), input_rate=16000)
    x = rng.standard_normal(8192).astype(np.float32)
    offline = np.asarray(g.chain(jnp.asarray(x)))
    state = g.init_state(1024)
    step = g.compile_stream(donate=False)
    outs = []
    for k in range(8):
        state, y = step(state, jnp.asarray(x[k * 1024 : (k + 1) * 1024]))
        outs.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(outs), offline, atol=1e-5)


def test_stream_resample_matches_offline_after_latency(rng):
    g = chain(Resample(48000, 16000, "kaiser"), input_rate=48000)
    chunk = g.chunk_granularity() * 10  # 3840
    x = rng.standard_normal(chunk * 12).astype(np.float32)
    offline = np.asarray(g.chain(jnp.asarray(x)))
    streamed = np.asarray(g.scan_stream(jnp.asarray(x), chunk))
    lat = g.stream_latency(chunk)
    assert lat > 0
    n = len(streamed) - lat
    np.testing.assert_allclose(streamed[lat:], offline[:n], atol=1e-5)


@pytest.mark.parametrize(
    "tail",
    [
        lambda: [BiquadChain((ops.highpass(100.0, 16000.0),))],
        lambda: [Limiter(-3.0)],
        lambda: [Stft(512, 128, center=False), Istft(512, 128, center=False)],
    ],
    ids=["biquad", "limiter", "stft-istft"],
)
def test_recursive_node_after_latency_is_exact_from_sample_zero(rng, tail):
    """Regression: a recursive/accumulating node downstream of a
    latency-bearing node must NOT fold the upstream preroll into its carry
    (Graph._warmups zeroing). Before the fix, resample->biquad streamed
    diverged from offline by ~2e-3 over the filter's settle time — from the
    very first valid sample, on every backend."""
    nodes = tail()
    g = chain(Resample(48000, 16000, "kaiser"), *nodes, input_rate=48000)
    chunk = g.chunk_granularity() * 4
    x = (0.3 * rng.standard_normal(chunk * 10)).astype(np.float32)
    offline = np.asarray(g.chain(jnp.asarray(x)))
    streamed = np.asarray(g.scan_stream(jnp.asarray(x), chunk))
    lat = g.stream_latency(chunk)
    n = min(len(streamed) - lat, len(offline))
    # exact from position 0 of the valid region — no settle-time exclusion.
    # Exception: the offline ISTFT's first few samples divide ~0/~0 (hann[0]
    # == 0 leaves wsum degenerate at the very edge — same skip as
    # test_istft_streaming_matches_offline), which is an offline edge
    # convention, not a streaming transient.
    deg = 4 if any(isinstance(nd, Istft) for nd in nodes) else 0
    np.testing.assert_allclose(streamed[lat + deg : lat + n], offline[deg:n], atol=2e-5)


def test_stream_full_pipeline_scan(rng):
    """Streaming resample->EQ->limiter->STFT->logmel stays shape-consistent
    and matches the offline graph on the overlapping (post-latency) region."""
    g = chain(
        Resample(48000, 16000, "kaiser"),
        BiquadChain((ops.highpass(80.0, 16000.0),)),
        Limiter(threshold_db=-3.0),
        Stft(512, 128, center=False),
        Power(),
        MelProject(n_mels=32),
        input_rate=48000,
    )
    chunk = g.chunk_granularity() * 25  # granularity = lcm(384, 3*128) = 384
    x = (rng.standard_normal(chunk * 10) * 0.4).astype(np.float32)
    streamed = np.asarray(g.scan_stream(jnp.asarray(x), chunk))
    offline = np.asarray(g.chain(jnp.asarray(x)))
    lat = g.stream_latency(chunk)
    n = min(len(streamed) - lat, len(offline))
    assert n > 100
    # delay alignment makes streamed == offline exactly (up to f32 noise,
    # amplified by log near the mel floor)
    np.testing.assert_allclose(streamed[lat : lat + n], offline[:n], atol=5e-4)


def test_stream_vad(rng):
    g = chain(Vad(frame_len=320), input_rate=16000)
    # tail must outlast EMA decay (~9 frames) + silence timeout (15 frames)
    x = np.concatenate(
        [np.zeros(6400), 0.4 * np.sin(2 * np.pi * 300 * np.arange(16000) / 16000), np.zeros(12800)]
    ).astype(np.float32)
    states = np.asarray(g.scan_stream(jnp.asarray(x), 3200))
    offline = np.asarray(g.chain(jnp.asarray(x)))
    np.testing.assert_array_equal(states, offline)
    assert 1 in states and 2 in states


def test_non_streamable_raises(rng):
    from audioflow_tpu.graph import PeakNormalize

    g = chain(PeakNormalize(), input_rate=16000)
    with pytest.raises(AudioError):
        g.init_state(1024)


def test_bad_chunk_raises():
    g = chain(Stft(512, 128, center=False), input_rate=16000)
    with pytest.raises(AudioError):
        g.chunk_lens(1000)  # not a multiple of hop


def test_to_mono_node(rng):
    g = chain(ToMono(2), input_rate=48000)
    x = jnp.asarray(rng.standard_normal(1000).astype(np.float32))
    assert g.chain(x).shape == (500,)


def test_stream_stft_matches_prepadded_offline(rng):
    g = chain(Stft(512, 128, center=False), input_rate=16000)
    x = rng.standard_normal(4096).astype(np.float32)
    streamed = np.asarray(g.scan_stream(jnp.asarray(x), 512))
    padded = np.concatenate([np.zeros(512 - 128, np.float32), x])
    want = np.asarray(ops.stft(jnp.asarray(padded), 512, 128, center=False))
    n = min(len(streamed), len(want))
    np.testing.assert_allclose(streamed[:n], want[:n], atol=2e-4)


def test_vad_gate_mutes_silence(rng):
    from audioflow_tpu.graph import VadGate

    g = chain(VadGate(frame_len=160, smoothing_factor=0.0, silence_timeout_frames=2,
                      min_speech_frames=1), input_rate=16000)
    x = np.concatenate(
        [np.zeros(1600), 0.4 * np.sin(2 * np.pi * 300 * np.arange(4800) / 16000), np.zeros(3200)]
    ).astype(np.float32)
    y = np.asarray(g.chain(jnp.asarray(x)))
    assert np.abs(y[:1600]).max() == 0.0            # leading silence muted
    assert np.abs(y[1600:6400]).max() > 0.3         # speech passes
    assert np.abs(y[-1600:]).max() == 0.0           # trailing silence muted
    # streaming == offline
    streamed = np.asarray(g.scan_stream(jnp.asarray(x), 1600))
    np.testing.assert_allclose(streamed, y, atol=1e-7)


def test_istft_node_round_trip(rng):
    from audioflow_tpu.graph import Istft, Stft

    g = chain(Stft(512, 128), Istft(512, 128), input_rate=16000)
    x = (rng.standard_normal(4096) * 0.5).astype(np.float32)
    y = np.asarray(g.chain(jnp.asarray(x)))
    np.testing.assert_allclose(y[512:-512], x[512 : len(y) - 512], atol=1e-4)


def test_streaming_center_true_rejected():
    from audioflow_tpu.graph import Spectrogram

    g = chain(Stft(512, 128, center=True), input_rate=16000)
    assert not g.streamable  # center=True nodes now report it up front
    with pytest.raises(AudioError, match="not streamable"):
        g.init_state(1024)
    g2 = chain(Spectrogram(512, 128, center=True), input_rate=16000)
    with pytest.raises(AudioError, match="center=False"):
        g2.chunk_lens(1024)


def test_graph_taps(rng):
    """One program yields intermediate outputs (flow-graph DAG taps)."""
    g = _logmel_graph()
    x = jnp.asarray(rng.standard_normal(48000).astype(np.float32))
    final, tapped = g.compile(taps=(0, 1))(x)
    assert set(tapped) == {0, 1}
    assert tapped[0].shape == (16000,)  # post-resample samples
    assert tapped[1].dtype == jnp.complex64  # post-stft spectrum
    np.testing.assert_allclose(np.asarray(final), np.asarray(g.compile()(x)), atol=1e-6)
    with pytest.raises(ConfigError):
        g.compile(taps=(99,))


def test_istft_streaming_matches_offline(rng):
    """Streaming WOLA resynthesis equals the offline ISTFT prefix exactly."""
    from audioflow_tpu.graph import Istft

    g = chain(Stft(512, 128, center=False), Istft(512, 128, center=False), input_rate=16000)
    assert g.streamable
    x = (rng.standard_normal(8192) * 0.5).astype(np.float32)
    streamed = np.asarray(g.scan_stream(jnp.asarray(x), 1024))
    offline = np.asarray(g.chain(jnp.asarray(x)))
    lat = g.stream_latency(1024)
    n = min(len(streamed) - lat, len(offline))
    # hann[0] == 0 leaves the first couple of samples wsum-degenerate in both
    # paths (clamped division of ~0/~0); compare from sample 2
    np.testing.assert_allclose(streamed[lat + 2 : lat + n], offline[2:n], atol=2e-4)
    # and the round-trip reconstructs the input on the interior
    np.testing.assert_allclose(offline[512:6000], x[512:6000], atol=1e-3)


def test_phase_vocoder_streaming(rng):
    """Streaming pvoc: magnitudes match offline exactly after the delay;
    resynthesis is click-free and pitch-preserving."""
    from audioflow_tpu.graph import Istft, PhaseVocoderStretch

    sr, f0 = 16000, 523.0
    t = np.arange(sr * 2) / sr
    x = (0.5 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)

    g = chain(
        Stft(1024, 256, center=False),
        PhaseVocoderStretch(rate_num=5, rate_den=4, hop=256, n_fft=1024),
        input_rate=sr,
    )
    chunk = g.chunk_granularity() * 4
    n_chunks = len(x) // chunk
    streamed = np.asarray(g.scan_stream(jnp.asarray(x[: n_chunks * chunk]), chunk))
    offline = np.asarray(g.chain(jnp.asarray(x[: n_chunks * chunk])))
    lat = g.stream_latency(chunk)
    n = min(len(streamed) - lat, len(offline))
    # magnitudes are interpolations of the same analysis frames -> exact
    np.testing.assert_allclose(
        np.abs(streamed[lat : lat + n]), np.abs(offline[:n]),
        atol=2e-3 * np.abs(offline[:n]).max(),
    )

    # full streaming tempo change with resynthesis
    g2 = chain(
        Stft(1024, 256, center=False),
        PhaseVocoderStretch(rate_num=5, rate_den=4, hop=256, n_fft=1024),
        Istft(1024, 256, center=False),
        input_rate=sr,
    )
    y = np.asarray(g2.scan_stream(jnp.asarray(x[: n_chunks * chunk]), chunk))
    assert len(y) == pytest.approx(n_chunks * chunk * 4 / 5, abs=chunk)
    body = y[4096:-1024]
    spec = np.abs(np.fft.rfft(body * np.hanning(len(body))))
    got_f = np.argmax(spec) * sr / len(body)
    assert abs(got_f - f0) < 6.0  # pitch preserved
    # click-free: adjacent-sample jumps bounded by the tone's natural slope
    max_jump = np.abs(np.diff(body)).max()
    assert max_jump < 0.35, max_jump


def test_phase_vocoder_stretch_validation():
    from audioflow_tpu.graph import PhaseVocoderStretch

    with pytest.raises(AudioError):
        PhaseVocoderStretch(rate_num=0, rate_den=1)
    node = PhaseVocoderStretch(rate_num=10, rate_den=8)  # reduces to 5/4
    assert (node.rate_num, node.rate_den) == (5, 4)


def test_graph_inspect(rng):
    g = _logmel_graph()
    rep = g.inspect((2, 48000))
    assert rep["fusions"] >= 1
    assert rep["collectives"] == 0
    assert rep["hlo_bytes"] > 1000


def test_compile_chunked_equals_whole_array(rng):
    """compile(chunked=...) — the offline API riding the streaming machinery
    — returns the whole-array program's result to f32 reassociation noise,
    including non-chunk-multiple lengths and frames-domain outputs."""
    from audioflow_tpu.models import log_mel_frontend

    g = log_mel_frontend(44100, 16000, 1024, 256, 64)
    x = (0.3 * rng.standard_normal(44100 * 2 + 1234)).astype(np.float32)
    off = np.asarray(g.compile(chunked=False)(jnp.asarray(x)))
    ch = np.asarray(g.compile(chunked=True)(jnp.asarray(x)))
    assert off.shape == ch.shape
    np.testing.assert_allclose(ch, off, atol=5e-5 * float(np.abs(off).max()))
    # batched auto path above the threshold picks chunked and stays equal
    xb = (0.3 * rng.standard_normal((3, 44100 * 2)).astype(np.float32))
    off_b = np.asarray(g.compile(chunked=False)(jnp.asarray(xb)))
    auto_b = np.asarray(g.compile()(jnp.asarray(xb)))
    np.testing.assert_allclose(auto_b, off_b, atol=5e-5 * float(np.abs(off_b).max()))


def test_compile_chunked_decenters_leading_center_node(rng):
    """A leading center=True Stft/Spectrogram no longer blocks the chunked
    form: center=True framing == center=False framing of the reflect-padded
    signal, so compile() pads once outside the scan and streams the rest."""
    from audioflow_tpu.graph import MelProject, Spectrogram

    x = (0.3 * rng.standard_normal(100000)).astype(np.float32)
    for g in (
        chain(Stft(1024, 256, center=True), Magnitude(), input_rate=16000),
        chain(Spectrogram(1024, 256, center=True, power=False), input_rate=16000),
        chain(
            Spectrogram(1024, 256, center=True), MelProject(n_mels=64),
            input_rate=16000,
        ),
    ):
        assert not g.streamable  # live streaming still can't reflect the tail
        ref = np.asarray(g.compile(chunked=False)(jnp.asarray(x)))
        ch = np.asarray(g.compile(chunked=True)(jnp.asarray(x)))
        assert ch.shape == ref.shape
        np.testing.assert_allclose(ch, ref, atol=5e-5 * float(np.abs(ref).max()))


def test_compile_chunked_falls_back_for_unstreamable(rng):
    from audioflow_tpu.graph import Gain

    # center node NOT leading: the decentering identity doesn't apply (the
    # pad would have to commute with the upstream node) -> whole-array path
    g = chain(Gain(db=3.0), Stft(1024, 256, center=True), input_rate=16000)
    assert not g.streamable
    x = (0.3 * rng.standard_normal(100000)).astype(np.float32)
    out = np.asarray(g.compile()(jnp.asarray(x)))  # auto: whole-array path
    ref = np.asarray(g.compile(chunked=False)(jnp.asarray(x)))
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(AudioError):
        g.compile(chunked=True)  # forcing it on an unstreamable graph raises
