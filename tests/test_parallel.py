"""Sharding tests on the 8-virtual-device CPU mesh (conftest forces platform)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from audioflow_tpu import ops
from audioflow_tpu.errors import AudioError
from audioflow_tpu.graph import MelProject, Power, Resample, Stft, chain
from audioflow_tpu.parallel import (
    batch_sharding,
    compile_sharded,
    make_mesh,
    mask_lanes,
    pad_batch,
    shard_batch,
)


def _graph():
    from audioflow_tpu.graph import Spectrogram

    return chain(
        Resample(48000, 16000, "kaiser"),
        Spectrogram(512, 128, center=False),
        MelProject(n_mels=32),
        input_rate=48000,
    )


def test_mesh_has_8_cpu_devices():
    mesh = make_mesh()
    assert mesh.shape["data"] == 8


def test_shard_batch_placement(rng):
    mesh = make_mesh()
    x = rng.standard_normal((16, 4800)).astype(np.float32)
    xs = shard_batch(x, mesh)
    assert xs.sharding == batch_sharding(mesh, 2)
    # each device holds 2 rows
    assert xs.addressable_shards[0].data.shape == (2, 4800)


def test_sharded_graph_matches_single_device(rng):
    mesh = make_mesh()
    g = _graph()
    x = rng.standard_normal((8, 48000)).astype(np.float32)
    fn = compile_sharded(g, mesh)
    out = np.asarray(fn(shard_batch(x, mesh)))
    want = np.asarray(g.compile()(jnp.asarray(x)))
    np.testing.assert_allclose(out, want, atol=1e-5)


def test_sharded_output_stays_sharded(rng):
    """No implicit gather: the batch axis sharding propagates to the output."""
    mesh = make_mesh()
    g = _graph()
    x = shard_batch(rng.standard_normal((8, 48000)).astype(np.float32), mesh)
    out = compile_sharded(g, mesh)(x)
    # output [8, frames, mels] should still be sharded on axis 0
    spec = out.sharding.spec
    assert spec[0] == "data"


def test_pad_batch_and_mask(rng):
    mesh = make_mesh()
    x = rng.standard_normal((5, 100)).astype(np.float32)
    xp, mask = pad_batch(x, mesh)
    assert xp.shape[0] == 8 and mask.sum() == 5
    out = jnp.asarray(xp) * 2
    masked, m = mask_lanes(out, mask)
    assert np.asarray(masked)[5:].sum() == 0
    np.testing.assert_allclose(np.asarray(masked)[:5], x * 2, atol=1e-6)


def test_indivisible_batch_raises(rng):
    mesh = make_mesh()
    with pytest.raises(AudioError):
        shard_batch(rng.standard_normal((5, 10)).astype(np.float32), mesh)


def test_2d_mesh():
    mesh = make_mesh(axes=("data", "model"), shape=(4, 2))
    assert mesh.shape == {"data": 4, "model": 2}


def test_vmapped_streaming_scan_sharded(rng):
    """Streaming scan over a sharded batch: per-lane carries stay on-lane."""
    mesh = make_mesh()
    g = chain(Resample(48000, 16000), input_rate=48000)
    chunk = g.chunk_granularity() * 4
    x = rng.standard_normal((8, chunk * 3)).astype(np.float32)
    fn = jax.jit(
        lambda b: g.scan_stream(b, chunk),
        in_shardings=(batch_sharding(mesh, 2),),
    )
    out = np.asarray(fn(shard_batch(x, mesh)))
    want = np.asarray(g.scan_stream(jnp.asarray(x), chunk))
    np.testing.assert_allclose(out, want, atol=1e-5)


def test_sharded_hot_path_has_no_collectives(rng):
    """The DP design promise (SURVEY §2.6): batch-sharded DSP graphs compile
    with zero cross-chip communication."""
    mesh = make_mesh()
    g = _graph()
    x = shard_batch(rng.standard_normal((8, 48000)).astype(np.float32), mesh)
    fn = compile_sharded(g, mesh)
    hlo = fn.lower(x).compile().as_text().lower()
    for coll in ("all-reduce", "all-gather", "collective-permute", "all-to-all", "reduce-scatter"):
        assert coll not in hlo, f"unexpected collective {coll} on the hot path"


def test_fft_stft_gathers_under_sharding(rng):
    """Documented limitation: XLA does not partition its FFT op, so a
    batch-sharded Stft (impl=fft) all-gathers the batch — use Spectrogram
    (matmul-DFT) in sharded pipelines unless the complex spectrum is needed."""
    mesh = make_mesh()
    g = chain(Stft(512, 128, center=False), input_rate=16000)
    x = shard_batch(rng.standard_normal((8, 48000)).astype(np.float32), mesh)
    hlo = compile_sharded(g, mesh).lower(x).compile().as_text().lower()
    assert "all-gather" in hlo


def test_trainable_step_has_gradient_allreduce(rng):
    """Conversely, the DP training step must all-reduce gradients across devices."""
    from audioflow_tpu.models import TrainableFrontend, make_train_step

    model = TrainableFrontend(n_fft=256, hop=128, n_mels=8, n_classes=2)
    params = model.init_params()
    mesh = make_mesh()
    step, opt = make_train_step(model, mesh=mesh)
    x = shard_batch(rng.standard_normal((8, 2048)).astype(np.float32), mesh)
    y = shard_batch(rng.integers(0, 2, 8).astype(np.int32), mesh)
    hlo = step.lower(params, opt.init(params), x, y).compile().as_text().lower()
    assert "all-reduce" in hlo


def test_multihost_init_honest_error_handling(monkeypatch):
    """multihost_init (SURVEY §5.8): benign already-initialized -> False,
    real misconfiguration -> logged and re-raised, success -> True."""
    import jax as _jax

    from audioflow_tpu import parallel

    calls = {}

    def fake_ok(coordinator_address=None, num_processes=None, process_id=None):
        calls["args"] = (coordinator_address, num_processes, process_id)

    monkeypatch.setattr(_jax.distributed, "initialize", fake_ok)
    assert parallel.multihost_init("10.0.0.1:1234", 2, 0) is True
    assert calls["args"] == ("10.0.0.1:1234", 2, 0)

    def fake_already(**kw):
        raise RuntimeError("jax.distributed is already initialized")

    monkeypatch.setattr(_jax.distributed, "initialize", fake_already)
    assert parallel.multihost_init() is False

    def fake_bad(**kw):
        raise RuntimeError("Could not connect to coordinator at 10.0.0.1:1234")

    monkeypatch.setattr(_jax.distributed, "initialize", fake_bad)
    with pytest.raises(RuntimeError, match="coordinator"):
        parallel.multihost_init("10.0.0.1:1234", 2, 1)

    def fake_valueerror(**kw):
        raise ValueError("process_id 7 out of range for num_processes 2")

    monkeypatch.setattr(_jax.distributed, "initialize", fake_valueerror)
    with pytest.raises(ValueError, match="process_id"):
        parallel.multihost_init("10.0.0.1:1234", 2, 7)


def test_fork_shards_with_zero_collectives():
    """A Fork (multi-branch DAG) compiles over the DP mesh with no
    collectives on the hot path — branch outputs shard like the batch."""
    import jax

    from audioflow_tpu.graph import Resample, Spectrogram, VadGate, chain, fork
    from audioflow_tpu.parallel import batch_sharding, make_mesh, shard_batch

    mesh = make_mesh()
    f = fork(
        chain(Resample(48000, 16000), input_rate=48000),
        wire=chain(VadGate(frame_len=320)),
        # matmul-DFT spectrogram: the XLA FFT op is not partitioned by GSPMD
        # and would all-gather the batch (the documented sharding rule)
        feats=chain(Spectrogram(512, 160, center=False, power=False)),
    )
    x = np.random.default_rng(0).standard_normal((16, 9600)).astype(np.float32)
    xd = shard_batch(x, mesh)
    fn = jax.jit(f.chain, in_shardings=(batch_sharding(mesh, 2),))
    lowered = fn.lower(xd).compile()
    hlo = lowered.as_text().lower()
    for c in ("all-reduce(", "all-gather(", "reduce-scatter(", "collective-permute("):
        assert c not in hlo, c
    out = fn(xd)
    assert out["wire"].shape == (16, 3200)
    assert out["feats"].shape[0] == 16


def test_new_family_nodes_shard_with_zero_collectives(rng):
    """The round-2 families keep the DP promise: compressor/gate/AGC
    (envelope/gain math), loudness normalize (masked means + biquads),
    PCEN/deltas/descriptor frontends — all batch-elementwise, zero
    cross-chip communication when batch-sharded."""
    from audioflow_tpu.graph import (
        Agc,
        Compressor,
        Deltas,
        LoudnessNormalize,
        MelProject,
        NoiseGate,
        Pcen,
        SpectralFeatures,
        Spectrogram,
        chain,
    )

    mesh = make_mesh()
    x = shard_batch(rng.standard_normal((8, 32768)).astype(np.float32), mesh)
    graphs = [
        chain(Compressor(-20.0, 4.0), NoiseGate(-50.0), Agc(), input_rate=16000),
        chain(LoudnessNormalize(max_true_peak_db=None), input_rate=16000),
        chain(
            Spectrogram(512, 128, center=False),
            MelProject(n_mels=40, log=None),
            Pcen(n_bins=40),
            Deltas(width=9, orders=(1,), n_bins=40),
            input_rate=16000,
        ),
        chain(
            Spectrogram(512, 128, center=False, power=False),
            SpectralFeatures(("centroid", "flatness", "rolloff")),
            input_rate=16000,
        ),
    ]
    for g in graphs:
        hlo = compile_sharded(g, mesh).lower(x).compile().as_text().lower()
        for coll in ("all-reduce(", "all-gather(", "collective-permute(", "all-to-all(", "reduce-scatter("):
            assert coll not in hlo, (g.name, coll)


def test_music_family_nodes_shard_with_zero_collectives(rng):
    """CQT (per-octave matmul kernels), spectral contrast (per-band sort),
    tonnetz (tiny matmul), and onset strength (elementwise flux) are
    batch-elementwise: zero cross-chip communication when batch-sharded.
    (Tempo/BeatTrack ride FFT autocorrelation and gather — covered by the
    documented-FFT test below.)"""
    from audioflow_tpu.graph import (
        Chroma,
        Cqt,
        MelProject,
        OnsetStrength,
        SpectralContrast,
        Spectrogram,
        Tonnetz,
        chain,
    )

    mesh = make_mesh()
    x = shard_batch(rng.standard_normal((8, 32768)).astype(np.float32), mesh)
    graphs = [
        chain(Cqt(n_bins=36, fmin=220.0, center=False), input_rate=16000),
        chain(
            Spectrogram(512, 128, center=False, power=False),
            SpectralContrast(),
            input_rate=16000,
        ),
        chain(
            Spectrogram(512, 128, center=False, power=True),
            Chroma(),
            Tonnetz(),
            input_rate=16000,
        ),
        chain(
            Spectrogram(512, 128, center=False, power=True),
            MelProject(n_mels=40, log=None),
            OnsetStrength(n_bins=40),
            input_rate=16000,
        ),
    ]
    for g in graphs:
        hlo = compile_sharded(g, mesh).lower(x).compile().as_text().lower()
        for coll in ("all-reduce(", "all-gather(", "collective-permute(", "all-to-all(", "reduce-scatter("):
            assert coll not in hlo, (g.nodes[-1], coll)


def test_fft_based_analysis_gathers_under_sharding_documented(rng):
    """YIN (FFT autocorrelation) and FIR impl='fft' ride XLA's FFT op, which
    GSPMD does not partition — like Stft(impl='fft'), they all-gather the
    batch when sharded. Documented behavior: shard-sensitive pipelines keep
    YIN/FIR-fft per-host, or use FIR impl='direct' (conv partitions fine)."""
    from audioflow_tpu.graph import Fir, Yin, chain

    mesh = make_mesh()
    x = shard_batch(rng.standard_normal((8, 32768)).astype(np.float32), mesh)
    g = chain(Yin(frame_length=1024, hop=256, center=False, fmin=80, fmax=1200), input_rate=16000)
    hlo = compile_sharded(g, mesh).lower(x).compile().as_text().lower()
    assert "all-gather" in hlo  # the documented FFT sharding limitation
    # FIR direct (XLA conv) partitions with zero collectives
    g2 = chain(Fir("lowpass", 65, (2000.0,)), input_rate=16000)
    hlo2 = compile_sharded(g2, mesh).lower(x).compile().as_text().lower()
    for coll in ("all-reduce(", "all-gather(", "collective-permute(", "reduce-scatter("):
        assert coll not in hlo2, coll


# ---------------------------------------------------------------------------
# Sequence parallelism (time-axis sharding of one long signal)
# ---------------------------------------------------------------------------


def test_sequence_sharded_spectrogram_matches_unsharded(rng):
    import jax

    from audioflow_tpu import ops
    from audioflow_tpu.parallel import make_mesh, sequence_sharded_spectrogram

    mesh = make_mesh(8)
    x = rng.standard_normal((2, 8 * 4096)).astype(np.float32)
    out = np.asarray(sequence_sharded_spectrogram(jnp.asarray(x), mesh, 512, 256))
    ref = np.asarray(ops.spectrogram(jnp.asarray(x), 512, 256, center=False))
    n = ref.shape[1]
    assert out.shape == (2, x.shape[1] // 256, 257)
    rel = np.abs(out[:, :n] - ref).max() / ref.max()
    assert rel < 1e-5, rel
    # the halo is the only collective: one ppermute, no gathers/reduces
    fn = jax.jit(lambda z: sequence_sharded_spectrogram(z, mesh, 512, 256))
    hlo = fn.lower(jnp.asarray(x)).compile().as_text()
    assert "collective-permute" in hlo
    assert "all-gather" not in hlo and "all-reduce" not in hlo


def test_sequence_sharded_downstream_stays_sharded(rng):
    """A frame-local mel stage composes with zero extra collectives."""
    import jax

    from audioflow_tpu import ops
    from audioflow_tpu.parallel import make_mesh, sequence_sharded_spectrogram

    mesh = make_mesh(8)
    fb = ops.mel_filterbank(257, 32, 16000)
    x = rng.standard_normal((1, 8 * 2048)).astype(np.float32)

    def pipe(z):
        s = sequence_sharded_spectrogram(z, mesh, 512, 256)
        return ops.log_mel(s, fb)

    out = np.asarray(jax.jit(pipe)(jnp.asarray(x)))
    ref = np.asarray(ops.log_mel(
        ops.spectrogram(jnp.asarray(x), 512, 256, center=False), fb))
    n = ref.shape[1]
    np.testing.assert_allclose(out[:, :n], ref, atol=1e-4)
    hlo = jax.jit(pipe).lower(jnp.asarray(x)).compile().as_text()
    assert hlo.count("all-gather") == 0


def test_sequence_sharded_validation():
    from audioflow_tpu.errors import AudioError
    from audioflow_tpu.parallel import make_mesh, sequence_sharded_spectrogram

    mesh = make_mesh(8)
    with pytest.raises(AudioError):  # not a multiple of n_dev * hop
        sequence_sharded_spectrogram(jnp.zeros((1, 1000)), mesh, 512, 256)
    with pytest.raises(AudioError):  # local shard shorter than n_fft
        sequence_sharded_spectrogram(jnp.zeros((1, 8 * 256)), mesh, 512, 256)
    with pytest.raises(AudioError):  # 1-D input
        sequence_sharded_spectrogram(jnp.zeros(8 * 4096), mesh, 512, 256)


def test_sequence_sharded_resample_matches_unsharded(rng):
    """Time-sharded resample == offline resample exactly: same banded
    block-matmul, halos supplying what the offline zero-pads/neighbors do."""
    from audioflow_tpu.ops.resample import make_plan
    from audioflow_tpu.parallel import make_mesh, sequence_sharded_resample

    mesh = make_mesh(8)
    for in_rate, out_rate, mode in [(48000, 16000, "kaiser"), (16000, 48000, "cubic")]:
        plan = make_plan(in_rate, out_rate, mode)
        t = 8 * plan.ipb * 16
        x = rng.standard_normal((2, t)).astype(np.float32)
        out = np.asarray(
            sequence_sharded_resample(jnp.asarray(x), mesh, in_rate, out_rate, mode)
        )
        want = np.asarray(ops.resample(jnp.asarray(x), in_rate, out_rate, mode))
        assert out.shape == want.shape, (out.shape, want.shape)
        np.testing.assert_allclose(out, want, atol=2e-5)


def test_sequence_sharded_resample_collectives_and_errors(rng):
    import jax

    from audioflow_tpu.ops.resample import make_plan
    from audioflow_tpu.parallel import make_mesh, sequence_sharded_resample

    mesh = make_mesh(8)
    plan = make_plan(48000, 16000, "kaiser")
    x = jnp.asarray(rng.standard_normal((1, 8 * plan.ipb * 8)).astype(np.float32))
    fn = jax.jit(lambda z: sequence_sharded_resample(z, mesh, 48000, 16000))
    hlo = fn.lower(x).compile().as_text().lower()
    assert "collective-permute" in hlo  # the two halo exchanges
    for coll in ("all-gather", "all-reduce", "all-to-all", "reduce-scatter"):
        assert coll not in hlo, coll
    with pytest.raises(AudioError):  # T not a multiple of n_dev * ipb
        sequence_sharded_resample(jnp.zeros((1, 8 * plan.ipb + 1)), mesh, 48000, 16000)
    with pytest.raises(AudioError):  # 1-D input
        sequence_sharded_resample(jnp.zeros(8 * plan.ipb * 8), mesh, 48000, 16000)


def test_sequence_sharded_fir_matches_unsharded(rng):
    import jax

    from audioflow_tpu.parallel import make_mesh, sequence_sharded_fir

    mesh = make_mesh(8)
    h = ops.fir_design(65, (2000.0,), 16000, "lowpass")
    x = rng.standard_normal((2, 8 * 1024)).astype(np.float32)
    out = np.asarray(sequence_sharded_fir(jnp.asarray(x), mesh, h))
    want, _ = ops.fir_apply(jnp.asarray(x), jnp.asarray(h, jnp.float32), impl="direct")
    np.testing.assert_allclose(out, np.asarray(want), atol=1e-5)
    hlo = (
        jax.jit(lambda z: sequence_sharded_fir(z, mesh, h))
        .lower(jnp.asarray(x)).compile().as_text().lower()
    )
    assert "collective-permute" in hlo
    for coll in ("all-gather", "all-reduce", "all-to-all", "reduce-scatter"):
        assert coll not in hlo, coll
    with pytest.raises(AudioError):  # local shard shorter than K-1
        sequence_sharded_fir(jnp.zeros((1, 8 * 32)), mesh, np.zeros(65))


def test_sequence_sharded_frontend_end_to_end(rng):
    """The full resample->spectrogram->log-mel frontend, time-sharded on one
    long signal: equals the unsharded pipeline on the fully-covered frames,
    with ppermutes as the ONLY collectives."""
    import jax

    from audioflow_tpu import ops as O
    from audioflow_tpu.ops.resample import make_plan
    from audioflow_tpu.parallel import make_mesh, sequence_sharded_frontend

    mesh = make_mesh(8)
    in_rate, out_rate, n_fft, hop, n_mels = 48000, 16000, 512, 128, 32
    plan = make_plan(in_rate, out_rate, "kaiser")
    # T: whole resample blocks per shard AND resampled shard a multiple of hop
    t = 8 * plan.ipb * 24  # ipb=384 -> local out 3072 = 24 hops of 128
    x = rng.standard_normal((1, t)).astype(np.float32)
    out = np.asarray(sequence_sharded_frontend(
        jnp.asarray(x), mesh, in_rate, out_rate, n_fft, hop, n_mels
    ))
    y = O.resample(jnp.asarray(x), in_rate, out_rate)
    fb = O.mel_filterbank(n_fft // 2 + 1, n_mels, out_rate)
    want = np.asarray(O.log_mel(
        O.spectrogram(y, n_fft, hop, center=False), jnp.asarray(fb)))
    n = want.shape[1]
    assert out.shape[:2] == (1, t // 3 // hop)
    np.testing.assert_allclose(out[:, :n], want, atol=1e-3, rtol=1e-3)
    fn = jax.jit(lambda z: sequence_sharded_frontend(
        z, mesh, in_rate, out_rate, n_fft, hop, n_mels))
    hlo = fn.lower(jnp.asarray(x)).compile().as_text().lower()
    assert "collective-permute" in hlo
    for coll in ("all-gather", "all-reduce", "all-to-all", "reduce-scatter"):
        assert coll not in hlo, coll


def test_sequence_sharded_iir_matches_unsharded(rng):
    """Time-sharded biquad cascade == unsharded: the
    zero-state local pass + affine carry prefix + C A^n output correction
    reconstruct the continuous filter exactly (f32 reassociation only)."""
    from audioflow_tpu.models.pipelines import eq_bands_default
    from audioflow_tpu.parallel import make_mesh, sequence_sharded_iir

    mesh = make_mesh(8)
    bands = eq_bands_default(16000)
    x = (0.5 * rng.standard_normal((2, 8 * 8192))).astype(np.float32)
    out = np.asarray(sequence_sharded_iir(jnp.asarray(x), mesh, bands))
    want, _ = ops.biquad_chain(jnp.asarray(x), bands)
    np.testing.assert_allclose(out, np.asarray(want), atol=1e-5)
    with pytest.raises(AudioError):  # T not divisible over devices
        sequence_sharded_iir(jnp.zeros((1, 8 * 64 + 1)), mesh, bands)


def test_sequence_sharded_iir_collective_footprint(rng):
    """The IIR has no finite halo, so its ONE collective is the tiny
    [n_dev, batch, order] state all-gather — nothing signal-sized moves
    (no ppermute, no all-reduce; documented in parallel/sp.py)."""
    import jax

    from audioflow_tpu.models.pipelines import eq_bands_default
    from audioflow_tpu.parallel import make_mesh, sequence_sharded_iir

    mesh = make_mesh(8)
    bands = eq_bands_default(16000)
    x = jnp.asarray(rng.standard_normal((2, 8 * 4096)).astype(np.float32))
    fn = jax.jit(lambda z: sequence_sharded_iir(z, mesh, bands))
    hlo = fn.lower(x).compile().as_text().lower()
    assert "all-gather" in hlo  # the state exchange
    for coll in ("all-reduce", "all-to-all", "reduce-scatter", "collective-permute"):
        assert coll not in hlo, coll


def test_sequence_sharded_limiter_and_master_match(rng):
    """The limiter's max-plus envelope carry composes across shards like
    the IIR's linear state; the full config-3 master chain (EQ + limiter)
    is therefore time-shardable end to end."""
    from audioflow_tpu.models.pipelines import master_chain_graph
    from audioflow_tpu.parallel import (
        make_mesh,
        sequence_sharded_limiter,
        sequence_sharded_master,
    )

    mesh = make_mesh(8)
    x = (0.5 * rng.standard_normal((2, 8 * 8192))).astype(np.float32)
    out_l = np.asarray(sequence_sharded_limiter(jnp.asarray(x), mesh))
    want_l = np.asarray(ops.limiter(jnp.asarray(x), -1.0, 50.0, 16000))
    np.testing.assert_allclose(out_l, want_l, atol=1e-5)
    out_m = np.asarray(sequence_sharded_master(jnp.asarray(x), mesh))
    want_m = np.asarray(master_chain_graph(16000)(jnp.asarray(x)))
    np.testing.assert_allclose(out_m, want_m, atol=1e-5)


def test_session7_families_shard_with_zero_collectives(rng):
    """The session-7 families keep the DP promise when batch-sharded: the
    effects (elementwise/gather/blocked scans), the matmul-ACF pitch
    trackers (yin forced impl='matmul' — the CPU auto default is fft, the
    documented all-gather case), self-similarity + novelty (per-sample Gram
    matmul + cumsums), NMF (per-sample factorization), and SpecAugment."""
    import jax

    from audioflow_tpu import ops

    mesh = make_mesh()
    x = shard_batch(rng.standard_normal((8, 32768)).astype(np.float32), mesh)
    feats = shard_batch(rng.standard_normal((8, 100, 13)).astype(np.float32), mesh)
    spec = shard_batch((rng.random((8, 60, 257)) ** 2).astype(np.float32), mesh)
    key = jax.random.PRNGKey(0)

    from jax.sharding import NamedSharding, PartitionSpec as P

    def sharded(fn, arg, ndim):
        return jax.jit(
            fn, in_shardings=(NamedSharding(mesh, P("data", *[None] * (ndim - 1))),)
        ).lower(arg).compile().as_text().lower()

    cases = [
        (lambda z: ops.feedback_delay(z, 1000, 0.4, 0.5)[0], x, 2),
        (lambda z: ops.chorus(z, 16000), x, 2),
        (lambda z: ops.tremolo(z, 16000), x, 2),
        (lambda z: ops.deemphasis(z), x, 2),
        (lambda z: ops.yin(z, 16000, fmin=80, fmax=1000, impl="matmul"), x, 2),
        (lambda f: ops.novelty_curve(ops.self_similarity(f), 16), feats, 3),
        (lambda f: ops.lpc(f.reshape(8, -1), 8), x, 2),
        (lambda s: ops.nmf(s, 3, n_iter=20)[0], spec, 3),
        (lambda f: ops.spec_augment(f, key), feats, 3),
    ]
    for i, (fn, arg, ndim) in enumerate(cases):
        hlo = sharded(fn, arg, ndim)
        for coll in ("all-reduce(", "all-gather(", "collective-permute(",
                     "all-to-all(", "reduce-scatter("):
            assert coll not in hlo, (i, coll)


def test_sequence_sharded_graph_master_chain(rng):
    """compile_sharded(shard='time') — the Graph-level SP surface: the config-3 master chain (BiquadChain + Limiter) on ONE
    long signal equals the offline graph end to end."""
    from audioflow_tpu.models.pipelines import master_chain_graph
    from audioflow_tpu.parallel import compile_sharded, make_mesh

    mesh = make_mesh(8)
    g = master_chain_graph(16000)
    x = (0.5 * rng.standard_normal((2, 8 * 8192))).astype(np.float32)
    fn = compile_sharded(g, mesh, shard="time")
    out = np.asarray(fn(jnp.asarray(x)))
    want = np.asarray(g.chain(jnp.asarray(x)))
    np.testing.assert_allclose(out, want, atol=1e-5)
    # collective footprint: two tiny all-gathers (EQ state + limiter
    # envelope), nothing signal-sized — no ppermute/all-reduce
    hlo = fn.lower(jnp.asarray(x)).compile().as_text().lower()
    assert "all-gather" in hlo
    for coll in ("all-reduce", "all-to-all", "reduce-scatter", "collective-permute"):
        assert coll not in hlo, coll


def test_sequence_sharded_graph_frontend_chain(rng):
    """Resample -> Spectrogram(center=False) -> MelProject through the
    Graph-level SP surface: equals the unsharded chain on the fully-covered
    frames; collectives are halo ppermutes only."""
    from audioflow_tpu.graph import MelProject, Resample, Spectrogram, chain
    from audioflow_tpu.parallel import compile_sharded, make_mesh

    mesh = make_mesh(8)
    g = chain(
        Resample(48000, 16000, "kaiser"),
        Spectrogram(512, 128, center=False),
        MelProject(n_mels=32),
        input_rate=48000,
    )
    from audioflow_tpu.ops.resample import make_plan

    ipb = make_plan(48000, 16000, "kaiser").ipb
    t = 8 * ipb * 24  # divides resample blocks; 16k side divides hops
    x = (0.3 * rng.standard_normal((2, t))).astype(np.float32)
    fn = compile_sharded(g, mesh, shard="time")
    out = np.asarray(fn(jnp.asarray(x)))
    want = np.asarray(g.chain(jnp.asarray(x)))
    n = want.shape[-2] - 4  # trailing frames: zero-tail convention
    np.testing.assert_allclose(out[:, :n], want[:, :n], rtol=2e-4, atol=1e-5)
    hlo = fn.lower(jnp.asarray(x)).compile().as_text().lower()
    assert "collective-permute" in hlo  # the halos
    for coll in ("all-reduce", "all-to-all", "reduce-scatter", "all-gather"):
        assert coll not in hlo, coll


def test_sequence_sharded_graph_dynamics_family(rng):
    """Compressor and NoiseGate ride the shared max-plus envelope carry."""
    from audioflow_tpu.graph import Compressor, Gain, NoiseGate, chain
    from audioflow_tpu.parallel import compile_sharded, make_mesh

    mesh = make_mesh(8)
    g = chain(
        Gain(3.0),
        Compressor(threshold_db=-20.0, ratio=4.0),
        NoiseGate(threshold_db=-55.0),
        input_rate=16000,
    )
    x = (0.4 * rng.standard_normal((2, 8 * 4096))).astype(np.float32)
    x[:, : 8 * 1024] *= 0.001  # exercise the gate region
    out = np.asarray(compile_sharded(g, mesh, shard="time")(jnp.asarray(x)))
    want = np.asarray(g.chain(jnp.asarray(x)))
    np.testing.assert_allclose(out, want, atol=1e-5)


def test_sequence_sharded_graph_unsupported_raises(rng):
    from audioflow_tpu.graph import Spectrogram, Stft, Vad, chain
    from audioflow_tpu.parallel import compile_sharded, make_mesh, sequence_sharded_graph

    mesh = make_mesh(8)
    with pytest.raises(AudioError, match="Vad.*no sequence-parallel"):
        sequence_sharded_graph(chain(Vad(), input_rate=16000), mesh)
    with pytest.raises(AudioError, match="FFT.*not partition"):
        sequence_sharded_graph(chain(Stft(512, 128, center=False), input_rate=16000), mesh)
    with pytest.raises(AudioError, match="center=False"):
        sequence_sharded_graph(chain(Spectrogram(512, 128, center=True), input_rate=16000), mesh)
    with pytest.raises(AudioError, match="unknown shard mode"):
        compile_sharded(chain(Spectrogram(512, 128, center=False), input_rate=16000), mesh, shard="nope")


def test_sequence_sharded_graph_kaldi_fbank(rng):
    """The full Kaldi fbank frontend (Preemphasis -> povey Spectrogram ->
    HTK mel -> CMVN) time-sharded through compile_sharded(shard='time'):
    Preemphasis rides a 1-sample halo with the position-0 convention on
    shard 0, and CMVN's per-utterance statistics become one tiny
    all-reduce. Equality is against the offline graph on the zero-padded
    signal whose frame grid matches the SP zero-tail convention (then the
    CMVN stats cover the identical frame set)."""
    from audioflow_tpu.models import kaldi_fbank_frontend
    from audioflow_tpu.parallel import compile_sharded, make_mesh

    mesh = make_mesh(8)
    t = 8 * 160 * 40
    x = (0.3 * rng.standard_normal((2, t))).astype(np.float32)
    # without CMVN: exact (to f32) on the fully-covered frames
    g0 = kaldi_fbank_frontend(16000, n_mels=24, cmvn=False)
    out0 = np.asarray(compile_sharded(g0, mesh, shard="time")(jnp.asarray(x)))
    want0 = np.asarray(g0.chain(jnp.asarray(x)))
    n = want0.shape[-2]  # offline has only the covered frames
    np.testing.assert_allclose(out0[:, :n], want0, rtol=2e-4, atol=2e-4)
    # with CMVN: the per-utterance stats become one all-reduce; the SP
    # frame set adds ceil(n_fft/hop)-1 zero-tail frames, so the stats
    # shift by O(tail/total) — bound it rather than demand equality
    g1 = kaldi_fbank_frontend(16000, n_mels=24)
    out1 = np.asarray(compile_sharded(g1, mesh, shard="time")(jnp.asarray(x)))
    want1 = np.asarray(g1.chain(jnp.asarray(x)))
    assert np.abs(out1[:, :n] - want1).max() < 0.1
    hlo = compile_sharded(g1, mesh, shard="time").lower(
        jnp.asarray(x)
    ).compile().as_text().lower()
    assert "all-reduce" in hlo  # the CMVN stats
    assert "collective-permute" in hlo  # the preemphasis + frame halos
    assert "all-gather" not in hlo


def test_sequence_sharded_graph_deltas(rng):
    """Deltas (orders=(1,)) rides a both-sides frame halo with global-edge
    replication on the end shards — equals the unsharded chain EXACTLY
    (the offline op's own edge replication) on every frame of the common
    grid; orders=(1, 2) raises the typed error."""
    from audioflow_tpu.graph import Deltas, MelProject, Spectrogram, chain
    from audioflow_tpu.parallel import compile_sharded, make_mesh, sequence_sharded_graph

    mesh = make_mesh(8)
    g = chain(
        Spectrogram(512, 128, center=False),
        MelProject(n_mels=24, log="ln"),
        Deltas(width=9, orders=(1,), n_bins=24),
        input_rate=16000,
    )
    t = 8 * 128 * 32
    x = (0.3 * rng.standard_normal((2, t))).astype(np.float32)
    out = np.asarray(compile_sharded(g, mesh, shard="time")(jnp.asarray(x)))
    want = np.asarray(g.chain(jnp.asarray(x)))
    n = want.shape[-2]
    # interior frames exact; the SP grid's zero-tail frames alter the
    # final width//2 windows' replication vs offline — compare inside
    np.testing.assert_allclose(
        out[:, : n - 4], want[:, : n - 4], rtol=2e-4, atol=1e-5
    )
    g2 = chain(
        Spectrogram(512, 128, center=False),
        MelProject(n_mels=24, log="ln"),
        Deltas(width=9, orders=(1, 2), n_bins=24),
        input_rate=16000,
    )
    with pytest.raises(AudioError, match="orders"):
        sequence_sharded_graph(g2, mesh)
