import json

import numpy as np
import pytest

import jax.numpy as jnp

from audioflow_tpu.cli import main as cli_main
from audioflow_tpu.io import read_wav, write_wav
from audioflow_tpu.models import (
    TrainableFrontend,
    log_mel_frontend,
    make_train_step,
    master_chain_graph,
    stft_magnitude_graph,
    vad_graph,
    wire_egress_graph,
)


def test_pipeline_shapes(rng):
    x = jnp.asarray(rng.standard_normal((2, 44100)).astype(np.float32))
    g = log_mel_frontend(44100, 16000, 1024, 256, 128)
    out = g.compile()(x)
    assert out.shape == (2, (16000 - 1024) // 256 + 1, 128)
    g1 = stft_magnitude_graph(16000, 1024, 256)
    out1 = g1.compile()(x[:, :16000])
    assert out1.shape[-1] == 513
    g3 = master_chain_graph(16000)
    _, y = g3.nodes[0].step(g3.nodes[0].init_carry((2,), 16000), x[:, :16000])
    assert y.shape == (2, 16000)


def test_wire_egress_graph(rng):
    g = wire_egress_graph(48000, 16000)
    x = jnp.asarray(rng.uniform(-0.8, 0.8, 4800).astype(np.float32))
    out = np.asarray(g.compile()(x))
    assert out.dtype == np.int16 and out.shape == (1600,)


def test_trainable_frontend_learns(rng):
    """Loss decreases over a few steps on a separable toy problem."""
    import optax

    model = TrainableFrontend(n_fft=256, hop=128, n_mels=16, n_classes=2)
    params = model.init_params()
    step, optimizer = make_train_step(model, optimizer=optax.adam(3e-2))
    opt_state = optimizer.init(params)
    t = np.arange(4096) / 16000
    lo = 0.4 * np.sin(2 * np.pi * 300 * t)
    hi = 0.4 * np.sin(2 * np.pi * 3000 * t)
    x = jnp.asarray(np.stack([lo, hi, lo, hi]).astype(np.float32))
    y = jnp.asarray(np.array([0, 1, 0, 1], np.int32))
    losses = []
    for _ in range(30):
        params, opt_state, loss = step(params, opt_state, x, y)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5


def test_trainable_sharded_matches_single(rng):
    from audioflow_tpu.parallel import make_mesh, shard_batch

    model = TrainableFrontend(n_fft=256, hop=128, n_mels=8, n_classes=2)
    params = model.init_params()
    x = rng.standard_normal((8, 2048)).astype(np.float32)
    y = rng.integers(0, 2, 8).astype(np.int32)
    step_s, opt = make_train_step(model, mesh=make_mesh())
    step_1, _ = make_train_step(model)
    o1 = opt.init(params)
    p_s, _, loss_s = step_s(params, o1, shard_batch(x, make_mesh()), shard_batch(y, make_mesh()))
    p_1, _, loss_1 = step_1(params, opt.init(params), jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(float(loss_s), float(loss_1), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(p_s["b"]), np.asarray(p_1["b"]), atol=1e-6)


def test_graft_entry_compiles():
    import __graft_entry__ as ge

    import jax

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape[0] == 4


def test_graft_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_validation_report():
    from audioflow_tpu.validate import run_validation

    rep = run_validation()
    assert rep["pass"], rep
    assert rep["max_abs_err"] < 1e-4
    assert rep["quantize_i16"] == 0
    assert rep["vad_state_mismatches"] == 0


# ------------------------------------------------------------------- CLI

def _tone_wav(path, n=44100, rate=44100):
    t = np.arange(n) / rate
    write_wav(path, (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32), rate)


def test_cli_info(capsys):
    assert cli_main(["info"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["name"] == "audioflow-tpu"


def test_cli_devices(capsys):
    assert cli_main(["devices"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert len(rows) == 8  # virtual CPU mesh


def test_cli_run_logmel(tmp_path, capsys):
    wavs = []
    for i in range(3):
        p = tmp_path / f"{i}.wav"
        _tone_wav(p)
        wavs.append(str(p))
    out_npy = tmp_path / "out.npy"
    rc = cli_main(
        ["run", "-i", *wavs, "-o", str(out_npy), "-g", "logmel", "--stats", str(tmp_path / "s.json")]
    )
    assert rc == 0
    res = json.loads(capsys.readouterr().out)
    assert res["files"] == 3 and res["failed_files"] == 0
    arr = np.load(out_npy)
    assert arr.shape[0] == 3 and arr.shape[2] == 128


def test_cli_run_sharded(tmp_path, capsys):
    wavs = []
    for i in range(4):
        p = tmp_path / f"{i}.wav"
        _tone_wav(p, n=22050)
        wavs.append(str(p))
    rc = cli_main(["run", "-i", *wavs, "-g", "stft", "--sharded", "--stats", str(tmp_path / "s.json")])
    assert rc == 0
    res = json.loads(capsys.readouterr().out)
    assert res["n_devices"] == 8


def test_cli_stream(tmp_path, capsys):
    p = tmp_path / "in.wav"
    _tone_wav(p, n=44100 * 2)
    rc = cli_main(["stream", "-i", str(p), "-g", "logmel"])
    assert rc == 0
    res = json.loads(capsys.readouterr().out)
    assert res["chunks"] >= 1 and res["audio_seconds"] == pytest.approx(2.0)


def test_cli_vad(tmp_path, capsys):
    rate = 16000
    seg = np.concatenate(
        [np.zeros(rate // 2), 0.4 * np.sin(2 * np.pi * 300 * np.arange(rate) / rate), np.zeros(rate)]
    ).astype(np.float32)
    p = tmp_path / "v.wav"
    write_wav(p, seg, rate)
    assert cli_main(["vad", "-i", str(p)]) == 0
    res = json.loads(capsys.readouterr().out)
    assert len(res["speech_segments"]) == 1
    assert res["speech_segments"][0]["start_s"] == pytest.approx(0.5, abs=0.1)


def test_cli_config_round_trip(tmp_path, capsys):
    f = str(tmp_path / "c.toml")
    assert cli_main(["config", "set", "audio.n_mels", "80", "--file", f]) == 0
    capsys.readouterr()
    assert cli_main(["config", "show", "--file", f]) == 0
    cfg = json.loads(capsys.readouterr().out)
    assert cfg["audio"]["n_mels"] == 80


def test_cli_validate(capsys):
    assert cli_main(["validate"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["pass"]


def test_cli_run_batched(tmp_path, capsys):
    wavs = []
    for i in range(5):
        p = tmp_path / f"b{i}.wav"
        _tone_wav(p, n=22050)
        wavs.append(str(p))
    rc = cli_main(
        ["run", "-i", *wavs, "-g", "logmel", "--batch-size", "2",
         "-o", str(tmp_path / "o.npy"), "--stats", str(tmp_path / "s.json")]
    )
    assert rc == 0
    res = json.loads(capsys.readouterr().out)
    assert res["files"] == 5 and res["batches"] == 3
    arr = np.load(tmp_path / "o.npy")
    assert arr.shape[0] == 5


def test_trainable_remat_matches(rng):
    model = TrainableFrontend(n_fft=256, hop=128, n_mels=8, n_classes=2)
    model_r = TrainableFrontend(n_fft=256, hop=128, n_mels=8, n_classes=2, remat=True)
    params = model.init_params()
    x = jnp.asarray(rng.standard_normal((2, 2048)).astype(np.float32))
    y = jnp.asarray(np.array([0, 1], np.int32))
    import jax

    g1 = jax.grad(model.loss)(params, x, y)
    g2 = jax.grad(model_r.loss)(params, x, y)
    for k in g1:
        np.testing.assert_allclose(np.asarray(g1[k]), np.asarray(g2[k]), atol=1e-6)


def test_cli_precision_flag(tmp_path, capsys):
    from audioflow_tpu.ops import get_default_matmul_precision, set_default_matmul_precision

    try:
        assert cli_main(["--precision", "high", "info"]) == 0
        assert get_default_matmul_precision() == "high"
    finally:
        set_default_matmul_precision("highest")


def test_cli_loudness_meter_and_normalize(tmp_path, capsys):
    t = np.arange(4 * 16000) / 16000
    x = (0.05 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    p = tmp_path / "tone.wav"
    write_wav(p, x, 16000)
    rc = cli_main(
        ["loudness", str(p), "--normalize-to", "-20", "--out-dir", str(tmp_path)]
    )
    assert rc == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["sample_rate"] == 16000
    assert row["integrated_lufs"] < -25  # quiet input
    assert abs(row["normalized_lufs"] - (-20.0)) < 0.1
    assert (tmp_path / "tone.normalized.wav").exists()
    # LRA present for >= 3 s inputs, true peak sane
    assert row["lra_lu"] is not None and row["true_peak_dbtp"] < 0


def test_cli_pitch(tmp_path, capsys):
    t = np.arange(16000) / 16000
    p = tmp_path / "tone.wav"
    write_wav(p, (0.5 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32), 16000)
    assert cli_main(["pitch", "-i", str(p), "--fmin", "80", "--fmax", "1200"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["voiced_fraction"] > 0.9
    assert abs(out["median_f0_hz"] - 220.0) < 3.0
    mid = [r for r in out["track"][4:-4]]
    assert all(r["f0_hz"] is not None and abs(r["f0_hz"] - 220.0) < 5 for r in mid)
    # pyin method: HMM-decoded voicing on the same tone
    assert cli_main(
        ["pitch", "-i", str(p), "--method", "pyin", "--fmin", "80", "--fmax", "1200"]
    ) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["voiced_fraction"] > 0.9
    assert abs(out["median_f0_hz"] - 220.0) < 3.0
    # pyin-online: --lag plumbs through and t carries the half-frame shift
    # that puts the uncentered online framing on the centered timeline
    #; the truncated tail (last `lag` frames) is documented
    assert cli_main(
        ["pitch", "-i", str(p), "--method", "pyin-online", "--lag", "10",
         "--fmin", "80", "--fmax", "1200"]
    ) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["track"][0]["t"] == round(2048 / (2 * 16000), 4)
    assert abs(out["median_f0_hz"] - 220.0) < 3.0
    # short file, lag > frames: the trimmed track is empty — the output
    # must still be VALID json (an empty-array mean is nan; r5 review)
    ps = tmp_path / "short.wav"
    write_wav(ps, (0.1 * np.sin(2 * np.pi * 220.0 * np.arange(4000) / 16000)
                   ).astype(np.float32), 16000)
    assert cli_main(
        ["pitch", "-i", str(ps), "--method", "pyin-online", "--lag", "40",
         "--fmin", "80", "--fmax", "1200"]
    ) == 0
    out = json.loads(capsys.readouterr().out)  # parses -> no NaN token
    assert out["frames"] == 0 and out["voiced_fraction"] == 0.0


def test_new_pipeline_constructors(rng, tmp_path, capsys):
    from audioflow_tpu.models import delta_fbank_frontend, denoise_master_chain, kws_frontend

    x = (0.3 * rng.standard_normal(2 * 16000)).astype(np.float32)
    # KWS frontend: streamable PCEN-mel, streamed == offline
    g = kws_frontend(16000, 512, 128, n_mels=40)
    assert g.streamable
    off = np.asarray(g.chain(jnp.asarray(x)))
    assert off.shape[-1] == 40 and (off >= -2.5).all()
    ck = g.chunk_granularity() * 8
    st = np.asarray(g.scan_stream(jnp.asarray(x[: len(x) // ck * ck]), ck))
    lat = g.stream_latency(ck)
    n = min(st.shape[0] - lat, off.shape[0])
    np.testing.assert_allclose(st[lat : lat + n], off[:n], rtol=1e-4, atol=1e-5)
    # delta fbank streams too
    g2 = delta_fbank_frontend(16000)
    assert g2.streamable and np.asarray(g2.chain(jnp.asarray(x))).shape[-1] == 48
    # denoise master: offline, hits the target loudness
    from audioflow_tpu import ops

    t = np.arange(4 * 16000) / 16000
    noisy = (0.1 * np.sin(2 * np.pi * 300.0 * t) + 0.005 * rng.standard_normal(4 * 16000)).astype(np.float32)
    g3 = denoise_master_chain(16000, target_lufs=-18.0)
    y = g3.chain(jnp.asarray(noisy))
    li = float(ops.integrated_loudness(y, 16000))
    assert abs(li - (-18.0)) < 0.2, li
    # CLI plumb-through
    p = tmp_path / "x.wav"
    write_wav(p, noisy, 16000)
    assert cli_main(["run", "-i", str(p), "-g", "kws"]) == 0
    capsys.readouterr()


def test_cli_features_and_chroma_graphs(tmp_path, capsys):
    t = np.arange(16000) / 16000
    p = tmp_path / "t.wav"
    write_wav(p, (0.4 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32), 16000)
    assert cli_main(["run", "-i", str(p), "-g", "features", "-o", str(tmp_path / "f.npy")]) == 0
    capsys.readouterr()
    f = np.load(tmp_path / "f.npy")
    assert f.shape[-1] == 5 and np.isfinite(f).all()
    assert cli_main(["run", "-i", str(p), "-g", "chroma", "-o", str(tmp_path / "c.npy")]) == 0
    capsys.readouterr()
    c = np.load(tmp_path / "c.npy")
    assert c.shape[-1] == 12
    assert c[0, 4:-4].mean(axis=0).argmax() == 9  # A440


def test_cli_music_graphs(tmp_path, capsys):
    rng = np.random.default_rng(3)
    t = np.arange(2 * 16000) / 16000
    p = tmp_path / "t.wav"
    write_wav(p, (0.4 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32), 16000)
    # cqt: A440 is bin 9 + 3 octaves above C1 = 45
    assert cli_main(["run", "-i", str(p), "-g", "cqt", "-o", str(tmp_path / "q.npy")]) == 0
    capsys.readouterr()
    q = np.load(tmp_path / "q.npy")
    assert q.shape[-1] == 84
    assert q[0, 4:-4].mean(axis=0).argmax() == 45
    # cqtroundtrip: audio -> complex CQT -> hybrid inverse -> audio; the
    # 440 Hz tone survives mid-signal (edges span the LS dual support)
    t4 = np.arange(4 * 16000) / 16000
    p4 = tmp_path / "t4.wav"
    write_wav(p4, (0.4 * np.sin(2 * np.pi * 440.0 * t4)).astype(np.float32), 16000)
    out_rt = tmp_path / "rt.wav"
    assert cli_main(["run", "-i", str(p4), "-g", "cqtroundtrip", "-o", str(out_rt)]) == 0
    capsys.readouterr()
    y_rt, sr_rt = read_wav(out_rt)
    assert sr_rt == 16000
    xs = (0.4 * np.sin(2 * np.pi * 440.0 * t4)).astype(np.float32)
    lo, hi = 17000, min(len(y_rt), len(xs)) - 17000
    err = y_rt[lo:hi] - xs[lo:hi]
    snr = 10 * np.log10((xs[lo:hi] ** 2).sum() / (err ** 2).sum())
    assert snr >= 25.0, snr
    # contrast + tonnetz shapes
    assert cli_main(["run", "-i", str(p), "-g", "contrast", "-o", str(tmp_path / "sc.npy")]) == 0
    capsys.readouterr()
    assert np.load(tmp_path / "sc.npy").shape[-1] == 7
    assert cli_main(["run", "-i", str(p), "-g", "tonnetz", "-o", str(tmp_path / "tn.npy")]) == 0
    capsys.readouterr()
    assert np.load(tmp_path / "tn.npy").shape[-1] == 6
    # onset + beats on a click track
    clicks = np.zeros(4 * 16000, np.float32)
    clicks[::8000] = 0.9
    clicks += 0.005 * rng.standard_normal(len(clicks)).astype(np.float32)
    pc = tmp_path / "clicks.wav"
    write_wav(pc, clicks, 16000)
    assert cli_main(["run", "-i", str(pc), "-g", "onset", "-o", str(tmp_path / "e.npy")]) == 0
    capsys.readouterr()
    env = np.load(tmp_path / "e.npy")
    assert env.shape[-1] == 1 and env.max() > 10.0  # dB-scale click jumps
    assert cli_main(["run", "-i", str(pc), "-g", "beats", "-o", str(tmp_path / "b.npy")]) == 0
    capsys.readouterr()
    beats = np.flatnonzero(np.load(tmp_path / "b.npy")[0, :, 0])
    assert len(beats) >= 5
    assert np.all(np.abs(np.diff(beats) - 31.25) <= 3.0)


def test_cli_align(tmp_path, capsys):
    sr = 16000
    t = np.arange(sr) / sr
    a = (0.5 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    # b = a time-stretched by repetition of the mid section (coarse warp)
    b = np.concatenate([a[: sr // 2], a[sr // 4 : 3 * sr // 4], a[sr // 2 :]])
    pa, pb = tmp_path / "a.wav", tmp_path / "b.wav"
    write_wav(pa, a, sr)
    write_wav(pb, b.astype(np.float32), sr)
    assert cli_main(["align", "-a", str(pa), "-b", str(pb)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["path_len"] >= max(out["frames_a"], out["frames_b"])
    assert out["anchors"][0]["t_a"] == 0.0
    # endpoints reached
    last = out["anchors"][-1]
    assert last["t_a"] > 0.8 and last["t_b"] > 1.2
    # identical files: near-zero cosine cost per step
    assert cli_main(["align", "-a", str(pa), "-b", str(pa), "--feature", "logmel"]) == 0
    out2 = json.loads(capsys.readouterr().out)
    assert out2["cost_per_step"] < 1e-3


def test_trainable_tp_matches_single(rng):
    """DP x TP (Megatron-split MLP head on a 2-D mesh) computes the same
    step as the unsharded program."""
    from audioflow_tpu.models import TrainableFrontend, make_train_step
    from audioflow_tpu.parallel import make_mesh, shard_batch

    model = TrainableFrontend(n_fft=256, hop=128, n_mels=8, n_classes=3, hidden=16)
    params = model.init_params()
    x = rng.standard_normal((8, 2048)).astype(np.float32)
    y = rng.integers(0, 3, 8).astype(np.int32)
    mesh = make_mesh(8, axes=("data", "model"), shape=(4, 2))
    step_tp, opt = make_train_step(model, mesh=mesh, model_axis="model")
    step_1, _ = make_train_step(model)
    p_tp, _, loss_tp = step_tp(params, opt.init(params), jnp.asarray(x), jnp.asarray(y))
    p_1, _, loss_1 = step_1(params, opt.init(params), jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(float(loss_tp), float(loss_1), rtol=1e-5)
    for k in ("w1", "w2", "b1", "b2"):
        np.testing.assert_allclose(
            np.asarray(p_tp[k]), np.asarray(p_1[k]), atol=2e-6, err_msg=k
        )
    # the sharded params actually live sharded over the model axis
    assert p_tp["w1"].sharding.spec == (None, "model")
    assert p_tp["w2"].sharding.spec == ("model", None)
    # hidden=0 + model_axis is a config error
    with pytest.raises(ValueError):
        make_train_step(TrainableFrontend(), mesh=mesh, model_axis="model")


def test_trainable_hidden_learns(rng):
    import optax

    from audioflow_tpu.models import TrainableFrontend, make_train_step

    model = TrainableFrontend(n_fft=256, hop=128, n_mels=16, n_classes=2, hidden=8)
    params = model.init_params()
    step, optimizer = make_train_step(model, optimizer=optax.adam(3e-2))
    opt_state = optimizer.init(params)
    t = np.arange(4096) / 16000
    lo = 0.4 * np.sin(2 * np.pi * 300 * t)
    hi = 0.4 * np.sin(2 * np.pi * 3000 * t)
    x = jnp.asarray(np.stack([lo, hi, lo, hi]).astype(np.float32))
    y = jnp.asarray(np.array([0, 1, 0, 1], np.int32))
    losses = []
    for _ in range(30):
        params, opt_state, loss = step(params, opt_state, x, y)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5


def test_cli_segments(tmp_path, capsys):
    sr = 16000
    t = np.arange(2 * sr) / sr
    # two spectrally distinct halves: 220 Hz tone, then bright harmonics
    a = 0.5 * np.sin(2 * np.pi * 220.0 * t[:sr])
    b = sum(0.2 * np.sin(2 * np.pi * f * t[:sr]) for f in (900.0, 1800.0, 2700.0))
    p = tmp_path / "two.wav"
    write_wav(p, np.concatenate([a, b]).astype(np.float32), sr)
    assert cli_main(["segments", "-i", str(p), "--kernel", "16"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["duration_s"] == pytest.approx(2.0)
    # one boundary near the 1.0 s change
    assert any(abs(x - 1.0) < 0.2 for x in out["boundaries_s"]), out["boundaries_s"]


def test_cli_separate(tmp_path, capsys):
    sr = 8000
    t = np.arange(2 * sr) / sr
    x = np.where((t % 1.0) < 0.5, 0.5 * np.sin(2 * np.pi * 250 * t),
                 0.4 * np.sin(2 * np.pi * 1750 * t)).astype(np.float32)
    p = tmp_path / "mix.wav"
    write_wav(p, x, sr)
    assert cli_main(["separate", "-i", str(p), "--iterations", "120"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert len(out["components"]) == 2
    peaks = sorted(out["template_peak_hz"])
    assert abs(peaks[0] - 250) < 40 and abs(peaks[1] - 1750) < 40, peaks
    assert out["residual_rel"] < 0.2
    import os as _os
    assert all(_os.path.exists(c) for c in out["components"])


def test_cli_cqtroundtrip_multirate(tmp_path, capsys):
    """`run -g cqtroundtrip --multirate` routes through the
    CqtRoundTripMultirate wrapper node (the broadband-invertible variant's
    Graph/CLI surface) and reconstructs a real file at high SNR."""
    t = np.arange(32000) / 16000.0
    x = (0.4 * np.sin(2 * np.pi * 523.25 * t)).astype(np.float32)
    p = tmp_path / "tone.wav"
    write_wav(p, x, 16000)
    out = tmp_path / "out.wav"
    assert cli_main(["run", "-i", str(p), "-g", "cqtroundtrip",
                     "--multirate", "-o", str(out)]) == 0
    row = json.loads(capsys.readouterr().out)
    assert row["failed_files"] == 0
    from audioflow_tpu.io import read_audio

    y, sr = read_audio(str(out))
    assert sr == 16000
    n = min(len(y), len(x))
    lo, hi = 8000, n - 8000
    e = y[lo:hi] - x[lo:hi]
    snr = 10 * np.log10((x[lo:hi] ** 2).sum() / max((e ** 2).sum(), 1e-30))
    assert snr >= 30.0, snr
