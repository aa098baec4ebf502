"""Backend-facing contracts: the precision-tier table, the compile-cache
rule, the GPU-only benchmark and smoke script, and the smoke script's
corpus, oracle and phases at CPU sizes. Tests marked ``gpu`` run only on a
GPU (tests/conftest.py)."""

import os
import shutil
import subprocess
import sys
import time
import wave
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import chip_smoke
from audioflow_tpu.ops import _mm

REPO = Path(__file__).resolve().parents[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)}, **extra)
    return env


def _dot_text(tier, platform=None, monkeypatch=None):
    if platform is not None:
        monkeypatch.setattr(_mm, "_platform", lambda: platform)
    x, w = jnp.ones((4, 8)), jnp.ones((8, 3))
    return jax.jit(lambda a, b: _mm.mm(a, b, tier)).lower(x, w).as_text()


# --- precision tiers --------------------------------------------------------


@pytest.mark.parametrize("tier, enum", [("default", "DEFAULT"), ("high", "HIGH"),
                                        ("highest", "HIGHEST")])
def test_cpu_tiers_lower_to_precision_enums(tier, enum):
    text = _dot_text(tier)
    assert f"precision = [{enum}, {enum}]" in text
    assert "algorithm" not in text


def test_gpu_high_tier_lowers_to_three_bf16_passes(monkeypatch):
    text = _dot_text("high", "gpu", monkeypatch)
    assert "lhs_precision_type = bf16" in text and "num_primitive_operations = 3" in text
    assert "accumulation_type = f32" in text


@pytest.mark.parametrize("tier, enum", [("default", "DEFAULT"), ("highest", "HIGHEST")])
def test_gpu_default_and_highest_keep_enums(tier, enum, monkeypatch):
    text = _dot_text(tier, "gpu", monkeypatch)
    assert f"precision = [{enum}, {enum}]" in text and "algorithm" not in text


def test_einsum_and_framework_default_follow_the_table(monkeypatch):
    monkeypatch.setattr(_mm, "_platform", lambda: "gpu")
    x, w = jnp.ones((2, 4, 8)), jnp.ones((8, 3))
    text = jax.jit(lambda a, b: _mm.em("bij,jk->bik", a, b, precision="high")).lower(x, w).as_text()
    assert "num_primitive_operations = 3" in text
    monkeypatch.setattr(_mm, "_default", "high")
    assert _mm.dot_precision() is jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3


def test_conv_precision_keeps_the_accuracy_of_an_algorithm_tier(monkeypatch):
    assert _mm.conv_precision("high") == jax.lax.Precision.HIGH
    monkeypatch.setattr(_mm, "_platform", lambda: "gpu")
    assert _mm.conv_precision("high") == jax.lax.Precision.HIGHEST
    assert _mm.conv_precision("default") == jax.lax.Precision.DEFAULT


def test_unknown_tier_or_platform_raises(monkeypatch):
    with pytest.raises(ValueError, match="known"):
        _mm.dot_precision("ultra")
    with pytest.raises(ValueError, match="known"):
        _mm.set_default_matmul_precision("ultra")
    monkeypatch.setattr(_mm, "_platform", lambda: "metal")
    with pytest.raises(ValueError, match="no precision table"):
        _mm.dot_precision("high")


# --- compile cache ----------------------------------------------------------

_CACHE_PROBE = """
import os, jax
from audioflow_tpu.utils import setup_compile_cache
used = setup_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: x * 2 + 1)(jax.numpy.ones(8)).block_until_ready()
print(used)
print(jax.config.jax_compilation_cache_dir)
"""


def test_compile_cache_goes_where_the_env_var_says(tmp_path):
    cache = tmp_path / "cache"
    out = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE], capture_output=True, text=True, timeout=300,
        env=_env(JAX_COMPILATION_CACHE_DIR=str(cache), JAX_ENABLE_COMPILATION_CACHE="true"),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(cache), str(cache)]
    assert any(cache.iterdir())  # the compiled program landed there


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    from audioflow_tpu.utils import DEFAULT_COMPILE_CACHE, setup_compile_cache

    assert DEFAULT_COMPILE_CACHE == REPO / ".jax_cache"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert setup_compile_cache() == str(DEFAULT_COMPILE_CACHE)
        assert jax.config.jax_compilation_cache_dir == str(DEFAULT_COMPILE_CACHE)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    ignored = subprocess.run(["git", "check-ignore", "-q", ".jax_cache"], cwd=REPO)
    assert ignored.returncode == 0


# --- GPU-only entry points --------------------------------------------------


def test_benchmark_refuses_a_cpu_backend():
    from audioflow_tpu.bench import run_benchmark

    with pytest.raises(RuntimeError, match="GPU.*'cpu'"):
        run_benchmark("stft", batch=1, seconds=0.1)


def test_chip_smoke_exits_nonzero_without_a_gpu():
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], capture_output=True,
                         text=True, timeout=300, env=_env(), cwd=REPO)
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr and "'cpu'" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = _env()
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                         timeout=300, env=env, cwd=tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_main_path_imports_only_jax_and_numpy():
    code = (
        "import sys, audioflow_tpu.cli, audioflow_tpu.bench, audioflow_tpu.runner, "
        "audioflow_tpu.validate, audioflow_tpu.session, audioflow_tpu.models\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'scipy', 'optax', 'chex', 'einops', 'hypothesis', 'pytest'}))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=_env())
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# --- smoke script pieces at CPU sizes ---------------------------------------


def test_corpus_is_seeded_16bit_mono(tmp_path):
    for d in "abc":
        (tmp_path / d).mkdir()
    a = chip_smoke.make_corpus(tmp_path / "a", 3, 0.25, seed=5)
    b = chip_smoke.make_corpus(tmp_path / "b", 3, 0.25, seed=5)
    c = chip_smoke.make_corpus(tmp_path / "c", 3, 0.25, seed=6)
    assert [p.name for p in a] == ["clip_0000.wav", "clip_0001.wav", "clip_0002.wav"]
    assert all(pa.read_bytes() == pb.read_bytes() for pa, pb in zip(a, b))
    assert a[0].read_bytes() != c[0].read_bytes()
    with wave.open(str(a[1])) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate(), w.getnframes()) == (
            1, 2, 44100, 11025)
    x, rate = chip_smoke.read_wav(a[1])
    assert rate == 44100 and x.dtype == np.float64 and 0.2 < np.abs(x).max() < 1.0


def test_oracle_polyphase_matches_a_serial_loop(rng):
    from audioflow_tpu.ops.resample import kaiser_sinc_bank
    from audioflow_tpu.validate import _oracle_polyphase

    x = rng.standard_normal(3000)
    bank = kaiser_sinc_bank(160, 441, 16)
    k, off, n_out = bank.shape[1], -((bank.shape[1] - 1) // 2), 3000 * 160 // 441
    xp = np.pad(x, (-off, k + 160))
    want = [bank[(n * 441) % 160] @ xp[(n * 441) // 160 : (n * 441) // 160 + k]
            for n in range(n_out)]
    np.testing.assert_allclose(_oracle_polyphase(x, bank, 160, 441, off, n_out, block=257),
                               want, rtol=1e-12, atol=1e-12)


def test_oracle_log_mel_matches_the_frontend():
    from audioflow_tpu.bench import _tone_batch
    from audioflow_tpu.models import log_mel_frontend
    from audioflow_tpu.validate import oracle_log_mel

    x = _tone_batch(2, 1.5, 44100, seed=3)
    got = np.asarray(log_mel_frontend(44100, 16000, 1024, 256, 128).compile()(jnp.asarray(x)))
    want = np.stack([oracle_log_mel(row, 44100) for row in x])
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-3  # float32 pipeline: ~1e-4


def test_logmel_comparisons_skip_bins_under_top_db():
    ref = np.log(np.array([[1.0, 1e-3, 1e-9], [2.0, 1.0, 1e-12]]))
    got = ref + np.array([[0.01, -0.02, 5.0], [0.0, 0.005, -3.0]])
    assert chip_smoke.logmel_err(got, ref) == pytest.approx(0.02)
    assert chip_smoke.mel_power_rel_err(ref, ref) == 0.0
    assert chip_smoke.mel_power_rel_err(np.log(np.exp(ref) + [[0.5, 0, 0], [0, 0, 0]]), ref) == (
        pytest.approx(0.5))


def test_smoke_corpus_phase_at_cpu_size(capsys):
    chip_smoke.phase_corpus(1, n_files=3, seconds=0.5)
    assert '[corpus] {"files": 3' in capsys.readouterr().out


def test_smoke_configs_phase_at_cpu_size(capsys):
    chip_smoke.phase_configs((("stft", 2), ("master", 2), ("pvoc", 2), ("streaming", 4)), 0.5)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[configs]")]
    assert len(lines) == 4 and all('"finite": true' in ln for ln in lines)


def test_smoke_session_phase_at_cpu_size(capsys):
    chip_smoke.phase_session(2, seconds=4.0)
    assert '"max_abs_lsb": 0' in capsys.readouterr().out


def test_smoke_four_card_phase_on_virtual_devices(capsys):
    chip_smoke.phase_four(0, batch=8, seconds=0.5, long_seconds=4.0)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[four]")]
    assert len(lines) == 2


# --- small repairs ----------------------------------------------------------


def test_profile_trace_raises_what_the_body_raises(tmp_path):
    from audioflow_tpu.obs import profile_trace

    with pytest.raises(KeyError, match="boom"):
        with profile_trace(str(tmp_path / "trace")):
            raise KeyError("boom")
    with profile_trace(""):  # empty dir: no profiler at all
        pass


def test_native_make_tracks_every_included_source(tmp_path):
    """The decoder library depends on each file wavcodec.cpp includes, so a
    newer include makes ``make`` rebuild it (checked with ``make -q``)."""
    if shutil.which("make") is None:
        pytest.skip("no make on this machine")
    shutil.copytree(REPO / "native", tmp_path / "native")
    lib = tmp_path / "audioflow_tpu" / "io" / "_libwavcodec.so"
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")
    sources = [ln.split('"')[1] for ln in (REPO / "native" / "wavcodec.cpp").read_text().splitlines()
               if ln.startswith('#include "')]
    assert sources
    for name in ["wavcodec.cpp", *sources]:
        now = time.time()
        for src in (tmp_path / "native").iterdir():
            os.utime(src, (now - 100, now - 100))
        os.utime(lib, (now - 50, now - 50))
        assert subprocess.run(["make", "-q", "-C", str(tmp_path / "native")]).returncode == 0
        os.utime(tmp_path / "native" / name, (now, now))
        assert subprocess.run(["make", "-q", "-C", str(tmp_path / "native")]).returncode == 1, name


# --- on the card ------------------------------------------------------------


@pytest.mark.gpu
def test_gpu_high_tier_compiles_to_three_bf16_passes():
    x = jnp.ones((256, 1024))
    w = jnp.ones((1024, 513))
    text = jax.jit(lambda a, b: _mm.mm(a, b, "high")).lower(x, w).compile().as_text()
    assert "bf16_bf16_f32_x3" in text.lower()


@pytest.mark.gpu
def test_gpu_validate_passes_at_shipped_defaults():
    from audioflow_tpu.validate import run_validation

    assert run_validation()["pass"]
