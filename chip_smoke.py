#!/usr/bin/env python
"""Smoke run of audioflow on a GPU, through the entry points a user calls.

One process drives the card. Each phase prints one line; the last line is
one JSON object ``{"ok": true, "device": {...}}``. A failed phase raises, so
the script exits non-zero and prints no result line.

Phases (default, one card):

* ``device`` — JAX's first device must be a GPU (no CPU fallback); prints
  its kind and ``nvidia-smi``'s name and power limit.
* ``validate`` — ``audioflow validate`` (:func:`validate.run_validation`)
  at the shipped precision defaults must pass.
* ``corpus`` — BASELINE config 2 through the production runner: 256 WAV
  files (10 s, 44.1 kHz, 16-bit; tones plus noise from ``--seed``) into
  ``audioflow run -g logmel --batch-size 256``; 4 lanes are compared with
  the float64 oracle of the same chain (``validate.oracle_log_mel``).
* ``configs`` — BASELINE configs 1, 3, 4 and 5 once each at the benchmark
  shapes (config 5 at its 1024-file batch); outputs must be finite.
* ``session`` — the dictation flow: a ``StreamSession`` on 48 kHz ->
  16 kHz -> VAD gate -> i16 over 60 s of audio pushed in 20 ms blocks;
  streamed output must equal the offline program's at ``stream_latency``.

``--four`` runs only the two paths that span four cards, each against one
card's result on the same input: config 5 batch-sharded through
``compile_sharded``, and ``compile_sharded(..., shard="time")`` of a 7-node
graph over one 60-minute 48 kHz signal.

Usage: python chip_smoke.py [--seed N] [--four]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np

#: log-mel tolerance in natural-log units (0.087 dB), over the mel bins
#: within TOP_DB of each signal's peak. The float32 pipeline lands within
#: 1e-4 of the float64 oracle; the "high" DFT tier (three bf16 passes, ~16
#: mantissa bits) within a few 1e-3 on noise-floor bins, where the log
#: magnifies a relative error. One TF32 pass (~10 bits) misses by tenths,
#: so this bound catches a precision tier that lost its meaning.
LOGMEL_TOL = 2e-2
#: bins more than 60 dB under the peak hold < 1e-6 of its power (e.g. the
#: bands a high-pass removed); their log is rounding noise of the linear
#: products, not signal, so they are left out of the comparison
TOP_DB = 60.0
#: four-card paths against one card, as mel power relative to each lane's
#: peak. The time-sharded chain composes IIR state and limiter envelopes
#: across shards, which reassociates float32 sums: the tests hold it to
#: 1e-5 on samples, which the low mel bins magnify to ~1e-4 (7.7e-5 on 4
#: virtual CPU devices at 120 s, 1.9e-4 on four H100s at one hour). A lost
#: halo or a wrong carry is off by O(1) at the shard seams, far above this
#: bound.
SHARD_REL_TOL = 1e-3
CORPUS_FILES = 256
CORPUS_SECONDS = 10.0
CORPUS_RATE = 44100


def emit(phase: str, **info) -> None:
    print(f"[{phase}] {json.dumps(info)}", flush=True)


def logmel_err(got, ref, lane_axes: int = 1) -> float:
    """max |got - ref| of natural-log mel features over the bins of ``ref``
    within :data:`TOP_DB` of the peak of their lane (the leading
    ``lane_axes`` axes index lanes)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    axes = tuple(range(lane_axes, ref.ndim))
    keep = ref >= ref.max(axis=axes, keepdims=True) - TOP_DB * np.log(10.0) / 10.0
    return float(np.abs(got - ref)[keep].max())


def mel_power_rel_err(got, ref) -> float:
    """max |exp(got) - exp(ref)| over the peak of exp(ref), per lane (the
    leading axis), of natural-log mel features."""
    a, b = np.exp(np.asarray(got, np.float64)), np.exp(np.asarray(ref, np.float64))
    axes = tuple(range(1, b.ndim))
    return float((np.abs(a - b).max(axis=axes) / b.max(axis=axes)).max())


def make_corpus(directory, n_files: int = CORPUS_FILES, seconds: float = CORPUS_SECONDS,
                rate: int = CORPUS_RATE, seed: int = 0) -> list[Path]:
    """Write ``n_files`` mono 16-bit WAVs of tones plus noise (the benchmark
    signal, ``bench._tone_batch``) made from ``seed``; returns their paths
    in name order."""
    from audioflow_tpu.bench import _tone_batch

    pcm = np.clip(np.round(_tone_batch(n_files, seconds, rate, seed) * 32767.0),
                  -32768, 32767).astype("<i2")
    paths = []
    for i, row in enumerate(pcm):
        path = Path(directory) / f"clip_{i:04d}.wav"
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(row.tobytes())
        paths.append(path)
    return paths


def read_wav(path) -> tuple[np.ndarray, int]:
    """16-bit mono WAV -> (float64 samples in [-1, 1), rate), decoded by the
    standard library: independent of the package's decoders."""
    with wave.open(str(path), "rb") as w:
        rate = w.getframerate()
        data = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    return data.astype(np.float64) / 32768.0, rate


def dictation_signal(seconds: float, rate: int = 48000, seed: int = 0) -> np.ndarray:
    """Speech-like bursts (harmonic tone plus noise, 0.4-1.5 s) separated by
    near-silence, so the VAD gate opens and closes."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    x = 1e-4 * rng.standard_normal(n)
    t = 0
    while t < n:
        t += int(rng.uniform(0.3, 1.0) * rate)
        length = int(rng.uniform(0.4, 1.5) * rate)
        seg = np.arange(min(length, max(n - t, 0))) / rate
        f0 = rng.uniform(100.0, 250.0)
        burst = sum(0.3 / k * np.sin(2 * np.pi * k * f0 * seg) for k in (1, 2, 3))
        x[t : t + seg.size] += burst + 0.02 * rng.standard_normal(seg.size)
        t += seg.size
    return x.astype(np.float32)


def _timed(fn, x):
    """(compiled output, compile seconds, run seconds) of one call."""
    import jax

    t0 = time.perf_counter()
    compiled = fn.lower(x).compile()
    t1 = time.perf_counter()
    out = jax.block_until_ready(compiled(x))
    return out, t1 - t0, time.perf_counter() - t1


def phase_device(count: int) -> dict:
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU; JAX found the {devices[0].platform!r} backend"
        )
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs; JAX found {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    emit("device", kind=devices[0].device_kind, count=len(devices), nvidia_smi=smi.splitlines())
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def phase_validate() -> None:
    from audioflow_tpu.validate import run_validation

    t0 = time.perf_counter()
    report = run_validation()
    emit("validate", seconds=round(time.perf_counter() - t0, 1), **report)
    if not report["pass"]:
        raise RuntimeError("audioflow validate failed on the card")


def phase_corpus(seed: int, n_files: int = CORPUS_FILES, seconds: float = CORPUS_SECONDS) -> None:
    from audioflow_tpu import cli
    from audioflow_tpu.utils import round_up
    from audioflow_tpu.validate import oracle_log_mel

    lanes = sorted({0, n_files // 3, 2 * n_files // 3, n_files - 1})
    with tempfile.TemporaryDirectory() as d:
        paths = make_corpus(d, n_files, seconds, seed=seed)
        out = Path(d) / "feats.npy"
        t0 = time.perf_counter()
        rc = cli.main(["run", "-i", f"{d}/*.wav", "-o", str(out), "-g", "logmel",
                       "--batch-size", str(n_files), "--stats", f"{d}/stats.json"])
        wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"audioflow run exited {rc}")
        feats = np.load(out)
        errs = {}
        for lane in lanes:
            x, rate = read_wav(paths[lane])
            # the runner pads every lane to its stride: the file length
            # rounded up to 1024 samples
            x = np.pad(x, (0, round_up(x.size, 1024) - x.size))
            ref = oracle_log_mel(x, rate)
            if feats[lane].shape != ref.shape:
                raise RuntimeError(f"lane {lane}: {feats[lane].shape} != {ref.shape}")
            errs[lane] = logmel_err(feats[lane], ref, lane_axes=0)
    worst = max(errs.values())
    emit("corpus", files=len(paths), feats_shape=list(feats.shape), run_seconds=round(wall, 2),
         finite=bool(np.isfinite(feats).all()), max_abs_logmel_err=errs, tol=LOGMEL_TOL)
    if feats.shape[0] != n_files or not np.isfinite(feats).all() or worst > LOGMEL_TOL:
        raise RuntimeError(f"corpus log-mel off the float64 oracle: {errs}")


CONFIGS = (("stft", 64), ("master", 64), ("pvoc", 64), ("streaming", 1024))


def phase_configs(configs=CONFIGS, seconds: float = 10.0) -> None:
    import jax
    import jax.numpy as jnp

    from audioflow_tpu.bench import config_program

    for name, batch in configs:
        prog, x, rate = config_program(name, batch, seconds)
        fn = prog.compile() if hasattr(prog, "compile") else jax.jit(prog)
        xd = jax.device_put(x)
        out, compile_s, wall_s = _timed(fn, xd)
        finite = bool(jnp.isfinite(out).all())
        emit("configs", config=name, batch=int(x.shape[0]), input_shape=list(x.shape),
             output_shape=list(out.shape), finite=finite, compile_seconds=round(compile_s, 2),
             wall_seconds=round(wall_s, 4), audio_seconds=x.shape[0] * x.shape[1] / rate)
        if not finite:
            raise RuntimeError(f"config {name}: non-finite output")
        del out, xd


def dictation_graph():
    """The reference's dictation path: 48 kHz capture -> 16 kHz -> VAD gate
    -> i16 wire samples."""
    from audioflow_tpu.graph import QuantizeI16, Resample, VadGate, chain

    return chain(Resample(48000, 16000, "cubic"), VadGate(frame_len=320), QuantizeI16(),
                 input_rate=48000, name="dictation")


def phase_session(seed: int, seconds: float = 60.0) -> None:
    import jax.numpy as jnp

    from audioflow_tpu.session import StreamSession

    g = dictation_graph()
    x = dictation_signal(seconds, 48000, seed)
    block = 960  # 20 ms at 48 kHz, the reference's capture cadence
    gran = g.chunk_granularity()
    chunk = gran * max(1, block // gran)
    sess = StreamSession(g, chunk_in=chunk).open()
    got, lat_ms = [], []
    for i in range(0, x.size, block):
        t0 = time.perf_counter()
        sess.push(x[i : i + block])
        got += [np.asarray(r.data) for r in sess.poll_all()]
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    sess.flush()
    got += [np.asarray(r.data) for r in sess.poll_all()]
    sess.close()
    streamed = np.concatenate(got, axis=-1)
    offline = np.asarray(g.compile()(jnp.asarray(x)))
    lat = g.stream_latency(chunk)
    m = min(streamed.size - lat, offline.size)
    diff = np.abs(streamed[lat : lat + m].astype(np.int64) - offline[:m].astype(np.int64))
    emit("session", seconds=seconds, pushes=len(lat_ms), chunk_in=chunk, latency_samples=lat,
         compared=int(m), max_abs_lsb=int(diff.max()), equal_share=float(np.mean(diff == 0)),
         gated_share=float(np.mean(offline == 0)),
         push_ms_p50=float(np.percentile(lat_ms, 50)), push_ms_p99=float(np.percentile(lat_ms, 99)))
    # one LSB: the two programs may round a float32 sum differently
    if m < offline.size - chunk or diff.max() > 1:
        raise RuntimeError("streamed dictation output differs from the offline program")


def _check_spread(out, n: int, axis: int, what: str) -> None:
    """Each of ``n`` output shards on its own card, 1/n of ``axis`` each."""
    devs = {s.device for s in out.addressable_shards}
    sizes = {s.data.shape[axis] for s in out.addressable_shards}
    if len(devs) != n or sizes != {out.shape[axis] // n}:
        raise RuntimeError(f"{what}: shards on {len(devs)} devices, sizes {sizes}")


def phase_four(seed: int, batch: int = 1024, seconds: float = 10.0,
               long_seconds: float = 3600.0) -> None:
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from audioflow_tpu.bench import _tone_batch, streaming_graph
    from audioflow_tpu.graph import (
        BiquadChain, Compressor, Gain, Limiter, MelProject, Resample, Spectrogram, chain,
    )
    from audioflow_tpu.ops import highpass, peaking
    from audioflow_tpu.parallel import compile_sharded, make_mesh, shard_batch

    mesh = make_mesh(4)  # 1-D: the cards are joined all to all
    one = jax.devices()[0]

    # config 5, 1024 files x 10 s, batch-sharded
    g5 = streaming_graph(44100)
    x = _tone_batch(batch, seconds, 44100, seed)
    out4, c4, w4 = _timed(compile_sharded(g5, mesh), shard_batch(x, mesh))
    _check_spread(out4, 4, 0, "config 5")
    out1, c1, w1 = _timed(jax.jit(g5.chain), jax.device_put(x, one))
    err = mel_power_rel_err(np.asarray(out4), np.asarray(out1))
    emit("four", path="config5_batch_sharded", input_shape=list(x.shape),
         output_shape=list(out4.shape), mel_power_rel_err_vs_one_card=err,
         logmel_err_vs_one_card=logmel_err(np.asarray(out4), np.asarray(out1)),
         tol=SHARD_REL_TOL,
         compile_seconds_4=round(c4, 2), wall_seconds_4=round(w4, 4),
         compile_seconds_1=round(c1, 2), wall_seconds_1=round(w1, 4))
    if not err <= SHARD_REL_TOL:
        raise RuntimeError(f"config 5 sharded differs from one card by {err}")
    del out4, out1, x

    # one 60-minute 48 kHz signal, time-sharded through the graph API
    g7 = chain(
        Gain(-1.0),
        BiquadChain((highpass(60.0, 48000.0), peaking(1000.0, 48000.0, 3.0, 1.0))),
        Compressor(threshold_db=-18.0, ratio=3.0),
        Resample(48000, 16000, "kaiser"),
        Limiter(-1.0),
        Spectrogram(512, 128, center=False),
        MelProject(n_mels=32),
        input_rate=48000,
        name="sp_graph",
    )
    n = int(long_seconds * 48000)
    xs = (0.4 * np.random.default_rng(seed + 1).standard_normal((1, n))).astype(np.float32)
    xt = jax.device_put(xs, NamedSharding(mesh, P(None, "data")))
    out4, c4, w4 = _timed(compile_sharded(g7, mesh, shard="time"), xt)
    _check_spread(out4, 4, 1, "time-sharded graph")
    out1, c1, w1 = _timed(jax.jit(g7.chain), jax.device_put(xs, one))
    # the last frames differ by construction: the sharded grid frames a
    # zero tail past the signal, the unsharded chain stops at the last
    # full frame (the convention tests/test_parallel.py checks)
    n = out1.shape[1] - 4
    a, b = np.asarray(out4[:, :n]), np.asarray(out1[:, :n])
    err = mel_power_rel_err(a, b)
    emit("four", path="graph_time_sharded", input_shape=list(xs.shape),
         output_shape=list(out4.shape), compared_frames=n, mel_power_rel_err_vs_one_card=err,
         logmel_err_vs_one_card=logmel_err(a, b), tol=SHARD_REL_TOL,
         compile_seconds_4=round(c4, 2), wall_seconds_4=round(w4, 4),
         compile_seconds_1=round(c1, 2), wall_seconds_1=round(w1, 4))
    if not err <= SHARD_REL_TOL:
        raise RuntimeError(f"time-sharded graph differs from one card by {err}")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--four", action="store_true",
                   help="run only the four-card paths (needs four GPUs)")
    args = p.parse_args(argv)

    from audioflow_tpu.utils import setup_compile_cache

    setup_compile_cache()
    device = phase_device(4 if args.four else 1)
    if args.four:
        phase_four(args.seed)
    else:
        phase_validate()
        phase_corpus(args.seed)
        phase_configs()
        phase_session(args.seed)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
