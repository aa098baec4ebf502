"""Benchmark harness: the five BASELINE.md configs, measured in
audio-seconds/sec/chip (the north-star metric). Runs on a GPU only: a
measurement path that finds no GPU fails instead of timing the CPU."""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .models import log_mel_frontend, master_chain_graph, stft_magnitude_graph
from .obs import measure_throughput
from .ops import time_stretch


def _tone_batch(batch: int, seconds: float, rate: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate), dtype=np.float32) / rate
    freqs = rng.uniform(80, 4000, batch).astype(np.float32)
    x = 0.3 * np.sin(2 * np.pi * freqs[:, None] * t[None, :])
    x += 0.05 * rng.standard_normal((batch, t.size)).astype(np.float32)
    return x.astype(np.float32)


def _cost_analysis(fn, x) -> dict:
    """XLA cost analysis (flops / bytes accessed) of ONE iteration's
    compiled program — the audit numbers behind the roofline column
    (utilization = how close the measured time sits to the max of the
    bandwidth floor and the compute floor from the `roofline` calibration
    row)."""
    try:
        c = jax.jit(fn).lower(x).compile().cost_analysis()
        c = c[0] if isinstance(c, (list, tuple)) else dict(c)
        return {
            "flops": float(c.get("flops", -1.0)),
            "bytes_accessed": float(c.get("bytes accessed", -1.0)),
        }
    except Exception:  # backend may not expose cost analysis
        return {}


def require_gpu() -> None:
    """Raise unless JAX's first device is a GPU."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"benchmarks run on a GPU; JAX found the {platform!r} backend"
        )


def _measure(graph_fn, x, audio_seconds, iters=10, sharded=False):
    if sharded:
        from .parallel import compile_sharded, make_mesh, shard_batch

        mesh = make_mesh()
        x = shard_batch(np.asarray(x), mesh)
        fn = compile_sharded(graph_fn, mesh)
        n_dev = mesh.devices.size
    else:
        # Graph.compile auto-chunks long signals (scan over fixed chunks);
        # callables are jitted directly
        fn = graph_fn.compile() if hasattr(graph_fn, "compile") else jax.jit(graph_fn)
        x = jnp.asarray(x)
        n_dev = 1
    m = measure_throughput(fn, x, audio_seconds, iters=iters)
    m.n_devices = n_dev
    m._cost_fn, m._cost_x = (None, None) if sharded else (fn, x)
    return m


def streaming_graph(rate: int = 44100):
    """BASELINE config 5's chain: resample -> EQ -> spectrogram -> log-mel."""
    from .graph import BiquadChain, MelProject, Resample, Spectrogram
    from .graph import chain as _chain
    from .models import eq_bands_default

    return _chain(
        Resample(rate, 16000, "kaiser"),
        BiquadChain(eq_bands_default(16000.0)),
        Spectrogram(1024, 256, center=False),
        MelProject(n_mels=128),
        input_rate=rate,
    )


def config_program(name: str, batch: int = 0, seconds: float = 10.0):
    """``(program, x, rate)`` of one BASELINE config at its benchmark shape:
    ``program`` is a Graph or a jittable callable over the host batch ``x
    [batch, T]`` of tones plus noise at ``rate`` Hz. Configs 2 and 5 run
    their chains in the chunked-scan streaming form (``scan_stream``)."""
    if name in ("stft", "config1"):
        return stft_magnitude_graph(16000, 1024, 256), _tone_batch(batch or 64, seconds, 16000), 16000
    if name in ("logmel", "config2"):
        g = log_mel_frontend(44100, 16000, 1024, 256, 128)
        return g, _tone_batch(batch or 256, seconds, 44100), 44100
    if name in ("master", "eq", "config3"):
        return master_chain_graph(16000), _tone_batch(batch or 64, seconds, 16000), 16000
    if name in ("pvoc", "config4"):
        def stretch(z):
            return time_stretch(z, 1.25, 1024, 256)

        return stretch, _tone_batch(batch or 64, seconds, 16000), 16000
    if name == "pitch":
        # the other half of config 4's definition ("time-stretch/pitch-shift
        # with ISTFT round-trip"): stretch + polyphase resample, +12
        # semitones (stretch rate exactly 1/2)
        from .ops import pitch_shift

        def shift(z):
            return pitch_shift(z, 12.0, 16000, 1024, 256)

        return shift, _tone_batch(batch or 64, seconds, 16000), 16000
    if name in ("logmel_stream", "streaming", "config5"):
        # logmel_stream is the headline: config 2's computation in the
        # framework's chunked-scan streaming mode
        if name == "logmel_stream":
            g = log_mel_frontend(44100, 16000, 1024, 256, 128, center=False)
            batch = batch or 512
        else:
            g = streaming_graph(44100)
            batch = batch or 256
        gran = g.chunk_granularity()
        chunk = gran * max(1, 16384 // gran)
        x = _tone_batch(batch, seconds, 44100)
        x = x[:, : x.shape[-1] // chunk * chunk]

        def stream(b):
            return g.scan_stream(b, chunk)

        return stream, x, 44100
    raise ValueError(f"unknown benchmark {name!r}")


def run_benchmark(
    name: str = "logmel", batch: int = 0, seconds: float = 10.0,
    sharded: bool = False, cost: bool = True,
) -> dict:
    """Run one named benchmark; returns a JSON-ready dict.

    With ``cost=True`` (default) the row also carries XLA's flops /
    bytes-accessed for the single-iteration program and the achieved
    TFLOP/s and GB/s — divide by the ``roofline`` calibration row to audit
    utilization."""
    require_gpu()
    if name in ("stft", "config1", "logmel", "config2", "master", "eq", "config3"):
        g, x, rate = config_program(name, batch, seconds)
        batch = x.shape[0]
        m = _measure(g, x, batch * x.shape[-1] / rate, sharded=sharded)
    elif name in ("pvoc", "config4", "pitch"):
        fn, x, rate = config_program(name, batch, seconds)
        batch = x.shape[0]
        m = _measure(fn, x, batch * x.shape[-1] / rate)
    elif name in ("logmel_stream", "streaming", "config5"):
        prog, x, rate = config_program(name, batch, seconds)
        batch = x.shape[0]
        audio = batch * x.shape[-1] / rate
        if sharded and name != "logmel_stream":
            from .parallel import batch_sharding, make_mesh, shard_batch

            mesh = make_mesh()
            fn = jax.jit(prog, in_shardings=(batch_sharding(mesh, 2),))
            m = measure_throughput(fn, shard_batch(x, mesh), audio, iters=10)
            m.n_devices = mesh.devices.size
        else:
            fn = jax.jit(prog)
            x = jnp.asarray(x)
            m = measure_throughput(fn, x, audio, iters=10)
            m._cost_fn, m._cost_x = fn, x
    elif name == "roofline":
        # platform calibration row: streaming device-memory bandwidth
        # (elementwise triad, three 128 MB streams) and the bf16 matmul
        # rate (8192^3, ~1.1 TFLOP/iter). Every other row's utilization is
        # measured time vs max(bytes/hbm_gbps, flops/matmul_tflops_bf16).
        nels = 32 * 1024 * 1024
        cvec = jnp.full((nels,), 0.5, jnp.float32)
        triad = lambda u: u * jnp.float32(1.0001) + cvec  # noqa: E731
        mt = measure_throughput(
            triad, jnp.ones((nels,), jnp.float32), 1.0, iters=10
        )
        gbps = 3 * nels * 4 * 10 / mt.wall_seconds / 1e9
        k = 8192
        w = jnp.full((k, k), 0.001, jnp.bfloat16)
        mm_fn = lambda a: jax.lax.dot_general(  # noqa: E731
            a.astype(jnp.bfloat16), w, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        ) * jnp.float32(1e-3)
        mmt = measure_throughput(
            mm_fn, jnp.full((k, k), 0.001, jnp.float32), 1.0, iters=10
        )
        tflops = 2 * k**3 * 10 / mmt.wall_seconds / 1e12
        return {
            "benchmark": "roofline",
            "hbm_gbps": round(gbps, 1),
            "matmul_tflops_bf16": round(tflops, 1),
            "triad_ms": round(mt.wall_seconds * 100, 3),
            "matmul_ms": round(mmt.wall_seconds * 100, 3),
            "compile_seconds": round(mt.compile_seconds + mmt.compile_seconds, 1),
        }
    elif name in ("session", "session_drain"):
        # live push-path throughput: StreamSession's device-ring + lazy
        # results, one host dispatch chain per chunk — a LATENCY-mode
        # figure, not the batch headline (that's "streaming").
        import time as _time

        from .session import StreamSession

        batch = batch or 64
        rate = 44100
        g = log_mel_frontend(rate, 16000, 1024, 256, 128)
        gran = g.chunk_granularity()
        chunk = gran * max(1, 16384 // gran)
        x = _tone_batch(batch, seconds, rate)
        # session_drain: producer outpaces the consumer — push 8-chunk blocks
        # so the bucketed lax.scan multi-step drains 8 chunks per dispatch
        # (ROADMAP 4b; per-chunk Result semantics preserved)
        block = 8 * chunk if name == "session_drain" else chunk
        cap = 17 * chunk if name == "session_drain" else None
        n = x.shape[-1] // block * block
        # precompile="all": step + every drain bucket compiled at open, so
        # the first push (and the latency loop below) never hits a compile
        sess = StreamSession(
            g, chunk_in=chunk, lead_shape=(batch,), ring_capacity=cap
        ).open(precompile="all")
        sess.push(x[:, :block])  # warm the staging-write path at this shape
        sess.poll_all()
        t0 = _time.perf_counter()
        for i in range(block, n, block):
            sess.push(x[:, i : i + block])
        last = sess.poll_all()[-1]
        np.asarray(last.data).sum()  # materialize the final chunk = sync
        wall = _time.perf_counter() - t0
        audio = batch * (n - block) / rate
        # latency mode: per-block wall including a host materialization of
        # that block's result — what a live caller waiting on each chunk
        # sees (the throughput number above lets dispatch pipeline instead)
        lat = []
        for _ in range(3):
            for i in range(0, n, block):
                tb = _time.perf_counter()
                sess.push(x[:, i : i + block])
                res = sess.poll_all()
                np.asarray(res[-1].data).sum()
                lat.append(_time.perf_counter() - tb)
        sess.close()
        per_chunk = np.sort(np.asarray(lat)) / max(block // chunk, 1) * 1000.0
        chunk_s = chunk / rate
        p50 = float(np.percentile(per_chunk, 50))
        p99 = float(np.percentile(per_chunk, 99))
        from .obs.metrics import RunMetrics

        m = RunMetrics(
            audio_seconds=audio, wall_seconds=wall, batches=(n - block) // chunk,
            extra={
                "latency_ms_p50": round(p50, 2),
                "latency_ms_p99": round(p99, 2),
                "latency_x_realtime_p50": round(batch * chunk_s / (p50 / 1000.0), 1),
            },
        )
    else:
        raise ValueError(f"unknown benchmark {name!r}")
    out = m.to_dict()
    out.update({"benchmark": name, "batch": batch, "clip_seconds": seconds})
    if cost and getattr(m, "_cost_fn", None) is not None:
        ca = _cost_analysis(m._cost_fn, m._cost_x)
        if ca.get("flops", -1.0) > 0:
            per_iter = out["wall_seconds"] / max(out["batches"], 1)
            out.update(ca)
            out["achieved_tflops"] = round(ca["flops"] / per_iter / 1e12, 3)
            out["achieved_gbps"] = round(ca["bytes_accessed"] / per_iter / 1e9, 1)
    return out
