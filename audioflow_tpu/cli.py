"""audioflow CLI — the framework's command surface.

Maps the reference's 24-command Tauri API (commands.rs:17-511, SURVEY §2.5)
onto batch-framework verbs:

  devices            compute device enumeration (get_audio_devices analog)
  info               version/platform info      (get_app_info analog)
  config show|path|set  config inspection/persistence (load/save_config)
  run                offline graph over WAV files -> sink   (the DSP path)
  stream             streaming session over a file, wire/npy egress
  vad                VAD segments of a file     (get/set_vad_level + detect)
  bench              throughput benchmarks      (new; north-star metric)
  validate           numerics vs oracle, max|delta| report

Usage: python -m audioflow_tpu.cli <command> [options]
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import sys

import numpy as np

from . import __version__
from .config import ConfigManager, default_config_path, graph_from_spec
from .errors import AudioFlowError
from .obs import StatsFile, get_logger, setup_logging
from .sinks import auto_sink
from .utils import setup_compile_cache

_log = get_logger("cli")

_GRAPHS = (
    "logmel", "stft", "eq", "master", "vad", "wire", "fbank", "kws",
    "deltafbank", "denoise", "features", "chroma", "cqt", "cqtroundtrip",
    "onset", "beats", "contrast", "tonnetz",
)


def _build_graph(
    name: str, input_rate: int, cfg, streaming: bool = False,
    multirate: bool = False,
):
    from .models import (
        eq_chain_graph,
        log_mel_frontend,
        master_chain_graph,
        stft_magnitude_graph,
        vad_graph,
        wire_egress_graph,
    )

    a = cfg.audio
    if name == "logmel":
        return log_mel_frontend(input_rate, a.target_rate, a.n_fft, a.hop, a.n_mels, a.resample_mode)
    if name == "stft":
        return stft_magnitude_graph(input_rate, a.n_fft, a.hop, center=not streaming)
    if name == "eq":
        return eq_chain_graph(input_rate)
    if name == "master":
        return master_chain_graph(input_rate)
    if name == "vad":
        return vad_graph(input_rate, a.chunk_ms)
    if name == "wire":
        return wire_egress_graph(input_rate, a.target_rate)
    if name == "fbank":
        from .models import kaldi_fbank_frontend

        return kaldi_fbank_frontend(input_rate, n_mels=a.n_mels)
    if name == "kws":
        from .models import kws_frontend

        return kws_frontend(input_rate, a.n_fft, a.hop)
    if name == "deltafbank":
        from .models import delta_fbank_frontend

        return delta_fbank_frontend(input_rate)
    if name == "denoise":
        from .models import denoise_master_chain

        return denoise_master_chain(input_rate)
    if name == "features":
        from .graph import SpectralFeatures, Spectrogram
        from .graph import chain as _chain

        return _chain(
            Spectrogram(a.n_fft, a.hop, center=False, power=False),
            SpectralFeatures(
                ("centroid", "bandwidth", "rolloff", "flatness", "flux"),
                n_bins=a.n_fft // 2 + 1,
            ),
            input_rate=input_rate,
        )
    if name == "chroma":
        from .graph import Chroma, Spectrogram
        from .graph import chain as _chain

        return _chain(
            Spectrogram(a.n_fft, a.hop, center=False, power=True),
            Chroma(),
            input_rate=input_rate,
        )
    if name == "cqt":
        from .models import cqt_frontend

        return cqt_frontend(input_rate, a.hop)
    if name == "cqtroundtrip":
        # audio -> complex CQT -> audio through the inverse; exercises the
        # analysis and synthesis banks end to end on real material.
        # Default: the fixed-hop transform (hybrid inverse past the
        # painless cliff — tonal content only, ops/cqt.py::icqt).
        # --multirate: the broadband-invertible per-octave-hop variant
        # (one wrapper node; the octave pytree never leaves it).
        from .graph import chain as _chain

        if multirate:
            from .graph import CqtRoundTripMultirate

            return _chain(
                CqtRoundTripMultirate(hop=a.hop), input_rate=input_rate,
            )
        from .graph import Cqt, Icqt

        return _chain(
            Cqt(hop=a.hop, output="complex", impl="onedot"),
            Icqt(hop=a.hop),
            input_rate=input_rate,
        )
    if name == "onset":
        from .models import onset_frontend

        return onset_frontend(input_rate, a.n_fft, a.hop)
    if name == "beats":
        from .models import beat_graph

        return beat_graph(input_rate, a.n_fft, a.hop)
    if name == "contrast":
        from .graph import SpectralContrast, Spectrogram
        from .graph import chain as _chain

        return _chain(
            Spectrogram(a.n_fft, a.hop, center=False, power=False),
            SpectralContrast(),
            input_rate=input_rate,
        )
    if name == "tonnetz":
        from .graph import Chroma, Spectrogram, Tonnetz
        from .graph import chain as _chain

        return _chain(
            Spectrogram(a.n_fft, a.hop, center=False, power=True),
            Chroma(),
            Tonnetz(),
            input_rate=input_rate,
        )
    raise SystemExit(f"unknown graph {name!r}; known: {_GRAPHS}")


def _expand_inputs(patterns: list[str]) -> list[str]:
    files: list[str] = []
    for p in patterns:
        hits = sorted(_glob.glob(p))
        files.extend(hits if hits else [p])
    if not files:
        raise SystemExit("no input files")
    return files


def cmd_devices(args) -> int:
    import jax

    rows = []
    for d in jax.devices():
        rows.append(
            {
                "id": d.id,
                "platform": d.platform,
                "kind": getattr(d, "device_kind", "?"),
                "process": d.process_index,
            }
        )
    print(json.dumps(rows, indent=None if args.json else 2))
    return 0


def cmd_info(args) -> int:
    import jax

    info = {
        "name": "audioflow-tpu",
        "version": __version__,
        "jax": jax.__version__,
        "backend": jax.default_backend(),
        "n_devices": jax.device_count(),
        "config_path": str(default_config_path()),
    }
    print(json.dumps(info, indent=2))
    return 0


def cmd_config(args) -> int:
    mgr = ConfigManager(args.file)
    if args.action == "path":
        print(mgr.path)
        return 0
    mgr.load()
    if args.action == "show":
        print(json.dumps(mgr.current().to_dict(), indent=2))
        return 0
    if args.action == "set":
        section, _, key = args.key.partition(".")

        def apply(cfg):
            obj = getattr(cfg, section, None)
            if obj is None or not hasattr(obj, key):
                raise SystemExit(f"unknown config key {args.key!r}")
            cur = getattr(obj, key)
            typ = type(cur) if cur is not None else str
            val = typ(args.value) if typ is not bool else args.value.lower() in ("1", "true", "yes")
            setattr(obj, key, val)

        mgr.update(apply)
        mgr.save()
        print(f"saved {args.key} to {mgr.path}")
        return 0
    raise SystemExit(f"unknown config action {args.action}")


def _load_batch(files, pad_multiple):
    from .io import decode_batch

    batch = decode_batch(files, pad_multiple=pad_multiple)
    if not batch.valid.any():
        raise SystemExit("all input files failed to decode")
    bad = [str(p) for p, v in zip(batch.paths, batch.valid) if not v]
    if bad:
        _log.warning("failed lanes (masked, not fatal): %s", bad)
    return batch


def cmd_run(args) -> int:
    import jax
    import jax.numpy as jnp

    cfg = ConfigManager(args.config).load() if args.config else ConfigManager().current()
    files = _expand_inputs(args.input)

    def _finish(sink, metrics):
        res = sink.close()
        stats = StatsFile(args.stats) if args.stats else StatsFile()
        stats.record_run(metrics.audio_seconds)
        stats.save()
        out_name = str(res) if isinstance(res, (str, os.PathLike)) else "array"
        print(json.dumps({"output": out_name, **metrics.to_dict()}))

    if args.batch_size:
        # multi-batch pipelined runner: per-lane masking handles bad files
        # and wrong rates, so no up-front whole-input decode is needed —
        # just probe headers for the stride and the input rate
        from .io import BatchLoader, wav
        from .runner import run_batches

        def _probe_head(path):
            # fmt/data chunks usually sit in the first 4 KB, but LIST/bext
            # metadata can push them far deeper — grow the head until the
            # header parses (full read as the last resort)
            for head in (4096, 1 << 16, None):
                with open(path, "rb") as fh:
                    buf = fh.read(head) if head else fh.read()
                try:
                    return wav.probe(buf, truncated=True)
                except Exception:
                    if head is None:
                        raise
            raise AssertionError  # unreachable

        max_frames, rate_votes = 1, {}
        for f in files:
            try:
                size = os.path.getsize(f)
                info = _probe_head(f)
            except Exception:
                continue
            # clamp the declared size against the actual file size: streaming
            # encoders often leave 0xFFFFFFFF placeholders that would explode
            # the staging allocation
            frame_bytes = max(1, info.channels * (info.bits // 8))
            n = min(info.n_frames, max(0, size - info.data_offset) // frame_bytes)
            max_frames = max(max_frames, n)
            rate_votes[info.sample_rate] = rate_votes.get(info.sample_rate, 0) + 1
        input_rate = args.input_rate or (
            max(rate_votes, key=rate_votes.get) if rate_votes else cfg.audio.sample_rate
        )
        if args.spec:
            with open(args.spec) as f:
                g = graph_from_spec(json.load(f))
        else:
            g = _build_graph(args.graph, input_rate, cfg,
                             multirate=getattr(args, "multirate", False))
        mesh = None
        if args.sharded:
            from .parallel import make_mesh

            mesh = make_mesh()
        from .utils import round_up

        stride = round_up(int(max_frames), 1024)
        sink = auto_sink(args.output, sample_rate=g.output_rate)
        loader = BatchLoader(files, batch_size=args.batch_size, stride=stride)
        m = run_batches(g, loader, sinks=[sink], mesh=mesh, expect_rate=input_rate)
        _finish(sink, m)
        return 0

    batch = _load_batch(files, pad_multiple=1024)
    rates = set(batch.rates[batch.valid].tolist())
    if len(rates) > 1:
        raise SystemExit(
            f"mixed sample rates in batch: {sorted(rates)} "
            "(use --batch-size with --input-rate to mask off-rate lanes)"
        )
    input_rate = args.input_rate or (rates.pop() if rates else cfg.audio.sample_rate)

    if args.spec:
        with open(args.spec) as f:
            g = graph_from_spec(json.load(f))
    else:
        g = _build_graph(args.graph, input_rate, cfg,
                         multirate=getattr(args, "multirate", False))

    from .obs import RunMetrics, Timer

    x = jnp.asarray(batch.samples)
    if args.sharded:
        from .parallel import compile_sharded, make_mesh, pad_batch, shard_batch

        mesh = make_mesh()
        padded, mask = pad_batch(batch.samples, mesh)
        x = shard_batch(padded, mesh)
        fn = compile_sharded(g, mesh)
    else:
        fn = g.compile()

    with Timer() as tc:
        jax.block_until_ready(fn(x))
    with Timer() as tr:
        out = jax.block_until_ready(fn(x))
    host = np.asarray(out)[: len(files)]

    m = RunMetrics(
        audio_seconds=batch.audio_seconds,
        wall_seconds=tr.elapsed,
        compile_seconds=tc.elapsed,
        files=len(files),
        failed_files=int((~batch.valid).sum()),
        batches=1,
        n_devices=jax.device_count() if args.sharded else 1,
    )
    sink = auto_sink(args.output, sample_rate=g.output_rate)
    sink.write(host)
    _finish(sink, m)
    return 0


def cmd_stream(args) -> int:
    from .io import read_audio
    from .session import StreamSession

    cfg = ConfigManager(args.config).load() if args.config else ConfigManager().current()
    data, rate = read_audio(args.input)
    if data.ndim == 2:
        data = data.mean(axis=1).astype(np.float32)
    g = _build_graph(args.graph, rate, cfg, streaming=True)
    sinks = [auto_sink(args.output, sample_rate=g.output_rate)] if args.output else []
    # a file source outruns the device, so default to 8-chunk block pushes:
    # the session's multi-chunk drain then runs 8 steps per dispatch
    gran = g.chunk_granularity()
    chunk = args.chunk or gran * max(1, 4096 // gran)
    sess = StreamSession(g, chunk_in=chunk, sinks=sinks, ring_capacity=17 * chunk)
    with sess:
        step = args.push_size or 8 * sess.chunk_in
        for i in range(0, len(data), step):
            sess.push(data[i : i + step])
        sess.flush()
        results = sess.poll_all()
    print(
        json.dumps(
            {
                "chunks": len(results),
                "latency": g.stream_latency(sess.chunk_in),
                "audio_seconds": len(data) / rate,
                "output": str(args.output) if args.output else None,
            }
        )
    )
    return 0


def cmd_key(args) -> int:
    """API-key storage (store/retrieve/delete parity, secure_storage.rs:18-33)."""
    from .config import EnvKeyStorage, FileKeyStorage
    from .errors import ConfigError

    file_store = FileKeyStorage(args.file) if args.file else FileKeyStorage()
    if args.action == "set":
        if not args.value:
            raise SystemExit("key set needs a value")
        # env vars die with this process; persistent set always uses the file
        file_store.store(args.account, args.value)
        print(f"stored key for {args.account} in {file_store.path}")
    elif args.action == "get":
        try:
            print(EnvKeyStorage().retrieve(args.account))  # env wins (cluster practice)
        except ConfigError:
            print(file_store.retrieve(args.account))
    elif args.action == "delete":
        file_store.delete(args.account)
        print(f"deleted key for {args.account}")
    return 0


def cmd_egress(args) -> int:
    """The reference's full dictation egress, end to end: WAV -> (VAD gate) ->
    resample to 16 kHz -> i16 wire chunks -> WebSocket, printing transcript
    events (connect_scribe + send_audio + receive_transcription parity,
    commands.rs:202-306). Runs on the live ScribeSession driver: background
    receive thread, keepalive pings, auto-reconnect with session resume."""
    import jax.numpy as jnp

    from .graph import Resample, VadGate, chain
    from .io import read_audio
    from .session import ScribeConfig, ScribeSession
    from .sinks import WebSocketConfig

    data, rate = read_audio(args.input)
    if data.ndim == 2:
        data = data.mean(axis=1).astype(np.float32)
    nodes = []
    if args.vad_gate:
        nodes.append(VadGate(frame_len=rate * 20 // 1000))
    if rate != 16000:
        nodes.append(Resample(rate, 16000, "cubic"))
    g = chain(*nodes, input_rate=rate) if nodes else None

    cfg = ConfigManager(args.config).load() if args.config else ConfigManager().current()
    api_key = args.api_key or ""
    if not api_key and cfg.api.api_key_env:
        api_key = os.environ.get(cfg.api.api_key_env, "")
    session = ScribeSession(
        ScribeConfig(
            model_id=cfg.api.model_id,
            language_code=cfg.api.language_code,
            ws=WebSocketConfig(
                url=args.url,
                api_key=api_key,
                connect_timeout_s=cfg.api.connect_timeout_s,
                reconnect_delay_ms=cfg.api.reconnect_delay_ms,
                max_reconnect_attempts=cfg.api.max_reconnect_attempts,
            ),
        )
    )
    pcm = np.asarray(g.compile()(jnp.asarray(data))) if g else data
    chunk = args.chunk or 16000 // 5  # 200 ms
    results = []

    def print_new():
        while (out := session.poll()) is not None:
            results.append(out)
            print(json.dumps(out))

    with session:
        for i in range(0, len(pcm), chunk):
            session.send_audio(pcm[i : i + chunk], wait_reconnect_s=args.receive_timeout)
            print_new()  # results stream in on the rx thread; surface them live
        if not any(r["is_final"] for r in results):
            for out in session.drain(timeout=args.receive_timeout):
                results.append(out)
                print(json.dumps(out))
    print(json.dumps({"chunks_sent": session.chunks_sent, "results": len(results)}))
    return 0


def cmd_vad(args) -> int:
    from .io import read_audio
    from .models import vad_graph

    data, rate = read_audio(args.input)
    if data.ndim == 2:
        data = data.mean(axis=1)
    # --level (named preset) wins over --threshold-db; with neither given,
    # the config's audio.vad_level preset applies (set_vad_level parity)
    level = args.level
    if level is None and args.threshold_db is None:
        cfg = ConfigManager(args.config).load() if args.config else ConfigManager().current()
        level = cfg.audio.vad_level
    g = vad_graph(
        rate,
        threshold_db=args.threshold_db if args.threshold_db is not None else -50.0,
        level=level or "",
    )
    import jax.numpy as jnp

    states = np.asarray(g.compile()(jnp.asarray(data, jnp.float32)))
    frame_s = g.nodes[0].frame_len / rate
    segments = []
    start = None
    for i, s in enumerate(states):
        if s == 1 and start is None:
            start = i
        elif s != 1 and start is not None:
            segments.append({"start_s": round(start * frame_s, 3), "end_s": round(i * frame_s, 3)})
            start = None
    if start is not None:
        segments.append(
            {"start_s": round(start * frame_s, 3), "end_s": round(len(states) * frame_s, 3)}
        )
    print(json.dumps({"frames": len(states), "speech_segments": segments}))
    return 0


def cmd_pitch(args) -> int:
    """f0 track of an audio file: frame times, f0 (Hz), voiced flag.

    ``--method yin`` (default) thresholds the CMND aperiodicity;
    ``--method pyin`` runs the probabilistic tracker with HMM smoothing
    (ops/pitch.py::pyin) — slower, but robust to octave jumps, and the
    voicing decision is decoded, not thresholded. ``--method pyin-online``
    runs the fixed-lag streaming tracker (ops/pitch.py::pyin_online, the
    :class:`OnlinePyin` node's algorithm) — what a live session would
    emit, ``--lag`` frames of decode delay. Timeline note: the online
    tracker frames WITHOUT centering (frame i spans
    ``[i*hop, i*hop + frame_length)``) while yin/pyin center frames on
    sample ``i*hop``; the reported ``t`` adds ``frame_length/(2*rate)``
    for the online method so all three methods share one timeline, and
    the last ``lag`` frames of the file are not emitted (they would need
    audio past EOF to decode)."""
    import jax.numpy as jnp

    from . import ops
    from .io import read_audio

    data, rate = read_audio(args.input)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if args.method in ("pyin", "pyin-online"):
        if args.method == "pyin-online":
            lag = args.lag
            f0, vflag, vprob = ops.pyin_online(
                jnp.asarray(data, jnp.float32), rate, args.fmin, args.fmax,
                args.frame_length, args.hop, lag,
            )
            # emission j decodes frame j - lag: report on the frame timeline
            f0, vflag, vprob = f0[lag:], vflag[lag:], vprob[lag:]
        else:
            f0, vflag, vprob = ops.pyin(
                jnp.asarray(data, jnp.float32), rate, args.fmin, args.fmax,
                args.frame_length, args.hop,
            )
        f0 = np.asarray(f0)
        voiced = np.asarray(vflag)
        ap = 1.0 - np.asarray(vprob)  # report as aperiodicity-like score
    else:
        f0, ap = ops.yin_voicing(
            jnp.asarray(data, jnp.float32), rate, args.fmin, args.fmax,
            args.frame_length, args.hop,
        )
        f0, ap = np.asarray(f0), np.asarray(ap)
        voiced = ap < args.voiced_threshold
    hop_s = args.hop / rate
    # online frames span [i*hop, i*hop+frame_length) (no centering) vs the
    # centered yin/pyin frames at i*hop: shift t by half a frame to put all
    # methods on one timeline
    t0 = args.frame_length / (2.0 * rate) if args.method == "pyin-online" else 0.0
    track = [
        {
            "t": round(t0 + i * hop_s, 4),
            "f0_hz": round(float(f), 2) if v else None,
            "aperiodicity": round(float(a), 3),
        }
        for i, (f, a, v) in enumerate(zip(f0, ap, voiced))
    ]
    med = float(np.median(f0[voiced])) if voiced.size and voiced.any() else None
    print(json.dumps({
        "frames": len(track),
        # guard the empty track (pyin-online drops the last `lag` frames,
        # so a file shorter than lag frames emits nothing): mean of an
        # empty array is nan, which json.dumps would print as invalid JSON
        "voiced_fraction": round(float(voiced.mean()), 3) if voiced.size else 0.0,
        "median_f0_hz": round(med, 2) if med else None,
        "track": track,
    }))
    return 0


def cmd_align(args) -> int:
    """DTW-align two audio files over MFCC (or log-mel) features.

    Prints the alignment cost and a time-to-time warp map (downsampled to
    ~100 anchors) — the feature-domain application of ops/sequence.py::dtw."""
    import jax.numpy as jnp

    from . import ops
    from .io import read_audio

    def feats(path):
        data, rate = read_audio(path)
        if data.ndim == 2:
            data = data.mean(axis=1)
        x = jnp.asarray(data, jnp.float32)
        fb = ops.mel_filterbank(args.n_fft // 2 + 1, 64, rate)
        lm = ops.log_mel(ops.power(ops.spectrogram(x, args.n_fft, args.hop)), fb)
        if args.feature == "mfcc":
            return ops.mfcc(lm, 13), rate
        return lm, rate

    fa, rate_a = feats(args.a)
    fb_, rate_b = feats(args.b)
    acc, path = ops.dtw(fa, fb_, metric=args.metric)
    cost = float(np.asarray(acc)[-1, -1])
    hop_a, hop_b = args.hop / rate_a, args.hop / rate_b
    stride = max(1, len(path) // 100)
    anchors = [
        {"t_a": round(float(i) * hop_a, 3), "t_b": round(float(j) * hop_b, 3)}
        for i, j in path[::stride]
    ]
    print(json.dumps({
        "frames_a": int(fa.shape[0]),
        "frames_b": int(fb_.shape[0]),
        "cost": round(cost, 3),
        "cost_per_step": round(cost / len(path), 5),
        "path_len": int(len(path)),
        "anchors": anchors,
    }))
    return 0


def cmd_separate(args) -> int:
    """Blind NMF source separation: writes one wav per component.

    STFT -> NMF magnitude factorization -> Wiener soft masks -> ISTFT
    (ops/decompose.py::nmf_separate); components sum back to the input."""
    import jax.numpy as jnp

    from . import ops
    from .io import read_audio, write_wav

    data, rate = read_audio(args.input)
    if data.ndim == 2:
        data = data.mean(axis=1)
    comps, h, w = ops.nmf_separate(
        jnp.asarray(data, jnp.float32), args.components, args.n_fft,
        args.hop, n_iter=args.iterations,
    )
    comps = np.asarray(comps)
    base, _ = os.path.splitext(args.output or args.input)
    outs = []
    for k in range(comps.shape[0]):
        path = f"{base}.comp{k}.wav"
        write_wav(path, comps[k].astype(np.float32), rate)
        outs.append(path)
    peak_bins = [int(np.argmax(np.asarray(w)[k])) for k in range(comps.shape[0])]
    print(json.dumps({
        "components": outs,
        "template_peak_hz": [round(b * rate / args.n_fft, 1) for b in peak_bins],
        "residual_rel": round(float(
            np.linalg.norm(comps.sum(0) - data[: comps.shape[1]])
            / max(np.linalg.norm(data), 1e-9)), 6),
    }))
    return 0


def cmd_segments(args) -> int:
    """Structural section boundaries of an audio file.

    MFCC self-similarity -> Foote novelty (SAT checkerboard) -> peak-picked
    boundaries (ops/segment.py); prints boundary times + novelty stats."""
    import jax.numpy as jnp

    from . import ops
    from .io import read_audio

    data, rate = read_audio(args.input)
    if data.ndim == 2:
        data = data.mean(axis=1)
    x = jnp.asarray(data, jnp.float32)
    fb = ops.mel_filterbank(args.n_fft // 2 + 1, 64, rate)
    lm = ops.log_mel(ops.power(ops.spectrogram(x, args.n_fft, args.hop)), fb)
    feats = ops.mfcc(lm, 13)
    mask, nov = ops.segment_boundaries(
        feats, kernel_width=args.kernel, delta=args.delta
    )
    mask, nov = np.asarray(mask), np.asarray(nov)
    hop_s = args.hop / rate
    bounds = [round(float(i) * hop_s, 3) for i in np.where(mask)[0]]
    print(json.dumps({
        "frames": int(mask.shape[0]),
        "duration_s": round(data.shape[-1] / rate, 3),
        "boundaries_s": bounds,
        "novelty_peak": round(float(nov.max()), 5),
    }))
    return 0


def cmd_loudness(args) -> int:
    """BS.1770-4 / EBU R128 loudness meter (and optional normalizer).

    Per file: integrated LUFS (gated), loudness range (LU), true peak
    (dBTP), max momentary/short-term. With --normalize-to, writes a
    gain-normalized copy next to each input (or into --out-dir)."""
    import jax.numpy as jnp

    from . import ops
    from .io import read_audio, write_wav

    paths: list[str] = []
    for pattern in args.inputs:
        hits = sorted(_glob.glob(pattern))
        paths.extend(hits if hits else [pattern])
    results = []
    for p in paths:
        data, rate = read_audio(p)
        if data.ndim == 2:
            data = data.mean(axis=1)
        x = jnp.asarray(data, jnp.float32)
        row = {
            "file": p,
            "sample_rate": rate,
            "seconds": round(data.shape[-1] / rate, 3),
            "integrated_lufs": round(float(ops.integrated_loudness(x, rate)), 2),
            "lra_lu": round(float(ops.loudness_range(x, rate)), 2)
            if data.shape[-1] >= 3 * rate
            else None,
            "true_peak_dbtp": round(float(ops.true_peak(x, rate)), 2),
            "max_momentary_lufs": round(float(ops.momentary_loudness(x, rate).max()), 2),
        }
        if data.shape[-1] >= 3 * rate:
            row["max_shortterm_lufs"] = round(float(ops.shortterm_loudness(x, rate).max()), 2)
        if args.normalize_to is not None:
            y = np.asarray(
                ops.normalize_loudness(x, rate, args.normalize_to, args.true_peak_max)
            )
            base = os.path.basename(p)
            stem, _ = os.path.splitext(base)
            out_dir = args.out_dir or os.path.dirname(p) or "."
            out = os.path.join(out_dir, f"{stem}.normalized.wav")
            write_wav(out, y, rate)
            row["normalized"] = out
            row["normalized_lufs"] = round(float(ops.integrated_loudness(jnp.asarray(y), rate)), 2)
        results.append(row)
        print(json.dumps(row))
    return 0 if results else 1


def cmd_bench(args) -> int:
    from .bench import run_benchmark
    from .obs import profile_trace

    names = (
        ["roofline", "stft", "logmel", "master", "pvoc", "streaming", "session"]
        if args.benchmark == "all"
        else [args.benchmark]
    )
    results = []
    with profile_trace(args.profile_dir):  # device trace -> TensorBoard/XProf
        for name in names:
            r = run_benchmark(name, batch=args.batch, seconds=args.seconds, sharded=args.sharded)
            results.append(r)
            print(json.dumps(r))
    if args.profile_dir:
        _log.info("profiler trace written to %s", args.profile_dir)
    if args.report:
        lines = [
            "# Benchmarks",
            "",
            "| config | batch | clip s | ms/iter | x realtime/chip |",
            "|---|---|---|---|---|",
        ]
        for r in results:
            if "wall_seconds" not in r:  # calibration rows (roofline)
                continue
            lines.append(
                f"| {r['benchmark']} | {r['batch']} | {r['clip_seconds']} | "
                f"{r['wall_seconds'] / max(r['batches'], 1) * 1000:.2f} | "
                f"{r['realtime_factor_per_chip']:.0f} |"
            )
        with open(args.report, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


def cmd_inspect(args) -> int:
    cfg = ConfigManager(args.config).load() if args.config else ConfigManager().current()
    g = _build_graph(args.graph, args.input_rate, cfg)
    shape = (args.batch, int(args.input_rate * args.seconds))
    report = g.inspect(shape)
    report.update({"graph": args.graph, "input_shape": list(shape)})
    print(json.dumps(report))
    return 0


def cmd_validate(args) -> int:
    from .validate import run_validation

    report = run_validation()
    print(json.dumps(report, indent=2))
    # report["pass"] also requires vad_state_mismatches == 0 and
    # quantize_i16 == 0 — gate on the full verdict, not just max_abs_err
    return 0 if report["pass"] else 1


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="audioflow", description=__doc__)
    p.add_argument("--log-level", default="info")
    p.add_argument(
        "--precision",
        choices=["highest", "high", "default"],
        help="precision tier of fidelity-critical matmuls (highest = full f32, "
        "the default; high = three bf16 passes; default = one reduced-precision "
        "pass, ~1e-3 error; see ops/_mm.py)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("devices", help="list compute devices")
    d.add_argument("--json", action="store_true")
    d.set_defaults(fn=cmd_devices)

    i = sub.add_parser("info", help="framework/platform info")
    i.set_defaults(fn=cmd_info)

    c = sub.add_parser("config", help="show/set/persist config")
    c.add_argument("action", choices=["show", "set", "path"])
    c.add_argument("key", nargs="?")
    c.add_argument("value", nargs="?")
    c.add_argument("--file")
    c.set_defaults(fn=cmd_config)

    r = sub.add_parser("run", help="run a graph over WAV files")
    r.add_argument("--input", "-i", nargs="+", required=True)
    r.add_argument("--output", "-o")
    r.add_argument("--graph", "-g", default="logmel", choices=_GRAPHS)
    r.add_argument("--spec", help="JSON GraphSpec file (overrides --graph)")
    r.add_argument("--input-rate", type=int)
    r.add_argument("--batch-size", type=int, default=0, help="pipeline files in batches of this size")
    r.add_argument("--sharded", action="store_true", help="shard batch over all devices")
    r.add_argument("--multirate", action="store_true",
                   help="cqtroundtrip only: the broadband-invertible "
                   "per-octave-hop CQT variant (ops.cqt_multirate)")
    r.add_argument("--config")
    r.add_argument("--stats")
    r.set_defaults(fn=cmd_run)

    s = sub.add_parser("stream", help="streaming session over one WAV")
    s.add_argument("--input", "-i", required=True)
    s.add_argument("--output", "-o")
    s.add_argument("--graph", "-g", default="logmel", choices=_GRAPHS)
    s.add_argument("--chunk", type=int)
    s.add_argument("--push-size", type=int)
    s.add_argument("--config")
    s.set_defaults(fn=cmd_stream)

    k = sub.add_parser("key", help="API-key storage (env or secrets file)")
    k.add_argument("action", choices=["set", "get", "delete"])
    k.add_argument("account", nargs="?", default="elevenlabs")
    k.add_argument("value", nargs="?")
    k.add_argument("--file", help="use a secrets file instead of env vars")
    k.set_defaults(fn=cmd_key)

    e = sub.add_parser("egress", help="stream a WAV to a WebSocket ASR endpoint")
    e.add_argument("--input", "-i", required=True)
    e.add_argument("--url", required=True)
    e.add_argument("--api-key")
    e.add_argument("--chunk", type=int, default=0, help="samples per wire chunk")
    e.add_argument("--vad-gate", action="store_true", help="mute non-speech before sending")
    e.add_argument("--receive-timeout", type=float, default=5.0)
    e.add_argument("--config")
    e.set_defaults(fn=cmd_egress)

    v = sub.add_parser("vad", help="voice-activity segments of a WAV")
    v.add_argument("--input", "-i", required=True)
    v.add_argument("--threshold-db", type=float, default=None)
    v.add_argument(
        "--level",
        choices=["aggressive", "balanced", "relaxed"],
        default=None,
        help="named sensitivity preset (overrides --threshold-db; "
        "default: config audio.vad_level)",
    )
    v.add_argument("--config")
    v.set_defaults(fn=cmd_vad)

    pt = sub.add_parser("pitch", help="YIN/pYIN f0 track of an audio file")
    pt.add_argument("-i", "--input", required=True)
    pt.add_argument(
        "--method", choices=("yin", "pyin", "pyin-online"), default="yin",
        help="yin: CMND + aperiodicity threshold; pyin: probabilistic "
        "candidates + HMM Viterbi voicing/pitch decode",
    )
    pt.add_argument("--fmin", type=float, default=65.0)
    pt.add_argument("--fmax", type=float, default=2093.0)
    pt.add_argument("--frame-length", type=int, default=2048)
    pt.add_argument("--hop", type=int, default=256)
    pt.add_argument("--voiced-threshold", type=float, default=0.3,
                    help="aperiodicity (CMND depth) below this counts as voiced")
    pt.add_argument("--lag", type=int, default=25,
                    help="pyin-online only: fixed-lag decode delay in frames "
                    "— the latency/accuracy knob of the streaming tracker")
    pt.set_defaults(fn=cmd_pitch)

    al = sub.add_parser("align", help="DTW-align two audio files (MFCC/log-mel)")
    al.add_argument("-a", required=True, help="first audio file")
    al.add_argument("-b", required=True, help="second audio file")
    al.add_argument("--feature", choices=("mfcc", "logmel"), default="mfcc")
    al.add_argument("--metric", choices=("euclidean", "cosine"), default="cosine")
    al.add_argument("--n-fft", type=int, default=1024)
    al.add_argument("--hop", type=int, default=256)
    al.set_defaults(fn=cmd_align)

    sg = sub.add_parser("segments", help="structural section boundaries (Foote novelty)")
    sg.add_argument("-i", "--input", required=True)
    sg.add_argument("--n-fft", type=int, default=2048)
    sg.add_argument("--hop", type=int, default=512)
    sg.add_argument("--kernel", type=int, default=32, help="checkerboard width (frames)")
    sg.add_argument("--delta", type=float, default=0.05, help="novelty peak threshold")
    sg.set_defaults(fn=cmd_segments)

    sp = sub.add_parser("separate", help="blind NMF source separation -> per-component wavs")
    sp.add_argument("-i", "--input", required=True)
    sp.add_argument("-o", "--output", default=None, help="output basename (default: input)")
    sp.add_argument("-k", "--components", type=int, default=2)
    sp.add_argument("--n-fft", type=int, default=1024)
    sp.add_argument("--hop", type=int, default=256)
    sp.add_argument("--iterations", type=int, default=200)
    sp.set_defaults(fn=cmd_separate)

    lo = sub.add_parser("loudness", help="BS.1770/R128 loudness meter (+ optional normalize)")
    lo.add_argument("inputs", nargs="+", help="audio files or globs")
    lo.add_argument("--normalize-to", type=float, default=None, metavar="LUFS",
                    help="write a gain-normalized copy at this integrated loudness")
    lo.add_argument("--true-peak-max", type=float, default=-1.0, metavar="DBTP",
                    help="ceiling for --normalize-to (default -1 dBTP; R128)")
    lo.add_argument("--out-dir", default=None, help="directory for normalized copies")
    lo.set_defaults(fn=cmd_loudness)

    b = sub.add_parser("bench", help="throughput benchmarks ('all' runs the 5 configs)")
    b.add_argument("benchmark", nargs="?", default="logmel")
    b.add_argument("--batch", type=int, default=0)
    b.add_argument("--seconds", type=float, default=10.0)
    b.add_argument("--sharded", action="store_true")
    b.add_argument("--report", help="write a markdown table to this path")
    b.add_argument(
        "--profile-dir",
        default="",
        help="capture a jax.profiler device trace here (TensorBoard/XProf)",
    )
    b.set_defaults(fn=cmd_bench)

    val = sub.add_parser("validate", help="numerics validation report")
    val.set_defaults(fn=cmd_validate)

    ins = sub.add_parser("inspect", help="compiled-graph cost analysis (flops/bytes/fusions)")
    ins.add_argument("--graph", "-g", default="logmel", choices=_GRAPHS)
    ins.add_argument("--input-rate", type=int, default=44100)
    ins.add_argument("--seconds", type=float, default=10.0)
    ins.add_argument("--batch", type=int, default=1)
    ins.add_argument("--config")
    ins.set_defaults(fn=cmd_inspect)

    args = p.parse_args(argv)
    setup_logging(args.log_level)
    setup_compile_cache()
    if args.precision:
        from .ops import set_default_matmul_precision

        set_default_matmul_precision(args.precision)
    try:
        return args.fn(args)
    except AudioFlowError as e:
        _log.error("%s (%s, %s)", e.message, e.code.value, e.strategy.value)
        return 2


if __name__ == "__main__":
    sys.exit(main())
