"""Batch runner: the production driving loop over many files.

Pipelines host decode (BatchLoader's background thread), host->HBM transfer,
and graph execution so the device never waits on ingest (SURVEY §7.3 #5's
double-buffering obligation): while batch k computes on device, batch k+1 is
being decoded on host CPU threads, and JAX's async dispatch overlaps the
device_put of k+1 with the compute of k.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

import jax
import jax.numpy as jnp

from .errors import AudioError, ErrorCode
from .graph import Graph
from .io import BatchLoader
from .obs import RunMetrics, Timer, get_logger
from .sinks import EventDispatcher, Sink

_log = get_logger("runner")


def run_batches(
    graph: Graph,
    loader: BatchLoader,
    sinks: Sequence[Sink] = (),
    mesh=None,
    events: EventDispatcher | None = None,
    expect_rate: int | None = None,
) -> RunMetrics:
    """Run ``graph`` over every batch the loader yields.

    Uses a fixed ``stride`` from the loader so one compiled program serves
    all batches (set ``loader.stride``; otherwise the first batch's stride is
    reused and longer later files are truncated with a warning). Failed decode
    lanes are masked, never fatal. Outputs are written to ``sinks`` batch by
    batch (valid lanes only).
    """
    events = events or EventDispatcher(enabled=False)
    expect_rate = expect_rate or graph.input_rate
    from .parallel import mask_lanes

    # failed/padded lanes are zeroed ON DEVICE (parallel.mask_lanes) inside
    # the same program, so garbage from a bad decode can never reach a sink
    # even before the host-side valid filter; the mask shards with the batch
    def _masked(x, valid):
        return mask_lanes(graph.chain(x), valid)[0]

    if mesh is not None:
        from .parallel import batch_sharding

        fn = jax.jit(
            _masked, in_shardings=(batch_sharding(mesh, 2), batch_sharding(mesh, 1))
        )
        n_dev = int(mesh.devices.size)
    else:
        fn = jax.jit(_masked)
        n_dev = 1

    m = RunMetrics(n_devices=n_dev)
    pending = None  # (device_out, batch) — one batch of latency for overlap
    stride = loader.stride
    first = True

    def _flush(pair):
        dev_out, batch = pair
        host = np.asarray(dev_out)
        ok = batch.valid
        for sink in sinks:
            sink.write(host[ok])
        events.emit_result(host[ok], final=False, index=m.batches)

    with Timer() as t_total:
        for batch in loader:
            if stride is None:
                stride = batch.samples.shape[1]
            x = batch.samples
            if x.shape[1] != stride:
                if x.shape[1] > stride:
                    _log.warning("batch longer than stride; truncating %d -> %d", x.shape[1], stride)
                    x = x[:, :stride]
                else:
                    x = np.pad(x, ((0, 0), (0, stride - x.shape[1])))
            if x.shape[0] < loader.batch_size:  # tail batch: keep one program
                pad_rows = loader.batch_size - x.shape[0]
                x = np.pad(x, ((0, pad_rows), (0, 0)))
            bad_rate = batch.valid & (batch.rates != (expect_rate or 0))
            if expect_rate and bad_rate.any():
                _log.warning(
                    "masking %d lanes with sample rate != %d", int(bad_rate.sum()), expect_rate
                )
                batch.valid &= ~bad_rate
            vmask = np.zeros(x.shape[0], dtype=bool)
            vmask[: len(batch.paths)] = batch.valid
            if mesh is not None:
                from .parallel import pad_batch, shard_batch

                x, pad_mask = pad_batch(x, mesh)
                if len(vmask) != len(pad_mask):
                    vmask = np.concatenate(
                        [vmask, np.zeros(len(pad_mask) - len(vmask), dtype=bool)]
                    )
                xd = shard_batch(x, mesh)
                vd = shard_batch(vmask, mesh)
            else:
                xd = jnp.asarray(x)
                vd = jnp.asarray(vmask)
            if first:
                # compile separately from execution so subtracting
                # compile_seconds from the wall never hides real compute
                with Timer() as tc:
                    fn = fn.lower(xd, vd).compile()
                m.compile_seconds = tc.elapsed
                first = False
            out = fn(xd, vd)  # async dispatch; overlaps with the next decode
            if pending is not None:
                _flush(pending)
            pending = (out[: len(batch.paths)], batch)
            m.batches += 1
            m.files += len(batch.paths)
            m.failed_files += int((~batch.valid).sum())
            # count only the audio actually processed (lanes may be truncated
            # to the stride), so realtime_factor is never overstated
            ok = batch.valid & (batch.rates > 0)
            eff = np.minimum(batch.lengths, stride)
            m.audio_seconds += float((eff[ok] / batch.rates[ok]).sum()) if ok.any() else 0.0
        if pending is not None:
            _flush(pending)
    # throughput excludes the one-time compile (reported separately)
    m.wall_seconds = max(t_total.elapsed - m.compile_seconds, 1e-9)
    if m.files == 0:
        raise AudioError("loader yielded no batches", code=ErrorCode.FILE_NOT_FOUND)
    _log.info(
        "run complete: %d files (%d failed), %.1f audio-s, %.0fx realtime",
        m.files, m.failed_files, m.audio_seconds, m.realtime_factor,
    )
    return m
