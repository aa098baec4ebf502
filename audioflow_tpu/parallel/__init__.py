"""Multi-chip scaling: mesh construction, batch sharding over the device mesh, multi-host
init, and per-lane fault masking.

Design (SURVEY §2.6): the reference has *no* distributed compute — parallelism
is introduced here, not ported. The workload is embarrassingly parallel over
files, so the primary strategy is **data-parallel batch sharding**: a
1-D ``Mesh(("data",))`` with inputs sharded on the leading (file) axis via
``NamedSharding``. The hot path then has zero cross-chip dependencies;
XLA inserts collectives only where an op genuinely mixes lanes (e.g. the
gradient psum of :mod:`audioflow_tpu.models.trainable`). Tensor parallelism
exists where the workload has a model dimension to split: the trainable
MLP head runs Megatron-sharded on a 2-D ("data", "model") mesh
(``make_train_step(..., model_axis=)``; one GSPMD all-reduce, sharded adam
state). Sequence parallelism exists for the one-long-signal case:
:mod:`.sp` shards the TIME axis over chips with a single ppermute halo
exchange for the frame overlap (the SPMD analog of the streaming carry).
PP/EP have no counterpart in a per-file DSP workload and are deliberately
out of scope.

Multi-host (DCN) scaling uses ``jax.distributed`` initialization; batch lanes
then span the global device set with the same NamedSharding.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..errors import AudioError, ErrorCode
from .sp import (
    sequence_sharded_fir,
    sequence_sharded_frontend,
    sequence_sharded_graph,
    sequence_sharded_iir,
    sequence_sharded_limiter,
    sequence_sharded_master,
    sequence_sharded_resample,
    sequence_sharded_spectrogram,
)


def make_mesh(
    n_devices: int | None = None,
    axes: tuple[str, ...] = ("data",),
    shape: tuple[int, ...] | None = None,
    devices=None,
) -> Mesh:
    """Build a device mesh.

    1-D ``("data",)`` by default (pure DP). Pass ``axes=("data", "model")``
    and ``shape`` for a 2-D mesh when an op-sharded dimension is wanted.
    """
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        if n_devices > len(devs):
            raise AudioError(
                f"requested {n_devices} devices, have {len(devs)}",
                code=ErrorCode.DEVICE_UNAVAILABLE,
            )
        devs = devs[:n_devices]
    if shape is None:
        shape = (len(devs),) + (1,) * (len(axes) - 1)
    if int(np.prod(shape)) != len(devs):
        raise AudioError(
            f"mesh shape {shape} != device count {len(devs)}",
            code=ErrorCode.DEVICE_UNAVAILABLE,
        )
    return Mesh(np.asarray(devs).reshape(shape), axes)


def batch_sharding(mesh: Mesh, ndim: int = 2, axis: str = "data") -> NamedSharding:
    """Shard the leading (file/batch) axis; replicate everything else."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def shard_batch(x, mesh: Mesh, axis: str = "data"):
    """Place ``x [batch, ...]`` sharded over the mesh's data axis.

    The batch dimension must divide by the axis size (pad upstream with
    :func:`pad_batch`).
    """
    size = mesh.shape[axis]
    if x.shape[0] % size:
        raise AudioError(
            f"batch {x.shape[0]} not divisible by data-axis size {size}; pad first",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    return jax.device_put(x, batch_sharding(mesh, np.ndim(x), axis))


def pad_batch(x: np.ndarray, mesh: Mesh, axis: str = "data") -> tuple[np.ndarray, np.ndarray]:
    """Zero-pad the batch to a multiple of the data-axis size.

    Returns (padded, valid_mask[batch_padded] bool).
    """
    size = mesh.shape[axis]
    b = x.shape[0]
    target = -(-b // size) * size
    mask = np.zeros(target, dtype=bool)
    mask[:b] = True
    if target != b:
        pad = [(0, target - b)] + [(0, 0)] * (x.ndim - 1)
        x = np.pad(x, pad)
    return x, mask


def compile_sharded(
    graph,
    mesh: Mesh,
    axis: str = "data",
    donate: bool = False,
    shard: str = "batch",
):
    """Jit a Graph's chain sharded over a device mesh.

    ``shard="batch"`` (default): input batch axis sharded — the
    embarrassingly-parallel per-file mode. Output shardings are left to XLA
    (it propagates the batch sharding through the chain, so no collectives
    appear on the hot path — asserted on HLO in tests).

    ``shard="time"``: ONE long signal's time axis sharded — the node chain
    is mapped onto the :mod:`.sp` machinery (finite-halo ppermutes, affine/
    max-plus carry composition; see
    :func:`~audioflow_tpu.parallel.sequence_sharded_graph` for node
    coverage and exactness). Takes ``x [batch, T]`` with
    ``T % (n_devices * granularity)`` per the stage requirements; a node
    without a time-sharded mapping raises a typed error naming itself.
    """
    if shard == "time":
        return jax.jit(
            sequence_sharded_graph(graph, mesh, axis=axis),
            donate_argnums=(0,) if donate else (),
        )
    if shard != "batch":
        raise AudioError(
            f"unknown shard mode {shard!r}; known: batch, time",
            code=ErrorCode.CONFIG_VALIDATION_ERROR,
        )
    return jax.jit(
        graph.chain,
        in_shardings=(NamedSharding(mesh, P(axis, None)),),
        donate_argnums=(0,) if donate else (),
    )


def mask_lanes(out, valid_mask) -> tuple:
    """Per-lane fault isolation (SURVEY §5.3): zero out failed/padded lanes.

    ``valid_mask [batch]`` — False lanes (bad decode, padding) are zeroed so a
    bad file never aborts the batch; callers filter by the mask on the host.
    """
    import jax.numpy as jnp

    m = jnp.asarray(valid_mask)
    shape = (-1,) + (1,) * (out.ndim - 1)
    return out * m.reshape(shape).astype(out.dtype), m


def multihost_init(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize multi-host (DCN) JAX; returns True when this call did the
    initialization (SURVEY §5.8; run recipe in README §multi-host).

    Only the benign already-initialized case is swallowed (returns False).
    Real misconfiguration — wrong coordinator address, inconsistent
    num_processes/process_id, unreachable peers — is logged and re-raised:
    silently continuing single-host after a failed cluster init would shard
    a fraction of the batch and quietly report wrong throughput.
    """
    from ..obs import get_logger

    log = get_logger("parallel")
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as err:
        if "already initialized" in str(err).lower():
            log.debug("jax.distributed already initialized; multihost_init is a no-op")
            return False
        log.error(
            "multi-host init failed (coordinator=%s, num_processes=%s, "
            "process_id=%s): %s", coordinator, num_processes, process_id, err,
        )
        raise
    except ValueError as err:
        log.error(
            "multi-host init misconfigured (coordinator=%s, num_processes=%s, "
            "process_id=%s): %s", coordinator, num_processes, process_id, err,
        )
        raise
    log.info(
        "multi-host initialized: process %d/%d, %d global devices",
        jax.process_index(), jax.process_count(), jax.device_count(),
    )
    return True
