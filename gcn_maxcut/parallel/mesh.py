"""Device mesh setup and multi-host initialization.

The reference has no distributed story (SURVEY.md §2.9: its device handling
is one ``torch.device`` line).  Here the communication backend is the XLA
runtime itself: meshes + ``shard_map`` + collectives over ICI/DCN — no
NCCL/MPI analog needed.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from gcn_maxcut.utils.logging import get_logger

logger = get_logger(__name__)


def device_count() -> int:
    return jax.device_count()


def make_mesh(
    axis_names: Sequence[str] = ("graph",),
    shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a named mesh over all (or given) devices.

    Default: a 1-D mesh named ``graph`` — the node-sharding axis for the
    giant-graph configs.  For hybrid data×graph parallelism pass e.g.
    ``axis_names=("data", "graph"), shape=(2, 4)``.
    """
    devs = list(devices) if devices is not None else jax.devices()
    if shape is None:
        shape = (len(devs),) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    if int(np.prod(shape)) != len(devs):
        raise ValueError(f"mesh shape {shape} != {len(devs)} devices")
    arr = np.asarray(devs).reshape(shape)
    return Mesh(arr, tuple(axis_names))


def multi_host_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """``jax.distributed.initialize`` wrapper for multi-host pod slices.

    No-op when already initialized or single-process (env-driven defaults on
    multi-host clusters).  Call before any jax computation on each host.

    A genuinely misconfigured launch (bad coordinator address, wrong
    process count) must NOT silently degrade to single-process: only the
    benign "already initialized" RuntimeError is swallowed; anything else
    is logged and re-raised.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        msg = str(e).lower()
        if "already" in msg and "initialize" in msg:
            logger.info("multi_host_init: jax.distributed already initialized")
            return
        if coordinator_address is None and (
            "coordinator" in msg or "auto" in msg or "detect" in msg
        ):
            # env-driven auto-detection unavailable => single-process run
            logger.info(
                "multi_host_init: no multi-host environment detected, "
                "continuing single-process (%s)", e,
            )
            return
        logger.error("multi_host_init failed: %s", e)
        raise
