"""Device-mesh construction and multi-host bring-up.

The reference is a single-process NumPy program with no communication layer
(SURVEY.md §5.8).  The scale-out uses a 2-D ``jax.sharding.Mesh`` with
axes:

  * ``'data'``    — independent tracking scenarios (embarrassingly parallel;
                    spans devices and hosts),
  * ``'samples'`` — the K rollout-sample axis (needs the three collectives:
                    pmin ρ, psum η, psum Σwε).

The mesh follows the algorithm, not a network shape: the four GPUs of one
host reach each other all to all.  XLA lowers the collectives to NCCL on
GPUs.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh

DATA_AXIS = "data"
SAMPLES_AXIS = "samples"


def make_mesh(
    data: Optional[int] = None,
    samples: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ('data', 'samples') mesh over the given (or all) devices.

    By default all devices go to the 'data' axis — scenario parallelism has
    zero communication.  Put devices on 'samples' when a single scenario's K
    must exceed one device's appetite (configs[4] of BASELINE.json).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None:
        if n % samples != 0:
            raise ValueError(f"{n} devices not divisible by samples={samples}")
        data = n // samples
    if data * samples != n:
        raise ValueError(f"mesh {data}x{samples} != {n} devices")
    arr = np.asarray(devices).reshape(data, samples)
    return Mesh(arr, (DATA_AXIS, SAMPLES_AXIS))


# Environment variables consulted (first hit wins per field).  The JAX_*
# names are what ``jax.distributed`` itself documents; the MPPI_* aliases let
# a launcher configure this framework without touching global JAX knobs.
_COORD_VARS = ("MPPI_COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS")
_NPROC_VARS = ("MPPI_NUM_PROCESSES", "JAX_NUM_PROCESSES")
_PID_VARS = ("MPPI_PROCESS_ID", "JAX_PROCESS_ID")


def detect_multihost_env(environ=None):
    """Read multi-host bring-up parameters from the environment.

    Returns ``(coordinator_address, num_processes, process_id)`` with None
    for any field not set.  Pure function of ``environ`` (defaults to
    ``os.environ``) so the pod branch of :func:`initialize_multihost` is
    unit-testable without a cluster (round-2 W6).  Malformed integer fields
    raise ``ValueError`` naming the variable — a silently-ignored typo in
    ``JAX_PROCESS_ID`` would otherwise strand a worker out of the fleet.
    """
    env = os.environ if environ is None else environ

    def first(names):
        for n in names:
            v = env.get(n)
            if v is not None and v != "":
                return n, v
        return None, None

    _, coord = first(_COORD_VARS)

    def as_int(names):
        name, v = first(names)
        if v is None:
            return None
        try:
            return int(v)
        except ValueError:
            raise ValueError(f"{name}={v!r} is not an integer")

    nproc = as_int(_NPROC_VARS)
    pid = as_int(_PID_VARS)
    if coord is not None and (nproc is None) != (pid is None):
        raise ValueError(
            "incomplete multihost environment: coordinator address is set "
            f"but only one of {_NPROC_VARS[-1]}/{_PID_VARS[-1]} — set both "
            "(or neither, for cluster auto-detection)")
    return coord, nproc, pid


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         initialization_timeout: Optional[int] = None) -> None:
    """Multi-host runtime bring-up (SURVEY.md §5.8).

    Thin wrapper over ``jax.distributed.initialize``; on single-host runs
    (or when already initialised) it is a no-op.  Explicit arguments win;
    otherwise :func:`detect_multihost_env` fills them from the environment
    (MPPI_*/JAX_* variables), and anything still unset is left to JAX's
    own cluster auto-detection.

    Failure policy (round-3 review): when a coordinator address was given —
    explicitly or through the environment — the caller asked for a
    multi-process fleet, so an initialization failure (port clash, typo'd
    address, timeout) RAISES instead of silently degrading the process to
    single-host mode (which would hang later inside the first cross-host
    collective).  Only the fully-implicit single-process case, where JAX's
    cluster auto-detection finds nothing, is a no-op.
    """
    env_coord, env_nproc, env_pid = detect_multihost_env()
    if coordinator_address is None:
        coordinator_address = env_coord
    if num_processes is None:
        num_processes = env_nproc
    if process_id is None:
        process_id = env_pid
    if jax.distributed.is_initialized():
        return
    kwargs = {}
    if initialization_timeout is not None:
        kwargs["initialization_timeout"] = initialization_timeout
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
    except (RuntimeError, ValueError):
        if coordinator_address is not None:
            raise  # a requested fleet that failed to form must fail loudly
        # Single-process environment where no coordinator can be
        # auto-detected — a no-op by design.
        pass
