"""Multi-host runtime: jax.distributed + pod-wide mesh construction.

The reference has no distributed backend at all (SURVEY.md §2 #17: a
single-process thread pool). This package's multi-host story:

  * ``initialize()`` wraps ``jax.distributed.initialize`` (pass the
    coordinator address, process count and id; clusters whose scheduler
    JAX detects supply them from the environment),
  * ``pod_mesh()`` builds the ('rows', 'samples') mesh over every device
    of every process — collectives (NCCL on GPUs) are orchestrated
    entirely by XLA,
  * rendering/training then goes through parallel.mesh.render_sharded /
    optim.make_train_step_sharded unchanged: the counter-based RNG keys
    off global pixel ids, so every host computes its shard of the exact
    same image.

Single-host multi-device and the CPU test mesh use the same code path;
nothing here is multi-host-specific except initialize().
"""
from __future__ import annotations

import logging
from typing import Optional

import jax

from .mesh import make_mesh

log = logging.getLogger("terra_tpu")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize the multi-host runtime (idempotent).

    Pass the arguments explicitly for manual multi-process CPU/GPU
    launches (nothing on a plain GPU host tells JAX of a cluster).
    """
    try:
        if coordinator_address is None:
            jax.distributed.initialize()
        else:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
        log.info(
            "distributed: process %d/%d, %d local / %d global devices",
            jax.process_index(), jax.process_count(),
            jax.local_device_count(), jax.device_count(),
        )
    except (RuntimeError, ValueError) as e:  # already initialized / single process
        log.debug("distributed.initialize skipped: %s", e)


def pod_mesh(sample_ways: int = 1) -> "jax.sharding.Mesh":
    """('rows', 'samples') mesh over the whole pod: sample_ways devices on
    the sample axis, the rest on pixel rows."""
    n = jax.device_count()
    assert n % sample_ways == 0, (n, sample_ways)
    return make_mesh((n // sample_ways, sample_ways))


def is_coordinator() -> bool:
    return jax.process_index() == 0
