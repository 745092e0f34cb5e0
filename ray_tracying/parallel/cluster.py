"""Multi-host cluster setup (SURVEY.md §5: the reference has no failure
detection or distributed runtime; this is its JAX equivalent).

One process per host, standard JAX multi-controller: every process runs
the same program, `jax.distributed.initialize` wires them through the
coordinator, and the global mesh spans all devices.  Rays shard over the
global mesh exactly as in sharding.py — no code changes between 1 device,
1 host, and N hosts.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import jax

log = logging.getLogger("ray_tracying.cluster")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    retries: int = 5,
    backoff_s: float = 2.0,
) -> None:
    """jax.distributed.initialize with retry/backoff.

    Pass coordinator_address ("host:port"), num_processes and process_id:
    JAX's auto-detection finds no cluster on a plain GPU host.  Coordinator
    restarts and transient
    DNS failures retry with exponential backoff — the reference's only
    failure mode was exit(1) (Code/material.hpp:103-107); a multi-host
    render should survive a slow-starting peer."""
    last = None
    for attempt in range(retries):
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
            log.info(
                "cluster up: process %d/%d, %d global devices",
                jax.process_index(),
                jax.process_count(),
                len(jax.devices()),
            )
            return
        except Exception as e:  # pragma: no cover - needs real cluster
            last = e
            wait = backoff_s * (2 ** attempt)
            log.warning(
                "distributed init failed (attempt %d/%d): %s; retrying in %.1fs",
                attempt + 1, retries, e, wait,
            )
            time.sleep(wait)
    raise RuntimeError(f"jax.distributed.initialize failed after {retries} attempts") from last


def local_ray_slice(n_rays_global: int) -> slice:
    """The contiguous slice of a global ray batch owned by this process
    (processes own equal contiguous chunks; pair with a Mesh whose first
    axis spans processes)."""
    per = n_rays_global // jax.process_count()
    pid = jax.process_index()
    return slice(pid * per, (pid + 1) * per)
