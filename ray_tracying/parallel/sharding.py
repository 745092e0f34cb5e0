"""Multi-device sharding: rays/pixels data-parallel over a device mesh.

The reference is one thread on one CPU (SURVEY.md §2 parallelism
inventory: none).  Here the scale axis is the ray/pixel batch
(SURVEY.md §5): rays shard over every mesh axis, the scene pytree +
primitive tables replicate into each device's memory, and nothing crosses
the interconnect during tracing.  Collectives appear only at the
boundaries:

  - forward: none (each shard owns its pixel rows; the host or a final
    all_gather assembles the image)
  - backward (diff/): cotangents of the replicated scene parameters are
    psum'ed over the mesh — shard_map's transpose rule inserts the
    all-reduce automatically for replicated (P()) inputs, and XLA overlaps
    it with the remaining backward bounce passes.

shard_map (not bare GSPMD annotations) because the Pallas intersection
kernels must see per-shard shapes; GSPMD cannot partition a pallas_call
on its own.  Every device reaches every other at the same rate on the
target machines, so the mesh is 1-D and follows the ray batch alone.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ray_tracying.render.integrator import trace_wavefront
from ray_tracying.scene.types import Scene


def make_mesh(n_devices: Optional[int] = None, axis: str = "rays") -> Mesh:
    """1D mesh over the first n devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.array(devices), (axis,))


def trace_wavefront_sharded(
    scene: Scene,
    origins: jnp.ndarray,     # (R, 3), R divisible by mesh size
    directions: jnp.ndarray,  # (R, 3)
    times: jnp.ndarray,       # (R,)
    key: jax.Array,
    light_samples: int,
    mesh: Mesh,
    queue_mult: int = 2,
) -> jnp.ndarray:
    """Shard rays over every mesh axis; scene replicated; per-shard RNG
    decorrelated by folding the shard index into the key."""
    axes = tuple(mesh.axis_names)

    def body(scene_rep, o, d, t):
        idx = jax.lax.axis_index(axes)
        k = jax.random.fold_in(key, idx)
        return trace_wavefront(
            scene_rep, o, d, t, k, light_samples, queue_mult
        )

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(axes), P(axes), P(axes)),
        out_specs=P(axes),
        check_vma=False,
    )(scene, origins, directions, times)
