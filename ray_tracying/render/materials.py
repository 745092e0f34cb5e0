"""Per-ray material record fetch.

One packed (M, 15) table + a single one-hot matmul (core/gather.py)
replaces eleven separate row gathers.  The record is fetched once per bounce level and shared by shading
and child-ray spawning.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ray_tracying.core.gather import onehot_gather
from ray_tracying.scene.types import Scene


class MatRec(NamedTuple):
    diffuse: jnp.ndarray       # (R, 3)
    specular: jnp.ndarray      # (R, 3)
    k_ambient: jnp.ndarray     # (R,)
    k_diffuse: jnp.ndarray     # (R,)
    k_specular: jnp.ndarray    # (R,)
    shininess: jnp.ndarray     # (R,)
    roughness: jnp.ndarray     # (R,)
    reflectivity: jnp.ndarray  # (R,)
    transparency: jnp.ndarray  # (R,)
    ior: jnp.ndarray           # (R,)
    tex_id: jnp.ndarray        # (R,) int32


def gather_materials(scene: Scene, gid: jnp.ndarray) -> MatRec:
    """gid: (R,) geom ids (clipped by caller if needed; out-of-range rows
    produce zero records, fine for masked slots)."""
    m = scene.materials
    packed = jnp.concatenate(
        [
            m.diffuse,
            m.specular,
            m.k_ambient[:, None],
            m.k_diffuse[:, None],
            m.k_specular[:, None],
            m.shininess[:, None],
            m.roughness[:, None],
            m.reflectivity[:, None],
            m.transparency[:, None],
            m.ior[:, None],
            m.tex_id[:, None].astype(jnp.float32),
        ],
        axis=1,
    )  # (M, 15): 3 diffuse + 3 specular + 9 scalar columns (tex_id is col 14)
    rec = onehot_gather(packed, gid)
    return MatRec(
        diffuse=rec[:, 0:3],
        specular=rec[:, 3:6],
        k_ambient=rec[:, 6],
        k_diffuse=rec[:, 7],
        k_specular=rec[:, 8],
        shininess=rec[:, 9],
        roughness=rec[:, 10],
        reflectivity=rec[:, 11],
        transparency=rec[:, 12],
        ior=rec[:, 13],
        tex_id=jnp.round(rec[:, 14]).astype(jnp.int32),
    )
