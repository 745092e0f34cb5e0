"""Affine TRS transforms.

Host-side (numpy) construction at scene-load time, device-side (jnp)
batched application inside the renderer.  Matrices are stored as 3x4
(rotation+scale block | translation column); the projective bottom row of
the reference's 4x4s is always (0,0,0,1) for TRS so it is dropped.

Semantics mirrored:
  - object_to_world = T @ Rz @ Ry @ Rx @ S  (Code/shapes.cpp:92-118)
  - world_to_object = S^-1 @ R^T @ T^-1 (analytic inverse, :120-138)
  - normals transform by world_to_object^T then renormalize (:167-187)
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def euler_xyz_rotation(r: np.ndarray) -> np.ndarray:
    """Rotation matrix Rz(rz) @ Ry(ry) @ Rx(rx) (the reference's Euler X-Y-Z
    composition, Code/shapes.cpp:100-110).  r: (...,3) radians -> (...,3,3)."""
    r = np.asarray(r, dtype=np.float32)
    cx, sx = np.cos(r[..., 0]), np.sin(r[..., 0])
    cy, sy = np.cos(r[..., 1]), np.sin(r[..., 1])
    cz, sz = np.cos(r[..., 2]), np.sin(r[..., 2])
    rot = np.stack(
        [
            np.stack([cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz], -1),
            np.stack([cy * sz, sx * sy * sz + cx * cz, cx * sy * sz - sx * cz], -1),
            np.stack([-sy, sx * cy, cx * cy], -1),
        ],
        axis=-2,
    )
    return rot.astype(np.float32)


def build_trs(translation, rotation, scale):
    """Build (object_to_world, world_to_object), each (...,3,4) float32.

    world_to_object uses the analytic inverse S^-1 R^T T^-1, matching the
    reference bit-for-intent rather than a generic matrix inverse.
    """
    t = np.asarray(translation, dtype=np.float32)
    s = np.asarray(scale, dtype=np.float32)
    rot = euler_xyz_rotation(np.asarray(rotation, dtype=np.float32))

    # o2w linear block: R @ diag(s)  (scale columns of R)
    lin = rot * s[..., None, :]
    o2w = np.concatenate([lin, t[..., :, None]], axis=-1)

    # w2o linear block: diag(1/s) @ R^T  (scale rows of R^T)
    lin_inv = np.swapaxes(rot, -1, -2) / s[..., :, None]
    # translation column: -(diag(1/s) @ R^T) @ t
    t_inv = -np.einsum("...ij,...j->...i", lin_inv, t)
    w2o = np.concatenate([lin_inv, t_inv[..., :, None]], axis=-1)
    return o2w.astype(np.float32), w2o.astype(np.float32)


# ---------------------------------------------------------------------------
# Device-side batched application (jnp).  m: (...,3,4), p/v/n: (...,3).
# ---------------------------------------------------------------------------

# NOTE: these 3-wide contractions are written as explicit multiply-adds, not
# einsum/dot.  On the GPU a float32 dot_general may run on the tensor cores
# in TF32 (about three decimal digits) — ruinous for intersection
# precision — and a K=3 contraction gains nothing from them anyway; the
# elementwise form stays exact f32.

def apply_point(m: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    return (
        m[..., :, 0] * p[..., 0:1]
        + m[..., :, 1] * p[..., 1:2]
        + m[..., :, 2] * p[..., 2:3]
        + m[..., :, 3]
    )


def apply_vector(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    return (
        m[..., :, 0] * v[..., 0:1]
        + m[..., :, 1] * v[..., 1:2]
        + m[..., :, 2] * v[..., 2:3]
    )


def apply_normal(w2o: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """World normal = normalize(w2o^T @ n_local) (Code/shapes.cpp:178-187)."""
    res = (
        w2o[..., 0, :3] * n[..., 0:1]
        + w2o[..., 1, :3] * n[..., 1:2]
        + w2o[..., 2, :3] * n[..., 2:3]
    )
    mag2 = jnp.sum(res * res, axis=-1, keepdims=True)
    # Double-where keeps the gradient finite at mag 0 (see vecmath.safe_sqrt).
    mag = jnp.sqrt(jnp.where(mag2 > 0.0, mag2, 1.0))
    return jnp.where(mag2 > 1e-12, res / jnp.where(mag2 > 0.0, mag, 1.0), res)
