"""Camera ray generation (pinhole + thin lens), fully batched.

Reproduces the reference math exactly (Code/camera.cpp:98-236):
  - NDC flips BOTH axes: n = 1 - 2*(pixel/res)  (camera.cpp:104-105,187-188)
  - basis: z = ||gaze||, x = ||up x z||, y = ||z x x||  (:110-116)
  - dir_cam = (nx*sensor_w/2, ny*sensor_h/2, focal_length), normalized in
    world space (:119-133)
  - thin lens: aperture<=0 degrades to pinhole (:138-140); else the origin
    jitters on a disk of radius aperture/2 in the camera x/y plane and the
    direction re-aims at origin + dir*focus_dist (:144-178)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ray_tracying.core.sampling import uniform_in_unit_disk
from ray_tracying.core.vecmath import cross, normalize
from ray_tracying.scene.types import Camera


def camera_basis(cam: Camera):
    """Right-handed-ish basis exactly as the reference builds it."""
    z = normalize(cam.gaze)
    x = normalize(cross(cam.up, z))
    y = normalize(cross(z, x))
    return x, y, z


def pixel_rays(cam: Camera, px: jnp.ndarray, py: jnp.ndarray, key: jax.Array):
    """Generate world-space rays for pixel sample positions.

    px, py: (...,) float pixel coordinates (fractional: x + sub_x).
    Returns (origins, directions), each (..., 3).  The lens-disk sample is
    drawn unconditionally; with aperture <= 0 the pinhole result is
    selected, matching the reference's explicit branch (camera.cpp:138-140).
    """
    res_x, res_y = cam.resolution
    nx = 1.0 - (px / jnp.float32(res_x)) * 2.0
    ny = 1.0 - (py / jnp.float32(res_y)) * 2.0
    nx_r = nx * (cam.sensor_wh[0] / 2.0)
    ny_r = ny * (cam.sensor_wh[1] / 2.0)

    x_dir, y_dir, z_dir = camera_basis(cam)
    d_world = (
        nx_r[..., None] * x_dir + ny_r[..., None] * y_dir
        + cam.focal_length * z_dir
    )
    d_world = normalize(d_world)

    pinhole_o = jnp.broadcast_to(cam.location, d_world.shape)

    # Thin lens: jitter origin on the aperture disk, re-aim at focus point.
    focus_point = cam.location + d_world * cam.focus_dist
    rd = uniform_in_unit_disk(key, px.shape)  # (..., 2)
    lens_radius = cam.aperture / 2.0
    offset = (rd[..., 0:1] * x_dir + rd[..., 1:2] * y_dir) * lens_radius
    lens_o = cam.location + offset
    lens_d = normalize(focus_point - lens_o)

    use_lens = cam.aperture > 0.0
    origins = jnp.where(use_lens, lens_o, pinhole_o)
    directions = jnp.where(use_lens, lens_d, d_world)
    return origins, directions
