"""Camera ray generation tests (reference math: Code/camera.cpp)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ray_tracying.render.camera import camera_basis, pixel_rays
from ray_tracying.scene.loader import load_scene_dict

from test_scene_loader import minimal_camera


def make_cam(**over):
    d = minimal_camera()
    d["cameras"][0].update(over)
    return load_scene_dict(d).camera


def test_center_pixel_points_along_gaze():
    cam = make_cam()
    # Pixel exactly at the image center -> NDC (0,0) -> pure gaze direction.
    px = jnp.asarray([4.0])  # res_x=8 -> center 4.0
    py = jnp.asarray([3.0])  # res_y=6
    o, d = pixel_rays(cam, px, py, jax.random.key(0))
    np.testing.assert_allclose(np.asarray(o[0]), [0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(d[0]), [0, 1, 0], atol=1e-6)


def test_ndc_flips_both_axes():
    """n = 1 - 2*(pixel/res) flips x and y (Code/camera.cpp:104-105): pixel
    (0,0) (top-left) maps to POSITIVE nx, ny."""
    cam = make_cam()
    o, d = pixel_rays(cam, jnp.asarray([0.5]), jnp.asarray([0.5]),
                      jax.random.key(0))
    dv = np.asarray(d[0])
    x_dir, y_dir, _ = (np.asarray(v) for v in camera_basis(cam))
    assert np.dot(dv, x_dir) > 0  # +x component in camera basis
    assert np.dot(dv, y_dir) > 0


def test_aperture_zero_is_pinhole():
    cam = make_cam(aperture=0.0)
    px = jnp.linspace(0.5, 7.5, 5)
    py = jnp.linspace(0.5, 5.5, 5)
    o1, d1 = pixel_rays(cam, px, py, jax.random.key(1))
    o2, d2 = pixel_rays(cam, px, py, jax.random.key(2))
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
    np.testing.assert_allclose(
        np.asarray(o1), np.zeros((5, 3)), atol=0
    )


def test_thin_lens_preserves_focus_point():
    """Every lens ray passes through the pinhole ray's focus point
    (Code/camera.cpp:144-178)."""
    cam = make_cam(aperture=0.5, focus_dist=5.0)
    px = jnp.full((256,), 1.5)
    py = jnp.full((256,), 2.5)
    o, d = pixel_rays(cam, px, py, jax.random.key(3))
    o0, d0 = pixel_rays(make_cam(aperture=0.0), px[:1], py[:1], jax.random.key(0))
    focus = np.asarray(o0[0]) + np.asarray(d0[0]) * 5.0
    # Each jittered ray origin + t*d should reach focus for some t: check
    # the point-line distance is ~0.
    oo = np.asarray(o)
    dd = np.asarray(d)
    to_f = focus - oo
    t = (to_f * dd).sum(-1)
    closest = oo + t[:, None] * dd
    dist = np.linalg.norm(closest - focus, axis=-1)
    assert dist.max() < 1e-5
    # Origins actually spread over the lens disk of radius aperture/2,
    # centered on the camera location (origin here).
    spread = np.linalg.norm(oo, axis=-1)
    assert spread.max() <= 0.25 + 1e-6
    assert spread.max() > 0.1


def test_sensor_aspect():
    """Corner ray offsets scale with sensor half-dims (36x24)."""
    cam = make_cam()
    o, d = pixel_rays(cam, jnp.asarray([0.0]), jnp.asarray([0.0]),
                      jax.random.key(0))
    x_dir, y_dir, z_dir = (np.asarray(v) for v in camera_basis(cam))
    dv = np.asarray(d[0])
    # Unnormalized direction components: (18, 12, 20) -> ratio x/y = 1.5
    cx = np.dot(dv, x_dir)
    cy = np.dot(dv, y_dir)
    cz = np.dot(dv, z_dir)
    assert cx / cy == pytest.approx(18.0 / 12.0, rel=1e-5)
    assert cx / cz == pytest.approx(18.0 / 20.0, rel=1e-5)
