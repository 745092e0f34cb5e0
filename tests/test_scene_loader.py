"""Scene loader quirk tests — each asserts a documented reference behavior
(citations in scene/loader.py)."""

import numpy as np
import jax.numpy as jnp
import pytest

from ray_tracying.scene.loader import load_scene_dict
from ray_tracying.scene.types import KIND_CUBE, KIND_RECT, KIND_SPHERE


def minimal_camera():
    return {
        "cameras": [
            {
                "location": [0, 0, 0],
                "gaze_vector": [0, 1, 0],
                "up_vector": [0, 0, 1],
                "focal_length": 20.0,
                "sensor_width": 36,
                "sensor_height": 24,
            }
        ],
        "render": {"resolution_x": 8, "resolution_y": 6},
    }


def test_sphere_velocity_divided_by_5():
    d = minimal_camera()
    d["spheres"] = [{"location": [0, 0, 0], "radius": 1.0, "velocity": [5.0, -10.0, 2.5]}]
    s = load_scene_dict(d)
    np.testing.assert_allclose(np.asarray(s.prims.velocity[0]), [1.0, -2.0, 0.5])
    assert s.has_motion


def test_sphere_scale_array_beats_radius():
    d = minimal_camera()
    d["spheres"] = [{"location": [0, 0, 0], "radius": 9.0, "scale": [1.0, 2.0, 3.0]}]
    s = load_scene_dict(d)
    # o2w linear diag should be the scale, not the radius.
    lin = np.asarray(s.prims.o2w[0, :, :3])
    np.testing.assert_allclose(np.diag(lin), [1.0, 2.0, 3.0], atol=1e-6)


def test_cube_scalar_scale():
    d = minimal_camera()
    d["cubes"] = [
        {"translation": [0, 0, 0], "rotation": [0, 0, 0], "scale": 0.5},
        {"translation": [0, 0, 0], "rotation": [0, 0, 0]},  # missing -> 1
    ]
    s = load_scene_dict(d)
    np.testing.assert_allclose(np.diag(np.asarray(s.prims.o2w[0, :, :3])), [0.5] * 3)
    np.testing.assert_allclose(np.diag(np.asarray(s.prims.o2w[1, :, :3])), [1.0] * 3)


def test_cube_missing_translation_skipped():
    d = minimal_camera()
    d["cubes"] = [{"rotation": [0, 0, 0]}]
    s = load_scene_dict(d)
    assert s.n_prims == 0


def test_material_defaults_differ_with_and_without_block():
    """Class defaults (k_d=0.9, k_s=0.3, shininess=20) when no block; loader
    defaults (k_d=0.6, k_s=0.6, shininess=5/0.001^2) when block present but
    keys missing (Code/material.hpp:52-70 vs Code/json_loader.cpp:45-61)."""
    d = minimal_camera()
    d["cubes"] = [
        {"translation": [0, 0, 0], "rotation": [0, 0, 0]},               # no block
        {"translation": [0, 0, 0], "rotation": [0, 0, 0], "material": {}},  # empty block
    ]
    s = load_scene_dict(d)
    m = s.materials
    assert float(m.k_diffuse[0]) == pytest.approx(0.9)
    assert float(m.k_specular[0]) == pytest.approx(0.3)
    assert float(m.shininess[0]) == pytest.approx(20.0)
    assert float(m.k_diffuse[1]) == pytest.approx(0.6)
    assert float(m.k_specular[1]) == pytest.approx(0.6)
    assert float(m.shininess[1]) == pytest.approx(5.0 / (0.001**2))


def test_shininess_formula():
    d = minimal_camera()
    d["cubes"] = [
        {"translation": [0, 0, 0], "rotation": [0, 0, 0],
         "material": {"roughness": 0.5}},
        {"translation": [0, 0, 0], "rotation": [0, 0, 0],
         "material": {"roughness": 2.0}},  # clamped to 1
    ]
    s = load_scene_dict(d)
    assert float(s.materials.shininess[0]) == pytest.approx(5.0 / 0.25)
    assert float(s.materials.shininess[1]) == pytest.approx(5.0)
    # roughness itself stored unclamped (used as glossy fuzz radius)
    assert float(s.materials.roughness[1]) == pytest.approx(2.0)


def test_invalid_lights_skipped():
    d = minimal_camera()
    d["lights"] = [
        {"location": [0, 0, 0], "color": [1, 1, 1], "intensity": -5.0},  # non-positive
        {"location": [0, 0, 0], "color": [1, 1, 1]},                      # missing key
        "garbage",
        {"location": [1, 2, 3], "color": [1, 1, 1], "intensity": 2.0},
    ]
    s = load_scene_dict(d)
    assert s.n_lights == 1
    np.testing.assert_allclose(np.asarray(s.lights.position[0]), [1, 2, 3])
    assert s.lights.is_area == (False,)


def test_light_radius_flags():
    d = minimal_camera()
    d["lights"] = [
        {"location": [0, 0, 0], "color": [1, 1, 1], "intensity": 1.0, "radius": 0.5},
        {"location": [0, 0, 0], "color": [1, 1, 1], "intensity": 1.0},
    ]
    s = load_scene_dict(d)
    assert s.lights.is_area == (True, False)


def test_load_order_and_kinds():
    d = minimal_camera()
    d["spheres"] = [{"location": [0, 0, 0], "radius": 1.0}]
    d["cubes"] = [{"translation": [0, 0, 0], "rotation": [0, 0, 0]}]
    d["rectangles"] = [
        {"translation": [0, 0, 0], "rotation": [0, 0, 0], "scale": [1, 1, 1]}
    ]
    d["planes"] = [{"corners": [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]]}]
    s = load_scene_dict(d)
    assert list(np.asarray(s.prims.kind)) == [KIND_SPHERE, KIND_CUBE, KIND_RECT]
    assert s.n_planes == 1
    assert s.n_geoms == 4


def test_plane_bad_corner_count_skipped():
    d = minimal_camera()
    d["planes"] = [{"corners": [[0, 0, 0], [1, 0, 0]]}]
    s = load_scene_dict(d)
    assert s.n_planes == 0


def test_texture_fail_soft():
    d = minimal_camera()
    d["cubes"] = [
        {"translation": [0, 0, 0], "rotation": [0, 0, 0],
         "material": {"texture_file": "missing.jpg"}}
    ]
    s = load_scene_dict(d, textures_dir="/nonexistent")
    assert int(s.materials.tex_id[0]) == -1
    assert not s.has_textures


def test_camera_defaults():
    d = minimal_camera()
    s = load_scene_dict(d)
    assert float(s.camera.aperture) == 0.0
    assert float(s.camera.focus_dist) == 10.0
    assert s.camera.resolution == (8, 6)
