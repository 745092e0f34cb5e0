"""Scene pytree: registration, static metadata, replace."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tracying.scene.types import Camera, Lights, Scene
from ray_tracying.scene.loader import load_scene_dict

from test_scene_loader import minimal_camera


def small_scene():
    d = minimal_camera()
    d["lights"] = [{"location": [0, 0, 5], "color": [1, 1, 1],
                    "intensity": 100.0, "radius": 0.5}]
    d["spheres"] = [{"location": [0, 5, 0], "radius": 1.0}]
    d["cubes"] = [{"translation": [2, 5, 0], "rotation": [0, 0, 0]}]
    return load_scene_dict(d)


def test_scene_pytree_round_trip():
    s = small_scene()
    leaves, treedef = jax.tree.flatten(s)
    assert all(isinstance(x, jax.Array) for x in leaves)
    back = jax.tree.unflatten(treedef, leaves)
    assert isinstance(back, Scene)
    assert back.n_prims == 2 and back.kind_counts == (1, 1, 0)
    assert back.lights.is_area == (True,)
    assert back.camera.resolution == s.camera.resolution
    for a, b in zip(jax.tree.leaves(back), leaves):
        assert a is b
    # Static fields are metadata, not leaves.
    assert len(leaves) == len(jax.tree.leaves(s.replace(n_lights=7)))
    doubled = jax.tree.map(lambda x: x * 2, s)
    np.testing.assert_array_equal(
        np.asarray(doubled.prims.w2o), 2 * np.asarray(s.prims.w2o))
    assert doubled.has_spheres and doubled.kind_counts == s.kind_counts


def test_static_fields_key_the_jit_cache():
    """Changing a leaf reuses the compiled function; changing a static
    field retraces it."""
    traces = []

    @jax.jit
    def f(scene):
        traces.append(scene.n_prims)
        return jnp.sum(scene.prims.w2o) * scene.n_prims

    s = small_scene()
    f(s)
    f(jax.tree.map(lambda x: x + 1.0 if x.dtype == jnp.float32 else x, s))
    assert len(traces) == 1
    out = f(s.replace(n_prims=3))
    assert len(traces) == 2
    assert float(out) == pytest.approx(3 * float(jnp.sum(s.prims.w2o)))


def test_replace_is_a_copy():
    s = small_scene()
    cam = s.camera.replace(resolution=(8, 4))
    assert isinstance(cam, Camera) and cam.resolution == (8, 4)
    assert s.camera.resolution != (8, 4)
    li = s.lights.replace(intensity=jnp.zeros(1))
    assert isinstance(li, Lights) and li.is_area == (True,)
    with pytest.raises(Exception):
        s.n_prims = 5  # frozen
