"""Scene model zoo registry (models/) and op API surface (ops/)."""

import numpy as np
import jax.numpy as jnp
import pytest

from ray_tracying import models, ops


def test_registry_contains_all_demos():
    for name in models.DEMO_SCENES:
        assert name in models.REGISTRY
    for name in ("bvh_stress", "cornell", "sphere_field", "cube_city"):
        assert name in models.REGISTRY


def test_procedural_scenes_build_and_trace():
    s = models.get("sphere_field", n=128, res=(32, 16))
    assert s.n_geoms == 129
    s2 = models.get("cube_city", n=50, res=(32, 16))
    assert s2.n_geoms == 51
    # One-bounce trace smoke check through the op API.
    import jax

    o = jnp.zeros((64, 3)) + jnp.asarray([0.0, -14.0, 6.0])
    d = jnp.tile(jnp.asarray([[0.0, 1.0, -0.3]]), (64, 1))
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    h = ops.closest_hit(s, o, d, jnp.zeros(64))
    assert bool(h.valid.any())


def test_cornell_touches_all_branches():
    s = models.get("cornell")
    assert s.has_reflection and s.has_refraction
    assert s.n_planes == 5 and s.n_prims == 2


def test_unknown_model_raises():
    with pytest.raises(KeyError):
        models.get("nope")


def test_demo_scenes_load():
    for name in models.DEMO_SCENES:
        s = models.demo(name)
        assert s.n_geoms > 0 and s.n_lights > 0
