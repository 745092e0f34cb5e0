"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ray_tracying.parallel.sharding import make_mesh, trace_wavefront_sharded
from ray_tracying.render.integrator import trace_wavefront

from test_diff import tiny_scene


@pytest.fixture(autouse=True)
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")


def make_rays(n):
    key = jax.random.key(3)
    o = jnp.tile(jnp.asarray([[0.0, -4.0, 1.5]]), (n, 1))
    d = jax.random.normal(key, (n, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    # Aim mostly forward so a good fraction hits the scene.
    d = d.at[:, 1].set(jnp.abs(d[:, 1]) + 0.5)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, jnp.zeros(n)


def test_sharded_trace_matches_single_device():
    """Deterministic scene (point lights, roughness 0): sharded and
    unsharded traces must agree exactly up to RNG-independent math."""
    scene = tiny_scene()
    n = 512
    o, d, t = make_rays(n)
    mesh = make_mesh(8)
    key = jax.random.key(0)
    ref = np.asarray(trace_wavefront(scene, o, d, t, key, 1))
    shd = np.asarray(
        trace_wavefront_sharded(scene, o, d, t, key, 1, mesh)
    )
    np.testing.assert_allclose(ref, shd, rtol=1e-6, atol=1e-7)


def test_sharded_gradient_psum_matches_single_device():
    """Cotangents of the replicated scene must all-reduce correctly: the
    sharded loss gradient w.r.t. light intensity equals the unsharded one."""
    scene = tiny_scene()
    n = 256
    o, d, t = make_rays(n)
    mesh = make_mesh(8)
    key = jax.random.key(0)

    def loss_unsharded(intensity):
        sc = scene.replace(lights=scene.lights.replace(intensity=intensity))
        c = trace_wavefront(sc, o, d, t, key, 1)
        return jnp.sum(c**2)

    def loss_sharded(intensity):
        sc = scene.replace(lights=scene.lights.replace(intensity=intensity))
        c = trace_wavefront_sharded(sc, o, d, t, key, 1, mesh)
        return jnp.sum(c**2)

    i0 = scene.lights.intensity
    g_ref = np.asarray(jax.grad(loss_unsharded)(i0))
    g_shd = np.asarray(jax.grad(loss_sharded)(i0))
    np.testing.assert_allclose(g_ref, g_shd, rtol=1e-5)
    assert np.abs(g_ref).max() > 0


def test_2d_mesh_dryrun():
    """The driver-facing dryrun compiles and runs a training step on a 2D
    (dp, sp) mesh."""
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(repo, "__graft_entry__.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)
