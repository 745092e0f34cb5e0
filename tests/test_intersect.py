"""Analytic intersection unit tests against hand-computed cases, covering
each primitive's reference quirks (citations in render/intersect.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ray_tracying.render import intersect as I
from ray_tracying.scene.loader import load_scene_dict

from test_scene_loader import minimal_camera


def scene_with(**kwargs):
    d = minimal_camera()
    d.update(kwargs)
    return load_scene_dict(d)


def hit_one(scene, o, d, time=0.0):
    o = jnp.asarray([o], jnp.float32)
    d = jnp.asarray([d], jnp.float32)
    return I.closest_hit(scene, o, d, jnp.asarray([time], jnp.float32))


def test_unit_sphere_frontal():
    s = scene_with(spheres=[{"location": [0, 5, 0], "radius": 1.0}])
    h = hit_one(s, [0, 0, 0], [0, 1, 0])
    assert bool(h.valid[0])
    assert float(h.t[0]) == pytest.approx(4.0, abs=1e-4)
    np.testing.assert_allclose(np.asarray(h.point[0]), [0, 4, 0], atol=1e-4)
    np.testing.assert_allclose(np.asarray(h.normal[0]), [0, -1, 0], atol=1e-4)


def test_sphere_inside_hits_far_side():
    s = scene_with(spheres=[{"location": [0, 0, 0], "radius": 2.0}])
    h = hit_one(s, [0, 0, 0], [1, 0, 0])
    assert bool(h.valid[0])
    assert float(h.t[0]) == pytest.approx(2.0, abs=1e-4)


def test_sphere_t_min_epsilon():
    """Hits with t <= 0.001 are rejected (Code/shapes.cpp:231)."""
    s = scene_with(spheres=[{"location": [0, 0, 0], "radius": 1.0}])
    # Origin on the surface pointing outward: both roots <= eps -> miss.
    h = hit_one(s, [0, 1.0005, 0], [0, 1, 0])
    assert not bool(h.valid[0])


def test_scaled_sphere_euclidean_t():
    """hit.t is the Euclidean distance to the world hit point even for
    non-uniform scale (Code/shapes.cpp:251-253)."""
    s = scene_with(spheres=[{"location": [0, 10, 0], "scale": [3.0, 1.0, 1.0]}])
    h = hit_one(s, [0, 0, 0], [0, 1, 0])
    assert float(h.t[0]) == pytest.approx(9.0, abs=1e-3)
    # Normal of an ellipsoid uses the inverse-transpose, still unit.
    assert np.linalg.norm(np.asarray(h.normal[0])) == pytest.approx(1.0, abs=1e-5)


def test_cube_frontal_face_normal():
    s = scene_with(cubes=[{"translation": [0, 3, 0], "rotation": [0, 0, 0]}])
    h = hit_one(s, [0, 0, 0], [0, 1, 0])
    assert float(h.t[0]) == pytest.approx(2.5, abs=1e-4)
    np.testing.assert_allclose(np.asarray(h.normal[0]), [0, -1, 0], atol=1e-5)


def test_cube_inside_exit_keeps_entry_normal():
    """Ray starting inside a cube exits through t_far but the normal comes
    from the entry axis (reference quirk, Code/shapes.cpp:392-402)."""
    s = scene_with(cubes=[{"translation": [0, 0, 0], "rotation": [0, 0, 0]}])
    h = hit_one(s, [0, 0, 0], [0, 1, 0])
    assert bool(h.valid[0])
    assert float(h.t[0]) == pytest.approx(0.5, abs=1e-5)
    # Entry axis for a +y ray through the center is y with sign -1.
    np.testing.assert_allclose(np.asarray(h.normal[0]), [0, -1, 0], atol=1e-5)


def test_cube_no_t_epsilon():
    """Cube uses t > 0, not the 0.001 epsilon: a hit at t=5e-4 counts
    (Code/shapes.cpp:392-393)."""
    s = scene_with(cubes=[{"translation": [0, 0, 0], "rotation": [0, 0, 0]}])
    h = hit_one(s, [0, -0.5005, 0], [0, 1, 0])
    assert bool(h.valid[0])
    assert float(h.t[0]) == pytest.approx(5e-4, abs=2e-4)


def test_rect_bounds_and_uv():
    s = scene_with(
        rectangles=[{"translation": [0, 4, 0], "rotation": [1.5707963, 0, 0],
                     "scale": [2.0, 2.0, 1.0]}]
    )
    # Rect rotated about x: local z -> world -y; spans x,z in [-1,1].
    h = hit_one(s, [0.5, 0, 0.25], [0, 1, 0])
    assert bool(h.valid[0])
    assert float(h.t[0]) == pytest.approx(4.0, abs=1e-4)
    # u = local_x + 0.5; local x = world x / 2 = 0.25 -> u = 0.75
    assert float(h.uv[0, 0]) == pytest.approx(0.75, abs=1e-5)
    miss = hit_one(s, [2.5, 0, 0], [0, 1, 0])
    assert not bool(miss.valid[0])


def test_plane_quad_parametric_t():
    s = scene_with(
        planes=[{"corners": [[-1, 5, -1], [1, 5, -1], [1, 5, 1], [-1, 5, 1]]}]
    )
    # Plane hit.t is the PARAMETRIC t (Code/shapes.cpp:458,481): use an
    # unnormalized direction to expose the difference.
    o = jnp.asarray([[0, 0, 0]], jnp.float32)
    d = jnp.asarray([[0, 2.0, 0]], jnp.float32)
    h = I.closest_hit(s, o, d, jnp.zeros(1))
    assert bool(h.valid[0])
    assert float(h.t[0]) == pytest.approx(2.5, abs=1e-5)  # 5 / |d|=2


def test_plane_point_in_quad_rejects_outside():
    s = scene_with(
        planes=[{"corners": [[-1, 5, -1], [1, 5, -1], [1, 5, 1], [-1, 5, 1]]}]
    )
    h = hit_one(s, [1.5, 0, 0], [0, 1, 0])
    assert not bool(h.valid[0])


def test_motion_blur_shifts_sphere():
    s = scene_with(
        spheres=[{"location": [0, 5, 0], "radius": 0.5, "velocity": [5.0, 0, 0]}]
    )
    # velocity/5 = 1.0/frame.  At time=1 the sphere center is at x=+1.
    h0 = hit_one(s, [0, 0, 0], [0, 1, 0], time=0.0)
    h1 = hit_one(s, [1.0, 0, 0], [0, 1, 0], time=1.0)
    miss = hit_one(s, [1.0, 0, 0], [0, 1, 0], time=0.0)
    assert bool(h0.valid[0]) and bool(h1.valid[0]) and not bool(miss.valid[0])
    # Advected hit point is reported in world space at the ray's time
    # (Code/shapes.cpp:243-248).
    np.testing.assert_allclose(np.asarray(h1.point[0]), [1.0, 4.5, 0], atol=1e-4)


def test_closest_hit_tie_break_first_geom():
    """Equal-t hits resolve to the first geom in load order, matching
    min_element / intersect_linear first-wins (Code/acceleration.cpp:112,133)."""
    d = minimal_camera()
    d["spheres"] = [
        {"location": [0, 5, 0], "radius": 1.0},
        {"location": [0, 5, 0], "radius": 1.0},
    ]
    s = load_scene_dict(d)
    h = hit_one(s, [0, 0, 0], [0, 1, 0])
    assert int(h.geom_id[0]) == 0


def test_empty_scene_misses():
    s = scene_with()
    h = hit_one(s, [0, 0, 0], [0, 1, 0])
    assert not bool(h.valid[0])
    assert np.isinf(float(h.t[0]))


def test_min_hit_t_matches_closest_hit():
    d = minimal_camera()
    d["spheres"] = [{"location": [0, 5, 0], "radius": 1.0}]
    d["cubes"] = [{"translation": [0, 8, 0], "rotation": [0, 0, 0]}]
    s = load_scene_dict(d)
    o = jnp.zeros((1, 3))
    dd = jnp.asarray([[0, 1, 0]], jnp.float32)
    t = I.min_hit_t(s, o, dd, jnp.zeros(1))
    h = I.closest_hit(s, o, dd, jnp.zeros(1))
    assert float(t[0]) == pytest.approx(float(h.t[0]), rel=1e-5)


def test_occluded_matches_min_hit_t():
    d = minimal_camera()
    d["spheres"] = [{"location": [0, 5, 0], "radius": 1.0}]
    d["cubes"] = [{"translation": [2, 8, 0], "rotation": [0, 0, 0]}]
    d["rectangles"] = [
        {"translation": [0, 12, 0], "rotation": [1.5707963, 0, 0],
         "scale": [30.0, 30.0, 1.0]}
    ]
    s = load_scene_dict(d)
    rng = np.random.default_rng(0)
    n = 64
    o = jnp.asarray(rng.normal(size=(n, 3)) * 2.0, jnp.float32)
    dd = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    dd = dd / jnp.linalg.norm(dd, axis=1, keepdims=True)
    maxt = jnp.asarray(rng.uniform(0.5, 20.0, size=n), jnp.float32)
    blocked = I.occluded(s, o, dd, maxt)
    t = I.min_hit_t(s, o, dd, jnp.zeros(n))
    np.testing.assert_array_equal(np.asarray(blocked), np.asarray(t <= maxt))


# ---------------------------------------------------------------------------
# Pass-1 routes and the Triton kernels (interpret mode here; compiled on
# the GPU by the `gpu`-marked test and chip_smoke.py).
# ---------------------------------------------------------------------------

from ray_tracying.kernels import closest_hit as K  # noqa: E402


def every_kind_scene(motion=False):
    d = minimal_camera()
    d["spheres"] = [
        {"location": [0, 5, 0], "radius": 1.0},
        {"location": [2, 6, 0.5], "rotation": [0.3, 0.2, 0.7],
         "scale": [0.8, 0.5, 1.2],
         "velocity": [1.0, 0.0, 0.0] if motion else [0.0, 0.0, 0.0]},
    ]
    d["cubes"] = [{"translation": [-2, 7, 0], "rotation": [0.1, 0.9, 0.4],
                   "scale": [0.7, 1.1, 0.6]}]
    d["rectangles"] = [{"translation": [0, 9, 0], "rotation": [1.0, 0.2, 0.0],
                        "scale": [6.0, 6.0, 1.0]}]
    d["planes"] = [
        {"corners": [[-9, 12, -9], [9, 12, -9], [9, 12, 9], [-9, 12, 9]]}
    ]
    return load_scene_dict(d)


def planes_only_scene():
    d = minimal_camera()
    d["planes"] = [
        {"corners": [[-3, 6, -3], [3, 6, -3], [3, 6, 3], [-3, 6, 3]]},
        {"corners": [[-1, 4, -1], [2, 4, -1], [2, 5, 2], [-1, 5, 2]]},
    ]
    return load_scene_dict(d)


def random_rays(n, seed, spread=1.5):
    rng = np.random.default_rng(seed)
    o = jnp.asarray(rng.normal(size=(n, 3)) * spread, jnp.float32)
    dd = rng.normal(size=(n, 3))
    dd[:, 1] = np.abs(dd[:, 1]) + 0.3
    dd = jnp.asarray(dd / np.linalg.norm(dd, axis=1, keepdims=True), jnp.float32)
    tm = jnp.asarray(rng.uniform(0.0, 1.0, size=n), jnp.float32)
    return o, dd, tm


def plain_pass1(s, o, d, tm):
    m = I.all_hit_t(s, o, d, tm)
    t = jnp.min(m, axis=1)
    gid = jnp.where(jnp.isfinite(t), jnp.argmin(m, axis=1), -1)
    return np.asarray(t), np.asarray(gid)


def assert_pass1_equal(t_k, id_k, t_p, id_p):
    t_k, id_k = np.asarray(t_k), np.asarray(id_k)
    np.testing.assert_array_equal(id_k, id_p)
    np.testing.assert_array_equal(np.isfinite(t_k), np.isfinite(t_p))
    hit = np.isfinite(t_p)
    np.testing.assert_allclose(t_k[hit], t_p[hit], rtol=1e-5)


@pytest.mark.parametrize(
    "make,motion",
    [(every_kind_scene, False), (every_kind_scene, True),
     (planes_only_scene, False)],
    ids=["every_kind", "motion_blur", "legacy_planes"],
)
def test_kernel_closest_hit_matches_plain(make, motion):
    s = make(motion) if make is every_kind_scene else make()
    assert s.has_motion == motion
    o, d, tm = random_rays(300, seed=3)
    t_k, id_k = K.closest_hit_tid(s, o, d, tm, interpret=True)
    assert_pass1_equal(t_k, id_k, *plain_pass1(s, o, d, tm))


@pytest.mark.parametrize(
    "make", [every_kind_scene, planes_only_scene],
    ids=["every_kind", "legacy_planes"],
)
def test_kernel_any_hit_matches_plain(make):
    s = make()
    o, d, _ = random_rays(256, seed=4)
    maxt = jnp.asarray(np.random.default_rng(5).uniform(0.5, 20.0, 256),
                       jnp.float32)
    got = np.asarray(K.occluded_tid(s, o, d, maxt, interpret=True))
    t, _ = plain_pass1(s, o, d, jnp.zeros(256))
    np.testing.assert_array_equal(got, t <= np.asarray(maxt))
    assert 0 < got.sum() < got.size


def test_kernel_tie_break_first_geom():
    """Coincident primitives: the first in load order wins, as with
    argmin / min_element (Code/acceleration.cpp:112,133)."""
    d = minimal_camera()
    d["cubes"] = [{"translation": [0, 5, 0], "rotation": [0, 0, 0]}] * 3
    d["planes"] = [
        {"corners": [[-1, 4.5, -1], [1, 4.5, -1], [1, 4.5, 1], [-1, 4.5, 1]]}
    ] * 2
    s = load_scene_dict(d)
    o = jnp.zeros((4, 3))
    dirs = jnp.asarray([[0, 1, 0], [0.05, 1, 0], [0, 1, 0.05], [0, 1, 0]],
                       jnp.float32)
    dirs = dirs / jnp.linalg.norm(dirs, axis=1, keepdims=True)
    t_k, id_k = K.closest_hit_tid(s, o, dirs, jnp.zeros(4), interpret=True)
    np.testing.assert_array_equal(np.asarray(id_k), [0, 0, 0, 0])
    assert_pass1_equal(t_k, id_k, *plain_pass1(s, o, dirs, jnp.zeros(4)))


@pytest.mark.parametrize("n", [1, K.BLOCK - 1, K.BLOCK + 1, 3 * K.BLOCK + 5])
def test_kernel_pads_ray_count(n):
    """Ray counts that are not a multiple of the block are padded with
    inactive rays and cut back."""
    s = every_kind_scene()
    o, d, tm = random_rays(n, seed=n)
    t_k, id_k = K.closest_hit_tid(s, o, d, tm, interpret=True)
    assert t_k.shape == (n,) and id_k.shape == (n,) and id_k.dtype == jnp.int32
    assert_pass1_equal(t_k, id_k, *plain_pass1(s, o, d, tm))
    b = K.occluded_tid(s, o, d, jnp.full(n, 30.0), interpret=True)
    assert b.shape == (n,) and b.dtype == jnp.bool_


def test_kernel_dead_blocks_report_miss():
    """A block whose rays are all inactive skips the loops and reports a
    miss; live blocks are unaffected."""
    s = every_kind_scene()
    n = 2 * K.BLOCK
    o, d, tm = random_rays(n, seed=7)
    active = jnp.arange(n) >= K.BLOCK  # first block dead
    t_k, id_k = K.closest_hit_tid(s, o, d, tm, active, interpret=True)
    t_p, id_p = plain_pass1(s, o, d, tm)
    assert np.isinf(np.asarray(t_k[: K.BLOCK])).all()
    assert (np.asarray(id_k[: K.BLOCK]) == -1).all()
    assert_pass1_equal(t_k[K.BLOCK:], id_k[K.BLOCK:], t_p[K.BLOCK:], id_p[K.BLOCK:])
    b = np.asarray(K.occluded_tid(s, o, d, jnp.full(n, 30.0), active,
                                  interpret=True))
    assert not b[: K.BLOCK].any()


def test_kernel_gradient_is_zero_cotangent():
    """Hit decisions carry zero cotangents; the differentiable distance
    comes from pass 2 (closest_hit) and matches the plain route's."""
    s = every_kind_scene()
    o, d, tm = random_rays(64, seed=8)

    def t_sum(o_, intersect):
        h = I.closest_hit(s, o_, d, tm, intersect=intersect)
        return jnp.sum(jnp.where(h.valid, h.t, 0.0))

    def kernel_t_sum(o_):
        t, _ = K.closest_hit_tid(s, o_, d, tm, interpret=True)
        return jnp.sum(jnp.where(jnp.isfinite(t), t, 0.0))

    assert float(jnp.abs(jax.grad(kernel_t_sum)(o)).max()) == 0.0
    g_k = jax.grad(t_sum)(o, "interpret")
    g_p = jax.grad(t_sum)(o, "plain")
    np.testing.assert_allclose(np.asarray(g_k), np.asarray(g_p), rtol=1e-5,
                               atol=1e-6)
    assert float(jnp.abs(g_p).max()) > 0


def test_closest_hit_interpret_route_matches_plain():
    """The full Hit record (pass 1 by kernel + pass-2 attributes) equals the
    plain route's."""
    s = every_kind_scene(motion=True)
    o, d, tm = random_rays(256, seed=9)
    a = I.closest_hit(s, o, d, tm, intersect="interpret")
    b = I.closest_hit(s, o, d, tm, intersect="plain")
    for f in ("valid", "geom_id"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)))
    for f in ("t", "point", "normal", "uv"):
        np.testing.assert_allclose(np.asarray(getattr(a, f)),
                                   np.asarray(getattr(b, f)), rtol=1e-5,
                                   atol=1e-6)


def test_route_plain_on_cpu_without_env():
    """On the CPU backend "auto" is the plain path, with no env var."""
    import os

    assert not any(k.startswith("RTT_") for k in os.environ)
    s = every_kind_scene()
    assert jax.default_backend() == "cpu"
    assert I.route(s) == "plain"
    assert I.route(s, "plain") == "plain"
    assert I.route(s, "interpret") == "interpret"


def test_route_falls_back_for_tables_out_of_kind_order():
    """A hand-built scene whose kind counts do not describe its primitive
    table, or one with no geometry, takes the plain path on every route."""
    s = every_kind_scene()
    assert K.kind_ranges(s) == ((0, 0, 2), (1, 2, 3), (2, 3, 4), (3, 4, 5))
    odd = s.replace(kind_counts=(0, 0, 0))
    assert K.kind_ranges(odd) is None
    assert I.route(odd, "interpret") == "plain"
    assert I.route(scene_with(), "interpret") == "plain"
    with pytest.raises(ValueError):
        I.route(s, "pallas")


@pytest.mark.gpu
def test_kernels_compiled_match_plain_on_gpu():
    """The compiled Triton kernels against the plain XLA path on the card."""
    s = every_kind_scene(motion=True)
    o, d, tm = random_rays(4096, seed=10)
    t_k, id_k = jax.jit(K.closest_hit_tid)(s, o, d, tm)
    assert_pass1_equal(t_k, id_k, *plain_pass1(s, o, d, tm))
    maxt = jnp.full(4096, 8.0)
    got = np.asarray(jax.jit(K.occluded_tid)(s, o, d, maxt))
    t, _ = plain_pass1(s, o, d, jnp.zeros(4096))
    np.testing.assert_array_equal(got, t <= 8.0)
