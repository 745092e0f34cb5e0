"""Wavefront integrator semantics tests (render/integrator.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ray_tracying.render.integrator import trace_wavefront
from ray_tracying.scene.loader import load_scene_dict

from test_scene_loader import minimal_camera


def trace_dirs(scene, dirs, key=0):
    dirs = jnp.asarray(dirs, jnp.float32)
    o = jnp.zeros_like(dirs)
    return np.asarray(
        trace_wavefront(
            scene, o, dirs, jnp.zeros(dirs.shape[0]), jax.random.key(key), 1
        )
    )


def test_miss_is_background():
    s = load_scene_dict(minimal_camera())
    c = trace_dirs(s, [[0, 1, 0], [1, 0, 0]])
    np.testing.assert_allclose(c, 0.1, atol=1e-7)


def test_opaque_hit_no_children():
    d = minimal_camera()
    d["lights"] = [
        {"location": [0, 0, 5], "color": [1, 1, 1], "intensity": 100.0}
    ]
    d["spheres"] = [{"location": [0, 5, 0], "radius": 1.0,
                     "material": {"diffuse_color": [1, 0, 0]}}]
    s = load_scene_dict(d)
    c = trace_dirs(s, [[0, 1, 0]])
    # Red-ish: ambient 0.1*1 plus diffuse; green/blue only ambient+spec.
    assert c[0, 0] > c[0, 1]
    assert c[0, 0] > 0.05


def test_energy_weights_mirror():
    """local*(1-refl) + refl*child (Code/raytracer.cpp:346-350): a perfect
    mirror (refl=1) facing the background returns exactly background."""
    d = minimal_camera()
    d["rectangles"] = [
        {"translation": [0, 5, 0], "rotation": [1.5707963, 0, 0],
         "scale": [4, 4, 1],
         "material": {"reflectivity": 1.0, "roughness": 0.0}}
    ]
    s = load_scene_dict(d)
    c = trace_dirs(s, [[0, 1, 0]])
    np.testing.assert_allclose(c[0], [0.1, 0.1, 0.1], atol=1e-6)


def test_depth_cutoff_two_mirrors():
    """Two facing perfect mirrors: the ray bounces 11 times then the chain
    terminates in black (depth > 10 -> {0,0,0}, Code/raytracer.cpp:290-292),
    so the result is exactly 0 (every level's local weight is 0)."""
    d = minimal_camera()
    for y in (5.0, -5.0):
        d.setdefault("rectangles", []).append(
            {"translation": [0, y, 0], "rotation": [1.5707963, 0, 0],
             "scale": [4, 4, 1],
             "material": {"reflectivity": 1.0, "roughness": 0.0}}
        )
    s = load_scene_dict(d)
    c = trace_dirs(s, [[0, 1, 0]])
    np.testing.assert_allclose(c[0], 0.0, atol=1e-6)


def test_transparency_passthrough():
    """A fully transparent, non-refracting (ior=1) slab passes the
    background through: trans=1 -> child carries all throughput."""
    d = minimal_camera()
    d["rectangles"] = [
        {"translation": [0, 5, 0], "rotation": [1.5707963, 0, 0],
         "scale": [4, 4, 1],
         "material": {"transparency": 1.0, "refractive_index": 1.0}}
    ]
    s = load_scene_dict(d)
    c = trace_dirs(s, [[0, 1, 0]])
    np.testing.assert_allclose(c[0], [0.1, 0.1, 0.1], atol=1e-6)


def test_glossy_absorption_black():
    """roughness >> 1 perturbs most reflection rays below the surface ->
    absorbed (black), so a rough mirror tends to black, not background
    (Code/raytracer.cpp:322-327)."""
    d = minimal_camera()
    d["rectangles"] = [
        {"translation": [0, 5, 0], "rotation": [1.5707963, 0, 0],
         "scale": [4, 4, 1],
         "material": {"reflectivity": 1.0, "roughness": 50.0}}
    ]
    s = load_scene_dict(d)
    n = 512
    c = trace_dirs(s, [[0, 1, 0]] * n)
    # ~half the fuzzed rays point into the surface -> absorbed.  Mean
    # radiance must be well below the full-background 0.1.
    assert c.mean() < 0.08


def test_queue_growth_mirror_plus_glass():
    """Scene with both reflective and refractive materials exercises the
    2-way branching queue; result must stay finite and >= background
    contributions only."""
    d = minimal_camera()
    d["lights"] = [
        {"location": [0, 0, 5], "color": [1, 1, 1], "intensity": 200.0}
    ]
    d["spheres"] = [
        {"location": [-1, 5, 0], "radius": 1.0,
         "material": {"reflectivity": 0.5}},
        {"location": [1.5, 5, 0], "radius": 1.0,
         "material": {"transparency": 0.7, "refractive_index": 1.5}},
    ]
    s = load_scene_dict(d)
    dirs = []
    for x in np.linspace(-0.5, 0.5, 16):
        v = np.array([x, 1.0, 0.0])
        dirs.append(v / np.linalg.norm(v))
    c = trace_dirs(s, dirs)
    assert np.isfinite(c).all()
    assert (c >= 0).all()


def test_stats_single_level_local_scene():
    """No-spawn scene: stats has one level, live == R, hits == hit count."""
    d = minimal_camera()
    d["spheres"] = [{"location": [0, 5, 0], "radius": 1.0}]
    s = load_scene_dict(d)
    dirs = jnp.asarray([[0, 1, 0], [0, -1, 0], [0, 1, 0]], jnp.float32)
    _, st = trace_wavefront(
        s, jnp.zeros_like(dirs), dirs, jnp.zeros(3), jax.random.key(0), 1,
        return_stats=True,
    )
    assert st.live.shape == (1,)
    assert int(st.live[0]) == 3
    assert int(st.hits[0]) == 2
    assert int(st.spawned[0]) == 0
    assert int(st.dropped[0]) == 0


def _mirror_glass_scene():
    d = minimal_camera()
    d["lights"] = [
        {"location": [0, 0, 5], "color": [1, 1, 1], "intensity": 200.0}
    ]
    d["spheres"] = [
        {"location": [-1, 5, 0], "radius": 1.0,
         "material": {"reflectivity": 0.5}},
        {"location": [1.5, 5, 0], "radius": 1.0,
         "material": {"transparency": 0.7, "refractive_index": 1.5}},
    ]
    return load_scene_dict(d)


def test_stats_mirror_glass_no_drops_at_mult2():
    """One-way branching per hit (no material both reflects and refracts):
    queue_mult=2 must never overflow -> dropped identically zero, and the
    live count entering each level equals the previous level's spawns."""
    s = _mirror_glass_scene()
    n = 64
    k1, k2 = jax.random.split(jax.random.key(3))
    dirs = jnp.concatenate(
        [jax.random.uniform(k1, (n, 1)) * 0.8 - 0.4,
         jnp.ones((n, 1)),
         jax.random.uniform(k2, (n, 1)) * 0.4 - 0.2],
        axis=1,
    )
    dirs = dirs / jnp.linalg.norm(dirs, axis=1, keepdims=True)
    _, st = trace_wavefront(
        s, jnp.zeros_like(dirs), dirs, jnp.zeros(n), jax.random.key(0), 1,
        queue_mult=2, return_stats=True,
    )
    assert int(jnp.sum(st.dropped)) == 0
    live = np.asarray(st.live)
    spawned = np.asarray(st.spawned)
    assert live[0] == n
    np.testing.assert_array_equal(live[1:], spawned[:-1])


def test_stats_zoo_scenes_no_drops_at_default_mult():
    """The bundled demo zoo (incl. the mirror+glass cornell) must not drop
    continuations at the default queue_mult=2."""
    from ray_tracying.models.zoo import cornell

    s = cornell(res=(16, 16))
    assert s.has_reflection and s.has_refraction  # exercises 2-way compaction
    n = 128
    k = jax.random.key(7)
    px = jax.random.uniform(jax.random.fold_in(k, 0), (n,)) * 16
    py = jax.random.uniform(jax.random.fold_in(k, 1), (n,)) * 16
    from ray_tracying.render.camera import pixel_rays

    o, d = pixel_rays(s.camera, px, py, jax.random.fold_in(k, 2))
    _, st = trace_wavefront(
        s, o, d, jnp.zeros(n), jax.random.key(0), 1, queue_mult=2,
        return_stats=True,
    )
    assert int(jnp.sum(st.dropped)) == 0


def test_stats_overflow_is_counted():
    """A material that BOTH reflects and refracts branches 2x per hit;
    queue_mult=1 cannot hold the growth, and the drop counter must see it
    (the drop itself is the documented overflow policy)."""
    d = minimal_camera()
    # Two parallel both-ways slabs: every hit spawns 2 children.
    for y in (5.0, 7.0):
        d.setdefault("rectangles", []).append(
            {"translation": [0, y, 0], "rotation": [1.5707963, 0, 0],
             "scale": [40, 40, 1],
             "material": {"reflectivity": 0.5, "transparency": 0.5,
                          "refractive_index": 1.0, "roughness": 0.0}}
        )
    s = load_scene_dict(d)
    n = 8
    dirs = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32), (n, 1))
    _, st = trace_wavefront(
        s, jnp.zeros_like(dirs), dirs, jnp.zeros(n), jax.random.key(0), 1,
        queue_mult=1, return_stats=True,
    )
    assert int(jnp.sum(st.dropped)) > 0
    # And the roomy queue sees none.
    _, st2 = trace_wavefront(
        s, jnp.zeros_like(dirs), dirs, jnp.zeros(n), jax.random.key(0), 1,
        queue_mult=4, return_stats=True,
    )
    assert int(jnp.sum(st2.dropped)) == 0


def test_stats_do_not_change_image():
    s = _mirror_glass_scene()
    dirs = jnp.asarray([[0, 1, 0], [0.2, 1, 0.1]], jnp.float32)
    dirs = dirs / jnp.linalg.norm(dirs, axis=1, keepdims=True)
    o = jnp.zeros_like(dirs)
    t = jnp.zeros(2)
    plain = trace_wavefront(s, o, dirs, t, jax.random.key(1), 1)
    with_st, _ = trace_wavefront(
        s, o, dirs, t, jax.random.key(1), 1, return_stats=True
    )
    np.testing.assert_array_equal(np.asarray(plain), np.asarray(with_st))


def test_render_with_stats_pipeline():
    from ray_tracying.render.pipeline import RenderOptions, render_with_stats

    s = _mirror_glass_scene()
    img, stats = render_with_stats(s, RenderOptions(samples_sqrt=1))
    assert img.shape[2] == 3
    assert stats["total_dropped"] == 0
    assert stats["levels"][0]["live"] > 0
    assert len(stats["tiles"]) >= 1


def test_segmented_integrator_matches_unsegmented():
    """Deterministic scene (no glossy / area lights): segment gating must
    be bit-identical to the plain in-slot path."""
    d = minimal_camera()
    d["lights"] = [
        {"location": [0, 0, 5], "color": [1, 1, 1], "intensity": 150.0}
    ]
    d["spheres"] = [
        {"location": [0, 6, 0], "radius": 1.5,
         "material": {"diffuse_color": [0.8, 0.2, 0.2],
                      "reflectivity": 0.4, "roughness": 0.0}},
    ]
    d["rectangles"] = [
        {"translation": [0, 6, -2], "rotation": [0, 0, 0], "scale": [10, 10, 1],
         "material": {"diffuse_color": [0.3, 0.5, 0.3], "reflectivity": 0.2,
                      "roughness": 0.0}},
    ]
    s = load_scene_dict(d)
    n = 128
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:, 1] = np.abs(dirs[:, 1]) + 0.5
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs = jnp.asarray(dirs)
    o = jnp.zeros_like(dirs)
    t = jnp.zeros(n)
    plain = trace_wavefront(s, o, dirs, t, jax.random.key(2), 1, segments=1)
    seg = trace_wavefront(s, o, dirs, t, jax.random.key(2), 1, segments=4)
    np.testing.assert_array_equal(np.asarray(plain), np.asarray(seg))
    # Stats agree too (deterministic scene).
    _, st1 = trace_wavefront(
        s, o, dirs, t, jax.random.key(2), 1, segments=1, return_stats=True
    )
    _, st4 = trace_wavefront(
        s, o, dirs, t, jax.random.key(2), 1, segments=4, return_stats=True
    )
    np.testing.assert_array_equal(np.asarray(st1.live), np.asarray(st4.live))
    np.testing.assert_array_equal(np.asarray(st1.hits), np.asarray(st4.hits))
    np.testing.assert_array_equal(
        np.asarray(st1.spawned), np.asarray(st4.spawned)
    )


# ---------------------------------------------------------------------------
# General-path cases carried over from the removed fused-level tests, and
# the kernel route (interpret mode) against the plain route in the full
# integrator.
# ---------------------------------------------------------------------------

import os  # noqa: E402

from ray_tracying.scene.loader import load_scene  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = sorted(
    f[:-5] for f in os.listdir(os.path.join(REPO, "scenes")) if f.endswith(".json")
)


def scene_file(name):
    return load_scene(
        os.path.join(REPO, "scenes", name + ".json"),
        textures_dir=os.path.join(REPO, "golden", "Textures"),
    )


def camera_rays(scene, n, seed=0):
    """n primary rays at jittered pixel positions of the scene's camera."""
    from ray_tracying.render.camera import pixel_rays

    w, h = scene.camera.resolution
    rng = np.random.default_rng(seed)
    px = jnp.asarray(rng.uniform(0, w, n), jnp.float32)
    py = jnp.asarray(rng.uniform(0, h, n), jnp.float32)
    o, d = pixel_rays(scene.camera, px, py, jax.random.key(seed))
    return o, d, jnp.asarray(rng.uniform(0, 1, n), jnp.float32)


def both_routes(scene, o, d, tm, light_samples=1, **kw):
    key = jax.random.key(5)
    return [
        np.asarray(trace_wavefront(scene, o, d, tm, key, light_samples,
                                   intersect=route, **kw))
        for route in ("plain", "interpret")
    ]


def test_textured_plane_and_many_lights():
    """Textured legacy planes (projective UV from the corners) and six
    point lights: the kernel route matches the plain route."""
    d = minimal_camera()
    d["lights"] = [
        {"location": [2.0 * i - 5, -1.0, 2.0 + 0.3 * i],
         "color": [1, 1, 1], "intensity": 80.0 + 10 * i}
        for i in range(6)
    ]
    d["cubes"] = [
        {"translation": [0.5, 5, 0], "rotation": [0.2, 0.3, 0.1],
         "material": {"diffuse_color": [0.9, 0.8, 0.7], "reflectivity": 0.3,
                      "texture_file": "checker.jpg"}},
    ]
    d["planes"] = [
        {"corners": [[-4.0, 8.0, -2.0], [4.0, 8.0, -2.0],
                     [4.0, 8.0, 4.0], [-4.0, 8.0, 4.0]],
         "material": {"diffuse_color": [0.8, 0.8, 0.8],
                      "texture_file": "checker.jpg"}},
    ]
    s = load_scene_dict(d, textures_dir=os.path.join(REPO, "golden", "Textures"))
    assert s.has_textures and s.n_planes == 1 and s.n_lights == 6
    rng = np.random.default_rng(5)
    dirs = rng.normal(size=(512, 3)).astype(np.float32)
    dirs[:, 1] = np.abs(dirs[:, 1]) + 0.3
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    plain, kern = both_routes(s, jnp.zeros((512, 3)), jnp.asarray(dirs),
                              jnp.zeros(512))
    np.testing.assert_allclose(kern, plain, rtol=2e-5, atol=2e-6)
    # The texture really shows: not every lit hit has the same colour.
    assert np.unique(np.round(plain, 4), axis=0).shape[0] > 8


def glass_scene():
    """One-way refraction + mirrors on DIFFERENT materials: the Snell/TIR
    continuation, the exit flip, and the per-lane reflection-vs-refraction
    pick (Code/raytracer.cpp:118-150,308-344)."""
    d = minimal_camera()
    d["lights"] = [
        {"location": [0, 0, 5], "color": [1, 1, 1], "intensity": 300.0},
        {"location": [4, 2, 3], "color": [1.0, 0.8, 0.6], "intensity": 200.0},
    ]
    d["spheres"] = [
        {"location": [0, 5, 0], "radius": 1.2,
         "material": {"diffuse_color": [0.9, 0.9, 0.9],
                      "transparency": 0.85, "refractive_index": 1.5}},
        {"location": [-2.5, 7, 1], "radius": 1.0,
         "material": {"diffuse_color": [0.2, 0.6, 0.8]}},
    ]
    d["cubes"] = [
        {"translation": [2.5, 6, -0.5], "rotation": [0.2, 0.4, 0.1],
         "material": {"diffuse_color": [0.9, 0.8, 0.3], "reflectivity": 0.35}},
    ]
    d["rectangles"] = [
        {"translation": [0, 8, 0], "rotation": [1.5707963, 0, 0],
         "scale": [14, 14, 1],
         "material": {"diffuse_color": [0.3, 0.5, 0.3]}},
    ]
    return load_scene_dict(d)


def spread_dirs(n, seed):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:, 1] = np.abs(dirs[:, 1]) + 0.4
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return jnp.zeros((n, 3)), jnp.asarray(dirs), jnp.zeros(n)


def test_one_way_refraction():
    """Glass + mirror (one-way mixed): deterministic, and the two routes
    agree to float tolerance; rays really refract and reflect."""
    s = glass_scene()
    assert s.has_refraction and s.has_reflection and not s.has_two_way
    o, d, tm = spread_dirs(512, 17)
    plain, kern = both_routes(s, o, d, tm)
    np.testing.assert_allclose(kern, plain, rtol=2e-5, atol=2e-6)
    _, st = trace_wavefront(s, o, d, tm, jax.random.key(5), 1,
                            return_stats=True)
    assert int(np.asarray(st.spawned)[0]) > 0
    assert int(np.asarray(st.live)[2]) > 0


def test_mixed_one_way_inslot_matches_compacted():
    """A mixed one-way scene (mirror and glass on different materials)
    takes the in-slot queue; forcing compaction must give the same image on
    a deterministic scene (slot permutation only)."""
    s = glass_scene()
    o, d, tm = spread_dirs(256, 23)
    key = jax.random.key(2)
    a = np.asarray(trace_wavefront(s, o, d, tm, key, 1))
    b = np.asarray(trace_wavefront(s, o, d, tm, key, 1, compact="always"))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_non_reflective_scene_single_level():
    """No material reflects or refracts: one level is traced, and both
    routes agree."""
    d = minimal_camera()
    d["lights"] = [{"location": [0, 0, 5], "color": [1, 1, 1], "intensity": 150.0}]
    d["spheres"] = [{"location": [0, 6, 0], "radius": 1.5,
                     "material": {"diffuse_color": [0.7, 0.3, 0.2]}}]
    s = load_scene_dict(d)
    o, dd, tm = spread_dirs(64, 2)
    plain, kern = both_routes(s, o, dd, tm)
    np.testing.assert_allclose(kern, plain, rtol=2e-5, atol=2e-6)
    _, st = trace_wavefront(s, o, dd, tm, jax.random.key(1), 1,
                            return_stats=True)
    assert st.live.shape == (1,)


@pytest.mark.parametrize("name", SCENES)
def test_scene_kernel_route_matches_plain(name):
    """Every committed scene: the full integrator with the kernels (interpret
    mode) matches the plain route on the same rays and RNG streams."""
    s = scene_file(name)
    o, d, tm = camera_rays(s, 192, seed=len(name))
    ls = 4 if any(s.lights.is_area) else 1
    plain, kern = both_routes(s, o, d, tm, light_samples=ls)
    assert np.isfinite(kern).all()
    np.testing.assert_allclose(kern, plain, rtol=1e-4, atol=1e-5)
