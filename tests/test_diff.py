"""Differentiable-rendering tests: finite-difference gradient checks (the
reference has no autodiff; FD is the oracle — SURVEY.md §4) and an
inverse-rendering convergence test."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ray_tracying.diff import params as P
from ray_tracying.diff.optimize import fit
from ray_tracying.diff.render import mse_loss, render_linear
from ray_tracying.render.pipeline import RenderOptions
from ray_tracying.scene.loader import load_scene_dict

from test_scene_loader import minimal_camera


def tiny_scene(res=(24, 16)):
    d = minimal_camera()
    d["cameras"][0]["location"] = [0.0, -4.0, 1.5]
    d["cameras"][0]["gaze_vector"] = [0.0, 0.94, -0.34]
    d["cameras"][0]["up_vector"] = [0.0, 0.34, 0.94]
    d["render"] = {"resolution_x": res[0], "resolution_y": res[1]}
    d["lights"] = [
        {"location": [2.0, -2.0, 3.0], "color": [1, 1, 1], "intensity": 500.0}
    ]
    d["spheres"] = [
        {"location": [-0.6, 0.5, 0.2], "radius": 0.5,
         "material": {"diffuse_color": [0.8, 0.3, 0.2], "reflectivity": 0.3,
                      "roughness": 0.0}}
    ]
    d["rectangles"] = [
        {"translation": [0, 1, -0.5], "rotation": [0, 0, 0], "scale": [8, 8, 1],
         "material": {"diffuse_color": [0.7, 0.7, 0.7]}}
    ]
    return load_scene_dict(d)


OPTS = RenderOptions(samples_sqrt=1, light_samples=1)
KEY = jax.random.key(0)


def loss_at(scene, theta):
    return mse_loss(
        P.apply(scene, theta),
        jnp.full(scene.camera.resolution[::-1] + (3,), 0.25),
        KEY,
        OPTS,
    )


@pytest.mark.parametrize(
    "path,eps",
    [
        ("lights.intensity", 1e-1),
        ("materials.diffuse", 1e-3),
        ("materials.k_diffuse", 1e-3),
        ("lights.position", 1e-3),
        ("camera.location", 1e-4),
    ],
)
def test_grad_matches_finite_difference(path, eps):
    scene = tiny_scene()
    theta = P.extract(scene, [path])
    g = jax.grad(lambda th: loss_at(scene, th))(theta)[path]
    g = np.asarray(g)

    # Central differences on a few coordinates.
    base = np.asarray(theta[path], np.float64)
    flat_idx = list(range(min(base.size, 4)))
    for i in flat_idx:
        pert = np.zeros_like(base).reshape(-1)
        pert[i] = eps
        pert = pert.reshape(base.shape)
        lp = float(loss_at(scene, {path: jnp.asarray(base + pert, jnp.float32)}))
        lm = float(loss_at(scene, {path: jnp.asarray(base - pert, jnp.float32)}))
        fd = (lp - lm) / (2 * eps)
        an = g.reshape(-1)[i]
        # f32 render -> FD noise; require agreement on scale + sign.
        assert an == pytest.approx(fd, rel=0.15, abs=2e-4), (
            f"{path}[{i}]: analytic {an} vs FD {fd}"
        )


def test_gradients_are_finite_everywhere():
    scene = tiny_scene()
    paths = [
        "materials.diffuse", "materials.specular", "materials.roughness",
        "materials.shininess", "materials.reflectivity",
        "lights.position", "lights.intensity", "lights.color",
        "camera.location", "camera.gaze", "camera.focal_length",
        "prims.o2w", "prims.w2o",
    ]
    theta = P.extract(scene, paths)
    grads = jax.grad(lambda th: loss_at(scene, th))(theta)
    for k, v in grads.items():
        assert np.isfinite(np.asarray(v)).all(), f"non-finite grad for {k}"


def test_inverse_rendering_recovers_diffuse():
    scene_true = tiny_scene()
    target = render_linear(scene_true, KEY, OPTS)

    # Corrupt the sphere's diffuse color, then fit it back.
    wrong = scene_true.materials.diffuse.at[0].set(
        jnp.asarray([0.2, 0.7, 0.7])
    )
    scene0 = scene_true.replace(
        materials=scene_true.materials.replace(diffuse=wrong)
    )
    fitted, theta, hist = fit(
        scene0, target, ["materials.diffuse"], steps=60,
        learning_rate=5e-2, opts=OPTS, key=KEY, resample_noise=False,
    )
    assert hist[-1] < hist[0] * 0.05, f"loss did not converge: {hist[::10]}"
    got = np.asarray(theta["materials.diffuse"][0])
    np.testing.assert_allclose(got, [0.8, 0.3, 0.2], atol=0.07)


def test_fit_checkpoint_and_resume(tmp_path):
    """fit() saves checkpoints and resumes from the latest one."""
    scene_true = tiny_scene()
    target = render_linear(scene_true, KEY, OPTS)
    wrong = scene_true.materials.diffuse.at[0].set(
        jnp.asarray([0.2, 0.7, 0.7])
    )
    scene0 = scene_true.replace(
        materials=scene_true.materials.replace(diffuse=wrong)
    )
    ckdir = str(tmp_path / "ckpt")
    # First leg: 20 steps, checkpoint every 10.
    _, theta_a, hist_a = fit(
        scene0, target, ["materials.diffuse"], steps=20,
        learning_rate=5e-2, opts=OPTS, key=KEY, resample_noise=False,
        checkpoint_dir=ckdir, checkpoint_every=10,
    )
    # Second leg: asks for 40 steps; must resume at step 20 (only 20 more).
    _, theta_b, hist_b = fit(
        scene0, target, ["materials.diffuse"], steps=40,
        learning_rate=5e-2, opts=OPTS, key=KEY, resample_noise=False,
        checkpoint_dir=ckdir, checkpoint_every=10,
    )
    assert len(hist_b) == 20, "resume should skip already-run steps"
    # Reference: one uninterrupted 40-step run.
    _, theta_c, _ = fit(
        scene0, target, ["materials.diffuse"], steps=40,
        learning_rate=5e-2, opts=OPTS, key=KEY, resample_noise=False,
    )
    np.testing.assert_allclose(
        np.asarray(theta_b["materials.diffuse"]),
        np.asarray(theta_c["materials.diffuse"]),
        atol=1e-5,
    )


def test_tiled_grad_matches_whole_frame():
    """mse_loss_and_grad_tiled (gradient accumulation over row tiles —
    how high-spp frames fit device memory) must equal the whole-frame gradient on a
    deterministic scene."""
    from ray_tracying.diff.render import mse_loss_and_grad_tiled

    scene = tiny_scene(res=(24, 16))
    target = jnp.full((16, 24, 3), 0.2, jnp.float32)
    theta = P.extract(
        scene, ["materials.diffuse", "lights.intensity", "camera.location"]
    )

    def whole(th):
        return mse_loss(P.apply(scene, th), target, KEY, OPTS)

    l_ref, g_ref = jax.value_and_grad(whole)(theta)

    # 6-row tiles -> 3 tiles, last one clamped+masked (16 = 6+6+4)
    opts = RenderOptions(
        samples_sqrt=1, light_samples=1, max_rays_per_pass=24 * 6
    )
    l_t, g_t = mse_loss_and_grad_tiled(scene, theta, target, KEY, opts)
    np.testing.assert_allclose(float(l_t), float(l_ref), rtol=1e-5)
    for k in theta:
        np.testing.assert_allclose(
            np.asarray(g_t[k]), np.asarray(g_ref[k]), rtol=2e-4,
            atol=1e-6, err_msg=k,
        )


def test_fit_tiled_converges():
    """fit(tiled=True) optimizes through tiled gradient accumulation to
    the same solution as the whole-frame path."""
    scene_true = tiny_scene()
    target = render_linear(scene_true, KEY, OPTS)
    wrong = scene_true.materials.diffuse.at[0].set(
        jnp.asarray([0.2, 0.7, 0.7])
    )
    scene0 = scene_true.replace(
        materials=scene_true.materials.replace(diffuse=wrong)
    )
    opts = RenderOptions(
        samples_sqrt=1, light_samples=1, max_rays_per_pass=24 * 6
    )
    _, theta, hist = fit(
        scene0, target, ["materials.diffuse"], steps=60,
        learning_rate=5e-2, opts=opts, key=KEY, resample_noise=False,
        tiled=True,
    )
    assert hist[-1] < hist[0] * 0.05, f"loss did not converge: {hist[::10]}"
    got = np.asarray(theta["materials.diffuse"][0])
    np.testing.assert_allclose(got, [0.8, 0.3, 0.2], atol=0.07)
