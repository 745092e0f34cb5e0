"""Image-level parity against the compiled reference renderer.

Deterministic configs (pinhole, point lights, roughness-0 reflectors, 1 spp
center sampling) must match the reference PPMs to within 1 uint8 count
(float reassociation only).  Stochastic configs (soft shadows, DoF, motion
blur, glossy) are compared statistically.

Goldens are produced by tools/make_test_scenes.py from the reference C++
build (see SURVEY.md §4 — the reference ships no goldens; they are
regenerated).
"""

import os

import numpy as np
import jax
import pytest

import ray_tracying as rt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
GOLD = os.path.join(REPO, "golden", "Output")
TEX = os.path.join(REPO, "golden", "Textures")

needs_goldens = pytest.mark.skipif(
    not os.path.exists(os.path.join(GOLD, "det_basic_s1.ppm")),
    reason="golden files not generated (run tools/make_test_scenes.py)",
)


def render_vs_golden(scene_name, golden_name, samples_sqrt, light_samples, key=0):
    scene = rt.load_scene(
        os.path.join(SCENES, f"{scene_name}.json"), textures_dir=TEX
    )
    img = rt.render_to_srgb_u8(
        scene,
        rt.RenderOptions(samples_sqrt=samples_sqrt, light_samples=light_samples),
        key=jax.random.key(key),
    )
    gold = rt.read_ppm(os.path.join(GOLD, golden_name))
    return img, gold


@needs_goldens
@pytest.mark.parametrize(
    "scene,golden",
    [
        ("det_basic", "det_basic_s1.ppm"),
        ("det_mirrors", "det_mirrors_s1.ppm"),
        # TWO-WAY material (reflect AND refract on one hit) — the only
        # scene class that takes the compacted-queue discipline; proves
        # Code/raytracer.cpp:308-344 branching against the oracle.
        ("det_twoway", "det_twoway_s1.ppm"),
        ("texture", "texture_s1.ppm"),
    ],
)
def test_deterministic_parity(scene, golden):
    img, gold = render_vs_golden(scene, golden, 1, 1)
    diff = np.abs(img.astype(int) - gold.astype(int))
    assert diff.max() <= 1, f"max uint8 diff {diff.max()}"
    assert (diff > 0).mean() < 0.01, "too many off-by-one pixels"


@needs_goldens
def test_flagship_bvh_deterministic_parity():
    """The bundled 140-cube stress scene (reference ASCII/scene.json) at
    320x180 with roughness zeroed — the one scene the reference actually
    ships, proven pixel-exact, not just benchmarked."""
    img, gold = render_vs_golden("bvh_det", "bvh_det_s1.ppm", 1, 1)
    diff = np.abs(img.astype(int) - gold.astype(int))
    assert diff.max() <= 1, f"max uint8 diff {diff.max()}"
    assert (diff > 0).mean() < 0.01, "too many off-by-one pixels"


@needs_goldens
@pytest.mark.parametrize(
    "scene,golden,s,ls",
    [
        ("softshadow", "softshadow_s4_l16.ppm", 4, 16),
        # two-way branching under stratified multi-sample jitter
        ("det_twoway", "det_twoway_s6.ppm", 6, 1),
        ("dof", "dof_s6.ppm", 6, 1),
        ("motion", "motion_s6.ppm", 6, 1),
        ("glossy", "glossy_s6.ppm", 6, 1),
        ("bvh_glossy", "bvh_glossy_s8.ppm", 8, 1),
    ],
)
def test_stochastic_parity(scene, golden, s, ls):
    """Both images are Monte-Carlo estimates with different RNGs; they must
    agree in distribution: tiny mean error, small p99."""
    img, gold = render_vs_golden(scene, golden, s, ls, key=7)
    diff = np.abs(img.astype(np.float32) - gold.astype(np.float32))
    assert diff.mean() < 1.0, f"mean diff {diff.mean()}"
    assert np.percentile(diff, 99) <= 8, f"p99 {np.percentile(diff, 99)}"
