"""Local Blinn-Phong shading with stochastic soft shadows, batched over a
ray wavefront.

Reproduces `shade` (Code/raytracer.cpp:180-274) exactly:
  - ambient = diffuse * k_ambient (:194)
  - per light: `light_samples` shadow rays toward points jittered uniformly
    in a sphere of the light's radius; radius == 0 -> exactly 1 hard-shadow
    sample (:207)
  - shadow origin offset +1e-4 * N (:227); visible iff no hit or closest
    hit beyond the sampled light distance (:233-235)
  - Blinn-Phong terms evaluated from the light CENTER even for area lights;
    only visibility is stochastic (:244-259)
  - attenuation 10*I / (25 + 10*d + 150*d^2) (:262)

Texture sampling matches Material::getDiffuseColor (Code/material.hpp:99-134):
nearest-neighbor, v flipped, multiplied by the base diffuse tint.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ray_tracying.core import constants as C
from ray_tracying.core.sampling import uniform_in_unit_sphere
from ray_tracying.core.vecmath import dot, normalize, safe_sqrt
from ray_tracying.render.intersect import Hit, occluded
from ray_tracying.render.materials import MatRec, gather_materials
from ray_tracying.scene.types import Scene


def safe_pow(base: jnp.ndarray, exp: jnp.ndarray) -> jnp.ndarray:
    """pow with well-defined value AND gradient at base == 0.

    C++ pow(0, s) = 0 for s > 0; jnp.power(0., s) is 0 but its gradient is
    NaN.  We clamp the base away from zero inside the power and select the
    exact 0 outside, keeping the forward value bit-identical and the
    gradient finite (needed by diff/)."""
    tiny = 1e-12
    safe = jnp.power(jnp.maximum(base, tiny), exp)
    return jnp.where(base > 0.0, safe, 0.0)


def sample_diffuse_color(scene: Scene, mrec: MatRec, uv: jnp.ndarray):
    """Per-ray textured diffuse color (Code/material.hpp:99-134)."""
    base = mrec.diffuse
    if not scene.has_textures:
        return base
    tid = mrec.tex_id
    tid_safe = jnp.maximum(tid, 0)
    wh = scene.tex_wh[tid_safe]  # (R, 2) = (w, h)
    w = wh[:, 0].astype(jnp.float32)
    h = wh[:, 1].astype(jnp.float32)
    # x = int(u * (w-1)), y = int((1-v) * (h-1)): C-style truncation; uv is
    # in [0,1] for every primitive so truncation == floor.
    x = jnp.clip(jnp.floor(uv[:, 0] * (w - 1.0)), 0, w - 1).astype(jnp.int32)
    y = jnp.clip(jnp.floor((1.0 - uv[:, 1]) * (h - 1.0)), 0, h - 1).astype(jnp.int32)
    texel = scene.tex_atlas[tid_safe, y, x]  # (R, 3)
    return jnp.where((tid >= 0)[:, None], texel * base, base)


def shade(
    scene: Scene,
    hit: Hit,
    view_origin: jnp.ndarray,
    key: jax.Array,
    light_samples: int,
    mrec: MatRec | None = None,
    active=None,
    intersect: str = "auto",
) -> jnp.ndarray:
    """Local color for each hit ray.  view_origin: (R, 3) ray origins
    (the reference builds V from the ray ORIGIN, not -direction, :197).
    active: optional (R,) mask forwarded to the shadow any-hit test (the
    kernel skips blocks of inactive rays).  intersect: the pass-1 route
    (render/intersect.route).  Returns (R, 3); garbage where hit.valid is
    False (callers mask)."""
    if mrec is None:
        mrec = gather_materials(scene, hit.geom_id)
    base_diffuse = sample_diffuse_color(scene, mrec, hit.uv)

    final = base_diffuse * mrec.k_ambient[:, None]
    v_dir = normalize(view_origin - hit.point)
    n = hit.normal
    p = hit.point
    shadow_o = p + n * C.EPS_NORMAL_OFFSET

    r = p.shape[0]
    for li in range(scene.n_lights):
        l_pos = scene.lights.position[li]
        l_color = scene.lights.color[li]
        l_intensity = scene.lights.intensity[li]
        l_radius = scene.lights.radius[li]
        # Static per-light sample count: 1 hard-shadow sample for point
        # lights (Code/raytracer.cpp:207).
        s = light_samples if scene.lights.is_area[li] else 1

        # Blinn-Phong from the light center (:244-259), computed BEFORE the
        # shadow pass so lanes whose contribution is exactly zero (e.g.
        # surface facing away with no specular lobe) can skip visibility —
        # their shadow result multiplies into zero either way, and the
        # any-hit kernel skips blocks with no live lane.
        lv_c = l_pos - p
        dist_sq = dot(lv_c, lv_c)
        l_distance = safe_sqrt(dist_sq)
        l_c = normalize(lv_c)
        n_dot_l = jnp.maximum(0.0, dot(n, l_c))
        diffuse = base_diffuse * n_dot_l[:, None]
        h_vec = normalize(l_c + v_dir)
        n_dot_h = jnp.maximum(0.0, dot(n, h_vec))
        spec_i = safe_pow(n_dot_h, mrec.shininess)
        specular = mrec.specular * spec_i[:, None]
        atten = (
            C.ATTEN_NUM * l_intensity
            / (C.ATTEN_C0 + C.ATTEN_C1 * l_distance + C.ATTEN_C2 * dist_sq)
        )
        contribution = (
            l_color
            * (
                diffuse * mrec.k_diffuse[:, None]
                + specular * mrec.k_specular[:, None]
            )
            * atten[:, None]
        )
        needs_vis = jnp.any(contribution != 0.0, axis=1)  # (R,)

        k_l = jax.random.fold_in(key, li)
        if scene.lights.is_area[li]:
            offs = uniform_in_unit_sphere(k_l, (r, s)) * l_radius  # (R, S, 3)
            targets = l_pos + offs
        else:
            targets = jnp.broadcast_to(l_pos, (r, s, 3))

        lv = targets - p[:, None, :]                    # (R, S, 3)
        l_dist = safe_sqrt(dot(lv, lv))                 # (R, S)
        l_dir = normalize(lv)
        so = jnp.broadcast_to(shadow_o[:, None, :], (r, s, 3)).reshape(r * s, 3)
        sd = l_dir.reshape(r * s, 3)
        s_act = needs_vis if active is None else (active & needs_vis)
        s_act = jnp.broadcast_to(s_act[:, None], (r, s)).reshape(r * s)
        # Shadow rays carry time = 0 (Ray default member init,
        # Code/shapes.hpp:28) — motion blur does NOT apply to them.
        # Visibility via an any-hit test: visible iff NO blocker at
        # t <= light_dist == shadow_hit.t > light_dist.
        blocked = occluded(
            scene, so, sd, l_dist.reshape(r * s), s_act, intersect
        ).reshape(r, s)
        visibility = jnp.mean(1.0 - blocked.astype(jnp.float32), axis=1)  # (R,)
        final = final + contribution * visibility[:, None]

    return final
