"""Stable op-level API: the batched primitives the renderer is built from.

Each op is jittable, differentiable where meaningful (hit DECISIONS are
piecewise-constant and carry zero-gradient custom VJPs; hit ATTRIBUTES and
shading are smooth).  Pass 1 of intersection runs as the Triton kernels
on the GPU and as the plain jnp path elsewhere (render/intersect.route).  This is the surface to target when composing
a custom integrator instead of render/pipeline's Whitted one.
"""

from ray_tracying.accel.lbvh import build_lbvh
from ray_tracying.core.sampling import (
    uniform_in_unit_disk,
    uniform_in_unit_sphere,
)
from ray_tracying.core.transforms import (
    apply_normal,
    apply_point,
    apply_vector,
    build_trs,
)
from ray_tracying.core.vecmath import dot, normalize, reflect, refract
from ray_tracying.render.camera import pixel_rays
from ray_tracying.render.integrator import trace_wavefront
from ray_tracying.render.intersect import (
    Hit,
    all_hit_t,
    closest_hit,
    min_hit_t,
    occluded,
)
from ray_tracying.render.materials import gather_materials
from ray_tracying.render.shade import shade

__all__ = [
    "Hit",
    "all_hit_t",
    "apply_normal",
    "apply_point",
    "apply_vector",
    "build_lbvh",
    "build_trs",
    "closest_hit",
    "dot",
    "gather_materials",
    "min_hit_t",
    "normalize",
    "occluded",
    "pixel_rays",
    "reflect",
    "refract",
    "shade",
    "trace_wavefront",
    "uniform_in_unit_disk",
    "uniform_in_unit_sphere",
]
