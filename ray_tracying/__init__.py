"""ray_tracying — a differentiable Whitted ray tracer in JAX.

A ground-up JAX/XLA/Pallas reimplementation of the capabilities of the
reference C++ renderer (EricZhang12138/Ray_Tracying): recursive Whitted
shading with distributed-ray-tracing effects (stratified antialiasing,
soft shadows from spherical area lights, thin-lens depth of field, motion
blur, glossy reflection), loaded from the same scene.json schema, with
the hit set of the reference's BVH.

Architecture (nothing here is a translation of the reference C++):
  - scene/   : scene.json -> frozen SoA pytree of arrays
  - core/    : vec math, transforms, sampling (counter-based jax.random)
  - accel/   : LBVH build (host + C++)
  - kernels/ : Pallas (Triton route) kernels for GPU intersection
  - render/  : camera ray gen + iterative wavefront integrator
  - parallel/: multi-device sharding (Mesh + shard_map) over pixel tiles
  - diff/    : differentiable rendering / inverse-rendering optimizers
  - io/      : PPM P3 codec (byte-compatible with the reference)
  - cli/     : command line mirroring the reference flags
"""

from ray_tracying.scene.types import (
    Scene,
    Camera,
    Lights,
    Materials,
    Primitives,
    Planes,
    KIND_SPHERE,
    KIND_CUBE,
    KIND_RECT,
)
from ray_tracying.scene.loader import load_scene, load_scene_dict
from ray_tracying.render.pipeline import (
    RenderOptions,
    render_image,
    render_to_srgb_u8,
)
from ray_tracying.io.ppm import read_ppm, write_ppm

__version__ = "0.1.0"

__all__ = [
    "Scene",
    "Camera",
    "Lights",
    "Materials",
    "Primitives",
    "Planes",
    "KIND_SPHERE",
    "KIND_CUBE",
    "KIND_RECT",
    "load_scene",
    "load_scene_dict",
    "RenderOptions",
    "render_image",
    "render_to_srgb_u8",
    "read_ppm",
    "write_ppm",
]
