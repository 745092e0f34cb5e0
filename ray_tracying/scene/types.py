"""Scene representation: a frozen SoA pytree of device arrays.

The reference keeps an AoS vector of polymorphic Shapes* with virtual
intersect() (Code/shapes.hpp:59-139).  Here virtual dispatch and AoS are
replaced by struct-of-arrays tables — one unified table for all
*transformed* primitives (sphere/cube/rect share the same object-space
transform machinery, Code/shapes.cpp:92-139) plus a separate corner table
for the legacy Plane (Code/shapes.cpp:438-503), and a flat material table
indexed by primitive id.

Static (non-pytree) fields capture scene facts known at trace time so jit
can specialize: whether any material refracts (queue branching factor),
whether any sphere moves (motion-blur math), texture presence.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def _static(default):
    """A dataclass field that is pytree metadata: hashed into jit cache
    keys instead of traced."""
    return dataclasses.field(default=default, metadata={"static": True})


def _pytree_dataclass(cls):
    """Frozen dataclass registered as a pytree; fields made with _static
    are metadata, the rest are children.  `replace` returns a copy with
    some fields swapped."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = dataclasses.replace
    return cls

# Primitive kind codes for the unified transformed-primitive table.
KIND_SPHERE = 0  # unit sphere, |p|=1         (Code/shapes.cpp:200-262)
KIND_CUBE = 1    # unit cube, [-0.5,0.5]^3    (Code/shapes.cpp:355-423)
KIND_RECT = 2    # unit square on z=0         (Code/shapes.cpp:299-333)


@_pytree_dataclass
class Materials:
    """Per-primitive material table, length = n_prims + n_planes.

    Matches Material fields (Code/material.hpp:47-77); tex_id is -1 when the
    primitive has no texture (texture atlas lives in Scene.tex_*)."""

    diffuse: jnp.ndarray        # (M, 3)
    specular: jnp.ndarray       # (M, 3)
    k_ambient: jnp.ndarray      # (M,)
    k_diffuse: jnp.ndarray      # (M,)
    k_specular: jnp.ndarray     # (M,)
    shininess: jnp.ndarray      # (M,)
    roughness: jnp.ndarray      # (M,)
    reflectivity: jnp.ndarray   # (M,)
    transparency: jnp.ndarray   # (M,)
    ior: jnp.ndarray            # (M,)
    tex_id: jnp.ndarray         # (M,) int32, -1 = none


@_pytree_dataclass
class Primitives:
    """Unified transformed primitives (spheres, cubes, rectangles)."""

    kind: jnp.ndarray      # (P,) int32 in {KIND_SPHERE, KIND_CUBE, KIND_RECT}
    o2w: jnp.ndarray       # (P, 3, 4) object->world affine
    w2o: jnp.ndarray       # (P, 3, 4) world->object affine (analytic inverse)
    velocity: jnp.ndarray  # (P, 3) motion-blur velocity; zero for non-spheres


@_pytree_dataclass
class Planes:
    """Legacy explicit-corner quads (Code/shapes.cpp:438-503)."""

    corners: jnp.ndarray  # (Q, 4, 3)


@_pytree_dataclass
class Lights:
    """Point / spherical-area lights (Code/light.hpp:5-14)."""

    position: jnp.ndarray   # (L, 3)
    color: jnp.ndarray      # (L, 3)
    intensity: jnp.ndarray  # (L,)
    radius: jnp.ndarray     # (L,)
    # Static: per-light "is an area light" flags frozen at load time so the
    # integrator can give radius==0 lights exactly 1 shadow sample
    # (Code/raytracer.cpp:207) without dynamic shapes.
    is_area: Tuple[bool, ...] = _static(())


@_pytree_dataclass
class Camera:
    """Pinhole / thin-lens camera (Code/camera.{hpp,cpp})."""

    location: jnp.ndarray      # (3,)
    gaze: jnp.ndarray          # (3,)
    up: jnp.ndarray            # (3,)
    focal_length: jnp.ndarray  # () mm
    aperture: jnp.ndarray      # () lens diameter; <=0 degrades to pinhole
    focus_dist: jnp.ndarray    # ()
    sensor_wh: jnp.ndarray     # (2,) mm
    # Render resolution is static: it shapes every downstream array.
    resolution: Tuple[int, int] = _static((0, 0))


@_pytree_dataclass
class Scene:
    camera: Camera
    lights: Lights
    prims: Primitives
    planes: Planes
    materials: Materials
    # Texture atlas: all loaded textures padded to a common (H, W); absent
    # textures fail-soft to the plain diffuse color exactly like the
    # reference (Code/json_loader.cpp:83-86).
    tex_atlas: Optional[jnp.ndarray] = None   # (T, H, W, 3) float32 in [0,1]
    tex_wh: Optional[jnp.ndarray] = None      # (T, 2) int32 true (w, h)

    # --- static trace-time facts ---
    n_prims: int = _static(0)
    n_planes: int = _static(0)
    n_lights: int = _static(0)
    has_refraction: bool = _static(False)
    has_reflection: bool = _static(False)
    # True iff SOME single material both reflects AND refracts — the only
    # case with branching factor 2 (Code/raytracer.cpp:308-344 runs both
    # branches for one hit).  Scenes that merely contain mirrors AND glass
    # on different materials spawn at most one continuation per ray and
    # keep the in-slot queue discipline.
    has_two_way: bool = _static(False)
    has_glossy: bool = _static(False)
    has_motion: bool = _static(False)
    has_textures: bool = _static(False)
    # Which primitive kinds exist — lets kernels drop dead per-kind math.
    has_spheres: bool = _static(False)
    has_cubes: bool = _static(False)
    has_rects: bool = _static(False)
    # Static (n_spheres, n_cubes, n_rects) of the load-order primitive
    # table: the intersection kernels run one loop per kind over it.
    kind_counts: Tuple[int, int, int] = _static((0, 0, 0))

    @property
    def n_geoms(self) -> int:
        """Total primitive count (transformed prims + planes)."""
        return self.n_prims + self.n_planes
