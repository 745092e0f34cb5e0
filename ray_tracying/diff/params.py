"""Optimizable-parameter plumbing for inverse rendering.

A parameter set is a flat dict mapping dotted paths into the Scene pytree
(e.g. "materials.diffuse", "lights.intensity", "camera.location") to
arrays.  `extract` pulls current values, `apply` returns a new Scene with
them swapped in — Scene is a frozen pytree dataclass, so this is pure.

The reference has no trainable anything; this subsystem exists for the
BASELINE.json differentiable configs (pixel gradients -> material albedo /
roughness, light position/intensity, camera parameters).
"""

from __future__ import annotations

from typing import Dict, Iterable

import jax.numpy as jnp

from ray_tracying.scene.types import Scene

# Paths that make sense to optimize (guards against typos).
SUPPORTED_PREFIXES = ("materials.", "lights.", "camera.", "prims.", "planes.", "tex_atlas")


def extract(scene: Scene, paths: Iterable[str]) -> Dict[str, jnp.ndarray]:
    out = {}
    for path in paths:
        node = scene
        for part in path.split("."):
            node = getattr(node, part)
        out[path] = node
    return out


def apply(scene: Scene, params: Dict[str, jnp.ndarray]) -> Scene:
    """Return a Scene with the given leaves replaced.

    The integrator's queue discipline is chosen STATICALLY from the
    scene's routing flags (has_reflection / has_refraction / has_two_way,
    computed at load time from reflectivity/transparency > 0).  Parameter
    updates must not change that classification: e.g. optimizing
    reflectivity above 0 on a transparent material would silently leave
    the one-continuation-per-ray route in place and drop the reflection
    branch and its gradients.  When the new values are concrete (eager /
    outside jit) this is verified here; under jit the values are tracers
    and the caller owns the invariant (keep a sign-preserving
    parametrization, e.g. optimize through a scaled sigmoid that cannot
    cross zero)."""
    # Group by top-level field.
    by_top: Dict[str, Dict[str, jnp.ndarray]] = {}
    direct: Dict[str, jnp.ndarray] = {}
    for path, val in params.items():
        if not path.startswith(SUPPORTED_PREFIXES):
            raise KeyError(f"unsupported parameter path: {path}")
        if "." in path:
            top, rest = path.split(".", 1)
            by_top.setdefault(top, {})[rest] = val
        else:
            direct[path] = val
    updates = dict(direct)
    for top, subs in by_top.items():
        node = getattr(scene, top)
        updates[top] = node.replace(**subs)
    new_scene = scene.replace(**updates)

    mats = by_top.get("materials", {})
    if ("reflectivity" in mats) or ("transparency" in mats):
        import jax.core

        refl = new_scene.materials.reflectivity
        trans = new_scene.materials.transparency
        concrete = not (
            isinstance(refl, jax.core.Tracer)
            or isinstance(trans, jax.core.Tracer)
        )
        if concrete:
            flags = (
                bool((refl > 0).any()),
                bool((trans > 0).any()),
                bool(((refl > 0) & (trans > 0)).any()),
            )
            old = (
                scene.has_reflection,
                scene.has_refraction,
                scene.has_two_way,
            )
            if flags != old:
                raise ValueError(
                    "parameter update changes the scene's static ray-"
                    f"routing classification {old} -> {flags} "
                    "(reflection/refraction/two-way); reload the scene "
                    "or keep reflectivity/transparency on the same side "
                    "of zero (see diff.params.apply docstring)"
                )
    return new_scene
