"""Batched ray/scene intersection — replaces the reference's per-shape
virtual dispatch (Code/shapes.cpp) and BVH recursion
(Code/acceleration.cpp).

Design: two-pass closest hit over SoA primitive tables.

  Pass 1 finds the winning geom per ray.  On the GPU it runs as the Triton
  kernels of kernels/closest_hit.py; elsewhere as `all_hit_t`, a dense
  (rays x geoms) matrix of hit distances (+inf on miss) reduced by
  min/argmin, which XLA fuses.  Both use the reference's Euclidean-distance
  semantics (Code/shapes.cpp:251-253 etc.): for affine TRS transforms the
  world hit point is exactly origin + t_loc * dir, so euclidean_t ==
  t_loc * |dir|, and all traced rays have unit |dir|.  Legacy planes use
  the parametric t (Code/shapes.cpp:458,481) — faithfully mixed semantics.
  `route` picks the path per backend.

  Pass 2 (`closest_hit`): per-ray attribute reconstruction for the argmin
  winner only (point, normal, uv) — O(R) instead of O(R*G).

The brute-force pass 1 mirrors `-bvh` off (intersect_linear,
Code/acceleration.cpp:124-139); the reference's BVH produces the identical
hit set (SURVEY.md §2 quirk 15).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ray_tracying.core import constants as C
from ray_tracying.core.gather import onehot_gather
from ray_tracying.core.transforms import apply_normal, apply_point, apply_vector
from ray_tracying.core.vecmath import (
    cross, dot, normalize, safe_arcsin, safe_sqrt,
)
from ray_tracying.kernels import closest_hit as K
from ray_tracying.scene.types import KIND_CUBE, KIND_RECT, KIND_SPHERE, Scene

# Python float, not jnp scalar: a module-level jnp constant would allocate
# on (and force init of) the default backend at import time.
_INF = float("inf")


# Intersection routes.  "auto": the Triton kernels of
# kernels/closest_hit.py on the "gpu" backend, the plain jnp path on every
# other backend.  "plain": the plain path everywhere (the reference the
# kernels are compared with).  "interpret": the kernels in the Pallas
# interpreter, which only tests ask for.
ROUTES = ("auto", "plain", "interpret")


def route(scene: Scene, intersect: str = "auto") -> str:
    """-> "kernel", "interpret" or "plain" for this scene and backend.
    Scenes the kernels cannot address (no geometry, or a primitive table
    not in the loader's kind order) take the plain path."""
    if intersect not in ROUTES:
        raise ValueError(f"intersect must be one of {ROUTES}, got {intersect!r}")
    if intersect == "plain" or not K.supported(scene):
        return "plain"
    if intersect == "interpret":
        return "interpret"
    return "kernel" if jax.default_backend() == "gpu" else "plain"


class Hit(NamedTuple):
    """Closest-hit record for a batch of rays (all fields shape (R, ...))."""

    valid: jnp.ndarray    # (R,) bool
    geom_id: jnp.ndarray  # (R,) int32 into the global geom/material table
    t: jnp.ndarray        # (R,) reference-semantics hit distance
    point: jnp.ndarray    # (R, 3) world intersection point
    normal: jnp.ndarray   # (R, 3) world unit normal
    uv: jnp.ndarray       # (R, 2)


# ---------------------------------------------------------------------------
# Object-space primitive tests (t only).  o, d: (..., 3) object-space ray.
# Each returns t_loc with +inf for miss.
# ---------------------------------------------------------------------------

def _sphere_t(o: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Unit-sphere quadratic with the 0.001 t-min and near-then-far root
    choice (Code/shapes.cpp:219-232)."""
    a = dot(d, d)
    b = 2.0 * dot(o, d)
    c = dot(o, o) - 1.0
    disc = b * b - 4.0 * a * c
    sq = safe_sqrt(disc)  # grad-safe at the disc<=0 (miss) boundary
    # a == 0 only for degenerate (masked-out) rays; guard the division so
    # NaNs never enter the min/argmin reduction.
    a_safe = jnp.where(a > 0.0, a, 1.0)
    t1 = (-b - sq) / (2.0 * a_safe)
    t2 = (-b + sq) / (2.0 * a_safe)
    t = jnp.where(t1 > C.EPS_T_MIN, t1, jnp.where(t2 > C.EPS_T_MIN, t2, _INF))
    return jnp.where((disc >= 0.0) & (a > 0.0), t, _INF)


def _cube_slabs(o: jnp.ndarray, d: jnp.ndarray):
    """Shared slab computation for the unit cube [-0.5, 0.5]^3
    (Code/shapes.cpp:361-392).  Returns (t_near, t_far, entry_t_per_axis,
    entry_sign_per_axis, miss)."""
    parallel = jnp.abs(d) < C.EPS_PARALLEL
    outside_parallel = parallel & ((o < -0.5) | (o > 0.5))
    d_safe = jnp.where(parallel, 1.0, d)
    t1 = (-0.5 - o) / d_safe
    t2 = (0.5 - o) / d_safe
    t_entry = jnp.minimum(t1, t2)
    t_exit = jnp.maximum(t1, t2)
    # hit_sign: -1 when the min-plane is entered first (t1 < t2), else +1
    # (Code/shapes.cpp:385).
    entry_sign = jnp.where(t1 < t2, -1.0, 1.0)
    # Parallel axes never win the entry max nor tighten the exit min.
    t_entry = jnp.where(parallel, -_INF, t_entry)
    t_exit = jnp.where(parallel, _INF, t_exit)
    t_near = jnp.max(t_entry, axis=-1)
    t_far = jnp.min(t_exit, axis=-1)
    miss = jnp.any(outside_parallel, axis=-1) | (t_near > t_far) | (t_far < 0.0)
    return t_near, t_far, t_entry, entry_sign, miss


def _cube_t(o: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """NOTE: the cube uses t > 0, NOT the 0.001 epsilon
    (Code/shapes.cpp:392-393)."""
    t_near, t_far, _, _, miss = _cube_slabs(o, d)
    t = jnp.where(t_near > 0.0, t_near, t_far)
    return jnp.where(miss | (t < 0.0), _INF, t)


def _rect_t(o: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Unit square on z=0, [-0.5, 0.5]^2 (Code/shapes.cpp:305-315)."""
    dz = d[..., 2]
    parallel = jnp.abs(dz) < C.EPS_PARALLEL
    t = -o[..., 2] / jnp.where(parallel, 1.0, dz)
    hx = o[..., 0] + t * d[..., 0]
    hy = o[..., 1] + t * d[..., 1]
    ok = (
        ~parallel
        & (t >= C.EPS_T_MIN)  # reference: t < 0.001 -> miss
        & (hx >= -0.5) & (hx <= 0.5) & (hy >= -0.5) & (hy <= 0.5)
    )
    return jnp.where(ok, t, _INF)


def _plane_geometry(corners: jnp.ndarray):
    """corners: (..., 4, 3) -> (unit_normal, degenerate_mask)."""
    e1 = corners[..., 1, :] - corners[..., 0, :]
    e2 = corners[..., 2, :] - corners[..., 0, :]
    n = cross(e1, e2)
    ln = jnp.sqrt(dot(n, n))
    degenerate = ln < C.EPS_PARALLEL
    n = n / jnp.where(degenerate, 1.0, ln)[..., None]
    return n, degenerate


def _point_in_tri(p, a, b, c, n):
    """Edge-sign test with the reference's -1e-6 tolerance
    (Code/shapes.cpp:24-40)."""
    s1 = dot(cross(b - a, p - a), n) >= C.EPS_PLANE_EDGE
    s2 = dot(cross(c - b, p - b), n) >= C.EPS_PLANE_EDGE
    s3 = dot(cross(a - c, p - c), n) >= C.EPS_PLANE_EDGE
    return s1 & s2 & s3


def _plane_t(corners: jnp.ndarray, o: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Legacy quad: parametric t, two-triangle containment
    (Code/shapes.cpp:444-483).  corners broadcast against o/d."""
    n, degenerate = _plane_geometry(corners)
    denom = dot(n, d)
    parallel = jnp.abs(denom) < C.EPS_PARALLEL
    t = dot(corners[..., 0, :] - o, n) / jnp.where(parallel, 1.0, denom)
    p = o + t[..., None] * d
    c0, c1, c2, c3 = (corners[..., i, :] for i in range(4))
    inside = _point_in_tri(p, c1, c3, c2, n) | _point_in_tri(p, c0, c1, c2, n)
    ok = ~degenerate & ~parallel & (t >= 0.0) & inside
    return jnp.where(ok, t, _INF)


# ---------------------------------------------------------------------------
# Pass 1: dense hit-distance matrix + min reduction
# ---------------------------------------------------------------------------

def _prims_object_rays(scene: Scene, o, d, time):
    """Transform rays into every transformed-prim's object space.

    o, d: (R, 3); time: (R,).  Returns o_loc, d_loc: (R, P, 3).
    Motion blur shifts the ray origin by -velocity * time before the
    transform (Code/shapes.cpp:201-215); velocity is zero for non-spheres.
    """
    # (R, P, 3): shift origins per prim by motion.
    o_shift = o[:, None, :] - scene.prims.velocity[None, :, :] * time[:, None, None]
    w2o = scene.prims.w2o[None]  # (1, P, 3, 4)
    # Explicit mul-add, NOT einsum: a K=3 dot_general may run in reduced
    # precision (see core/transforms.py note).
    o_loc = (
        w2o[..., :, 0] * o_shift[..., 0:1]
        + w2o[..., :, 1] * o_shift[..., 1:2]
        + w2o[..., :, 2] * o_shift[..., 2:3]
        + w2o[..., :, 3]
    )
    dr = d[:, None, :]
    d_loc = (
        w2o[..., :, 0] * dr[..., 0:1]
        + w2o[..., :, 1] * dr[..., 1:2]
        + w2o[..., :, 2] * dr[..., 2:3]
    )
    return o_loc, d_loc


def all_hit_t(scene: Scene, o, d, time) -> jnp.ndarray:
    """(R, G) matrix of reference-semantics hit distances, +inf = miss.

    Geom order is sphere/cube/rect table then planes, matching the
    reference's load order so that argmin tie-breaks agree with
    min_element / intersect_linear first-wins (Code/acceleration.cpp:112,133).
    """
    parts = []
    if scene.n_prims:
        o_loc, d_loc = _prims_object_rays(scene, o, d, time)
        kind = scene.prims.kind[None, :]
        t_s = _sphere_t(o_loc, d_loc)
        t_c = _cube_t(o_loc, d_loc)
        t_r = _rect_t(o_loc, d_loc)
        t_loc = jnp.where(
            kind == KIND_SPHERE, t_s, jnp.where(kind == KIND_CUBE, t_c, t_r)
        )
        # Euclidean world distance == t_loc * |d| (see module docstring).
        d_norm = jnp.sqrt(dot(d, d))[:, None]
        parts.append(t_loc * d_norm)
    if scene.n_planes:
        t_p = _plane_t(
            scene.planes.corners[None, :, :, :], o[:, None, :], d[:, None, :]
        )
        parts.append(t_p)
    if not parts:
        return jnp.full(o.shape[:1] + (0,), _INF)
    return jnp.concatenate(parts, axis=1)


def min_hit_t(scene: Scene, o, d, time, active=None, intersect="auto"):
    """Closest hit distance per ray, +inf on miss.  This is all shadow
    visibility needs (visible iff min_t > light_dist, Code/raytracer.cpp:233).

    active: optional (R,) bool mask; on the kernel route, blocks of
    inactive rays are skipped and report a miss.  The brute-force hit set
    is the reference's with or without -bvh
    (Code/acceleration.cpp:124-151; SURVEY.md §2 quirk 15)."""
    if scene.n_geoms == 0:
        return jnp.full(o.shape[:1], _INF)
    how = route(scene, intersect)
    if how != "plain":
        t, _ = K.closest_hit_tid(scene, o, d, time, active, how == "interpret")
        return t
    return jnp.min(all_hit_t(scene, o, d, time), axis=1)


def occluded(scene: Scene, o, d, maxt, active=None, intersect="auto"):
    """(R,) bool: some geom blocks the ray at distance <= maxt.

    The complement of the reference's shadow visibility test
    `shadow_hit.t > light_dist` (Code/raytracer.cpp:233-235).  On the kernel
    route this is an any-hit test that stops once every ray of a block is
    occluded.  Shadow rays carry time = 0 (Ray default, Code/shapes.hpp:28)."""
    if scene.n_geoms == 0:
        return jnp.zeros(o.shape[:1], bool)
    how = route(scene, intersect)
    if how != "plain":
        return K.occluded_tid(scene, o, d, maxt, active, how == "interpret")
    return min_hit_t(scene, o, d, jnp.zeros(o.shape[:1]), intersect="plain") <= maxt


# ---------------------------------------------------------------------------
# Pass 2: attribute reconstruction for the winning geom
# ---------------------------------------------------------------------------

def _prim_attributes(scene: Scene, pid, o, d, time):
    """Reconstruct hit attributes for transformed prims.  pid: (R,) int32
    clipped to valid range; returns per-field (R, ...) plus recomputed
    validity-t (callers rely on the pass-1 winner, not this t).

    Per-ray primitive records are fetched with one-hot matmuls
    (core/gather.py); a plain table[pid] gather is unmeasured on the GPU
    (ROADMAP A5)."""
    packed = jnp.concatenate(
        [
            scene.prims.w2o.reshape(-1, 12),
            scene.prims.o2w.reshape(-1, 12),
            scene.prims.velocity,
            scene.prims.kind[:, None].astype(jnp.float32),
        ],
        axis=1,
    )  # (P, 28)
    rec = onehot_gather(packed, pid)
    w2o = rec[:, 0:12].reshape(-1, 3, 4)
    o2w = rec[:, 12:24].reshape(-1, 3, 4)
    vel = rec[:, 24:27]
    kind = jnp.round(rec[:, 27]).astype(jnp.int32)

    o_shift = o - vel * time[:, None]
    o_loc = apply_point(w2o, o_shift)
    d_loc = apply_vector(w2o, d)

    # --- sphere ---
    t_sph = _sphere_t(o_loc, d_loc)
    t_sph = jnp.where(jnp.isfinite(t_sph), t_sph, 0.0)  # grad-safe miss
    p_sph = o_loc + t_sph[..., None] * d_loc
    n_sph = p_sph
    pi = jnp.float32(3.1415926535)
    u_sph = 0.5 + jnp.arctan2(p_sph[..., 2], p_sph[..., 0]) / (2.0 * pi)
    v_sph = 0.5 - safe_arcsin(jnp.clip(p_sph[..., 1], -1.0, 1.0)) / pi

    # --- cube ---
    t_near, t_far, t_entry, entry_sign, miss = _cube_slabs(o_loc, d_loc)
    t_cub = jnp.where(t_near > 0.0, t_near, t_far)
    t_cub = jnp.where(miss | (t_cub < 0.0) | ~jnp.isfinite(t_cub), 0.0, t_cub)
    p_cub = o_loc + t_cub[..., None] * d_loc
    # Normal comes from the ENTRY face even when the exit t is used
    # (the reference never updates hit_axis for t_far, Code/shapes.cpp:392-402).
    axis = jnp.argmax(t_entry, axis=-1)
    # Select-by-axis: a three-way where, no gather.
    sign = jnp.where(
        axis == 0,
        entry_sign[..., 0],
        jnp.where(axis == 1, entry_sign[..., 1], entry_sign[..., 2]),
    )
    n_cub = jnp.zeros_like(p_cub).at[..., 0].set(
        jnp.where(axis == 0, sign, 0.0)
    )
    n_cub = n_cub.at[..., 1].set(jnp.where(axis == 1, sign, 0.0))
    n_cub = n_cub.at[..., 2].set(jnp.where(axis == 2, sign, 0.0))
    uc = p_cub[..., 0] + 0.5
    vc = p_cub[..., 1] + 0.5
    wc = p_cub[..., 2] + 0.5
    pos = sign > 0.0
    u_cub = jnp.where(
        axis == 0, jnp.where(pos, wc, 1.0 - wc),
        jnp.where(axis == 1, uc, jnp.where(pos, uc, 1.0 - uc)),
    )
    v_cub = jnp.where(
        axis == 0, vc, jnp.where(axis == 1, jnp.where(pos, wc, 1.0 - wc), vc)
    )

    # --- rect ---
    t_rec = _rect_t(o_loc, d_loc)
    t_rec = jnp.where(jnp.isfinite(t_rec), t_rec, 0.0)  # grad-safe miss
    p_rec = o_loc + t_rec[..., None] * d_loc
    p_rec = p_rec.at[..., 2].set(0.0)
    n_rec = jnp.zeros_like(p_rec).at[..., 2].set(1.0)
    u_rec = p_rec[..., 0] + 0.5
    v_rec = p_rec[..., 1] + 0.5

    is_s = (kind == KIND_SPHERE)[..., None]
    is_c = (kind == KIND_CUBE)[..., None]
    p_loc = jnp.where(is_s, p_sph, jnp.where(is_c, p_cub, p_rec))
    n_loc = jnp.where(is_s, n_sph, jnp.where(is_c, n_cub, n_rec))
    u = jnp.where(is_s[..., 0], u_sph, jnp.where(is_c[..., 0], u_cub, u_rec))
    v = jnp.where(is_s[..., 0], v_sph, jnp.where(is_c[..., 0], v_cub, v_rec))

    # World point: transformed at time 0 then advected (Code/shapes.cpp:243-248).
    point = apply_point(o2w, p_loc) + vel * time[:, None]
    normal = apply_normal(w2o, n_loc)
    # Reference recomputes t as the Euclidean distance from the true origin
    # (Code/shapes.cpp:251-253).  safe_sqrt: masked slots can have point==o.
    t = safe_sqrt(dot(point - o, point - o))
    return point, normal, u, v, t


def _plane_attributes(scene: Scene, qid, o, d):
    """Legacy plane attribute reconstruction (Code/shapes.cpp:444-482)."""
    corners = onehot_gather(scene.planes.corners, qid)  # (R, 4, 3)
    n, _ = _plane_geometry(corners)
    denom = dot(n, d)
    safe = jnp.where(jnp.abs(denom) < C.EPS_PARALLEL, 1.0, denom)
    t = dot(corners[:, 0, :] - o, n) / safe
    p = o + t[..., None] * d
    vec_u = corners[:, 1, :] - corners[:, 0, :]
    vec_v = corners[:, 3, :] - corners[:, 0, :]
    hv = p - corners[:, 0, :]
    u = jnp.clip(dot(hv, vec_u) / jnp.maximum(dot(vec_u, vec_u), 1e-20), 0.0, 1.0)
    v = jnp.clip(dot(hv, vec_v) / jnp.maximum(dot(vec_v, vec_v), 1e-20), 0.0, 1.0)
    return p, n, u, v, t


def closest_hit(scene: Scene, o, d, time, active=None, intersect="auto") -> Hit:
    """Full closest-hit: pass-1 winner search then pass-2 attribute rebuild.

    Pass 1 runs as the Triton kernel on the GPU (kernels/closest_hit.py)
    or as the dense jnp reduction elsewhere; both find the same winners.
    Pass 2 is differentiable jnp either way: gradients flow to scene
    parameters with the hit id held fixed."""
    if scene.n_geoms == 0:
        r = o.shape[0]
        return Hit(
            valid=jnp.zeros(r, bool),
            geom_id=jnp.full(r, -1, jnp.int32),
            t=jnp.full(r, _INF),
            point=jnp.zeros((r, 3)),
            normal=jnp.zeros((r, 3)),
            uv=jnp.zeros((r, 2)),
        )
    how = route(scene, intersect)
    if how != "plain":
        t_min, gid = K.closest_hit_tid(
            scene, o, d, time, active, how == "interpret"
        )
        gid = jnp.maximum(gid, 0)
    else:
        tm = all_hit_t(scene, o, d, time)
        gid = jnp.argmin(tm, axis=1).astype(jnp.int32)
        t_min = jnp.min(tm, axis=1)  # second fused reduction beats a gather
    valid = jnp.isfinite(t_min)

    if scene.n_prims and scene.n_planes:
        pid = jnp.clip(gid, 0, scene.n_prims - 1)
        qid = jnp.clip(gid - scene.n_prims, 0, scene.n_planes - 1)
        p1, n1, u1, v1, t1 = _prim_attributes(scene, pid, o, d, time)
        p2, n2, u2, v2, t2 = _plane_attributes(scene, qid, o, d)
        is_plane = gid >= scene.n_prims
        point = jnp.where(is_plane[:, None], p2, p1)
        normal = jnp.where(is_plane[:, None], n2, n1)
        u = jnp.where(is_plane, u2, u1)
        v = jnp.where(is_plane, v2, v1)
        t = jnp.where(is_plane, t2, t1)
    elif scene.n_prims:
        pid = jnp.clip(gid, 0, scene.n_prims - 1)
        point, normal, u, v, t = _prim_attributes(scene, pid, o, d, time)
    else:
        qid = jnp.clip(gid, 0, scene.n_planes - 1)
        point, normal, u, v, t = _plane_attributes(scene, qid, o, d)

    t = jnp.where(valid, t, _INF)
    return Hit(
        valid=valid,
        geom_id=jnp.where(valid, gid, -1),
        t=t,
        point=point,
        normal=normal,
        uv=jnp.stack([u, v], axis=-1),
    )
