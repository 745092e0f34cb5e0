"""Closest-hit and any-hit kernels for the GPU (Pallas, Triton route).

They replace pass 1 of render/intersect.py on the card: the dense
(rays x geoms) hit matrix that `all_hit_t` builds, reduced by `min` and
`argmin`, and the same matrix reduced once more for shadow visibility.

Design for the card:

  - One ray per lane, BLOCK rays per program.  The grid has one axis over
    ray blocks; blocks run in any order, so nothing carries between them.
  - The geometry table (`pack_table`, G x 16 f32: the world->object 3x4
    and the velocity of a transformed primitive, or the 4 corners of a
    legacy plane) is read by every block as broadcast scalar loads.
  - The loader emits primitives kind by kind (spheres, cubes, rects, then
    planes), so each kind gets its own loop over a static row range and no
    row pays for the other kinds' tests.  Row order is load order, so the
    strict `<` update is the reference's first-wins tie-break
    (Code/acceleration.cpp:112,133).
  - `(best_t, best_id)` stay in registers; blocks whose rays are all
    inactive skip the loops.
  - The any-hit kernel runs a while loop per kind that stops as soon as
    every lane of the block is occluded.

The per-primitive tests mirror `all_hit_t` operation by operation: hit
distances are the reference's Euclidean t (t_loc * |d|) for transformed
primitives and the parametric t for legacy planes.

Both kernels sit inside custom VJPs with zero cotangents: hit decisions
are piecewise constant, and the differentiable attributes are rebuilt
from the winning id by render/intersect.py pass 2.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ray_tracying.core import constants as C
from ray_tracying.scene.types import Scene

# Rays per program: one ray per thread at NUM_WARPS warps of 32.
BLOCK = 128
NUM_WARPS = 4
# Primitives tested between two early-exit checks of the any-hit loop: the
# check is a block-wide reduction, so it is amortised over a few tests.
ANY_HIT_CHUNK = 4
TABLE_COLS = 16
KIND_SPHERE, KIND_CUBE, KIND_RECT, KIND_PLANE = 0, 1, 2, 3
_INF = float("inf")


def kind_ranges(scene: Scene):
    """Static (kind, start, end) row ranges of the load-order table, or None
    when the scene's kind counts do not describe its primitive table (a
    hand-built scene); such scenes take the plain path."""
    ns, nc, nr = scene.kind_counts
    if ns + nc + nr != scene.n_prims:
        return None
    counts = ((KIND_SPHERE, ns), (KIND_CUBE, nc), (KIND_RECT, nr),
              (KIND_PLANE, scene.n_planes))
    out, start = [], 0
    for kind, n in counts:
        if n:
            out.append((kind, start, start + n))
        start += n
    return tuple(out)


def supported(scene: Scene) -> bool:
    return scene.n_geoms > 0 and kind_ranges(scene) is not None


def pack_table(scene: Scene) -> jnp.ndarray:
    """(G, 16) f32 in load order.  Transformed primitives: w2o row-major in
    columns 0..11, velocity in 12..14.  Legacy planes: the 4 corners
    (x, y, z interleaved) in 0..11.  Column 15 is unused padding."""
    rows = []
    if scene.n_prims:
        p = scene.n_prims
        rows.append(jnp.concatenate(
            [scene.prims.w2o.reshape(p, 12), scene.prims.velocity,
             jnp.zeros((p, 1), jnp.float32)], axis=1))
    if scene.n_planes:
        q = scene.n_planes
        rows.append(jnp.concatenate(
            [scene.planes.corners.reshape(q, 12),
             jnp.zeros((q, 4), jnp.float32)], axis=1))
    return lax.stop_gradient(jnp.concatenate(rows, axis=0).astype(jnp.float32))


def pack_rays(o, d, time, active):
    """(R, 3) x 2 + (R,) x 2 -> (8, R_pad) rows ox oy oz dx dy dz time
    active, padded with inactive rays to a multiple of BLOCK."""
    r = o.shape[0]
    r_pad = -(-r // BLOCK) * BLOCK
    act = jnp.ones((1, r), jnp.float32) if active is None else (
        active.astype(jnp.float32)[None, :])
    rays = jnp.concatenate([o.T, d.T, time[None, :], act], axis=0)
    rays = jnp.pad(rays, ((0, 0), (0, r_pad - r)))
    return lax.stop_gradient(rays.astype(jnp.float32))


# ---------------------------------------------------------------------------
# Per-primitive hit distance of one table row against a block of rays.
# ---------------------------------------------------------------------------

def _object_ray(c, ox, oy, oz, dx, dy, dz, tm, motion):
    """World ray -> object space of row c (motion shifts the origin by
    -velocity * time first, Code/shapes.cpp:201-215)."""
    if motion:
        ox = ox - c[12] * tm
        oy = oy - c[13] * tm
        oz = oz - c[14] * tm
    olx = c[0] * ox + c[1] * oy + c[2] * oz + c[3]
    oly = c[4] * ox + c[5] * oy + c[6] * oz + c[7]
    olz = c[8] * ox + c[9] * oy + c[10] * oz + c[11]
    dlx = c[0] * dx + c[1] * dy + c[2] * dz
    dly = c[4] * dx + c[5] * dy + c[6] * dz
    dlz = c[8] * dx + c[9] * dy + c[10] * dz
    return olx, oly, olz, dlx, dly, dlz


def _sphere_t(ox, oy, oz, dx, dy, dz):
    """Unit sphere (intersect._sphere_t, Code/shapes.cpp:219-232)."""
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (ox * dx + oy * dy + oz * dz)
    c = ox * ox + oy * oy + oz * oz - 1.0
    disc = b * b - 4.0 * a * c
    sq = jnp.where(disc > 0.0, jnp.sqrt(jnp.where(disc > 0.0, disc, 1.0)), 0.0)
    a_safe = jnp.where(a > 0.0, a, 1.0)
    t1 = (-b - sq) / (2.0 * a_safe)
    t2 = (-b + sq) / (2.0 * a_safe)
    t = jnp.where(t1 > C.EPS_T_MIN, t1, jnp.where(t2 > C.EPS_T_MIN, t2, _INF))
    return jnp.where((disc >= 0.0) & (a > 0.0), t, _INF)


def _cube_t(ox, oy, oz, dx, dy, dz):
    """Unit cube slabs with t > 0 (intersect._cube_t, Code/shapes.cpp:361-393)."""
    t_near = t_far = miss = None
    for o, d in ((ox, dx), (oy, dy), (oz, dz)):
        par = jnp.abs(d) < C.EPS_PARALLEL
        d_safe = jnp.where(par, 1.0, d)
        t1 = (-0.5 - o) / d_safe
        t2 = (0.5 - o) / d_safe
        ent = jnp.where(par, -_INF, jnp.minimum(t1, t2))
        ext = jnp.where(par, _INF, jnp.maximum(t1, t2))
        out = par & ((o < -0.5) | (o > 0.5))
        if t_near is None:
            t_near, t_far, miss = ent, ext, out
        else:
            t_near = jnp.maximum(t_near, ent)
            t_far = jnp.minimum(t_far, ext)
            miss = miss | out
    miss = miss | (t_near > t_far) | (t_far < 0.0)
    t = jnp.where(t_near > 0.0, t_near, t_far)
    return jnp.where(miss | (t < 0.0), _INF, t)


def _rect_t(ox, oy, oz, dx, dy, dz):
    """Unit square on z = 0 (intersect._rect_t, Code/shapes.cpp:305-315)."""
    par = jnp.abs(dz) < C.EPS_PARALLEL
    t = -oz / jnp.where(par, 1.0, dz)
    hx = ox + t * dx
    hy = oy + t * dy
    ok = (~par & (t >= C.EPS_T_MIN) & (hx >= -0.5) & (hx <= 0.5)
          & (hy >= -0.5) & (hy <= 0.5))
    return jnp.where(ok, t, _INF)


def _plane_t(c, ox, oy, oz, dx, dy, dz):
    """Legacy quad, parametric t (intersect._plane_t,
    Code/shapes.cpp:444-483).  c[0..11] hold the 4 world corners."""
    p0, p1, p2, p3 = ((c[3 * i], c[3 * i + 1], c[3 * i + 2]) for i in range(4))

    def sub(a, b):
        return (a[0] - b[0], a[1] - b[1], a[2] - b[2])

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    n = cross(sub(p1, p0), sub(p2, p0))
    n2 = dot(n, n)
    ln = jnp.sqrt(n2)
    degenerate = ln < C.EPS_PARALLEL
    ln_safe = jnp.where(degenerate, 1.0, ln)
    n = (n[0] / ln_safe, n[1] / ln_safe, n[2] / ln_safe)
    o = (ox, oy, oz)
    d = (dx, dy, dz)
    denom = dot(n, d)
    par = jnp.abs(denom) < C.EPS_PARALLEL
    t = dot(sub(p0, o), n) / jnp.where(par, 1.0, denom)
    p = (ox + t * dx, oy + t * dy, oz + t * dz)

    def in_tri(a, b, cc):
        s1 = dot(cross(sub(b, a), sub(p, a)), n) >= C.EPS_PLANE_EDGE
        s2 = dot(cross(sub(cc, b), sub(p, b)), n) >= C.EPS_PLANE_EDGE
        s3 = dot(cross(sub(a, cc), sub(p, cc)), n) >= C.EPS_PLANE_EDGE
        return s1 & s2 & s3

    inside = in_tri(p1, p3, p2) | in_tri(p0, p1, p2)
    ok = ~degenerate & ~par & (t >= 0.0) & inside
    return jnp.where(ok, t, _INF)


def _row_t(table_ref, g, kind, rays, motion):
    """Hit distance of table row g (of static kind) for the ray block."""
    ox, oy, oz, dx, dy, dz, tm, dnorm = rays
    c = [table_ref[g, j] for j in range(15 if motion else 12)]
    if kind == KIND_PLANE:
        return _plane_t(c, ox, oy, oz, dx, dy, dz)
    loc = _object_ray(c, ox, oy, oz, dx, dy, dz, tm,
                      motion and kind == KIND_SPHERE)
    test = {KIND_SPHERE: _sphere_t, KIND_CUBE: _cube_t, KIND_RECT: _rect_t}[kind]
    return test(*loc) * dnorm


def _load_rays(rays_ref):
    rows = [rays_ref[i, :] for i in range(8)]
    dx, dy, dz = rows[3], rows[4], rows[5]
    dnorm = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    return tuple(rows[:7]) + (dnorm,), rows[7]


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def _closest_kernel(rays_ref, table_ref, t_ref, id_ref, *, ranges, motion):
    t_ref[...] = jnp.full((BLOCK,), _INF, jnp.float32)
    id_ref[...] = jnp.full((BLOCK,), -1, jnp.int32)
    rays, act = _load_rays(rays_ref)

    @pl.when(jnp.max(act) > 0.0)
    def _():
        best = (jnp.full((BLOCK,), _INF, jnp.float32),
                jnp.full((BLOCK,), -1, jnp.int32))
        for kind, start, end in ranges:
            def step(g, carry, kind=kind):
                best_t, best_id = carry
                t = _row_t(table_ref, g, kind, rays, motion)
                better = t < best_t
                return (jnp.where(better, t, best_t),
                        jnp.where(better, g, best_id))

            best = lax.fori_loop(start, end, step, best)
        t_ref[...] = best[0]
        id_ref[...] = best[1]


def _any_hit_kernel(rays_ref, maxt_ref, table_ref, out_ref, *, ranges):
    out_ref[...] = jnp.zeros((BLOCK,), jnp.int32)
    rays, act = _load_rays(rays_ref)

    @pl.when(jnp.max(act) > 0.0)
    def _():
        maxt = maxt_ref[...]
        # Inactive lanes start occluded so they never hold the loop open.
        blocked = jnp.where(act > 0.0, 0, 1).astype(jnp.int32)
        for kind, start, end in ranges:
            def cond(carry, end=end):
                g, blk = carry
                return (g < end) & (jnp.min(blk) < 1)

            def body(carry, kind=kind, end=end):
                g, blk = carry
                for i in range(ANY_HIT_CHUNK):
                    # Rows past the range repeat its last row: harmless
                    # for an "any" test.
                    t = _row_t(table_ref, jnp.minimum(g + i, end - 1), kind,
                               rays, False)
                    blk = jnp.maximum(blk, (t <= maxt).astype(jnp.int32))
                return g + ANY_HIT_CHUNK, blk

            _, blocked = lax.while_loop(cond, body, (jnp.int32(start), blocked))
        out_ref[...] = jnp.where(act > 0.0, blocked, 0)


_COMPILER_PARAMS = plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def _closest_call(rays, table, ranges, motion, interpret):
    r_pad = rays.shape[1]
    return pl.pallas_call(
        functools.partial(_closest_kernel, ranges=ranges, motion=motion),
        grid=(r_pad // BLOCK,),
        in_specs=[
            pl.BlockSpec((8, BLOCK), lambda i: (0, i)),
            pl.BlockSpec(table.shape, lambda i: (0, 0)),
        ],
        out_specs=[
            pl.BlockSpec((BLOCK,), lambda i: (i,)),
            pl.BlockSpec((BLOCK,), lambda i: (i,)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((r_pad,), jnp.float32),
            jax.ShapeDtypeStruct((r_pad,), jnp.int32),
        ],
        backend="triton",
        compiler_params=_COMPILER_PARAMS,
        interpret=interpret,
        name="rtt_closest_hit",
    )(rays, table)


def _closest_fwd(rays, table, ranges, motion, interpret):
    return _closest_call(rays, table, ranges, motion, interpret), None


def _closest_bwd(ranges, motion, interpret, _res, _ct):
    return None, None


_closest_call.defvjp(_closest_fwd, _closest_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def _any_hit_call(rays, maxt, table, ranges, interpret):
    r_pad = rays.shape[1]
    return pl.pallas_call(
        functools.partial(_any_hit_kernel, ranges=ranges),
        grid=(r_pad // BLOCK,),
        in_specs=[
            pl.BlockSpec((8, BLOCK), lambda i: (0, i)),
            pl.BlockSpec((BLOCK,), lambda i: (i,)),
            pl.BlockSpec(table.shape, lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((BLOCK,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct((r_pad,), jnp.int32),
        backend="triton",
        compiler_params=_COMPILER_PARAMS,
        interpret=interpret,
        name="rtt_any_hit",
    )(rays, maxt, table)


def _any_hit_fwd(rays, maxt, table, ranges, interpret):
    return _any_hit_call(rays, maxt, table, ranges, interpret), None


def _any_hit_bwd(ranges, interpret, _res, _ct):
    return None, None, None


_any_hit_call.defvjp(_any_hit_fwd, _any_hit_bwd)


def closest_hit_tid(scene: Scene, o, d, time, active=None, interpret=False):
    """(t, geom_id) of the closest hit per ray: t is +inf and id -1 on a
    miss.  Rays whose whole block is inactive report a miss.
    interpret=True runs the kernel in the Pallas interpreter (tests)."""
    r = o.shape[0]
    rays = pack_rays(o, d, time, active)
    t, gid = _closest_call(rays, pack_table(scene), kind_ranges(scene),
                           scene.has_motion, interpret)
    return t[:r], gid[:r]


def occluded_tid(scene: Scene, o, d, maxt, active=None, interpret=False):
    """(R,) bool: some geometry is hit at a distance <= maxt.  Shadow rays
    carry time 0 (Code/shapes.hpp:28), so no motion shift applies."""
    r = o.shape[0]
    rays = pack_rays(o, d, jnp.zeros(r, jnp.float32), active)
    mt = jnp.pad(lax.stop_gradient(maxt).astype(jnp.float32),
                 (0, rays.shape[1] - r))
    blocked = _any_hit_call(rays, mt, pack_table(scene), kind_ranges(scene),
                            interpret)
    return blocked[:r] > 0
