"""Iterative wavefront Whitted integrator.

The reference's recursive `Trace` (Code/raytracer.cpp:280-351) is a binary
recursion (reflection + refraction children) to depth 11.  Here the
recursion is flattened into 11 bounce passes under `lax.scan` (the body is
shape-invariant, so XLA compiles ONE level and the recursion depth becomes
a trip count).

Two queue disciplines, chosen statically from the scene:

  IN-SLOT (branching factor 1 — no material both reflects and refracts):
    each ray has at most one continuation, which overwrites its own queue
    slot.  No compaction, no scatters: radiance accumulates elementwise
    into accum[slot].  The bundled bvh scene and most scenes take it;
    dead slots stay in the queue as masked lanes.

  COMPACTED (some material reflects AND some refracts):
    slots carry an explicit dest index; both children are emitted and
    stream-compacted (stable multi-operand lax.sort on the dead flag)
    into a queue of capacity
    R * queue_mult; radiance accumulates via sort-by-dest + segment_sum.
    Overflow beyond capacity is dropped in compaction order — a
    documented deviation that only triggers on mirror+glass scenes deeper
    than log2(queue_mult) simultaneous branchings.

Level semantics (identical in both paths, all cited):
  - miss -> background 0.1 gray weighted by path throughput
    (Code/raytracer.cpp:296-298)
  - local shading weighted by throughput * max(0, 1 - refl - trans)
    (Code/raytracer.cpp:346-350)
  - children spawned at the depth-10 level are never traced: at depth 11
    the reference returns black (raytracer.cpp:290-292), so their
    contribution is identically zero.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ray_tracying.core import constants as C
from ray_tracying.core.sampling import uniform_in_unit_sphere
from ray_tracying.core.vecmath import (
    dot,
    normalize,
    reflect,
    refract,
)
from ray_tracying.render.intersect import closest_hit
from ray_tracying.render.materials import gather_materials
from ray_tracying.render.shade import shade
from ray_tracying.scene.types import Scene


class _Queue(NamedTuple):
    o: jnp.ndarray       # (Cap, 3)
    d: jnp.ndarray       # (Cap, 3)
    time: jnp.ndarray    # (Cap,)
    tp: jnp.ndarray      # (Cap,) scalar throughput
    dest: jnp.ndarray    # (Cap,) int32 primary-sample index
    active: jnp.ndarray  # (Cap,) bool


class TraceStats(NamedTuple):
    """Per-level integrator counters (one row per bounce level).

    The reference has no observability at all (SURVEY.md §5); these are
    this renderer's per-pass instrumentation — in particular `dropped` makes the
    compacted queue's overflow policy (see _compact) impossible to miss."""

    live: jnp.ndarray     # (L,) int32 — active queue slots entering the level
    hits: jnp.ndarray     # (L,) int32 — rays that hit geometry this level
    spawned: jnp.ndarray  # (L,) int32 — continuations emitted by this level
    dropped: jnp.ndarray  # (L,) int32 — continuations lost to queue overflow


def _compact(cands: _Queue, keep: jnp.ndarray, capacity: int):
    """Stream-compact candidate slots where keep is True into a queue of
    `capacity` slots; overflow beyond capacity is dropped in order.
    Returns (queue, dropped) where dropped counts the lost continuations
    (always surfaced through TraceStats so the loss cannot be silent).

    Implemented as ONE stable multi-operand lax.sort on the dead flag.  A
    cumsum-scatter compaction is the alternative; neither is measured on
    the GPU yet (ROADMAP A2)."""
    n_keep = jnp.sum(keep.astype(jnp.int32))
    count = jnp.minimum(n_keep, capacity)
    dropped = n_keep - count
    dead = jnp.where(keep, 0, 1).astype(jnp.int32)
    ops = jax.lax.sort(
        (
            dead,
            cands.o[:, 0], cands.o[:, 1], cands.o[:, 2],
            cands.d[:, 0], cands.d[:, 1], cands.d[:, 2],
            cands.time, cands.tp, cands.dest,
        ),
        num_keys=1,
        is_stable=True,
    )
    (_, ox, oy, oz, dx, dy, dz, time, tp, dest) = (
        op[:capacity] for op in ops
    )
    q = _Queue(
        o=jnp.stack([ox, oy, oz], axis=1),
        d=jnp.stack([dx, dy, dz], axis=1),
        time=time,
        tp=tp,
        dest=dest,
        active=jnp.arange(capacity) < count,
    )
    return q, dropped


def _cat(queues) -> _Queue:
    return _Queue(*(jnp.concatenate(f, axis=0) for f in zip(*queues)))


def _spawn_reflection(scene, q, hit, mrec, act, k_level, capacity, min_tp):
    """Reflection continuation (Code/raytracer.cpp:307-333)."""
    rdir = reflect(q.d, hit.normal)
    if scene.has_glossy:
        # Glossy fuzz: normalize(R + roughness * unit_sphere); rays
        # perturbed below the surface are absorbed (raytracer.cpp:312-327).
        fuzz = uniform_in_unit_sphere(jax.random.fold_in(k_level, 1), (capacity,))
        pert = normalize(rdir + mrec.roughness[:, None] * fuzz)
        pert = jnp.where((dot(pert, hit.normal) < 0.0)[:, None], 0.0, pert)
        rdir = jnp.where((mrec.roughness > 0.0)[:, None], pert, rdir)
    tp = q.tp * mrec.reflectivity
    ok = act & (mrec.reflectivity > 0.0) & (dot(rdir, rdir) > C.EPS_GLOSSY_DIR2)
    if min_tp > 0.0:
        ok = ok & (tp > min_tp)
    return _Queue(
        o=hit.point + hit.normal * C.EPS_NORMAL_OFFSET,
        d=rdir,
        # Secondary rays carry time = 0 (Ray default, Code/shapes.hpp:28).
        time=jnp.zeros(capacity),
        tp=tp,
        dest=q.dest,
        active=ok,
    )


def _spawn_refraction(scene, q, hit, mrec, act, capacity, min_tp):
    """Refraction continuation (Code/raytracer.cpp:335-344)."""
    tdir, n_eff = refract(q.d, hit.normal, mrec.ior)
    tp = q.tp * mrec.transparency
    ok = act & (mrec.transparency > 0.0) & (dot(tdir, tdir) > C.EPS_REFRACT_DIR2)
    if min_tp > 0.0:
        ok = ok & (tp > min_tp)
    return _Queue(
        o=hit.point - n_eff * C.EPS_NORMAL_OFFSET,
        d=tdir,
        time=jnp.zeros(capacity),
        tp=tp,
        dest=q.dest,
        active=ok,
    )


def _spawn_one_way(scene, q, hit, mrec, act, k_level, capacity, min_tp):
    """At-most-one continuation per ray: reflection-only and
    refraction-only scenes spawn their single kind; MIXED one-way scenes
    (mirrors and glass on DIFFERENT materials, scene.has_two_way False)
    pick per lane by the hit material — transparency > 0 takes the
    refraction branch, else reflectivity > 0 the reflection branch.  Both
    stay in-slot because no lane ever emits two children."""
    if scene.has_reflection and not scene.has_refraction:
        return _spawn_reflection(
            scene, q, hit, mrec, act, k_level, capacity, min_tp
        )
    if scene.has_refraction and not scene.has_reflection:
        return _spawn_refraction(scene, q, hit, mrec, act, capacity, min_tp)
    q_refl = _spawn_reflection(
        scene, q, hit, mrec, act, k_level, capacity, min_tp
    )
    q_refr = _spawn_refraction(scene, q, hit, mrec, act, capacity, min_tp)
    use_refr = mrec.transparency > 0.0
    pick = lambda a, b: jnp.where(
        use_refr[:, None] if a.ndim == 2 else use_refr, a, b
    )
    return _Queue(*(pick(a, b) for a, b in zip(q_refr, q_refl)))


# Rays per segment unit of the segment-gated in-slot path: each segment's
# length is a multiple of this.
SEGMENT_QUANTUM = 2048


def trace_wavefront(
    scene: Scene,
    origins: jnp.ndarray,     # (R, 3)
    directions: jnp.ndarray,  # (R, 3) unit
    times: jnp.ndarray,       # (R,)
    key: jax.Array,
    light_samples: int,
    queue_mult: int = 2,
    use_bvh: bool = False,
    min_throughput: float = 0.0,
    compact: str = "auto",
    differentiable: bool = False,
    return_stats: bool = False,
    max_depth: int | None = None,
    segments: int = 0,
    return_dropped: bool = False,
    intersect: str = "auto",
) -> jnp.ndarray:
    """Trace R primary rays to completion.  Returns (R, 3) radiance, or
    (radiance, TraceStats) when return_stats — per-level live/hit/spawn/drop
    counters (one extra sum per level; negligible next to the trace).

    use_bvh mirrors the reference -bvh flag (Code/raytracer.cpp:369): the
    hit set is identical with or without it (SURVEY.md §2 quirk 15), and
    every backend intersects by brute force.

    compact: "always" stream-compacts the continuation queue every level
    (one stable lax.sort on the dead flag) so dead rays leave the queue;
    "auto"/"never" keep one-way continuations in their own slots.
    Two-way (mirror+glass) scenes always compact — the queue physically
    grows.  Compaction only permutes queue slots, so deterministic scenes
    are bit-identical either way; stochastic effects consume slot-indexed
    RNG streams and differ within their sampling noise.

    min_throughput: kill continuation rays whose path throughput falls at
    or below this value.  0.0 (default) = the reference's exact semantics
    (rays die only on miss or at depth 11).  Positive values are a lossy
    speed knob: a killed ray changes its sample's linear radiance by at
    most tp * L_max, so small cutoffs perturb the uint8 image by a few
    steps at most.

    max_depth: recursion depth cutoff; None (default) = the reference's
    MAX_RECURSION_DEPTH (10 -> 11 levels, Code/raytracer.hpp:11).

    segments: split the in-slot queue into this many segments and gate
    each level's whole body per segment on any(active) via lax.cond, so
    dead segments of deep levels cost nothing.  0 or 1 = off (the
    default; not measured on the GPU).  Deterministic scenes are
    bit-identical either way; stochastic effects consume segment-indexed
    RNG streams and differ within their sampling noise.

    return_dropped: also return the scalar count of continuations lost to
    compacted-queue overflow (only two-way scenes can overflow).

    intersect: the pass-1 route of render/intersect.py ("auto", "plain"
    or "interpret")."""
    r = origins.shape[0]
    if max_depth is None:
        max_depth = C.MAX_RECURSION_DEPTH
    bg = jnp.asarray(C.BACKGROUND_RGB, jnp.float32)

    if scene.n_geoms == 0:
        # Nothing can be hit: every ray takes the background path.
        out = jnp.broadcast_to(bg, (r, 3))
        if return_stats:
            z = jnp.zeros(1, jnp.int32)
            return out, TraceStats(
                live=jnp.full(1, r, jnp.int32), hits=z, spawned=z, dropped=z
            )
        if return_dropped:
            return out, jnp.int32(0)
        return out

    # Branching factor 2 requires a single MATERIAL that both reflects and
    # refracts (Code/raytracer.cpp:308-344); scenes that merely mix mirror
    # and glass materials spawn one continuation per ray and stay in-slot.
    two_way = scene.has_two_way
    spawn = scene.has_reflection or scene.has_refraction
    capacity = r * queue_mult if two_way else r
    # One-way scenes keep continuations in their slots unless asked to
    # compact; two-way scenes must compact: the queue physically grows.
    do_compact = (compact == "always" or two_way) and spawn

    accum = jnp.zeros((r, 3), jnp.float32)
    q = _Queue(
        o=origins,
        d=directions,
        time=times,
        tp=jnp.ones(r, jnp.float32),
        dest=jnp.arange(r, dtype=jnp.int32),
        active=jnp.ones(r, bool),
    )
    if capacity > r:
        pad = capacity - r
        q = _Queue(
            o=jnp.concatenate([q.o, jnp.zeros((pad, 3))]),
            d=jnp.concatenate([q.d, jnp.zeros((pad, 3))]),
            time=jnp.concatenate([q.time, jnp.zeros(pad)]),
            tp=jnp.concatenate([q.tp, jnp.zeros(pad)]),
            dest=jnp.concatenate([q.dest, jnp.zeros(pad, jnp.int32)]),
            active=jnp.concatenate([q.active, jnp.zeros(pad, bool)]),
        )

    # --- segment gating (in-slot path only; see docstring) ---
    seg_n = segments
    use_segments = (
        spawn and not do_compact and not differentiable and segments > 1
    )
    if use_segments:
        unit = seg_n * SEGMENT_QUANTUM
        rp = -(-r // unit) * unit
        if rp > r:
            padn = rp - r
            q = _Queue(
                o=jnp.concatenate([q.o, jnp.zeros((padn, 3))]),
                d=jnp.concatenate([q.d, jnp.zeros((padn, 3))]),
                time=jnp.concatenate([q.time, jnp.zeros(padn)]),
                tp=jnp.concatenate([q.tp, jnp.zeros(padn)]),
                dest=jnp.concatenate([q.dest, jnp.zeros(padn, jnp.int32)]),
                active=jnp.concatenate([q.active, jnp.zeros(padn, bool)]),
            )
            accum = jnp.zeros((rp, 3), jnp.float32)
        seg_len = (rp if rp > r else r) // seg_n

    def inslot_level(accum_s, q_s, k_lvl):
        """One level of in-slot work on a queue slice (the whole queue or
        one segment).  Returns (accum', continuation queue, counters)."""
        cap = q_s.o.shape[0]
        hit = closest_hit(
            scene, q_s.o, q_s.d, q_s.time, q_s.active, intersect
        )
        act = q_s.active & hit.valid
        missed = q_s.active & ~hit.valid
        mrec = gather_materials(scene, hit.geom_id)
        local = shade(
            scene, hit, q_s.o, jax.random.fold_in(k_lvl, 0), light_samples,
            mrec, act, intersect
        )
        local_w = jnp.maximum(0.0, 1.0 - mrec.reflectivity - mrec.transparency)
        w_miss = jnp.where(missed, q_s.tp, 0.0)[:, None]
        w_local = jnp.where(act, q_s.tp * local_w, 0.0)[:, None]
        contrib = w_miss * bg + w_local * jnp.where(act[:, None], local, 0.0)
        accum_s = accum_s + contrib
        if not spawn:
            q2 = q_s
            spawned = jnp.zeros(cap, bool)
        else:
            q2 = _spawn_one_way(
                scene, q_s, hit, mrec, act, k_lvl, cap, min_throughput
            )
            spawned = q2.active
        counts = (
            jnp.sum(q_s.active.astype(jnp.int32)),
            jnp.sum(act.astype(jnp.int32)),
            jnp.sum(spawned.astype(jnp.int32)),
            jnp.int32(0),
        )
        return accum_s, q2, counts

    def compacted_level(accum, q, k_level):
        """Two-way / forced-compaction level over the full queue."""
        hit = closest_hit(scene, q.o, q.d, q.time, q.active, intersect)
        act = q.active & hit.valid
        missed = q.active & ~hit.valid
        live_in = jnp.sum(q.active.astype(jnp.int32))
        n_hit = jnp.sum(act.astype(jnp.int32))

        mrec = gather_materials(scene, hit.geom_id)
        local = shade(
            scene, hit, q.o, jax.random.fold_in(k_level, 0), light_samples,
            mrec, act, intersect
        )
        local_w = jnp.maximum(0.0, 1.0 - mrec.reflectivity - mrec.transparency)
        w_miss = jnp.where(missed, q.tp, 0.0)[:, None]
        w_local = jnp.where(act, q.tp * local_w, 0.0)[:, None]
        contrib = w_miss * bg + w_local * jnp.where(act[:, None], local, 0.0)

        # Accumulate by dest: sort the contributions by dest and
        # segment-sum (a scatter-add is unmeasured here, ROADMAP A8).
        dd = jnp.where(q.active, q.dest, r)
        sd, c0, c1, c2 = jax.lax.sort(
            (dd, contrib[:, 0], contrib[:, 1], contrib[:, 2]),
            num_keys=1,
            is_stable=False,
        )
        csort = jnp.stack([c0, c1, c2], axis=1)
        accum = accum + jax.ops.segment_sum(
            csort, sd, num_segments=r + 1, indices_are_sorted=True
        )[:r]

        if two_way:
            c_refl = _spawn_reflection(
                scene, q, hit, mrec, act, k_level, capacity, min_throughput
            )
            c_refr = _spawn_refraction(
                scene, q, hit, mrec, act, capacity, min_throughput
            )
            cand = _cat([c_refl, c_refr])
            q, dropped = _compact(cand, cand.active, capacity)
            spawned = cand.active
        else:
            q = _spawn_one_way(
                scene, q, hit, mrec, act, k_level, capacity, min_throughput
            )
            spawned = q.active
            q, dropped = _compact(q, q.active, capacity)
        counts = (live_in, n_hit, jnp.sum(spawned.astype(jnp.int32)), dropped)
        return accum, q, counts

    def level_body(carry, depth):
        accum, q = carry
        k_level = jax.random.fold_in(key, depth)
        if do_compact:
            accum, q, counts = compacted_level(accum, q, k_level)
        elif use_segments:
            qs = jax.tree.map(
                lambda a: a.reshape((seg_n, seg_len) + a.shape[1:]), q
            )
            accs = accum.reshape(seg_n, seg_len, 3)
            seg_keys = jax.vmap(
                lambda i: jax.random.fold_in(k_level, i)
            )(jnp.arange(seg_n))

            def seg_step(_, xs):
                acc_s, q_s, k_s = xs

                def dead(args):
                    a, qq, _k = args
                    z = jnp.int32(0)
                    return a, qq, (z, z, z, z)

                out = jax.lax.cond(
                    jnp.any(q_s.active),
                    lambda args: inslot_level(*args),
                    dead,
                    (acc_s, q_s, k_s),
                )
                return None, out

            _, (accs2, qs2, seg_counts) = jax.lax.scan(
                seg_step, None, (accs, qs, seg_keys)
            )
            accum = accs2.reshape(-1, 3)
            q = jax.tree.map(
                lambda a: a.reshape((-1,) + a.shape[2:]), qs2
            )
            counts = tuple(jnp.sum(c) for c in seg_counts)
        else:
            accum, q, counts = inslot_level(accum, q, k_level)
        if return_stats:
            out_row = counts
        elif return_dropped and do_compact:
            out_row = counts[3]
        else:
            out_row = None
        return (accum, q), out_row

    if not spawn:
        # Purely local scene: one level suffices.
        accum, _, row = inslot_level(accum, q, jax.random.fold_in(key, 0))
        if return_stats:
            return accum[:r], TraceStats(*(v[None] for v in row))
        if return_dropped:
            return accum[:r], jnp.int32(0)
        return accum[:r]

    # max_depth+1 levels (depth 0..10 by default); children spawned by the
    # last iteration are never consumed, reproducing "depth > 10 -> black".
    if differentiable:
        # Remat each level under AD: without this, every level's dense
        # (rays x geoms) hit matrix is saved as a scan residual —
        # 11 x R x G f32, 23 GB for the flagship at 1 spp.  Recomputing
        # the level forward in the backward pass costs ~2x FLOPs and caps
        # residual memory at one level's carry.
        level_body = jax.checkpoint(level_body)
    (accum, _), rows = jax.lax.scan(
        level_body,
        (accum, q),
        jnp.arange(max_depth + 1, dtype=jnp.int32),
    )
    if return_stats:
        return accum[:r], TraceStats(*rows)
    if return_dropped:
        # Only compacted (two-way) queues can overflow on this path.
        return accum[:r], (
            jnp.sum(rows) if rows is not None else jnp.int32(0)
        )
    return accum[:r]
