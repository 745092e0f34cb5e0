#!/usr/bin/env python3
"""Smoke test of the renderer on one CUDA GPU, through its user entry points.

    python3 chip_smoke.py           # phases 1-4 on the first GPU
    python3 chip_smoke.py --four    # only the 4-GPU sharded phase

Phases (one process, so one process holds the card):
  1. goldens   — the deterministic golden scenes within 1 uint8 step of the
                 reference renders, the stochastic ones within the
                 statistical contract (tests/test_parity_golden.py).
  2. frame     — the flagship frame (1920x1080, 4x4 spp, light_samples=1)
                 through render_to_srgb_u8: a warm-up, two timed frames,
                 rays/s, peak device memory, and the stochastic contract
                 against the reference's textured render.
  3. kernels   — the Triton closest-hit and any-hit kernels against the
                 plain XLA path (all_hit_t / min) on one full 8.4M-lane
                 tile of the flagship scene (141 primitives).  It runs
                 after the frame because the plain path's (rays x geoms)
                 arrays would dominate the frame's peak memory.
  4. fit       — fit(tiled=True) on the flagship at 1 spp: two steps with a
                 checkpoint each, a restart that resumes for a third step,
                 finite loss and gradients.
  --four       — trace_wavefront_sharded over a 1-D mesh of 4 GPUs against
                 the one-GPU image, and the sharded training step against
                 one device's loss and gradient.

Prints the card's name and power limit, each phase's compile and run
seconds, and as its last line one JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, with no such line, when JAX finds no GPU or any phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))

FLAGSHIP = ("golden", "ASCII", "scene.json")
FLAGSHIP_GOLDEN = ("golden", "Output", "bvh_s4_textured_r4.ppm")
# (scene, golden, samples_sqrt, light_samples): tests/test_parity_golden.py
DETERMINISTIC = (
    ("det_basic", "det_basic_s1.ppm", 1, 1),
    ("det_mirrors", "det_mirrors_s1.ppm", 1, 1),
    ("det_twoway", "det_twoway_s1.ppm", 1, 1),
    ("texture", "texture_s1.ppm", 1, 1),
    ("bvh_det", "bvh_det_s1.ppm", 1, 1),
)
STOCHASTIC = (
    ("softshadow", "softshadow_s4_l16.ppm", 4, 16),
    ("det_twoway", "det_twoway_s6.ppm", 6, 1),
    ("dof", "dof_s6.ppm", 6, 1),
    ("motion", "motion_s6.ppm", 6, 1),
    ("glossy", "glossy_s6.ppm", 6, 1),
    ("bvh_glossy", "bvh_glossy_s8.ppm", 8, 1),
)
# Kernel-vs-plain tolerances: both sides are f32 with no matrix product.
T_RTOL = 1e-5    # hit distance
TIE_RTOL = 1e-6  # ids may differ only where the two best t are this close


def require_gpu():
    """The devices JAX found; RuntimeError unless they are CUDA GPUs."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"chip_smoke needs a CUDA GPU; JAX found {devices[0].platform!r}"
        )
    return devices


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def log(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def stochastic_ok(img, gold) -> dict:
    import numpy as np

    diff = np.abs(img.astype(np.float32) - gold.astype(np.float32))
    mean, p99 = float(diff.mean()), float(np.percentile(diff, 99))
    return {"mean": mean, "p99": p99, "ok": mean < 1.0 and p99 <= 8}


def deterministic_ok(img, gold) -> dict:
    import numpy as np

    diff = np.abs(img.astype(int) - gold.astype(int))
    frac = float((diff > 0).mean())
    return {"max": int(diff.max()), "off_frac": frac,
            "ok": int(diff.max()) <= 1 and frac < 0.01}


def phase_goldens() -> bool:
    import jax

    import ray_tracying as rt

    ok = True
    compile_s = run_s = 0.0
    for cases, check, key in ((DETERMINISTIC, deterministic_ok, 0),
                              (STOCHASTIC, stochastic_ok, 7)):
        for scene_name, golden, s, ls in cases:
            scene = rt.load_scene(
                os.path.join(REPO, "scenes", f"{scene_name}.json"),
                textures_dir=os.path.join(REPO, "golden", "Textures"),
            )
            opts = rt.RenderOptions(samples_sqrt=s, light_samples=ls)

            def render():
                return rt.render_to_srgb_u8(scene, opts, key=jax.random.key(key))

            _, tc = _timed(render)
            img, tr = _timed(render)
            compile_s += tc - tr
            run_s += tr
            res = check(img, rt.read_ppm(os.path.join(REPO, "golden", "Output", golden)))
            ok &= res["ok"]
            log("goldens", case=f"{scene_name}:{golden}", run_s=tr, **res)
    log("goldens", compile_s=compile_s, run_s=run_s, ok=ok)
    return ok


def flagship_tile_rays(scene, n, seed=0):
    """n primary rays at uniform pixel positions over the flagship frame."""
    import jax
    import jax.numpy as jnp

    from ray_tracying.render.camera import pixel_rays

    w, h = scene.camera.resolution
    k = jax.random.key(seed)
    px = jax.random.uniform(jax.random.fold_in(k, 0), (n,)) * w
    py = jax.random.uniform(jax.random.fold_in(k, 1), (n,)) * h
    o, d = pixel_rays(scene.camera, px, py, jax.random.fold_in(k, 2))
    t = jax.random.uniform(jax.random.fold_in(k, 3), (n,))
    return o, d, t


def phase_kernels(n=None) -> bool:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import ray_tracying as rt
    from ray_tracying.kernels.closest_hit import closest_hit_tid, occluded_tid
    from ray_tracying.render.intersect import all_hit_t

    scene = rt.load_scene(os.path.join(REPO, *FLAGSHIP))
    w, _ = scene.camera.resolution
    if n is None:
        # One full tile of the flagship frame at 4x4 spp (pipeline tiling).
        n = (rt.RenderOptions().max_rays_per_pass // (w * 16)) * w * 16
    o, d, tm = flagship_tile_rays(scene, n)

    def plain_closest(scene, o, d, tm):
        m = all_hit_t(scene, o, d, tm)
        t = jnp.min(m, axis=1)
        return t, jnp.where(jnp.isfinite(t), jnp.argmin(m, axis=1), -1)

    def shadow_rays(o, d, t):
        """From each hit toward light 0, started 1e-3 along the way so no
        ray starts on the surface it leaves."""
        hit = jnp.isfinite(t)
        p = o + jnp.where(hit, t, 0.0)[:, None] * d
        lv = scene.lights.position[0] - p
        dist = jnp.sqrt(jnp.sum(lv * lv, axis=1))
        sd = lv / dist[:, None]
        return p + 1e-3 * sd, sd, dist - 1e-3, hit

    def plain_any(scene, so, sd, maxt, act):
        t = jnp.min(all_hit_t(scene, so, sd, jnp.zeros(so.shape[0])), axis=1)
        return t <= maxt, t

    fns = {
        "closest_kernel": jax.jit(closest_hit_tid),
        "closest_plain": jax.jit(plain_closest),
        "any_kernel": jax.jit(occluded_tid),
        "any_plain": jax.jit(plain_any),
    }
    t0 = time.perf_counter()
    t_k, id_k = jax.block_until_ready(fns["closest_kernel"](scene, o, d, tm))
    t_p, id_p = jax.block_until_ready(fns["closest_plain"](scene, o, d, tm))
    so, sd, maxt, act = jax.jit(shadow_rays)(o, d, t_p)
    b_k = jax.block_until_ready(fns["any_kernel"](scene, so, sd, maxt, act))
    b_p, ts_p = jax.block_until_ready(fns["any_plain"](scene, so, sd, maxt, act))
    compile_s = time.perf_counter() - t0

    times = {}
    t0 = time.perf_counter()
    for name, args in (("closest_kernel", (scene, o, d, tm)),
                       ("closest_plain", (scene, o, d, tm)),
                       ("any_kernel", (scene, so, sd, maxt, act)),
                       ("any_plain", (scene, so, sd, maxt, act))):
        reps = []
        for _ in range(3):
            _, dt = _timed(lambda: jax.block_until_ready(fns[name](*args)))
            reps.append(dt)
        times[name + "_ms"] = 1e3 * min(reps)

    t_k, id_k, t_p, id_p = map(np.asarray, (t_k, id_k, t_p, id_p))
    hit_p = np.isfinite(t_p)
    tie = np.abs(t_k - t_p) <= TIE_RTOL * np.where(hit_p, t_p, 1.0)
    id_bad = int(((id_k != id_p) & ~tie).sum())
    fin = hit_p & np.isfinite(t_k)
    t_bad = int((np.isfinite(t_k) != hit_p).sum()) + int(
        (np.abs(t_k[fin] - t_p[fin]) > T_RTOL * t_p[fin]).sum())
    b_k, b_p, ts_p, maxt, act = map(np.asarray, (b_k, b_p, ts_p, maxt, act))
    # Only lanes with a live shadow ray count; a blocker at the light's
    # distance itself (within T_RTOL) may fall either way.
    near = np.abs(ts_p - maxt) <= T_RTOL * maxt
    any_bad = int(((b_k != b_p) & act & ~near).sum())
    ok = id_bad == 0 and t_bad == 0 and any_bad == 0
    log("kernels", rays=int(n), geoms=scene.n_geoms, hit_frac=float(hit_p.mean()),
        id_mismatch=id_bad, id_ties=int(((id_k != id_p) & tie).sum()),
        t_mismatch=t_bad, any_hit_mismatch=any_bad,
        shadow_live=int(act.sum()), occluded_frac=float(b_p[act].mean()),
        compile_s=compile_s, run_s=time.perf_counter() - t0, ok=ok,
        **times)
    return ok


def phase_frame() -> bool:
    import jax

    import ray_tracying as rt

    scene = rt.load_scene(os.path.join(REPO, *FLAGSHIP))
    opts = rt.RenderOptions(samples_sqrt=4, light_samples=1)
    w, h = scene.camera.resolution
    n_rays = w * h * 16
    _, compile_s = _timed(
        lambda: rt.render_to_srgb_u8(scene, opts, key=jax.random.key(0)))
    run = []
    for i in range(2):
        img, dt = _timed(
            lambda: rt.render_to_srgb_u8(scene, opts, key=jax.random.key(i + 1)))
        run.append(dt)
    res = stochastic_ok(img, rt.read_ppm(os.path.join(REPO, *FLAGSHIP_GOLDEN)))
    stats = jax.devices()[0].memory_stats() or {}
    log("frame", resolution=[w, h], spp=16, rays=n_rays,
        compile_s=compile_s - run[0], run_s=run,
        rays_per_s=n_rays / (sum(run) / len(run)),
        peak_bytes_in_use=stats.get("peak_bytes_in_use"), **res)
    return res["ok"]


def phase_fit() -> bool:
    import jax
    import numpy as np
    import optax

    import ray_tracying as rt
    from ray_tracying.diff import checkpoint as ckpt
    from ray_tracying.diff import params as P
    from ray_tracying.diff.optimize import fit
    from ray_tracying.diff.render import mse_loss_and_grad_tiled, mse_loss_tiled

    scene_true = rt.load_scene(os.path.join(REPO, *FLAGSHIP))
    w, h = scene_true.camera.resolution
    # 1 spp over the full frame, two row tiles per step.
    opts = rt.RenderOptions(samples_sqrt=1, light_samples=1,
                            max_rays_per_pass=w * h // 2)
    key = jax.random.key(0)
    paths = ["materials.diffuse", "lights.intensity"]
    theta_true = P.extract(scene_true, paths)
    target = rt.render_image(scene_true, opts, key=key)
    scene0 = P.apply(scene_true, {
        "materials.diffuse": theta_true["materials.diffuse"] * 0.7,
        "lights.intensity": theta_true["lights.intensity"] * 1.3,
    })
    theta0 = P.extract(scene0, paths)

    def grads_now():
        loss, g = mse_loss_and_grad_tiled(scene0, theta0, target, key, opts)
        return float(loss), jax.device_get(g)

    (loss0, g0), compile_s = _timed(grads_now)
    (loss0, g0), grad_s = _timed(grads_now)
    compile_s -= grad_s
    finite = np.isfinite(loss0) and all(
        np.isfinite(np.asarray(v)).all() for v in g0.values())
    nonzero = any(float(np.abs(np.asarray(v)).max()) > 0 for v in g0.values())

    with tempfile.TemporaryDirectory(dir=REPO, prefix=".fit_ckpt_") as ckdir:
        kw = dict(learning_rate=2e-2, opts=opts, key=key, tiled=True,
                  checkpoint_dir=ckdir, checkpoint_every=1)
        (_, theta_a, hist_a), leg1 = _timed(
            lambda: fit(scene0, target, paths, steps=2, **kw))
        opt_like = optax.adam(kw["learning_rate"]).init(theta0)
        step, theta_saved, _ = ckpt.restore(ckdir, theta0, opt_like)
        # A restarted job calls fit again with the same directory: it
        # resumes at the saved step and runs only the third step.
        (_, theta_b, hist_b), leg2 = _timed(
            lambda: fit(scene0, target, paths, steps=3, **kw))
    same = all(np.array_equal(np.asarray(theta_saved[k]), np.asarray(theta_a[k]))
               for k in paths)
    loss_end = float(mse_loss_tiled(scene0, theta_b, target, key, opts))
    hist = hist_a + hist_b
    ok = (finite and nonzero and step == 2 and same and len(hist_b) == 1
          and all(np.isfinite(hist)) and np.isfinite(loss_end))
    log("fit", rays_per_step=w * h, steps=hist, resumed_at=step,
        resumed_theta_matches_saved=same, grads_finite=bool(finite),
        loss_before=loss0, loss_after=loss_end, compile_s=compile_s,
        run_s=[leg1, leg2], fwdbwd_s=grad_s, ok=bool(ok))
    return bool(ok)


def phase_four(devices) -> bool:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import ray_tracying as rt
    from ray_tracying.parallel.sharding import make_mesh, trace_wavefront_sharded
    from ray_tracying.render.camera import pixel_rays
    from ray_tracying.render.integrator import trace_wavefront
    from ray_tracying.render.pipeline import linear_to_srgb_u8

    sys.path.insert(0, REPO)
    from __graft_entry__ import train_step_on

    if len(devices) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, found {len(devices)}")
    scene = rt.load_scene(os.path.join(REPO, "scenes", "bvh_det.json"),
                          textures_dir=os.path.join(REPO, "golden", "Textures"))
    w, h = scene.camera.resolution
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32) + 0.5
    key = jax.random.key(0)
    o, d = pixel_rays(scene.camera, jnp.asarray(xs.ravel()),
                      jnp.asarray(ys.ravel()), key)
    tm = jnp.zeros(o.shape[0])
    mesh = make_mesh(4)
    to_u8 = jax.jit(lambda c: linear_to_srgb_u8(c.reshape(h, w, 3)))
    one = jax.jit(lambda o, d, tm: trace_wavefront(scene, o, d, tm, key, 1))
    four = jax.jit(lambda o, d, tm: trace_wavefront_sharded(
        scene, o, d, tm, key, 1, mesh))
    t0 = time.perf_counter()
    img1 = np.asarray(to_u8(one(o, d, tm)))
    img4 = np.asarray(to_u8(four(o, d, tm)))
    compile_s = time.perf_counter() - t0
    _, run1 = _timed(lambda: jax.block_until_ready(one(o, d, tm)))
    _, run4 = _timed(lambda: jax.block_until_ready(four(o, d, tm)))
    diff = int(np.abs(img1.astype(int) - img4.astype(int)).max())

    (loss1, g1, _, _), step1 = _timed(lambda: train_step_on(devices[:1]))
    (loss4, g4, _, mesh4), step4 = _timed(lambda: train_step_on(devices[:4]))

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))

    g_rel = {k: rel(g4[k], g1[k]) for k in g1}
    l_rel = rel(loss4, loss1)
    ok = diff <= 1 and l_rel <= 1e-4 and all(v <= 1e-4 for v in g_rel.values())
    log("four", image=[w, h], image_max_diff=diff, trace_1gpu_s=run1,
        trace_4gpu_s=run4, mesh=dict(zip(mesh4.axis_names, mesh4.devices.shape)),
        loss_1=loss1, loss_4=loss4, loss_rel=l_rel, grad_rel=g_rel,
        train_step_s=[step1, step4], compile_s=compile_s, ok=ok)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU sharded phase")
    ap.add_argument("--only", action="append", default=None,
                    choices=("goldens", "frame", "kernels", "fit"),
                    help="run only these one-GPU phases (repeatable)")
    args = ap.parse_args(argv)

    devices = require_gpu()
    sys.path.insert(0, REPO)
    from ray_tracying import compile_cache

    print(f"card: {card_line()}", flush=True)
    print(f"compile cache: {compile_cache.setup()}", flush=True)
    phases = ([("four", lambda: phase_four(devices))] if args.four else
              [("goldens", phase_goldens), ("frame", phase_frame),
               ("kernels", phase_kernels), ("fit", phase_fit)])
    if args.only:
        phases = [p for p in phases if p[0] in args.only]
    failed = []
    for name, fn in phases:
        try:
            if not fn():
                failed.append(name)
        except Exception:
            traceback.print_exc()
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
