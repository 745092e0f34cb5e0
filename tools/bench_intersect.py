#!/usr/bin/env python3
"""Kernel route against the plain XLA route, end to end, on one GPU.

The figures PERF.md gives for the intersection kernel come from here and
from chip_smoke.py's kernels phase.

Renders the flagship frame (golden/ASCII/scene.json, 1920x1080, 4x4 spp,
light_samples=1) through render_to_srgb_u8 with RenderOptions.intersect
"auto" (the Triton kernels) and "plain" (XLA's dense all_hit_t path), in
the order auto, plain, plain, auto, each after its own warm-up.  Also
prints compiled.memory_analysis() of one tile per route and tile size.
One JSON line per measurement; the card's name and power limit first.

    python3 tools/bench_intersect.py [--sizes 22,23,24] [--frames 2]
"""

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="23",
                    help="log2 of max_rays_per_pass values to measure")
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--routes", default="auto,plain")
    args = ap.parse_args()

    import jax

    from chip_smoke import card_line, require_gpu
    from ray_tracying import compile_cache

    require_gpu()
    compile_cache.setup()
    print(f"card: {card_line()}", flush=True)

    import ray_tracying as rt
    from ray_tracying.render.pipeline import _render_tile

    scene = rt.load_scene(os.path.join(REPO, "golden", "ASCII", "scene.json"))
    w, h = scene.camera.resolution
    n_rays = w * h * 16
    routes = args.routes.split(",")
    order = routes + routes[::-1]
    for lg in map(int, args.sizes.split(",")):
        base = rt.RenderOptions(samples_sqrt=4, light_samples=1,
                                max_rays_per_pass=1 << lg)
        rows = max(1, min(h, base.max_rays_per_pass // (w * 16)))
        for route in routes:
            t0 = time.perf_counter()
            mem = _render_tile.lower(
                scene, jax.numpy.float32(0), jax.random.key(0), rows, w,
                4, 1, 2, False, 0.0, intersect=route,
            ).compile().memory_analysis()
            rec = {k: getattr(mem, k) for k in (
                "temp_size_in_bytes", "argument_size_in_bytes",
                "output_size_in_bytes", "generated_code_size_in_bytes")}
            print(json.dumps({"memory": route, "max_rays_per_pass": 1 << lg,
                              "tile_rays": rows * w * 16,
                              "compile_s": time.perf_counter() - t0, **rec}),
                  flush=True)
        for i, route in enumerate(order):
            opts = dataclasses.replace(base, intersect=route)
            try:
                t0 = time.perf_counter()
                rt.render_to_srgb_u8(scene, opts, key=jax.random.key(0))
                warm = time.perf_counter() - t0
                ts = []
                for f in range(args.frames):
                    t0 = time.perf_counter()
                    rt.render_to_srgb_u8(scene, opts, key=jax.random.key(f + 1))
                    ts.append(time.perf_counter() - t0)
                rec = {"warmup_s": warm, "frame_s": ts,
                       "rays_per_s": n_rays / min(ts)}
            except jax.errors.JaxRuntimeError as e:
                # The plain route outgrows the card at large tiles: report
                # the allocation failure and go on; anything else raises.
                if "RESOURCE_EXHAUSTED" not in str(e):
                    raise
                rec = {"error": "out of memory: " + str(e)[:300]}
            stats = jax.devices()[0].memory_stats() or {}
            print(json.dumps({"frame": route, "turn": i,
                              "max_rays_per_pass": 1 << lg, "rays": n_rays,
                              "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
                              **rec}), flush=True)


if __name__ == "__main__":
    main()
