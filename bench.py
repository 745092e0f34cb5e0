#!/usr/bin/env python3
"""Headline benchmark: primary rays/s on the reference's bundled bvh
stress scene (1920x1080, 4x4 spp, 141 shapes, full 11-level Whitted +
shadow rays, tex2 texture bound on all 140 cubes), on one CUDA GPU.

Fails without a GPU.  Prints the card's name and power limit, then ONE
JSON line: {"metric", "value", "unit", "device", "compile_s"}.

For scale: the reference C++ renderer, compiled -O2 and run single
threaded on the CPU of the machine that made the goldens, took 58.191 s
for this frame (570,149 primary rays/s).  That CPU is not recorded, so the
number is context, not a baseline this script divides by.
"""

import json
import os
import sys
import time

import jax

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def main():
    from chip_smoke import card_line, require_gpu
    from ray_tracying import compile_cache

    devices = require_gpu()
    compile_cache.setup()
    print(f"card: {card_line()}", flush=True)

    import ray_tracying as rt

    scene = rt.load_scene(os.path.join(REPO, "golden", "ASCII", "scene.json"))
    opts = rt.RenderOptions(samples_sqrt=4, light_samples=1)
    width, height = scene.camera.resolution
    n_rays = width * height * opts.samples_sqrt**2

    # Warm-up = compile.  render_to_srgb_u8 ends with uint8 pixels on the
    # host, so each frame's time covers the whole device program.
    t0 = time.perf_counter()
    rt.render_to_srgb_u8(scene, opts, key=jax.random.key(0))
    first = time.perf_counter() - t0

    trials = 2
    t0 = time.perf_counter()
    for i in range(trials):
        rt.render_to_srgb_u8(scene, opts, key=jax.random.key(i + 1))
    dt = (time.perf_counter() - t0) / trials

    d = devices[0]
    print(
        json.dumps(
            {
                "metric": "primary rays/s, bvh scene 1920x1080 4x4spp",
                "value": n_rays / dt,
                "unit": "rays/s",
                "device": {"platform": d.platform, "kind": d.device_kind,
                           "count": 1},
                "compile_s": first - dt,
            }
        )
    )


if __name__ == "__main__":
    main()
