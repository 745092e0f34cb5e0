#!/usr/bin/env python3
"""Forward and forward+backward rays/s on the bundled bvh stress scene —
the second half of BASELINE.json's metric (rays/s, forward and
forward+backward), on one CUDA GPU.

The differentiable path is the general integrator with custom-VJP hit
kernels (hit decisions stop-gradient, shading/geometry differentiable —
the "closest-hit re-use" scope of BASELINE.json); gradients flow to the
realistic inverse-rendering parameter set: material albedo/roughness/
reflectivity, light position/intensity, camera location.

The whole image renders in ONE traced call (diff/render.render_linear):
AD through the 11-level lax.scan saves each level's queue as residuals,
so memory scales with rays * levels; --tiled bounds it by the tile size.
--spp-sqrt scales the sample count.

Writes one JSON line per config plus --out for the committed artifact.
"""

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import card_line, require_gpu  # noqa: E402
import ray_tracying as rt
from ray_tracying.diff import params as P
from ray_tracying.diff.render import mse_loss, render_linear
from ray_tracying.render.pipeline import RenderOptions

PARAM_PATHS = (
    "materials.diffuse",
    "materials.roughness",
    "materials.reflectivity",
    "lights.position",
    "lights.intensity",
    "camera.location",
)


def timeit(fn, trials=3):
    jax.block_until_ready(fn())  # compile
    ts = []
    for _ in range(trials):
        t0 = time.time()
        jax.block_until_ready(fn())
        ts.append(time.time() - t0)
    return float(np.median(ts))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--scene", default=os.path.join(REPO, "golden/ASCII/scene.json")
    )
    ap.add_argument("--spp-sqrt", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument(
        "--tiled", action="store_true",
        help="gradient accumulation over row tiles (mse_loss_and_grad_"
             "tiled): bounds AD residual memory by the tile size",
    )
    args = ap.parse_args()
    devices = require_gpu()
    from ray_tracying import compile_cache

    compile_cache.setup()
    print(f"card: {card_line()}", flush=True)

    scene = rt.load_scene(
        args.scene, textures_dir=os.path.join(REPO, "golden/Textures")
    )
    w, h = scene.camera.resolution
    spp = args.spp_sqrt * args.spp_sqrt if args.spp_sqrt > 1 else 1
    n_rays = w * h * spp
    opts = RenderOptions(samples_sqrt=args.spp_sqrt, light_samples=1)
    key = jax.random.key(0)

    theta = P.extract(scene, PARAM_PATHS)
    target = jnp.full((h, w, 3), 0.25, jnp.float32)

    def loss(th):
        return mse_loss(P.apply(scene, th), target, key, opts)

    if args.tiled:
        from ray_tracying.diff.render import (
            mse_loss_and_grad_tiled,
            mse_loss_tiled,
        )

        def fwd():
            return float(mse_loss_tiled(scene, theta, target, key, opts))

        def fwdbwd():
            return jax.block_until_ready(
                mse_loss_and_grad_tiled(scene, theta, target, key, opts)
            )

        t_fwd = timeit(fwd)
        t_fb = timeit(fwdbwd)
        _, grads = fwdbwd()
    else:
        fwd_j = jax.jit(lambda th: loss(th))
        fwdbwd_j = jax.jit(lambda th: jax.value_and_grad(loss)(th))

        def fwd():
            return float(fwd_j(theta))

        def fwdbwd():
            return jax.block_until_ready(fwdbwd_j(theta))

        t_fwd = timeit(fwd)
        t_fb = timeit(fwdbwd)

        # Sanity: gradients must be finite and not identically zero.
        _, grads = fwdbwd()
    flat = jax.tree.leaves(grads)
    assert all(np.isfinite(np.asarray(g)).all() for g in flat)
    assert any(float(jnp.abs(g).max()) > 0 for g in flat)

    report = {
        "scene": os.path.basename(args.scene),
        "resolution": [w, h],
        "spp": spp,
        "tiled": bool(args.tiled),
        "primary_rays": n_rays,
        "param_paths": list(PARAM_PATHS),
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": 1},
        "fwd_seconds": t_fwd,
        "fwd_rays_per_s": n_rays / t_fwd,
        "fwdbwd_seconds": t_fb,
        "fwdbwd_rays_per_s": n_rays / t_fb,
        "bwd_over_fwd": t_fb / t_fwd,
    }
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
