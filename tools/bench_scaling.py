#!/usr/bin/env python3
"""Multi-device scaling sweep (BASELINE.json target: >= 85% efficiency).

On the GPUs of one host this sweeps mesh sizes 1..N and reports rays/s
and efficiency vs linear scaling.  --virtual validates the sharded
program end-to-end on an 8-device virtual CPU mesh instead (correctness +
compiled-collective check, NOT a wall-clock measurement).

Rays shard over the mesh, the scene replicates, no collective runs during
tracing (parallel/sharding.py).  The printed radiance checksum varies
only in the stochastic effects' RNG (per-shard keys decorrelate by shard
index); deterministic scenes produce identical checksums at every size.
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--virtual", action="store_true",
                    help="8-device virtual CPU mesh (validation mode)")
    ap.add_argument("--rays", type=int, default=1 << 21)
    ap.add_argument("--out", default=None, help="write a JSON artifact")
    args = ap.parse_args()

    if args.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        ).strip()
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    from ray_tracying import compile_cache

    compile_cache.setup()
    if not args.virtual:
        from chip_smoke import card_line, require_gpu

        require_gpu()
        print(f"card: {card_line()}", flush=True)

    import jax.numpy as jnp

    from ray_tracying import models
    from ray_tracying.parallel.sharding import (
        make_mesh,
        trace_wavefront_sharded,
    )
    from ray_tracying.render.camera import pixel_rays

    devices = jax.devices()
    scene = models.bvh_stress()
    w, h = scene.camera.resolution
    n = args.rays
    key = jax.random.key(0)
    k1, k2 = jax.random.split(key)
    xs = jax.random.uniform(k1, (n,)) * w
    ys = jax.random.uniform(k2, (n,)) * h
    o, d = pixel_rays(scene.camera, xs, ys, key)
    tm = jnp.zeros(n)

    sizes = [s for s in (1, 2, 4, 8, 16, 32) if s <= len(devices)]
    base = None
    rows = []
    print(f"{'devices':>7} {'seconds':>9} {'rays/s':>14} {'efficiency':>11} checksum")
    for s in sizes:
        mesh = make_mesh(s)
        f = jax.jit(
            lambda o, d, tm, mesh=mesh: trace_wavefront_sharded(
                scene, o, d, tm, key, 1, mesh
            )
        )
        chk = float(jnp.sum(f(o, d, tm)))  # compile + full execution
        t0 = time.time()
        chk = float(jnp.sum(f(o, d, tm)))
        dt = time.time() - t0
        rps = n / dt
        if base is None:
            base = rps
        eff = rps / (base * s)
        rows.append(
            {
                "devices": s,
                "seconds": round(dt, 4),
                "rays_per_s": round(rps),
                "efficiency_vs_linear": round(eff, 4),
                "radiance_checksum": round(chk, 2),
            }
        )
        print(f"{s:>7} {dt:>9.3f} {rps:>14,.0f} {eff:>10.1%} {chk:.4f}")

    if args.out:
        import json

        # Cross-size agreement: same rays, same scene — checksums differ
        # only in stochastic-effect RNG (per-shard key decorrelation).
        chks = [r["radiance_checksum"] for r in rows]
        spread = (max(chks) - min(chks)) / max(abs(min(chks)), 1e-9)
        report = {
            "mode": "virtual-8cpu" if args.virtual else "real",
            "device": {"platform": devices[0].platform,
                       "kind": devices[0].device_kind,
                       "count": len(devices)},
            "rays": n,
            "scene": "bvh_stress (bundled 140-cube)",
            "note": (
                "virtual mode validates the sharded program end-to-end "
                "(shard_map lowering, collectives, per-shard RNG) on an "
                "8-device CPU mesh — the wall-clock column is NOT a "
                "hardware scaling measurement"
                if args.virtual
                else "real-device sweep"
            ),
            "rows": rows,
            "checksum_rel_spread": round(spread, 6),
        }
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
