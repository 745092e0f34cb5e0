"""Worker process for the 2-process jax.distributed smoke test
(tests/test_multihost.py spawns two of these).

Each process owns one virtual CPU device; the global mesh spans both.
Exercises parallel.cluster.initialize (coordinator handshake with retry),
local_ray_slice, and a sharded trace over the global mesh, then checks its
local output shard against a locally-computed single-process trace.
"""

import os
import sys

# One CPU device per process BEFORE jax import; force the CPU backend even
# if an accelerator plugin is importable.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=1"
)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]

    from ray_tracying import compile_cache
    from ray_tracying.parallel.cluster import initialize, local_ray_slice

    compile_cache.setup()

    initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc,
        process_id=pid,
        retries=3,
        backoff_s=0.5,
    )
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.process_index() == pid
    assert len(jax.devices()) == nproc, jax.devices()
    assert len(jax.local_devices()) == 1

    from jax.experimental import multihost_utils as mhu
    from jax.sharding import PartitionSpec as P

    from ray_tracying.parallel.sharding import make_mesh, trace_wavefront_sharded
    from ray_tracying.render.integrator import trace_wavefront
    from ray_tracying.scene.loader import load_scene_dict

    # Deterministic scene (no area lights / glossy / spp jitter): the
    # sharded and single-process traces must agree exactly regardless of
    # the per-shard RNG decorrelation.
    d = {
        "cameras": [{
            "location": [0, 0, 0], "gaze_vector": [0, 1, 0],
            "up_vector": [0, 0, 1], "focal_length": 35.0,
            "sensor_width": 36.0, "sensor_height": 24.0,
        }],
        "render": {"resolution_x": 8, "resolution_y": 8},
        "lights": [
            {"location": [0, 0, 5], "color": [1, 1, 1], "intensity": 150.0}
        ],
        "spheres": [
            {"location": [0, 6, 0], "radius": 1.5,
             "material": {"diffuse_color": [0.8, 0.2, 0.2],
                          "reflectivity": 0.3, "roughness": 0.0}},
        ],
        "rectangles": [
            {"translation": [0, 6, -2], "rotation": [0, 0, 0],
             "scale": [10, 10, 1],
             "material": {"diffuse_color": [0.3, 0.5, 0.3]}},
        ],
    }
    scene = load_scene_dict(d)

    # Global ray batch, computed identically on every process.
    r_global = 16
    theta = np.linspace(-0.4, 0.4, r_global, dtype=np.float32)
    dirs = np.stack(
        [np.sin(theta), np.cos(theta), 0.1 * np.cos(3 * theta)], axis=1
    )
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origins = np.zeros((r_global, 3), np.float32)
    times = np.zeros(r_global, np.float32)

    sl = local_ray_slice(r_global)
    per = r_global // nproc
    assert sl == slice(pid * per, (pid + 1) * per), sl

    mesh = make_mesh()
    spec = P("rays")
    o_g = mhu.host_local_array_to_global_array(origins[sl], mesh, spec)
    d_g = mhu.host_local_array_to_global_array(dirs[sl], mesh, spec)
    t_g = mhu.host_local_array_to_global_array(times[sl], mesh, spec)
    scene_g = jax.tree.map(
        lambda a: mhu.host_local_array_to_global_array(np.asarray(a), mesh, P()),
        scene,
    )

    out = trace_wavefront_sharded(
        scene_g, o_g, d_g, t_g, jax.random.key(0), 1, mesh
    )

    # Single-process oracle on this process's local device.
    expected = np.asarray(
        trace_wavefront(
            scene,
            jnp.asarray(origins),
            jnp.asarray(dirs),
            jnp.asarray(times),
            jax.random.key(0),
            1,
        )
    )

    local_rows = []
    for shard in out.addressable_shards:
        lo = shard.index[0].start or 0
        local_rows.append((lo, np.asarray(shard.data)))
    local_rows.sort(key=lambda t: t[0])
    got = np.concatenate([a for _, a in local_rows], axis=0)
    want = expected[sl]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.isfinite(got).all()
    # The scene must actually be hit somewhere (non-background radiance).
    assert (np.abs(expected - 0.1) > 1e-3).any()

    print(f"MULTIHOST_OK pid={pid}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
