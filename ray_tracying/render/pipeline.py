"""Image render pipeline: tiled, jitted, device-resident end to end.

Replaces the reference's sequential per-pixel double loop
(Code/raytracer.cpp:433-476) with row-tile batches: each tile generates
rows * width * spp primary rays, traces the full wavefront on device, and
averages samples.  Gamma (1.1) + clamp + *255.999 quantization
(Code/raytracer.cpp:446-457) are applied only at the output boundary —
everything upstream stays linear (and differentiable).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ray_tracying.core import constants as C
from ray_tracying.render.camera import pixel_rays
from ray_tracying.render.integrator import trace_wavefront
from ray_tracying.scene.types import Scene


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Mirrors the reference CLI surface (Code/raytracer.cpp:362-390)."""

    samples_sqrt: int = 4      # -s     (n x n stratified samples per pixel)
    light_samples: int = 1     # -light_sample
    use_bvh: bool = False      # -bvh   (identical hit set either way)
    # Rays per device pass (one jitted tile).  Chosen from
    # compiled.memory_analysis() and frame times on an H100: with the
    # kernels the flagship's frame time is flat from 1<<22 to 1<<24 and a
    # tile needs 6.8 GB of temporaries here; the plain path (the reference
    # route, whose (rays x geoms) operands grow with the tile) needs 53 GB
    # here and does not fit at 1<<24 (PERF.md).
    max_rays_per_pass: int = 1 << 23
    queue_mult: int = 2        # queue growth headroom for mirror+glass scenes
    # Kill continuation rays at throughput <= this.  0.0 = exact reference
    # semantics; positive values trade bounded uint8 error for speed (see
    # trace_wavefront docstring).
    min_throughput: float = 0.0
    # Collect per-level TraceStats + per-tile timings (render_with_stats);
    # forces per-tile sync, so use for diagnosis, not production renders.
    stats: bool = False
    # Segment-gating of the in-slot bounce levels (trace_wavefront
    # docstring): 0 = auto, 1 = off, N = force N segments.
    segments: int = 0
    # Pass-1 intersection route (render/intersect.route): "auto" runs the
    # Triton kernels on the GPU and the plain path elsewhere; "plain" is
    # the XLA reference path on any backend.
    intersect: str = "auto"


@functools.partial(
    jax.jit,
    static_argnames=(
        "rows", "width", "samples_sqrt", "light_samples", "queue_mult",
        "use_bvh", "min_throughput", "differentiable", "return_stats",
        "segments", "intersect",
    ),
)
def _render_tile(
    scene: Scene,
    y0: jnp.ndarray,
    key: jax.Array,
    rows: int,
    width: int,
    samples_sqrt: int,
    light_samples: int,
    queue_mult: int,
    use_bvh: bool = False,
    min_throughput: float = 0.0,
    differentiable: bool = False,
    return_stats: bool = False,
    segments: int = 0,
    intersect: str = "auto",
):
    """Render a (rows, width) tile -> (rows, width, 3) linear radiance."""
    spp = samples_sqrt * samples_sqrt if samples_sqrt > 1 else 1
    k_jit, k_lens, k_time, k_trace = jax.random.split(key, 4)

    ys = y0 + jnp.arange(rows, dtype=jnp.float32)[:, None, None]
    xs = jnp.arange(width, dtype=jnp.float32)[None, :, None]

    if samples_sqrt <= 1:
        # One ray through the pixel center (Code/raytracer.cpp:30-40).
        sub = jnp.full((rows, width, 1, 2), 0.5, jnp.float32)
    else:
        # Fresh jitter per pixel per stratum (Code/raytracer.cpp:46-66).
        jitter = jax.random.uniform(
            k_jit, (rows, width, samples_sqrt, samples_sqrt, 2), jnp.float32
        )
        jy = jnp.arange(samples_sqrt, dtype=jnp.float32)[:, None, None]
        ix = jnp.arange(samples_sqrt, dtype=jnp.float32)[None, :, None]
        strata = jnp.stack(
            [
                jnp.broadcast_to(ix, (samples_sqrt, samples_sqrt, 1))[..., 0],
                jnp.broadcast_to(jy, (samples_sqrt, samples_sqrt, 1))[..., 0],
            ],
            axis=-1,
        )  # (n, n, 2) with [..., 0] = x stratum, [..., 1] = y stratum
        sub = (strata[None, None] + jitter) / samples_sqrt
        sub = sub.reshape(rows, width, spp, 2)

    px = (xs + sub[..., 0]).reshape(-1)
    py = (ys + sub[..., 1]).reshape(-1)

    o, d = pixel_rays(scene.camera, px, py, k_lens)
    # Every primary ray gets a fresh exposure time in [0,1)
    # (Code/raytracer.cpp:37,61).
    times = jax.random.uniform(k_time, px.shape, jnp.float32)

    out = trace_wavefront(
        scene, o, d, times, k_trace, light_samples, queue_mult, use_bvh,
        min_throughput, "auto", differentiable, return_stats,
        segments=segments, return_dropped=not return_stats,
        intersect=intersect,
    )
    colors, aux = out if isinstance(out, tuple) else (out, None)
    tile = jnp.mean(colors.reshape(rows, width, spp, 3), axis=2)
    # aux: TraceStats in stats mode, else the scalar count of live rays
    # dropped to compacted-queue overflow (the pipeline warns from the
    # host when it is nonzero — drops must never be silent).
    return tile, aux


def _render_tiles(scene, opts, key, post=None, out_dtype=np.float32):
    """Shared tile loop.  post: optional jitted device-side postprocess
    applied per tile before the host copy (e.g. uint8 quantization — the
    device->host link can be orders of magnitude slower than HBM, so
    shrinking the transfer matters more than the extra device op).

    Returns the image, or (image, stats dict) when opts.stats — per-level
    TraceStats summed over tiles plus per-tile wall times (stats mode syncs
    per tile, trading the async-dispatch overlap for observability)."""
    width, height = scene.camera.resolution
    spp = opts.samples_sqrt * opts.samples_sqrt if opts.samples_sqrt > 1 else 1
    rows = max(1, min(height, opts.max_rays_per_pass // max(1, width * spp)))

    # Dispatch every tile before copying any back: JAX's async dispatch
    # queues them on device back-to-back, so the per-call host->device
    # round-trip latency is paid once, not per tile.
    tiles = []
    drop_counts = []
    level_acc = None
    tile_times = []
    y0 = 0
    tile_idx = 0
    while y0 < height:
        k_tile = jax.random.fold_in(key, tile_idx)
        t_start = time.time() if opts.stats else 0.0
        tile, aux = _render_tile(
            scene,
            jnp.float32(y0),
            k_tile,
            rows,
            width,
            opts.samples_sqrt,
            opts.light_samples,
            opts.queue_mult,
            opts.use_bvh,
            opts.min_throughput,
            return_stats=opts.stats,
            segments=opts.segments,
            intersect=opts.intersect,
        )
        if not opts.stats:
            drop_counts.append(aux)
        if opts.stats:
            tstats = jax.block_until_ready(aux)
            tile_times.append(
                {
                    "tile": tile_idx,
                    "rows": min(rows, height - y0),
                    "rays": min(rows, height - y0) * width * spp,
                    "seconds": round(time.time() - t_start, 4),
                }
            )
            rowsum = np.stack([np.asarray(f, np.int64) for f in tstats])
            level_acc = rowsum if level_acc is None else level_acc + rowsum
        if post is not None:
            tile = post(tile)
        tiles.append((y0, min(rows, height - y0), tile))
        y0 += min(rows, height - y0)
        tile_idx += 1

    out = np.zeros((height, width, 3), out_dtype)
    for y0, take, tile in tiles:
        out[y0 : y0 + take] = np.asarray(tile)[:take]
    if not opts.stats:
        # The reference never drops rays (Code/raytracer.cpp:280-351):
        # any continuation lost to compacted-queue overflow is surfaced,
        # never silent.
        dropped = sum(int(np.asarray(c)) for c in drop_counts if c is not None)
        if dropped:
            import warnings

            warnings.warn(
                f"render dropped {dropped} live continuation rays to "
                "compacted-queue overflow; use render_with_stats for "
                "per-level counts, or raise RenderOptions.queue_mult",
                RuntimeWarning,
                stacklevel=2,
            )
        return out
    levels = [
        {
            "level": i,
            "live": int(level_acc[0, i]),
            "hits": int(level_acc[1, i]),
            "spawned": int(level_acc[2, i]),
            "dropped": int(level_acc[3, i]),
        }
        for i in range(level_acc.shape[1])
    ]
    stats = {
        "levels": levels,
        "tiles": tile_times,
        "total_dropped": int(level_acc[3].sum()),
    }
    return out, stats


def render_image(
    scene: Scene,
    opts: Optional[RenderOptions] = None,
    key: Optional[jax.Array] = None,
) -> np.ndarray:
    """Render the full image -> (H, W, 3) float32 linear radiance.
    With opts.stats, returns (image, stats dict) instead."""
    opts = opts or RenderOptions()
    if key is None:
        key = jax.random.key(0)
    return _render_tiles(scene, opts, key)


def render_with_stats(
    scene: Scene,
    opts: Optional[RenderOptions] = None,
    key: Optional[jax.Array] = None,
):
    """Render with per-level instrumentation -> (linear image, stats dict).

    stats["levels"]: per bounce level, live/hit/spawned/dropped ray counts
    summed over tiles; stats["total_dropped"] counts continuations lost to
    compacted-queue overflow (0 unless a mirror+glass scene out-branches
    queue_mult); stats["tiles"]: per-tile wall seconds."""
    opts = dataclasses.replace(opts or RenderOptions(), stats=True)
    if key is None:
        key = jax.random.key(0)
    return _render_tiles(scene, opts, key)


def linear_to_srgb_u8(linear: jnp.ndarray) -> jnp.ndarray:
    """Gamma 1.1 + clamp + *255.999 quantize (Code/raytracer.cpp:446-457)."""
    corr = jnp.power(jnp.maximum(linear, 0.0), 1.0 / C.GAMMA)
    return (jnp.clip(corr, 0.0, 1.0) * C.QUANT_SCALE).astype(jnp.uint8)


def render_to_srgb_u8(
    scene: Scene,
    opts: Optional[RenderOptions] = None,
    key: Optional[jax.Array] = None,
) -> np.ndarray:
    """Render and quantize to the reference's output encoding.

    Quantization runs on device per tile so only uint8 crosses the
    device->host link (4x less traffic than linear f32)."""
    opts = opts or RenderOptions()
    if key is None:
        key = jax.random.key(0)
    return _render_tiles(
        scene, opts, key, post=jax.jit(linear_to_srgb_u8), out_dtype=np.uint8
    )
