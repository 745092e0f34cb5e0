"""Fully-traced differentiable rendering.

`render_linear` is the pipeline's tile renderer without the host loop: the
whole image renders inside one trace, so jax.grad flows pixel gradients
back to any Scene leaf.  Hit decisions (which geom, visibility booleans)
are piecewise-constant and contribute zero gradient; everything downstream
of a fixed hit — shading, attenuation, throughput weights, camera/lens
geometry, textures — is smooth (the BASELINE.json "closest-hit re-use"
scope).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ray_tracying.render.pipeline import RenderOptions, _render_tile
from ray_tracying.scene.types import Scene


def render_linear(
    scene: Scene,
    key: jax.Array,
    opts: Optional[RenderOptions] = None,
) -> jnp.ndarray:
    """Render the full image in one traced call -> (H, W, 3) linear f32."""
    opts = opts or RenderOptions()
    width, height = scene.camera.resolution
    tile, _ = _render_tile(
        scene,
        jnp.float32(0.0),
        key,
        height,
        width,
        opts.samples_sqrt,
        opts.light_samples,
        opts.queue_mult,
        opts.use_bvh,
        opts.min_throughput,
        differentiable=True,
        intersect=opts.intersect,
    )
    return tile


def mse_loss(
    scene: Scene,
    target_linear: jnp.ndarray,
    key: jax.Array,
    opts: Optional[RenderOptions] = None,
) -> jnp.ndarray:
    img = render_linear(scene, key, opts)
    return jnp.mean((img - target_linear) ** 2)


def mse_loss_and_grad_tiled(
    scene: Scene,
    theta,
    target_linear: jnp.ndarray,
    key: jax.Array,
    opts: Optional[RenderOptions] = None,
):
    """(loss, grads) of the MSE w.r.t. the theta dict, with GRADIENT
    ACCUMULATION over row tiles — the differentiable mirror of the
    inference pipeline's tiling.

    render_linear traces the whole frame in one call, so AD residuals
    scale with frame_rays * levels.  Tiling bounds residual
    memory by opts.max_rays_per_pass instead: each tile's loss term is
    rendered + differentiated independently (same per-shard RNG
    convention as the pipeline: key folded by tile index) and the
    gradients sum — d(sum of tile losses)/d(theta) is exactly the sum of
    per-tile gradients, so for deterministic scenes the result equals
    the untiled gradient to float tolerance."""
    from ray_tracying.diff import params as P

    opts = opts or RenderOptions()
    width, height = scene.camera.resolution
    spp = opts.samples_sqrt ** 2 if opts.samples_sqrt > 1 else 1
    rows = max(1, min(height, opts.max_rays_per_pass // max(1, width * spp)))
    n_px = float(height * width * 3)

    loss = None
    grads = None
    y0 = 0
    tile_idx = 0
    while y0 < height:
        take = min(rows, height - y0)
        start = min(y0, height - rows)
        k_tile = jax.random.fold_in(key, tile_idx)
        l, g = _tile_loss_grad(
            scene, theta, target_linear, start, y0 - start, take, k_tile,
            n_px, rows, width, opts.samples_sqrt, opts.light_samples,
            opts.queue_mult, opts.use_bvh, opts.min_throughput,
            opts.intersect,
        )
        loss = l if loss is None else loss + l
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        y0 += take
        tile_idx += 1
    return loss, grads


def mse_loss_tiled(
    scene: Scene,
    theta,
    target_linear: jnp.ndarray,
    key: jax.Array,
    opts: Optional[RenderOptions] = None,
):
    """Forward-only counterpart of mse_loss_and_grad_tiled: per-tile loss
    terms computed on device (only scalars cross the host link)."""
    opts = opts or RenderOptions()
    width, height = scene.camera.resolution
    spp = opts.samples_sqrt ** 2 if opts.samples_sqrt > 1 else 1
    rows = max(1, min(height, opts.max_rays_per_pass // max(1, width * spp)))
    n_px = float(height * width * 3)
    loss = None
    y0 = 0
    tile_idx = 0
    while y0 < height:
        take = min(rows, height - y0)
        start = min(y0, height - rows)
        k_tile = jax.random.fold_in(key, tile_idx)
        l = _tile_loss(
            scene, theta, target_linear, start, y0 - start, take, k_tile,
            n_px, rows, width, opts.samples_sqrt, opts.light_samples,
            opts.queue_mult, opts.use_bvh, opts.min_throughput,
            opts.intersect,
        )
        loss = l if loss is None else loss + l
        y0 += take
        tile_idx += 1
    return loss


@functools.partial(
    jax.jit,
    static_argnames=(
        "rows", "width", "samples_sqrt", "light_samples", "queue_mult",
        "use_bvh", "min_throughput", "intersect",
    ),
)
def _tile_loss(
    scene, theta, target_linear, start, offset, take, k_tile, n_px,
    rows, width, samples_sqrt, light_samples, queue_mult, use_bvh,
    min_throughput, intersect,
):
    return _tile_term(
        scene, theta, target_linear, start, offset, take, k_tile, n_px,
        rows, width, samples_sqrt, light_samples, queue_mult, use_bvh,
        min_throughput, intersect,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "rows", "width", "samples_sqrt", "light_samples", "queue_mult",
        "use_bvh", "min_throughput", "intersect",
    ),
)
def _tile_loss_grad(
    scene, theta, target_linear, start, offset, take, k_tile, n_px,
    rows, width, samples_sqrt, light_samples, queue_mult, use_bvh,
    min_throughput, intersect,
):
    """(loss, d loss/d theta) for one tile term (see _tile_term).
    Module-level jit: one compile serves every tile and every
    optimization step."""

    def term(th):
        return _tile_term(
            scene, th, target_linear, start, offset, take, k_tile, n_px,
            rows, width, samples_sqrt, light_samples, queue_mult, use_bvh,
            min_throughput, intersect,
        )

    return jax.value_and_grad(term)(theta)


def _tile_term(
    scene, theta, target_linear, start, offset, take, k_tile, n_px,
    rows, width, samples_sqrt, light_samples, queue_mult, use_bvh,
    min_throughput, intersect,
):
    """MSE term over image rows [start+offset, start+offset+take) of the
    fixed-size tile rendered at `start` (the last tile clamps start to
    height-rows and masks the re-rendered overlap rows out)."""
    from ray_tracying.diff import params as P

    sc = P.apply(scene, theta)
    tile, _ = _render_tile(
        sc,
        jnp.asarray(start, jnp.float32),
        k_tile,
        rows,
        width,
        samples_sqrt,
        light_samples,
        queue_mult,
        use_bvh,
        min_throughput,
        differentiable=True,
        intersect=intersect,
    )
    tgt = jax.lax.dynamic_slice_in_dim(target_linear, start, rows, axis=0)
    ridx = jnp.arange(rows)
    live = ((ridx >= offset) & (ridx < offset + take))[:, None, None]
    return jnp.sum(jnp.where(live, (tile - tgt) ** 2, 0.0)) / n_px
