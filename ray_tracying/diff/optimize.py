"""Inverse-rendering optimization loop (the BASELINE.json
glossy-param-fitting config): gradient-descend selected scene parameters
to match a target image.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from ray_tracying.diff import params as P
from ray_tracying.diff.render import mse_loss
from ray_tracying.render.pipeline import RenderOptions
from ray_tracying.scene.types import Scene


def fit(
    scene: Scene,
    target_linear: jnp.ndarray,
    param_paths: Iterable[str],
    steps: int = 100,
    learning_rate: float = 5e-2,
    opts: Optional[RenderOptions] = None,
    key: Optional[jax.Array] = None,
    resample_noise: bool = True,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 25,
    tiled: bool = False,
) -> Tuple[Scene, Dict[str, jnp.ndarray], list]:
    """Adam-optimize the given scene leaves against the target.

    resample_noise: redraw the per-step render RNG (stochastic effects act
    as unbiased noise on the gradient); fix it for deterministic scenes.
    checkpoint_dir: if set, saves {theta, opt_state} every
    checkpoint_every steps (diff/checkpoint.py) and RESUMES from the latest
    checkpoint found there (diff/checkpoint.py).
    tiled: accumulate gradients over row tiles (bounded by
    opts.max_rays_per_pass) instead of differentiating the whole frame in
    one trace — required when frame_rays x bounce levels of AD residuals
    exceed device memory; same gradients to float tolerance.
    Returns (fitted scene, fitted params, loss history).
    """
    opts = opts or RenderOptions(samples_sqrt=1, light_samples=1)
    if key is None:
        key = jax.random.key(0)
    theta = P.extract(scene, param_paths)
    opt = optax.adam(learning_rate)
    opt_state = opt.init(theta)

    start = 0
    if checkpoint_dir is not None:
        from ray_tracying.diff import checkpoint as ckpt

        restored = ckpt.restore(checkpoint_dir, theta, opt_state)
        if restored is not None:
            start, theta, opt_state = restored

    if tiled:
        from ray_tracying.diff.render import mse_loss_and_grad_tiled

        @jax.jit
        def apply_update(theta, opt_state, grads):
            updates, opt_state = opt.update(grads, opt_state)
            return optax.apply_updates(theta, updates), opt_state

        def step(theta, opt_state, k):
            loss, grads = mse_loss_and_grad_tiled(
                scene, theta, target_linear, k, opts
            )
            theta, opt_state = apply_update(theta, opt_state, grads)
            return theta, opt_state, loss
    else:
        @jax.jit
        def step(theta, opt_state, k):
            def loss_fn(th):
                return mse_loss(P.apply(scene, th), target_linear, k, opts)

            loss, grads = jax.value_and_grad(loss_fn)(theta)
            updates, opt_state = opt.update(grads, opt_state)
            theta = optax.apply_updates(theta, updates)
            return theta, opt_state, loss

    history = []
    for i in range(start, steps):
        k = jax.random.fold_in(key, i) if resample_noise else key
        theta, opt_state, loss = step(theta, opt_state, k)
        history.append(float(loss))
        if (
            checkpoint_dir is not None
            and (i + 1) % checkpoint_every == 0
        ):
            from ray_tracying.diff import checkpoint as ckpt

            ckpt.save(checkpoint_dir, i + 1, theta, opt_state)
    return P.apply(scene, theta), theta, history
