"""Checkpoint / resume for inverse-rendering optimization runs.

The reference renders one-shot and keeps no state (SURVEY.md §5:
checkpoint/resume = none); the differentiable path adds long-running
parameter fitting, so fitted parameters + optimizer state checkpoint with
automatic resume (diff/optimize.fit(checkpoint_dir=...)).

Format: one `ckpt_<step>.npz` per step holding the flattened leaves of
(theta, opt_state).  The caller's `theta_like` / `opt_state_like` supply
the tree structure on restore.  Files are written to a temporary name and
renamed into place, so a reader never sees a partial checkpoint.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Optional, Tuple

import jax
import numpy as np

_NAME = re.compile(r"ckpt_(\d+)\.npz")


def _steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(m.group(1)) for m in map(_NAME.fullmatch, os.listdir(directory)) if m
    )


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:09d}.npz")


def save(directory: str, step: int, theta: Any, opt_state: Any,
         keep: int = 3) -> None:
    """Write {theta, opt_state} at `step` (retains the newest `keep`)."""
    os.makedirs(directory, exist_ok=True)
    leaves = jax.tree.leaves((theta, opt_state))
    arrays = {f"leaf_{i:05d}": np.asarray(x) for i, x in enumerate(leaves)}
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, step=np.int64(step), **arrays)
        os.replace(tmp, _path(directory, step))
    except BaseException:
        os.unlink(tmp)
        raise
    for old in _steps(directory)[:-keep]:
        os.unlink(_path(directory, old))


def restore(
    directory: str, theta_like: Any, opt_state_like: Any
) -> Optional[Tuple[int, Any, Any]]:
    """Load the latest (step, theta, opt_state), or None if no checkpoint.

    theta_like / opt_state_like supply the pytree structure and dtypes; a
    checkpoint whose leaves do not match them raises ValueError."""
    steps = _steps(directory)
    if not steps:
        return None
    like, treedef = jax.tree.flatten((theta_like, opt_state_like))
    with np.load(_path(directory, steps[-1])) as z:
        names = sorted(k for k in z.files if k.startswith("leaf_"))
        if len(names) != len(like):
            raise ValueError(
                f"checkpoint has {len(names)} leaves, expected {len(like)}"
            )
        leaves = []
        for name, ref in zip(names, like):
            a = z[name]
            if a.shape != np.shape(ref):
                raise ValueError(
                    f"{name}: shape {a.shape}, expected {np.shape(ref)}"
                )
            leaves.append(jax.numpy.asarray(a, dtype=np.asarray(ref).dtype))
        step = int(z["step"])
    theta, opt_state = jax.tree.unflatten(treedef, leaves)
    return step, theta, opt_state
