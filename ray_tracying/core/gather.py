"""Row gathers of small per-geom tables as one-hot matmuls.

`table[idx]` with a (R,)-shaped idx is written here as an (R, N) one-hot
contracted with the (N, F) table.  Precision HIGHEST keeps the result
exact: each output row sums one table row times 1.0 plus zeros.  The cost
is O(R * N); whether a plain gather is cheaper on the GPU is not measured
yet (ROADMAP A5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def onehot_gather(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """table: (N, ...), idx: (R,) int -> (R, ...).

    Out-of-range idx rows produce zeros (useful for masked slots)."""
    n = table.shape[0]
    oh = (idx[:, None] == jnp.arange(n, dtype=idx.dtype)[None, :]).astype(
        jnp.float32
    )
    flat = table.reshape(n, -1).astype(jnp.float32)
    out = jax.lax.dot_general(
        oh,
        flat,
        (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    return out.reshape(idx.shape + table.shape[1:])


def onehot_gather_int(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Integer-table variant (exact for |values| < 2^24)."""
    return jnp.round(onehot_gather(table.astype(jnp.float32), idx)).astype(
        table.dtype
    )
