"""Checkpoint save / restore / resume (diff/checkpoint.py)."""

import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ray_tracying.diff import checkpoint as ckpt


def state(scale=1.0):
    theta = {"materials.diffuse": jnp.full((3, 3), 0.5 * scale),
             "lights.intensity": jnp.asarray([100.0 * scale])}
    return theta, optax.adam(1e-2).init(theta)


def test_save_restore_round_trip(tmp_path):
    d = str(tmp_path / "ck")
    assert ckpt.restore(d, *state()) is None
    theta, opt = state(2.0)
    opt = opt[:1] + opt[1:]  # same structure, a fresh tuple
    ckpt.save(d, 7, theta, opt)
    step, th, op = ckpt.restore(d, *state())
    assert step == 7
    for k in theta:
        np.testing.assert_array_equal(np.asarray(th[k]), np.asarray(theta[k]))
    a, b = op[0], opt[0]
    assert int(a.count) == int(b.count)
    np.testing.assert_array_equal(np.asarray(a.mu["lights.intensity"]),
                                  np.asarray(b.mu["lights.intensity"]))


def test_keeps_newest_and_restores_latest(tmp_path):
    d = str(tmp_path / "ck")
    for step in (1, 2, 3, 4, 5):
        ckpt.save(d, step, *state(step), keep=2)
    files = sorted(os.listdir(d))
    assert files == ["ckpt_000000004.npz", "ckpt_000000005.npz"]
    step, th, _ = ckpt.restore(d, *state())
    assert step == 5
    assert float(th["lights.intensity"][0]) == pytest.approx(500.0)


def test_restore_rejects_other_structure(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, *state())
    theta = {"materials.diffuse": jnp.zeros((4, 3)),
             "lights.intensity": jnp.zeros(1)}
    with pytest.raises(ValueError):
        ckpt.restore(d, theta, optax.adam(1e-2).init(theta))
    with pytest.raises(ValueError):
        ckpt.restore(d, {"lights.intensity": jnp.zeros(1)}, ())


def test_no_temporary_files_left(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, *state())
    assert [f for f in os.listdir(d) if not f.endswith(".npz")] == []
