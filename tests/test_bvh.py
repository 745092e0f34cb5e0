"""LBVH build invariants (host builder: C++ when loaded, else numpy)."""

import numpy as np

from ray_tracying.accel import lbvh
from ray_tracying.scene.loader import load_scene_dict

from test_scene_loader import minimal_camera


def cluttered_scene(n=40, seed=0):
    rng = np.random.default_rng(seed)
    d = minimal_camera()
    d["spheres"] = [
        {"location": rng.uniform(-3, 3, 3).tolist(), "radius": float(rng.uniform(0.1, 0.5))}
        for _ in range(n // 2)
    ]
    d["cubes"] = [
        {"translation": rng.uniform(-3, 3, 3).tolist(),
         "rotation": rng.uniform(0, 6.28, 3).tolist(),
         "scale": rng.uniform(0.1, 0.5, 3).tolist()}
        for _ in range(n - n // 2 - 1)
    ]
    d["planes"] = [
        {"corners": [[-4, 4, -1], [4, 4, -1], [4, 4, 3], [-4, 4, 3]]}
    ]
    return load_scene_dict(d)


def test_build_invariants():
    scene = cluttered_scene()
    aabbs = lbvh.geom_aabbs(scene)
    boxes, topo, order = lbvh.build_lbvh(aabbs)
    g = aabbs.shape[0]

    # Every geom appears exactly once across leaves.
    seen = []
    for left, right, first, count in topo:
        if left < 0:
            seen.extend(order[first:first + count])
            assert count <= lbvh.LEAF_SIZE
    assert sorted(seen) == list(range(g))

    # Parent boxes contain child boxes; leaf boxes contain member AABBs.
    for i, (left, right, first, count) in enumerate(topo):
        if left >= 0:
            for child in (left, right):
                assert (boxes[child][:3] >= boxes[i][:3] - 1e-5).all()
                assert (boxes[child][3:] <= boxes[i][3:] + 1e-5).all()
        else:
            members = aabbs[order[first:first + count]]
            assert (members[:, :3] >= boxes[i][:3] - 1e-5).all()
            assert (members[:, 3:] <= boxes[i][3:] + 1e-5).all()


def test_sphere_aabb_includes_velocity_extent():
    """Sphere boxes merge the velocity-displaced corners
    (Code/shapes.cpp:272-285)."""
    d = minimal_camera()
    d["spheres"] = [
        {"location": [0, 0, 0], "radius": 1.0, "velocity": [10.0, 0, 0]}
    ]
    scene = load_scene_dict(d)
    box = lbvh.geom_aabbs(scene)[0]
    # velocity/5 = 2: box spans [-1, 1+2] in x.
    np.testing.assert_allclose(box[:3], [-1, -1, -1], atol=1e-5)
    np.testing.assert_allclose(box[3:], [3, 1, 1], atol=1e-5)
