"""LBVH construction.

Replaces the reference's pointer-based recursive median-split BVH
(Code/acceleration.cpp:20-64) with a flat structure:

  - per-geom AABBs with the reference's exact semantics (sphere boxes
    include the velocity-displaced time-1 extent, Code/shapes.cpp:264-287;
    plane boxes padded 1e-4, :496-503; node box = merge of member boxes,
    acceleration.cpp:21-25)
  - geoms sorted by 30-bit Morton code of their AABB centroids
  - balanced median split over the sorted order (an "LBVH-lite": the
    radix-tree topology of Karras 2012 is unnecessary because builds are
    per-scene, not per-frame), leaves hold <= 4 geoms like the reference
    (acceleration.cpp:30)
  - flat arrays: boxes (M, 6) f32 [min|max], topo (M, 4) int32
    [left, right, first, count] with left = -1 marking a leaf, and the
    sorted geom order for reordering the packed geom table.

Traversal order never affects the image: the closest hit is a min over
the full hit set (SURVEY.md §2 quirk 15), so this build does NOT need to
reproduce the reference's in-place sort topology.

The build runs on the host: the C++ builder (ray_tracying.native) when it
loaded, else numpy, with identical output.  No traversal runs on the
device yet: every backend intersects by brute force, which finds the same
hit set (ROADMAP B1).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ray_tracying.scene.types import KIND_RECT, KIND_SPHERE, Scene

LEAF_SIZE = 4  # reference: acceleration.cpp:30


def geom_aabbs(scene: Scene) -> np.ndarray:
    """(G, 6) [min xyz | max xyz] with reference AABB semantics."""
    boxes = []
    if scene.n_prims:
        o2w = np.asarray(scene.prims.o2w)         # (P, 3, 4)
        kind = np.asarray(scene.prims.kind)
        vel = np.asarray(scene.prims.velocity)
        # Unit-cube corners; spheres use +-1 (shapes.cpp:267-270), cubes and
        # rects +-0.5 (rects flat in z, shapes.cpp:337-340,427-430).
        signs = np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
            np.float32,
        )  # (8, 3)
        half = np.where(kind[:, None] == KIND_SPHERE, 1.0, 0.5)  # (P, 1)
        corners = signs[None, :, :] * half[:, None, :]           # (P, 8, 3)
        corners[kind == KIND_RECT, :, 2] = 0.0
        world = (
            np.einsum("pij,pcj->pci", o2w[:, :, :3], corners) + o2w[:, None, :, 3]
        )  # (P, 8, 3)
        # Sphere motion extent: also merge corners displaced by velocity
        # (shapes.cpp:272-285).
        moved = world + vel[:, None, :]
        allc = np.concatenate([world, moved], axis=1)  # (P, 16, 3)
        boxes.append(
            np.concatenate([allc.min(axis=1), allc.max(axis=1)], axis=1)
        )
    if scene.n_planes:
        c = np.asarray(scene.planes.corners)  # (Q, 4, 3)
        pad = 1e-4  # shapes.cpp:498
        boxes.append(
            np.concatenate([c.min(axis=1) - pad, c.max(axis=1) + pad], axis=1)
        )
    if not boxes:
        return np.zeros((0, 6), np.float32)
    return np.concatenate(boxes, axis=0).astype(np.float32)


def morton_codes(centroids: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of normalized centroids."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    q = np.clip(((centroids - lo) / span * 1023.0), 0, 1023).astype(np.uint32)

    def spread(v):
        v = (v | (v << 16)) & np.uint32(0x030000FF)
        v = (v | (v << 8)) & np.uint32(0x0300F00F)
        v = (v | (v << 4)) & np.uint32(0x030C30C3)
        v = (v | (v << 2)) & np.uint32(0x09249249)
        return v

    return (
        (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    ).astype(np.uint64)


def build_lbvh(
    aabbs: np.ndarray, leaf_size: int = LEAF_SIZE
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (boxes (M, 6), topo (M, 4) int32, order (G,) int64).

    topo rows: [left, right, first, count]; left == -1 marks a leaf whose
    geoms are order[first : first+count]."""
    from ray_tracying.native import lbvh_native

    if lbvh_native is not None and aabbs.shape[0]:
        return lbvh_native.build(aabbs, leaf_size)
    return _build_lbvh_numpy(aabbs, leaf_size)


def _build_lbvh_numpy(aabbs: np.ndarray, leaf_size: int):
    g = aabbs.shape[0]
    if g == 0:
        return (
            np.zeros((1, 6), np.float32),
            np.array([[-1, -1, 0, 0]], np.int32),
            np.zeros(0, np.int64),
        )
    centroids = (aabbs[:, :3] + aabbs[:, 3:]) * 0.5
    order = np.argsort(morton_codes(centroids), kind="stable")
    sorted_boxes = aabbs[order]

    boxes: list = []
    topo: list = []

    # Iterative preorder build over [start, end) ranges of the sorted list.
    # Children are emitted depth-first so left == parent+1 always; we still
    # store both child ids explicitly for kernel simplicity.
    def alloc():
        boxes.append(None)
        topo.append(None)
        return len(boxes) - 1

    stack = [(alloc(), 0, g)]
    while stack:
        node, start, end = stack.pop()
        seg = sorted_boxes[start:end]
        bmin = seg[:, :3].min(axis=0)
        bmax = seg[:, 3:].max(axis=0)
        boxes[node] = np.concatenate([bmin, bmax])
        if end - start <= leaf_size:
            topo[node] = [-1, -1, start, end - start]
            continue
        mid = (start + end) // 2
        left = alloc()
        right = alloc()
        topo[node] = [left, right, 0, 0]
        # Push right first so left is processed next (preorder).
        stack.append((right, mid, end))
        stack.append((left, start, mid))

    return (
        np.stack(boxes).astype(np.float32),
        np.array(topo, np.int32),
        order,
    )
