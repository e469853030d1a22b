"""BVH build: binary tree over triangles with fixed-size padded leaves.

The reference builds a per-triangle binary SAH tree (x-axis-only sweep,
reference src/TerraBVH.c:79-126) walked with an explicit per-ray
stack (TerraBVH.c:250-310). Here:

  * the default builder is the native binned SAH (16 bins x 3 axes,
    ``terra_tpu.native``); the Morton LBVH (Karras 2012 radix tree over
    leaf Morton codes, vectorized NumPy) serves per-frame rebuilds and
    hosts without a C++ compiler,
  * leaves hold up to ``leaf_size`` triangles, padded by repeating the
    last one (fixed-shape leaf tests for the XLA walk; the GPU kernel's
    packing drops the padding),
  * the result is a flat SoA node table (index arrays, not pointers) read
    by both traversals: the per-ray CUDA kernel (``gpu_traverse``) and the
    threaded skip-link walk (``traverse``).

Build runs host-side at commit time, like the reference's
terra_scene_commit -> terra_bvh_create path (Terra.c:162-191). ``refit``
re-computes AABBs only (for vertex edits / "mesh move", Scene.cpp:271-321).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["LBVH", "build", "refit", "DEFAULT_LEAF_SIZE"]

# Leaf size of every build that names none (chosen by the leaf-size sweep
# on the GPU traversal, PERF.md).
DEFAULT_LEAF_SIZE = 4


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "node_min",
        "node_max",
        "node_left",
        "node_right",
        "node_is_leaf",
        "leaf_tri",
        "tri_order",
        "dfs_next",
        "dfs_skip",
    ],
    meta_fields=["leaf_size", "num_leaves", "depth"],
)
@dataclass
class LBVH:
    """Flat SoA tree. Internal nodes: 0..C-2; leaves indexed separately.

    node_min/max : (C-1+C, 3) AABBs in the unified id space: rows
                   0..C-2 are internal nodes, rows C-1.. are leaves (so a
                   child id indexes this array directly)
    node_left/right : (C-1,) child ids; value < C-1 = internal node id,
                      value >= C-1 encodes leaf id (value - (C-1))
    node_is_leaf : unused for internals (kept for clarity)
    leaf_tri : (C, leaf_size) global triangle ids per leaf (padded by
               repeating the last valid id; degenerate duplicates are
               harmless for closest-hit)
    tri_order : (T,) morton-sorted triangle permutation (for debugging)
    leaf_size, num_leaves : static metadata
    """

    node_min: jax.Array
    node_max: jax.Array
    node_left: jax.Array
    node_right: jax.Array
    node_is_leaf: jax.Array
    leaf_tri: jax.Array
    tri_order: jax.Array
    dfs_next: jax.Array  # (ni+C,) preorder successor (stackless threading)
    dfs_skip: jax.Array  # (ni+C,) preorder successor skipping the subtree
    leaf_size: int
    num_leaves: int
    # Max root->leaf node count (static, host-computed at build): the GPU
    # kernel's ordered stack holds at most depth - 1 entries, which
    # gpu_traverse.raycast checks against its stack size at trace time.
    depth: int = 0

    @property
    def num_internal(self) -> int:
        return self.node_left.shape[0]


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10 bits per axis -> 30-bit Morton codes. x in [0,1)^3."""
    q = np.clip((x * 1024.0).astype(np.uint64), 0, 1023)

    def expand(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return (expand(q[:, 0]) << np.uint64(2)) | (expand(q[:, 1]) << np.uint64(1)) | expand(q[:, 2])


def _karras_tree(codes: np.ndarray):
    """Vectorized Karras 2012 binary radix tree over sorted unique codes.

    codes: (C,) uint64, strictly increasing (uniqueness enforced by caller
    via appended index bits). Returns (left, right) child arrays for the
    C-1 internal nodes; child >= C-1 encodes leaf (child - (C-1)).
    """
    c = len(codes)
    if c == 1:
        return np.zeros((0,), np.int32), np.zeros((0,), np.int32)

    codes = codes.astype(np.uint64)

    def delta(i, j):
        """Common-prefix length between codes[i] and codes[j]; -1 out of
        range. i, j: int64 arrays."""
        out = np.full(i.shape, -1, np.int64)
        ok = (j >= 0) & (j < c)
        x = codes[i[ok]] ^ codes[j[ok]]
        # count leading zeros of 64-bit x (x != 0 guaranteed: codes unique)
        lz = 63 - np.floor(np.log2(x.astype(np.float64) + 0.5)).astype(np.int64)
        lz = np.where(x == 0, 64, lz)
        res = np.full(i.shape, -1, np.int64)
        res[ok] = lz
        return res

    i = np.arange(c - 1, dtype=np.int64)
    d = np.sign(delta(i, i + 1) - delta(i, i - 1)).astype(np.int64)
    d = np.where(d == 0, 1, d)

    # upper bound on range length
    delta_min = delta(i, i - d)
    lmax = np.full(c - 1, 2, np.int64)
    grow = np.ones(c - 1, bool)
    while grow.any():
        cand = i + lmax * d
        grow = delta(i, cand) > delta_min
        lmax = np.where(grow, lmax * 2, lmax)

    # binary search exact other end
    l = np.zeros(c - 1, np.int64)
    t = lmax // 2
    while (t >= 1).any():
        cand = i + (l + t) * d
        ok = delta(i, cand) > delta_min
        l = np.where((t >= 1) & ok, l + t, l)
        t = t // 2
    j = i + l * d

    # split search
    delta_node = delta(i, j)
    s = np.zeros(c - 1, np.int64)
    t = np.int64(1)
    # t iterates ceil(l / 2^k)
    max_l = int(l.max()) if len(l) else 0
    divs = []
    dv = 2
    while True:
        divs.append(dv)
        if dv >= max(max_l, 2):
            break
        dv *= 2
    for dv in divs:
        t = (l + dv - 1) // dv
        cand = i + (s + t) * d
        ok = delta(i, cand) > delta_node
        s = np.where(ok, s + t, s)
    gamma = i + s * d + np.minimum(d, 0)

    left = np.where(np.minimum(i, j) == gamma, gamma + (c - 1), gamma).astype(np.int32)
    right = np.where(np.maximum(i, j) == gamma + 1, gamma + 1 + (c - 1), gamma + 1).astype(np.int32)
    return left, right


def build(geometry, leaf_size: int | None = None, builder: str = "sah") -> LBVH:
    """Host-side BVH build from a Geometry (SURVEY.md §7 step 5).

    ``builder`` selects the native C++ builder (terra_tpu.native):
      "sah"  — binned SAH, 16 bins x 3 axes (default; the reference's
               builder is a sweep SAH, TerraBVH.c:79-126 — x-axis-only,
               which this strictly improves on). Leaves hold
               [leaf_size/2, leaf_size] triangles, padded by repetition.
      "lbvh" — Morton cluster LBVH (faster build; use for per-frame
               rebuilds of dynamic geometry).
    Falls back to the vectorized NumPy LBVH when the native library is
    unavailable.

    ``leaf_size=None`` takes DEFAULT_LEAF_SIZE."""
    pos = np.asarray(geometry.positions)
    vidx = np.asarray(geometry.tri_vidx)
    from .. import native

    use_sah = builder == "sah" and native.available()
    if leaf_size is None:
        leaf_size = DEFAULT_LEAF_SIZE
    nat = native.sah_build(pos, vidx, leaf_size) if use_sah else native.lbvh_build(pos, vidx, leaf_size)

    if nat is not None:
        c = nat["num_leaves"]
        return LBVH(
            node_min=jnp.asarray(nat["box_min"]),
            node_max=jnp.asarray(nat["box_max"]),
            node_left=jnp.asarray(nat["left"]),
            node_right=jnp.asarray(nat["right"]),
            node_is_leaf=jnp.zeros((max(c - 1, 0),), jnp.int32),
            leaf_tri=jnp.asarray(nat["leaf_tri"]),
            tri_order=jnp.asarray(nat["tri_order"]),
            dfs_next=jnp.asarray(nat["dfs_next"]),
            dfs_skip=jnp.asarray(nat["dfs_skip"]),
            leaf_size=leaf_size,
            num_leaves=c,
            depth=_tree_depth(nat["left"], nat["right"]),
        )
    a, b, c3 = pos[vidx[:, 0]], pos[vidx[:, 1]], pos[vidx[:, 2]]
    t = len(vidx)

    centroid = (a + b + c3) / 3.0
    lo = centroid.min(axis=0)
    hi = centroid.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    codes = _morton3((centroid - lo) / extent)
    order = np.argsort(codes, kind="stable").astype(np.int32)

    num_leaves = (t + leaf_size - 1) // leaf_size
    # leaf triangle table, padded with the last valid tri of each leaf
    leaf_tri = np.zeros((num_leaves, leaf_size), np.int32)
    for k in range(leaf_size):
        idx = np.minimum(np.arange(num_leaves) * leaf_size + k, t - 1)
        leaf_tri[:, k] = order[idx]

    # unique leaf codes: representative code + leaf index in low bits
    leaf_code = codes[order[np.minimum(np.arange(num_leaves) * leaf_size, t - 1)]]
    leaf_code = (leaf_code.astype(np.uint64) << np.uint64(32)) | np.arange(
        num_leaves, dtype=np.uint64
    )
    left, right = _karras_tree(leaf_code)

    # bottom-up AABB refit (vectorized fixpoint over levels), unified
    # [internal; leaf] id space
    node_min, node_max = _refit_host(pos, vidx, leaf_tri, left, right)
    dfs_next, dfs_skip = _thread_tree(left, right, num_leaves)

    return LBVH(
        node_min=jnp.asarray(node_min),
        node_max=jnp.asarray(node_max),
        node_left=jnp.asarray(left),
        node_right=jnp.asarray(right),
        node_is_leaf=jnp.zeros((max(num_leaves - 1, 0),), jnp.int32),
        leaf_tri=jnp.asarray(leaf_tri),
        tri_order=jnp.asarray(order),
        dfs_next=jnp.asarray(dfs_next),
        dfs_skip=jnp.asarray(dfs_skip),
        leaf_size=leaf_size,
        num_leaves=num_leaves,
        depth=_tree_depth(left, right),
    )


def _tree_depth(left, right) -> int:
    """Max root->leaf node count of the binary tree (host, at build)."""
    ni = len(left)
    if ni == 0:
        return 1
    mx = 1
    stack = [(0, 1)]
    while stack:
        n, dep = stack.pop()
        if dep > mx:
            mx = dep
        for c in (int(left[n]), int(right[n])):
            if c < ni:
                stack.append((c, dep + 1))
    return mx + 1  # + the leaf level


def _thread_tree(left, right, num_leaves):
    """Preorder threading for stackless traversal: for each node (unified id
    space: [0, ni) internal, [ni, ni+C) leaves) compute

      dfs_next[n] — the preorder successor when *descending* into n
                    (its left child for internals; == dfs_skip for leaves),
      dfs_skip[n] — the node that follows n's entire subtree (-1 at end).

    Traversal is then a pure pointer walk: hit -> dfs_next, miss ->
    dfs_skip. This is the 'stackless rope' scheme SURVEY.md §7 calls for —
    per-packet state is ONE integer, no stack scatters.
    """
    ni = len(left)
    total = ni + num_leaves
    dfs_next = np.full(total, -1, np.int64)
    dfs_skip = np.full(total, -1, np.int64)
    if ni == 0:
        return dfs_next.astype(np.int32), dfs_skip.astype(np.int32)

    # iterative preorder with explicit (node, continuation) stack
    stack = [(0, -1)]
    while stack:
        node, cont = stack.pop()
        dfs_skip[node] = cont
        if node < ni:
            l, r = int(left[node]), int(right[node])
            dfs_next[node] = l
            stack.append((r, cont))
            stack.append((l, r))
        else:
            dfs_next[node] = cont
    return dfs_next.astype(np.int32), dfs_skip.astype(np.int32)


def _leaf_bounds(pos, vidx, leaf_tri):
    tri = leaf_tri.reshape(-1)
    corners = np.stack(
        [pos[vidx[tri, 0]], pos[vidx[tri, 1]], pos[vidx[tri, 2]]], axis=1
    )  # (C*L, 3corners, 3)
    corners = corners.reshape(leaf_tri.shape[0], -1, 3)
    return corners.min(axis=1), corners.max(axis=1)


def _refit_host(pos, vidx, leaf_tri, left, right):
    """Bottom-up AABB computation; returns UNIFIED (ni + C, 3) boxes where
    rows [0, ni) are internal nodes and rows [ni, ni+C) are leaves."""
    ni = len(left)
    leaf_min, leaf_max = _leaf_bounds(pos, vidx, leaf_tri)
    c = leaf_min.shape[0]
    box_min = np.full((ni + c, 3), np.inf, np.float32)
    box_max = np.full((ni + c, 3), -np.inf, np.float32)
    box_min[ni:] = leaf_min
    box_max[ni:] = leaf_max
    known = np.zeros(ni + c, bool)
    known[ni:] = True

    for _ in range(ni + 1):
        if known.all():
            break
        ready = known[left] & known[right] & ~known[:ni]
        box_min[:ni][ready] = np.minimum(box_min[left[ready]], box_min[right[ready]])
        box_max[:ni][ready] = np.maximum(box_max[left[ready]], box_max[right[ready]])
        known[:ni] |= ready
    assert known.all(), "BVH refit did not converge (cycle?)"
    return box_min, box_max


def refit(bvh: LBVH, geometry) -> LBVH:
    """Re-fit AABBs for updated vertex positions (fixed topology) — the
    fast path for the reference's ``mesh move`` (Scene.cpp:271-321 forces a
    full rebuild; here topology-preserving edits just refit)."""
    import dataclasses

    pos = np.asarray(geometry.positions)
    vidx = np.asarray(geometry.tri_vidx)
    node_min, node_max = _refit_host(
        pos, vidx, np.asarray(bvh.leaf_tri), np.asarray(bvh.node_left), np.asarray(bvh.node_right)
    )
    return dataclasses.replace(
        bvh, node_min=jnp.asarray(node_min), node_max=jnp.asarray(node_max)
    )
