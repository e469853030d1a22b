"""Stackless packet BVH traversal in plain XLA: skip-link walk, vectorized
closest hit. The BVH traversal on the CPU (``render.bvh_traversal``); the
GPU runs the per-ray CUDA kernel of ``gpu_traverse`` instead.

Re-design of terra_bvh_traverse (reference src/TerraBVH.c:250-310).
The reference walks a per-ray explicit stack — per-lane pointer chasing that
array code cannot vectorize. Here:

  * the tree is *threaded* at build time (lbvh._thread_tree): every node
    carries its preorder successor (``dfs_next``) and its skip-subtree
    successor (``dfs_skip``), so traversal state per packet is ONE node id —
    no stack, no scatters (the north star's "stackless" scheme);
  * rays are grouped into packets sharing that single cursor (classic
    coherent packet tracing): hit-any-ray -> descend (dfs_next), miss or
    pruned -> skip (dfs_skip);
  * the walk alternates two phases inside one ``lax.while_loop``:
      advance — cheap packet-granular AABB steps until every live packet
                rests on a leaf whose box some ray hits,
      leaf    — one dense fixed-shape Moller-Trumbore batch
                (packets x rays x leaf_size) that is useful for every
                packet simultaneously;
  * a packet prunes a subtree when no member ray can beat its current best
    t inside the subtree's box (any-reduction over the packet).

All per-iteration memory traffic is packet-granular gathers (thousands of
rows); the lane-wide math is dense and fusable. Packet dilation is the cost
of coherence; primary rays are pixel-coherent by construction.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..intersect import RayHit, T_FAR, mt_grid_components

__all__ = ["raycast", "PACKET_SIZE"]

PACKET_SIZE = 64
ADVANCE_UNROLL = 8  # skip-link steps per advance iteration


def _spread3(v):  # 10-bit Morton spread
    v = (v | (v << 16)) & jnp.uint32(0x030000FF)
    v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
    v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
    v = (v | (v << 2)) & jnp.uint32(0x09249249)
    return v


def _morton3_bits(x, bits):
    """Interleaved Morton code of (..., 3) values already scaled to
    [0, 2^bits); returns 3*bits-bit codes."""
    q = jnp.clip(x, 0.0, float((1 << bits) - 1)).astype(jnp.uint32)
    return (
        (_spread3(q[..., 0]) << jnp.uint32(2))
        | (_spread3(q[..., 1]) << jnp.uint32(1))
        | _spread3(q[..., 2])
    ) & jnp.uint32((1 << (3 * bits)) - 1)


def sort_keys(o, d, scene_min, scene_max):
    """Coherence keys for reordering rays: direction octant (3 high bits)
    + 7-bit/axis Morton code of the origin in the scene box. Sorting by it
    groups incoherent (bounce) rays into tight packets."""
    inv_ext = 1.0 / jnp.maximum(scene_max - scene_min, 1e-12)
    on = (o - scene_min) * inv_ext  # [0,1] inside the scene
    dkey = _morton3_bits((d + 1.0) * 0.5 * 2.0, 1)
    morton = _morton3_bits(on * 127.0, 7)  # 21 bits
    return (dkey << jnp.uint32(21)) | morton


def _packet_raycast(bvh, tri_a, tri_b, tri_c, o, d, max_outer: int = 4096,
                    algo: str = "mt", t_init=None, any_hit: bool = False):
    """o, d: (P2, P, 3). Returns (best_t, best_tri) of shape (P2, P).
    ``t_init``: optional (P2, P) best-t seed (occlusion queries)."""
    p2, p, _ = o.shape
    ni = bvh.num_internal
    leaf_size = bvh.leaf_size
    inv_d = jnp.where(jnp.abs(d) > 1e-12, 1.0 / d, jnp.float32(1e12))

    # flattened leaf corner tables: (C, L, 3)
    leaf_tri_flat = bvh.leaf_tri.reshape(-1)
    la = tri_a[leaf_tri_flat].reshape(bvh.num_leaves, leaf_size, 3)
    lb = tri_b[leaf_tri_flat].reshape(bvh.num_leaves, leaf_size, 3)
    lc = tri_c[leaf_tri_flat].reshape(bvh.num_leaves, leaf_size, 3)

    END = jnp.int32(-1)

    def box_any_hit(cur, best_t):
        """Does any packet ray hit cur's AABB closer than its best?"""
        safe = jnp.maximum(cur, 0)
        bmin = bvh.node_min[safe]
        bmax = bvh.node_max[safe]
        t1 = (bmin[:, None, :] - o) * inv_d
        t2 = (bmax[:, None, :] - o) * inv_d
        tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
        tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
        # >= not >: flat boxes (zero-extent axis) give tmin == tmax for
        # every ray through them (see intersect.ray_aabb).
        hit = (tmax >= jnp.maximum(tmin, 0.0)) & (tmin < best_t)
        return jnp.any(hit, axis=1)

    def advance_step(cur, best_t):
        """One skip-link step: internals descend/skip by box test; leaves
        with a box hit STAY (ready for the leaf phase); missed leaves skip."""
        live = cur >= 0
        hit = box_any_hit(cur, best_t) & live
        is_leaf = (cur >= ni) & live
        ready = is_leaf & hit
        nxt = jnp.where(hit, bvh.dfs_next[jnp.maximum(cur, 0)], bvh.dfs_skip[jnp.maximum(cur, 0)])
        return jnp.where(live & ~ready, nxt, cur)

    def body(state):
        cur, best_t, best_i = state
        # --- advance: a few cheap steps toward the next hit leaf
        for _ in range(ADVANCE_UNROLL):
            cur = advance_step(cur, best_t)
        # --- leaf: dense MT for packets resting on a hit leaf
        at_leaf = cur >= ni
        leaf_id = jnp.where(at_leaf, cur - ni, 0)
        a = la[leaf_id]
        b = lb[leaf_id]
        c = lc[leaf_id]
        valid, t = mt_grid_components(o, d, a, b, c, algo=algo)  # (P2, P, L)
        t = jnp.where(valid & at_leaf[:, None, None], t, T_FAR)
        t_best_l = jnp.min(t, axis=2)
        arg_l = jnp.argmin(t, axis=2)
        tri_l = bvh.leaf_tri[leaf_id[:, None], arg_l]
        take = t_best_l < best_t
        if any_hit:
            # occlusion-only query: any accepted hit collapses best-t to 0,
            # pruning the lane from all later box tests; t is then only
            # "t < t_max".
            best_t = jnp.where(take, jnp.float32(0.0), best_t)
        else:
            best_t = jnp.where(take, t_best_l, best_t)
        best_i = jnp.where(take, tri_l, best_i)
        # move past the processed leaf
        cur = jnp.where(at_leaf, bvh.dfs_skip[jnp.maximum(cur, 0)], cur)
        return cur, best_t, best_i

    def cond(state):
        cur, _, _ = state
        return jnp.any(cur >= 0)

    cur0 = jnp.zeros((p2,), jnp.int32) if ni > 0 else jnp.full((p2,), ni, jnp.int32)
    best_t0 = jnp.full((p2, p), T_FAR, jnp.float32) if t_init is None else t_init
    best_i0 = jnp.zeros((p2, p), jnp.int32)
    if ni == 0:
        # single leaf: test it directly
        valid, t = mt_grid_components(o, d, la[0][None], lb[0][None], lc[0][None], algo=algo)
        t = jnp.where(valid & (t < best_t0[..., None]), t, T_FAR)
        best_t_l = jnp.min(t, axis=2)
        best_i0 = bvh.leaf_tri[0][jnp.argmin(t, axis=2)]
        return jnp.minimum(best_t_l, best_t0), best_i0
    cur, best_t, best_i = jax.lax.while_loop(cond, body, (cur0, best_t0, best_i0))
    return best_t, best_i


def hinted_keys(leaf_of_tri, sort_hint, d):
    """Parent-hit coherence keys, (parent hit's BVH leaf, 3-bit/axis
    direction): rays leaving the same leaf climb the same part of the
    tree, so packets become hierarchy-aligned rather than merely spatially
    close. ``sort_hint`` is the parent-hit triangle id per ray, or -1 for
    lanes with no parent (dead/masked lanes group together at the
    key-space top)."""
    # Sort-quality-only key: clamp real leaf ids below the dead-lane
    # sentinel (0x3FFFFF) so giant trees (leaf ids >= 2^23 would overflow
    # the uint32 shift, and id 0x3FFFFF would collide with the sentinel)
    # still produce valid, collision-free keys.
    leaf = jnp.where(
        sort_hint >= 0,
        jnp.minimum(leaf_of_tri[jnp.maximum(sort_hint, 0)].astype(jnp.uint32),
                    jnp.uint32(0x3FFFFE)),
        jnp.uint32(0x3FFFFF),
    )
    dn = (d + 1.0) * 0.5
    return (leaf << jnp.uint32(9)) | _morton3_bits(dn * 8.0, 3)


def leaf_of_tri_table(bvh):
    """(T,) i32: the BVH leaf holding each triangle (jit-traceable scatter;
    padded leaves repeat tris — last writer wins, any is valid)."""
    leaf_tri = bvh.leaf_tri  # (C, L)
    t = bvh.tri_order.shape[0]  # static triangle count
    leaf_ids = jnp.repeat(
        jnp.arange(leaf_tri.shape[0], dtype=jnp.int32), leaf_tri.shape[1]
    )
    return jnp.zeros(max(t, 1), jnp.int32).at[leaf_tri.reshape(-1)].set(leaf_ids)


def raycast(scene, o, d, packet_size: int = PACKET_SIZE, sort_rays: bool = True,
            algo: str = "mt", t_max=None, any_hit: bool = False,
            sort_hint=None, leaf_of_tri=None) -> RayHit:
    """Closest-hit via stackless LBVH packet traversal. o, d: (N, 3).

    ``sort_rays`` reorders lanes by (direction octant, origin Morton) before
    packetizing so incoherent bounce rays form tight packets, then restores
    the original order. Primary rays are already pixel-coherent, but the
    sort is cheap relative to traversal and never hurts.
    ``sort_hint``/``leaf_of_tri``: parent-hit keys (see hinted_keys).

    ``t_max``: optional (N,) per-ray best-t seed — the occlusion query;
    ``hit`` then means "occluded within t_max".
    """
    bvh = scene.bvh
    tri_a, tri_b, tri_c = scene.geometry.corners()
    n = o.shape[0]
    tm = t_max

    order = None
    if sort_rays and n > packet_size:
        root = 0 if bvh.num_internal > 0 else bvh.num_internal
        if sort_hint is not None and leaf_of_tri is not None:
            keys = hinted_keys(leaf_of_tri, sort_hint, d)
        else:
            keys = sort_keys(o, d, bvh.node_min[root], bvh.node_max[root])
        order = jnp.argsort(keys)
        o = o[order]
        d = d[order]
        if tm is not None:
            tm = tm[order]

    pad = -n % packet_size
    if pad:
        o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)], axis=0)
        d = jnp.concatenate([d, jnp.ones((pad, 3), d.dtype)], axis=0)
        if tm is not None:
            tm = jnp.concatenate([tm, jnp.zeros((pad,), tm.dtype)], axis=0)
    p2 = o.shape[0] // packet_size
    best_t, best_i = _packet_raycast(
        bvh,
        tri_a, tri_b, tri_c,
        o.reshape(p2, packet_size, 3),
        d.reshape(p2, packet_size, 3),
        algo=algo,
        t_init=None if tm is None else tm.reshape(p2, packet_size),
        any_hit=any_hit,
    )
    best_t = best_t.reshape(-1)[:n]
    best_i = best_i.reshape(-1)[:n]
    if order is not None:
        inv = jnp.zeros_like(order).at[order].set(jnp.arange(n, dtype=order.dtype))
        best_t = best_t[inv]
        best_i = best_i[inv]
    hit = best_t < (T_FAR if t_max is None else t_max)
    return RayHit(
        t=jax.lax.stop_gradient(best_t),
        tri=jax.lax.stop_gradient(jnp.where(hit, best_i, 0)),
        hit=hit,
    )
