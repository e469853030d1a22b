"""Ray/primitive intersection: vectorized, wavefront-wide.

Replaces the scalar geometry kernels of the reference
(/root/reference/src/TerraGeometry.c and the slab AABB test at
Terra.c:851-878) with batched jnp implementations:

  * Moller-Trumbore ray/triangle (TerraGeometry.c:34-87 and the legacy path
    Terra.c:880-1020), fully vectorized over (rays x triangles).
  * Wald2013-style watertight test (TerraGeometry.c:98-259), selectable at
    render time via ``RenderOptions.intersector`` (the runtime analogue of
    the reference's compile-time switch, TerraGeometry.c:25-31); the f64
    fallback of the reference (TerraGeometry.c:204-208) is replaced by an
    epsilon-free sign-consistency test in f32 (no f64 on the hot path).
  * A brute-force closest-hit sweep: for small scenes (Cornell-class) a
    dense rays-x-triangles test is perfectly regular work with zero
    divergence, so it is a first-class accelerator (Accelerator.BRUTE),
    not a fallback, and the oracle every BVH traversal is gated on.

Gradient policy: raycast produces discrete indices + t under stop_gradient;
differentiable hit attributes are recomputed from the chosen triangle in
``surface.py`` (SURVEY.md §7 hard part (b)).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .ops import math3

__all__ = [
    "RayHit", "ray_aabb", "moller_trumbore", "watertight_components",
    "raycast_brute", "RAY_OFFSET_DIR", "SURFACE_OFFSET_NORMAL",
]

RAY_OFFSET_DIR = np.float32(1e-3)  # origin nudge along dir (Terra.c:1629)
SURFACE_OFFSET_NORMAL = np.float32(1e-4)  # normal offset (Terra.c:1716)
T_FAR = np.float32(3.4e38)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["t", "tri", "hit"],
    meta_fields=[],
)
@dataclass
class RayHit:
    """Closest-hit result per lane.

    t   : (N,) f32 — hit distance from the (offset) ray origin, T_FAR on miss
    tri : (N,) i32 — global triangle index (0 on miss; check ``hit``)
    hit : (N,) bool
    """

    t: jax.Array
    tri: jax.Array
    hit: jax.Array


# Canonical ray for terminated/masked lanes: origin far outside any scene,
# so every AABB/triangle test misses immediately. With the BVH coherence
# sort, masked lanes cluster into all-dead packets whose traversal ends
# after the root pop — masked-lane "compaction" without changing the
# estimator (every contribution is already gated on the active mask).
MISS_ORIGIN = np.float32(3.0e5)


def mask_dead_rays(active, o, d):
    """Replace rays of inactive lanes with the canonical miss ray."""
    live = active[..., None]
    o_q = jnp.where(live, o, MISS_ORIGIN)
    d_q = jnp.where(live, d, jnp.asarray([1.0, 0.0, 0.0], o.dtype))
    return o_q, d_q


def ray_aabb(o, inv_d, box_min, box_max):
    """Branchless slab test (terra_ray_aabb_intersection, Terra.c:851-878).
    All args broadcastable (..., 3); returns (hit, tmin, tmax)."""
    t1 = (box_min - o) * inv_d
    t2 = (box_max - o) * inv_d
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    # >= not > (deviation from the reference's strict test): perfectly
    # flat boxes (an axis collapsed to zero extent, e.g. axis-aligned
    # walls) give tmin == tmax for EVERY ray through them; the strict
    # form rejects them all.
    return tmax >= jnp.maximum(tmin, 0.0), tmin, tmax


def moller_trumbore(o, d, a, b, c, eps: float = 1e-4):
    """Vectorized Moller-Trumbore (TerraGeometry.c:34-87; epsilon matches
    terra_Epsilon). Broadcasts rays (..., 3) against triangles (..., 3).

    Returns (valid, t, u, v): ``valid`` requires |det| > eps, barycentric
    inside, and t > eps (front hits only, no self-hit at origin).
    """
    e1 = b - a
    e2 = c - a
    h = math3.cross(d, e2)
    det = math3.dot(e1, h)
    valid = jnp.abs(det) > eps
    f = jnp.where(valid, jnp.reciprocal(jnp.where(valid, det, 1.0)), 0.0)
    s = o - a
    u = f * math3.dot(s, h)
    q = math3.cross(s, e1)
    v = f * math3.dot(d, q)
    t = f * math3.dot(e2, q)
    valid = valid & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps)
    return valid, t, u, v


def mt_components(oc, dc, ac, bc, cc, eps: float = 1e-4):
    """Component-wise Moller-Trumbore core: each argument is an (x, y, z)
    tuple of mutually broadcastable arrays. Returns (valid, t) broadcast.

    Written with scalar component arrays (no jnp.stack/cross) so XLA fuses
    the whole chain into the consuming reduction instead of materializing
    stacked (..., 3) intermediates.
    """
    ox, oy, oz = oc
    dx, dy, dz = dc
    ax, ay, az = ac
    bx, by, bz = bc
    cx, cy, cz = cc
    e1x, e1y, e1z = bx - ax, by - ay, bz - az
    e2x, e2y, e2z = cx - ax, cy - ay, cz - az
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    inv = 1.0 / jnp.where(jnp.abs(det) > eps, det, 1.0)
    sx, sy, sz = ox - ax, oy - ay, oz - az
    u = inv * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = inv * (dx * qx + dy * qy + dz * qz)
    t = inv * (e2x * qx + e2y * qy + e2z * qz)
    valid = (
        (jnp.abs(det) > eps)
        & (u >= 0.0)           # u <= 1 is implied by v >= 0 & u + v <= 1
        & (v >= 0.0) & (u + v <= 1.0)
        & (t > eps)
    )
    return valid, t


def watertight_components(oc, dc, ac, bc, cc, eps: float = 1e-4):
    """Wald2013-style watertight ray/triangle test, component-wise.

    The batched re-design of the reference's watertight kernel
    (terra_ray_triangle_intersection_init/query, TerraGeometry.c:98-259):

      * the per-ray shear transform of the reference's ``TerraRayState``
        (TerraPrivate.h:114-120) — max-|d| axis to +Z, winding-preserving
        kx/ky swap, shear constants — is recomputed inline from ``dc``
        via branchless selects (no AoS ray-state struct on a SIMD machine);
      * the 2D scaled barycentrics U, V, W get the paper's sign-consistency
        edge test: a hit iff U, V, W carry no OPPOSING signs, so rays
        through shared edges/vertices (where one of them is exactly 0)
        hit at least one of the adjacent triangles — no cracks;
      * the reference's double-precision fallback for tiny barycentrics
        (TerraGeometry.c:204-208) is dropped: the zero-tolerant sign test
        above already covers the exact-edge case the fallback exists for
        (documented deviation).

    Arguments/result match :func:`mt_components`: component tuples of
    mutually broadcastable arrays; returns (valid, t).
    """
    ox, oy, oz = oc
    dx, dy, dz = dc
    adx, ady, adz = jnp.abs(dx), jnp.abs(dy), jnp.abs(dz)
    m0 = (adx >= ady) & (adx >= adz)  # kz = x
    m1 = (~m0) & (ady >= adz)  # kz = y; else kz = z

    def perm(vx, vy, vz):
        """Permute to (kx, ky, kz) = (kz+1, kz+2, kz) cyclic order."""
        pz = jnp.where(m0, vx, jnp.where(m1, vy, vz))
        px = jnp.where(m0, vy, jnp.where(m1, vz, vx))
        py = jnp.where(m0, vz, jnp.where(m1, vx, vy))
        return px, py, pz

    dpx, dpy, dpz = perm(dx, dy, dz)
    swap = dpz < 0.0  # preserve winding when the ray points down the axis
    dpx, dpy = jnp.where(swap, dpy, dpx), jnp.where(swap, dpx, dpy)
    sz = 1.0 / jnp.where(dpz != 0.0, dpz, 1.0)
    sx = dpx * sz
    sy = dpy * sz

    def shear(vx, vy, vz):
        """Translate to ray origin, permute, apply the 2D shear."""
        px, py, pz = perm(vx - ox, vy - oy, vz - oz)
        px, py = jnp.where(swap, py, px), jnp.where(swap, px, py)
        return px - sx * pz, py - sy * pz, pz

    def dop(p1, p2, q1, q2):
        """p1*p2 - q1*q2 with zero-snapping: XLA contracts the expression
        into an FMA whose rounding residual turns an exactly-cancelling
        product pair into a tiny nonzero of arbitrary sign — which both
        breaks the sign-consistency edge test and makes zero-area
        (degenerate/padding) triangles "hit". Results within a few ulps of
        full cancellation are treated as exact 0, restoring the watertight
        guarantee (the reference instead falls back to f64 there,
        TerraGeometry.c:204-208)."""
        p = p1 * p2
        q = q1 * q2
        r = p - q
        snap = jnp.abs(r) <= jnp.maximum(jnp.abs(p), jnp.abs(q)) * np.float32(4e-7)
        return jnp.where(snap, 0.0, r)

    axp, ayp, azp = shear(*ac)
    bxp, byp, bzp = shear(*bc)
    cxp, cyp, czp = shear(*cc)
    u = dop(cxp, byp, cyp, bxp)
    v = dop(axp, cyp, ayp, cxp)
    w = dop(bxp, ayp, byp, axp)
    any_neg = (u < 0.0) | (v < 0.0) | (w < 0.0)
    any_pos = (u > 0.0) | (v > 0.0) | (w > 0.0)
    det = u + v + w
    t_scaled = (u * azp + v * bzp + w * czp) * sz
    t = t_scaled / jnp.where(det != 0.0, det, 1.0)
    valid = ~(any_neg & any_pos) & (det != 0.0) & (t > eps)
    return valid, t


def _comps(v, ray_axis: bool):
    """Split (..., 3) into broadcastable component tuples: rays get a
    trailing singleton tris-axis, triangles a leading singleton rays-axis."""
    if ray_axis:
        return (v[..., :, None, 0], v[..., :, None, 1], v[..., :, None, 2])
    return (v[..., None, :, 0], v[..., None, :, 1], v[..., None, :, 2])


def mt_grid_components(o, d, tri_a, tri_b, tri_c, eps: float = 1e-4, algo: str = "mt"):
    """Dense (rays x tris) intersection grid: o, d (..., N, 3) vs tri_*
    (..., TB, 3) -> (valid, t) of shape (..., N, TB). ``algo`` selects the
    kernel — "mt" (Moller-Trumbore) or "watertight" (Wald2013) — the
    runtime analogue of the reference's compile-time algorithm switch
    (TerraGeometry.c:25-31)."""
    fn = watertight_components if algo == "watertight" else mt_components
    return fn(
        _comps(o, True), _comps(d, True),
        _comps(tri_a, False), _comps(tri_b, False), _comps(tri_c, False),
        eps,
    )


def _closest_hit_block(o, d, tri_a, tri_b, tri_c, base_idx, algo: str = "mt"):
    """Dense (chunk, TB) test; returns per-ray (best_t, best_local_idx).

    Uses min + argmin (not take_along_axis, a per-row gather)."""
    valid, t = mt_grid_components(o, d, tri_a, tri_b, tri_c, algo=algo)
    t = jnp.where(valid, t, T_FAR)
    best_t = jnp.min(t, axis=1)
    best = jnp.argmin(t, axis=1)
    return best_t, base_idx + best.astype(jnp.int32)


def raycast_brute(o, d, tri_a, tri_b, tri_c, ray_chunk: int = 0, tri_block: int = 1024, algo: str = "mt") -> RayHit:
    """Closest-hit over all triangles, chunked to bound memory.

    o, d : (N, 3) rays (origins already offset by the caller)
    tri_* : (T, 3) triangle corners

    Outer ``lax.map`` over ray chunks x inner ``lax.scan`` over triangle
    blocks with a running (best_t, best_idx) carry — the array analogue of the
    reference's per-ray loop over BVH leaves (TerraBVH.c:250-310) when the
    scene is small enough that a dense sweep beats pointer chasing.

    ``ray_chunk=0`` (default) sizes chunks so the transient (chunk x TB)
    wavefront stays around 64M lanes-x-tris — big launches amortize; only
    very large N x T needs the chunking at all.
    """
    n = o.shape[0]
    t_count = tri_a.shape[0]
    tri_block = min(tri_block, max(t_count, 1))
    if ray_chunk <= 0:
        ray_chunk = max(8192, (64 << 20) // max(tri_block, 1))
    ray_chunk = min(ray_chunk, max(n, 1))

    # Pad rays to a chunk multiple, triangles to a block multiple.
    n_pad = -n % ray_chunk
    t_pad = -t_count % tri_block
    if n_pad:
        o = jnp.concatenate([o, jnp.zeros((n_pad, 3), o.dtype)], axis=0)
        d = jnp.concatenate([d, jnp.ones((n_pad, 3), d.dtype)], axis=0)
    if t_pad:
        # Degenerate (zero-area) padding triangles never intersect.
        z = jnp.zeros((t_pad, 3), tri_a.dtype)
        tri_a = jnp.concatenate([tri_a, z], axis=0)
        tri_b = jnp.concatenate([tri_b, z], axis=0)
        tri_c = jnp.concatenate([tri_c, z], axis=0)

    num_blocks = tri_a.shape[0] // tri_block
    blk_a = tri_a.reshape(num_blocks, tri_block, 3)
    blk_b = tri_b.reshape(num_blocks, tri_block, 3)
    blk_c = tri_c.reshape(num_blocks, tri_block, 3)
    block_base = (jnp.arange(num_blocks, dtype=jnp.int32) * tri_block)

    def per_chunk(rays):
        co, cd = rays

        def scan_block(carry, blk):
            best_t, best_i = carry
            a_, b_, c_, base = blk
            t_blk, i_blk = _closest_hit_block(co, cd, a_, b_, c_, base, algo)
            take = t_blk < best_t
            return (
                jnp.where(take, t_blk, best_t),
                jnp.where(take, i_blk, best_i),
            ), None

        init = (
            jnp.full((ray_chunk,), T_FAR, jnp.float32),
            jnp.zeros((ray_chunk,), jnp.int32),
        )
        (best_t, best_i), _ = jax.lax.scan(
            scan_block, init, (blk_a, blk_b, blk_c, block_base)
        )
        return best_t, best_i

    num_chunks = o.shape[0] // ray_chunk
    if num_chunks == 1:
        best_t, best_i = per_chunk((o, d))
    else:
        best_t, best_i = jax.lax.map(
            per_chunk,
            (o.reshape(num_chunks, ray_chunk, 3), d.reshape(num_chunks, ray_chunk, 3)),
        )
        best_t = best_t.reshape(-1)
        best_i = best_i.reshape(-1)
    best_t = best_t[:n]
    best_i = best_i[:n]
    hit = best_t < T_FAR
    return RayHit(
        t=jax.lax.stop_gradient(best_t),
        tri=jax.lax.stop_gradient(jnp.where(hit, best_i, 0)),
        hit=hit,
    )
