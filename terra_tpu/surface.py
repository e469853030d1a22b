"""Differentiable shading-surface construction (wavefront-wide).

Replaces terra_surface_init (/root/reference/src/Terra.c:1726-1764). The
raycast (intersect.py / the BVH kernel) returns only discrete triangle ids
under stop_gradient; everything continuous — hit distance, position,
barycentrics, interpolated normal/uv, material attributes — is recomputed
here *differentiably* from the vertex buffer, so gradients flow to vertex
positions and material parameters without differentiating through the
discrete hit choice (SURVEY.md §7 hard part (b)).

Design note: instead of per-lane chained gathers
(positions[tri_vidx[tri,k]] x3, normals[tri], uvs[tri], attrs[mat[tri]]),
all per-triangle data is packed into ONE (T, 25) "shade table" built per
trace (T-sized, cheap, differentiable) and fetched per lane with a single
row lookup: a one-hot matmul for small scenes, a single wide gather for
large ones. Material rows (always few) are fetched the same
way from a packed (M, 29) table.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from . import textures
from .ops import math3
from .scene import Scene, MAX_ATTRS

__all__ = ["Surface", "ShadeTables", "build_shade_tables", "surface_init"]

# Max triangle count for the one-hot-matmul fetch path; larger tables use a
# plain row gather.
ONEHOT_MAX_ROWS = 512


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["tri", "mat", "light"],
    meta_fields=[],
)
@dataclass
class ShadeTables:
    """Packed per-triangle + per-material + per-light tables (built once
    per trace).

    tri : (T, 26) f32 — va(0:3) vb(3:6) vc(6:9) n0(9:12) n1(12:15)
          n2(15:18) uv0(18:20) uv1(20:22) uv2(22:24) mat_id(24) obj_id(25)
    mat : (M, 29) f32 — bsdf_type(0) ior(1) emissive(2:5) attrs(5:29)
    light : (Lcap, 30) f32 — a(0:3) b(3:6) c(6:9) n0(9:12) n1(12:15)
          n2(15:18) uv0(18:20) uv1(20:22) uv2(22:24) area(24)
          emissive(25:28) tri_idx(28) emissive_tex(29). One fetch_rows per
          NEE sample replaces ~8 per-lane chained gathers, as the
          tri/mat tables do.
    """

    tri: jax.Array
    mat: jax.Array
    light: jax.Array


def build_shade_tables(scene: Scene) -> ShadeTables:
    geom = scene.geometry
    # Tri/mat ids ride f32 in packed rows (exact only below 2^24); fail at
    # table-build time rather than corrupting shading on giant scenes.
    assert geom.tri_vidx.shape[0] < (1 << 24), (
        f"{geom.tri_vidx.shape[0]} tris exceed f32-exact table ids (2^24)")
    va, vb, vc = geom.corners()
    n = geom.normals  # (T, 3, 3)
    uv = geom.uvs  # (T, 3, 2)
    t = va.shape[0]
    tri = jnp.concatenate(
        [
            va, vb, vc,
            n[:, 0, :], n[:, 1, :], n[:, 2, :],
            uv[:, 0, :], uv[:, 1, :], uv[:, 2, :],
            geom.mat_id.astype(jnp.float32)[:, None],
            geom.obj_id.astype(jnp.float32)[:, None],
        ],
        axis=1,
    )
    mats = scene.materials
    m = mats.num_materials
    mat = jnp.concatenate(
        [
            mats.bsdf_type.astype(jnp.float32)[:, None],
            mats.ior[:, None],
            mats.emissive,
            mats.attrs.reshape(m, MAX_ATTRS * 3),
        ],
        axis=1,
    )
    # Light-sample table: gathers over the (small, static-capacity) light
    # list happen ONCE here instead of per lane per bounce in NEE.
    lt = scene.lights
    lti = lt.tri_idx
    la = va[lti]
    lb = vb[lti]
    lc = vc[lti]
    ln = n[lti]      # (Lcap, 3, 3)
    luv = uv[lti]    # (Lcap, 3, 2)
    # same ops as the gather path computed per lane (bit-identical goldens)
    area = 0.5 * math3.length(math3.cross(lb - la, lc - la))
    etid = mats.emissive_tex[lt.mat_id].astype(jnp.float32)
    light = jnp.concatenate(
        [
            la, lb, lc,
            ln[:, 0, :], ln[:, 1, :], ln[:, 2, :],
            luv[:, 0, :], luv[:, 1, :], luv[:, 2, :],
            area[:, None],
            lt.emissive,
            lti.astype(jnp.float32)[:, None],
            etid[:, None],
        ],
        axis=1,
    )
    return ShadeTables(tri=tri, mat=mat, light=light)


def fetch_rows(table, idx):
    """Row lookup: one-hot matmul for small tables, single wide gather
    otherwise (whether the matmul beats a gather on the GPU is not
    measured). idx values must be in range."""
    rows = table.shape[0]
    if rows <= ONEHOT_MAX_ROWS:
        oh = jax.nn.one_hot(idx, rows, dtype=table.dtype)
        # precision=HIGHEST: a reduced-precision default (bf16 passes,
        # TF32) silently QUANTIZES every fetched table value (vertex
        # coords off by ~2 units at Cornell scale) — caught once by the
        # compiled-render smoke gate (tests/test_gpu_smoke.py; CPU goldens
        # never see it because XLA CPU matmuls are full f32). One-hot
        # products are exact at any precision; the table operand's
        # mantissa is the casualty.
        return jnp.dot(oh, table, preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
    return table[idx]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "point",
        "normal",
        "tangent",
        "bitangent",
        "uv",
        "attrs",
        "emissive",
        "mat_id",
        "bsdf_type",
        "ior",
        "t",
        "obj_id",
        "tri_area",
    ],
    meta_fields=[],
)
@dataclass
class Surface:
    """Batched TerraShadingSurface (Terra.h:36-44) + frame + material refs."""

    point: jax.Array  # (N, 3) world hit position (differentiable)
    normal: jax.Array  # (N, 3) interpolated shading normal
    tangent: jax.Array  # (N, 3)
    bitangent: jax.Array  # (N, 3)
    uv: jax.Array  # (N, 2) interpolated texcoord
    attrs: jax.Array  # (N, 8, 3) evaluated material attributes
    emissive: jax.Array  # (N, 3)
    mat_id: jax.Array  # (N,) i32
    bsdf_type: jax.Array  # (N,) i32
    ior: jax.Array  # (N,) f32
    t: jax.Array  # (N,) differentiable hit distance
    obj_id: jax.Array  # (N,) i32 source object of the hit triangle
    tri_area: jax.Array  # (N,) f32 area of the hit triangle


def _eval_attribute(scene: Scene, const_val, tex_id, uv):
    """Constant-or-texture attribute closure (terra_attribute_eval,
    Terra.c:1804-1810): texture id >= 0 overrides the constant."""
    if scene.textures.num_textures == 0:
        return const_val
    safe_id = jnp.maximum(tex_id, 0)
    tex_val = textures.sample(scene.textures, safe_id, uv)
    return jnp.where((tex_id >= 0)[..., None], tex_val, const_val)


def surface_init(scene: Scene, tables: ShadeTables, o, d, tri_idx):
    """Build the Surface for lanes with (possibly invalid) triangle ids.

    o, d : (N, 3) the ray that produced the hit (origins already offset)
    tri_idx : (N,) i32 triangle ids (stop-gradient; callers mask misses)

    The hit distance is recomputed by differentiable ray/plane intersection
    against the chosen triangle, then barycentrics via the same 2x2 system
    as the reference (Terra.c:1728-1739). Corner weights: w_b = uv.x,
    w_c = uv.y, w_a = 1 - uv.x - uv.y (Terra.c:1741-1752).
    """
    row = fetch_rows(tables.tri, tri_idx)  # (N, 26)
    va, vb, vc = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    n0, n1, n2 = row[:, 9:12], row[:, 12:15], row[:, 15:18]
    uv0, uv1, uv2 = row[:, 18:20], row[:, 20:22], row[:, 22:24]
    mat_id = jnp.round(row[:, 24]).astype(jnp.int32)
    obj_id = jnp.round(row[:, 25]).astype(jnp.int32)

    # Differentiable hit distance: t = ((a - o) . n_g) / (d . n_g)
    e0 = vb - va
    e1 = vc - va
    ng = math3.cross(e0, e1)
    denom = math3.dot(d, ng)
    safe = jnp.abs(denom) > 1e-12
    t = math3.dot(va - o, ng) / jnp.where(safe, denom, 1.0)
    t = jnp.where(safe, t, 0.0)
    point = o + t[..., None] * d

    # Barycentric uv via the reference's normal-equation solve.
    p = point - va
    d00 = math3.dot(e0, e0)
    d11 = math3.dot(e1, e1)
    d01 = math3.dot(e0, e1)
    dp0 = math3.dot(p, e0)
    dp1 = math3.dot(p, e1)
    div = d00 * d11 - d01 * d01
    inv_div = jnp.reciprocal(jnp.where(jnp.abs(div) > 1e-20, div, 1.0))
    wb = (d11 * dp0 - d01 * dp1) * inv_div
    wc = (d00 * dp1 - d01 * dp0) * inv_div
    wa = 1.0 - wb - wc

    normal = math3.normalize(
        wa[..., None] * n0 + wb[..., None] * n1 + wc[..., None] * n2
    )
    uv = wa[..., None] * uv0 + wb[..., None] * uv1 + wc[..., None] * uv2

    mrow = fetch_rows(tables.mat, mat_id)  # (N, 29)
    bsdf_type = jnp.round(mrow[:, 0]).astype(jnp.int32)
    ior = mrow[:, 1]
    emissive_c = mrow[:, 2:5]
    attrs = mrow[:, 5:].reshape(-1, MAX_ATTRS, 3)

    # Texture-driven attributes override constants (Terra.c:1758-1762).
    # Only the statically-known textured slots are evaluated (each slot
    # costs 4 bilinear texel gathers per lane — the dominant shade cost on
    # big wavefronts when all 8 slots were sampled unconditionally).
    mats = scene.materials
    emissive = emissive_c
    if scene.textures.num_textures > 0 and mats.tex_slots:
        slots = []
        for s in range(MAX_ATTRS):
            if s in mats.tex_slots:
                slots.append(
                    _eval_attribute(scene, attrs[:, s, :], mats.attr_tex[mat_id, s], uv)
                )
            else:
                slots.append(attrs[:, s, :])
        attrs = jnp.stack(slots, axis=-2)
    if scene.textures.num_textures > 0 and mats.emissive_textured:
        emissive = _eval_attribute(scene, emissive_c, mats.emissive_tex[mat_id], uv)

    tangent, bitangent = math3.build_basis(normal)
    return Surface(
        point=point,
        normal=normal,
        tangent=tangent,
        bitangent=bitangent,
        uv=uv,
        attrs=attrs,
        emissive=emissive,
        mat_id=mat_id,
        bsdf_type=bsdf_type,
        ior=ior,
        t=t,
        obj_id=obj_id,
        tri_area=0.5 * math3.length(ng),
    )
