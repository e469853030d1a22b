"""Area-light sampling over the flattened emissive-triangle table.

Replaces terra_scene_pick_light / terra_light_pick_triangle /
terra_light_sample_triangle (/root/reference/src/Terra.c:1592-1697). The
reference picks a light *object* uniformly, then one of its triangles
uniformly, while using pdf = 1 / total_light_triangles (Terra.c:1618-1619,
1663-1665) — only consistent when all lights have equal triangle counts.
The flattened per-triangle table makes uniform picking actually match that
pdf. An area-weighted CDF pick (inverse-CDF via searchsorted over
scene.lights.cdf) is available as an extension.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from .ops import math3
from .scene import Scene

__all__ = ["LightSample", "pick_and_sample"]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["tri_idx", "pos", "normal", "uv", "area", "pick_pdf",
                 "area_pdf", "emissive"],
    meta_fields=[],
)
@dataclass
class LightSample:
    tri_idx: jax.Array  # (N,) i32 global triangle index of the sampled light
    pos: jax.Array  # (N, 3) sampled point on the light
    normal: jax.Array  # (N, 3) interpolated light normal at the sample
    uv: jax.Array  # (N, 2)
    area: jax.Array  # (N,) area of the sampled triangle
    pick_pdf: jax.Array  # (N,) probability of picking this triangle
    area_pdf: jax.Array  # (N,) 1/area — pdf of the point given the triangle
    emissive: jax.Array  # (N, 3) radiance emitted at the sampled point


def pick_and_sample(scene: Scene, e_pick, e1, e2, area_weighted: bool = False,
                    table=None) -> LightSample:
    """Pick a light triangle and sample a point on it.

    e_pick, e1, e2 : (N,) uniforms. Mirrors the reference call sequence
    (Terra.c:1366-1389): pick (uniform, pdf = 1/L), then uniform-in-triangle
    via sqrt warp (terra_light_sample_triangle, Terra.c:1668-1697).

    ``table``: the packed (Lcap, 30) light row table from
    surface.build_shade_tables — ONE fetch_rows per lane instead of ~8
    chained gathers through geometry/light arrays; the chained-gather form
    remains only as the table-free fallback. Both paths produce bit-identical samples
    (the table stores the same f32 values the gathers would load, and area
    is precomputed with the identical op sequence).
    """
    lights = scene.lights
    num = jnp.maximum(lights.num, 1)
    if area_weighted:
        slot = jnp.searchsorted(lights.cdf, e_pick).astype(jnp.int32)
        slot = jnp.minimum(slot, num - 1)
        total_area = jnp.sum(jnp.where(jnp.arange(lights.area.shape[0]) < num, lights.area, 0.0))
        pick_pdf = lights.area[slot] / jnp.maximum(total_area, 1e-12)
    else:
        slot = jnp.minimum((e_pick * num.astype(jnp.float32)).astype(jnp.int32), num - 1)
        pick_pdf = jnp.ones_like(e_pick) / num.astype(jnp.float32)

    # Uniform-in-triangle warp (Terra.c:1671-1674): wa = 1-sqrt(e1),
    # wb = e2*sqrt(e1), wc = 1-wa-wb.
    s = jnp.sqrt(e1)
    wa = 1.0 - s
    wb = e2 * s
    wc = 1.0 - wa - wb

    if table is not None:
        from .surface import fetch_rows

        row = fetch_rows(table, slot)  # (N, 30)
        a, b, c = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        n0, n1, n2 = row[:, 9:12], row[:, 12:15], row[:, 15:18]
        uv0, uv1, uv2 = row[:, 18:20], row[:, 20:22], row[:, 22:24]
        area = row[:, 24]
        emissive = row[:, 25:28]
        tri_idx = jnp.round(row[:, 28]).astype(jnp.int32)
        etid = jnp.round(row[:, 29]).astype(jnp.int32)
        pos = wa[..., None] * a + wb[..., None] * b + wc[..., None] * c
        normal = math3.normalize(
            wa[..., None] * n0 + wb[..., None] * n1 + wc[..., None] * n2
        )
        uv = wa[..., None] * uv0 + wb[..., None] * uv1 + wc[..., None] * uv2
        if scene.textures.num_textures > 0 and scene.materials.emissive_textured:
            from . import textures as textures_mod

            tex = textures_mod.sample(scene.textures, jnp.maximum(etid, 0), uv)
            emissive = jnp.where((etid >= 0)[..., None], tex, emissive)
        return LightSample(
            tri_idx=tri_idx, pos=pos, normal=normal, uv=uv, area=area,
            pick_pdf=pick_pdf,
            area_pdf=jnp.reciprocal(jnp.maximum(area, 1e-12)),
            emissive=emissive,
        )

    tri_idx = lights.tri_idx[slot]
    geom = scene.geometry
    a = geom.positions[geom.tri_vidx[tri_idx, 0]]
    b = geom.positions[geom.tri_vidx[tri_idx, 1]]
    c = geom.positions[geom.tri_vidx[tri_idx, 2]]
    pos = wa[..., None] * a + wb[..., None] * b + wc[..., None] * c
    n_corners = geom.normals[tri_idx]
    normal = math3.normalize(
        wa[..., None] * n_corners[..., 0, :]
        + wb[..., None] * n_corners[..., 1, :]
        + wc[..., None] * n_corners[..., 2, :]
    )
    uv_corners = geom.uvs[tri_idx]
    uv = (
        wa[..., None] * uv_corners[..., 0, :]
        + wb[..., None] * uv_corners[..., 1, :]
        + wc[..., None] * uv_corners[..., 2, :]
    )
    area = 0.5 * math3.length(math3.cross(b - a, c - a))
    # Radiance at the sampled point: the light table's constant (no per-lane
    # gather through the material table), with the texture override of
    # terra_attribute_eval when the light's emissive is texture-driven.
    emissive = lights.emissive[slot]
    if scene.textures.num_textures > 0 and scene.materials.emissive_textured:
        from . import textures as textures_mod

        etid = scene.materials.emissive_tex[lights.mat_id[slot]]
        tex = textures_mod.sample(scene.textures, jnp.maximum(etid, 0), uv)
        emissive = jnp.where((etid >= 0)[..., None], tex, emissive)
    return LightSample(
        tri_idx=tri_idx,
        pos=pos,
        normal=normal,
        uv=uv,
        area=area,
        pick_pdf=pick_pdf,
        area_pdf=jnp.reciprocal(jnp.maximum(area, 1e-12)),
        emissive=emissive,
    )
