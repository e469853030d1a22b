"""Scene representation: flat SoA device arrays registered as JAX pytrees.

Redesign of the reference scene layer (``src/
Terra.c:27-282``): where the reference keeps a growable array of
``TerraObject`` (AoS triangle structs + per-object material with function
pointer BSDF vtables, Terra.h:124-129), we flatten the whole scene into
struct-of-arrays device buffers:

  * one global vertex buffer + triangle index buffer (differentiable w.r.t.
    vertex positions),
  * a material *table* indexed by a per-triangle material id (the reference's
    BSDF function-pointer vtable, Terra.h:46-54, becomes a static integer
    ``bsdf_type`` dispatched with masked passes),
  * a light table of emissive triangles with per-triangle areas + CDF
    (replacing the per-object light list built in Terra.c:194-231),
  * an optional texture atlas (Terra.c:350-507) as one padded device array.

Everything is a pytree leaf, so the scene is jit-traceable, shardable and
its continuous leaves (positions, material attrs, emissive, env color)
receive gradients.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .ops import math3

__all__ = [
    "BSDFType",
    "Integrator",
    "LightPick",
    "Tonemap",
    "SamplingMethod",
    "Accelerator",
    "Geometry",
    "MaterialTable",
    "TextureAtlas",
    "LightTable",
    "Camera",
    "RenderOptions",
    "Scene",
    "MAX_ATTRS",
    "ATTR",
]

MAX_ATTRS = 8  # TERRA_MATERIAL_MAX_ATTRIBUTES (Terra.h:25)


class BSDFType(enum.IntEnum):
    """Static BSDF dispatch ids (replaces the TerraBSDF vtable, Terra.h:46-54).

    DIFFUSE / PHONG mirror TerraPresets.c; GGX is the microfacet model the
    reference left disabled (TerraPresets.c:298-395) rebuilt properly;
    MIRROR is a perfect specular delta lobe; GLASS is the reference's
    disabled perfect-glass preset (TerraPresets.c:397-465) rebuilt with
    working transmission (Snell refraction, TIR, Fresnel-weighted lobe RR).
    """

    DIFFUSE = 0
    PHONG = 1
    GGX = 2
    MIRROR = 3
    DISNEY = 4
    GLASS = 5


class ATTR:
    """Material attribute slot layout (TerraPresets.h:11-51)."""

    # diffuse
    DIFFUSE_ALBEDO = 0
    # phong
    PHONG_ALBEDO = 0
    PHONG_SPECULAR_COLOR = 1
    PHONG_SPECULAR_INTENSITY = 2
    # ggx microfacet
    GGX_ALBEDO = 0
    GGX_ROUGHNESS = 1
    GGX_METALNESS = 2
    GGX_SPECULAR = 3
    # mirror
    MIRROR_COLOR = 0
    # glass (dielectric): tint applied to both lobes; ior comes from the
    # material's ior column (TerraPresets.c:407 material->ior)
    GLASS_COLOR = 0
    # disney (slot layout follows TerraPresets.c:217-224)
    DISNEY_BASE_COLOR = 0
    DISNEY_SPECULAR = 1      # [specular, specular_tint, -]
    DISNEY_SHEEN = 2         # [sheen, sheen_tint, -]
    DISNEY_CLEARCOAT = 3     # [clearcoat, clearcoat_gloss, -]
    DISNEY_METAL_ROUGH = 4   # [metalness, roughness, -]
    DISNEY_ANISO_SUBSURF = 5 # [anisotropic, subsurface, -]


class Integrator(enum.IntEnum):
    """kTerraIntegrator* (Terra.h:149-157)."""

    SIMPLE = 0
    DIRECT = 1
    DIRECT_MIS = 2
    DEBUG_MONO = 3
    DEBUG_DEPTH = 4
    DEBUG_NORMALS = 5
    DEBUG_MIS_WEIGHTS = 6
    # extension: full path tracer AOVs could go here later


class Tonemap(enum.IntEnum):
    """kTerraTonemappingOperator* (Terra.h:131-137)."""

    NONE = 0
    LINEAR = 1
    REINHARD = 2
    FILMIC = 3
    UNCHARTED2 = 4


class SamplingMethod(enum.IntEnum):
    """kTerraSamplingMethod* (Terra.h:143-147); drives pixel jitter only,
    exactly like the reference (Terra.c:532-548)."""

    RANDOM = 0
    STRATIFIED = 1
    HALTON = 2


class Accelerator(enum.IntEnum):
    """Reference has only BVH (Terra.h:139-141). We add BRUTE: a dense
    all-triangles intersection, perfectly regular work with zero
    divergence, for small scenes (and the oracle the BVH is gated on)."""

    BRUTE = 0
    BVH = 1


class LightPick(enum.IntEnum):
    """NEE light-triangle picking strategy. UNIFORM matches the reference's
    pdf = 1/num_light_triangles (Terra.c:1618-1619); AREA importance-samples
    the flattened table by triangle area via the CDF built at commit
    (extension — lower variance when light sizes differ a lot)."""

    UNIFORM = 0
    AREA = 1


class Intersector(enum.IntEnum):
    """Ray/triangle intersection algorithm — the runtime analogue of the
    reference's compile-time switch (TerraGeometry.c:25-31): Moller-Trumbore
    (TerraGeometry.c:34-87) or Wald2013 watertight (TerraGeometry.c:98-259).
    """

    MT = 0
    WATERTIGHT = 1


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["positions", "tri_vidx", "normals", "uvs", "mat_id", "obj_id"],
    meta_fields=[],
)
@dataclass
class Geometry:
    """Flattened triangle soup.

    positions : (V, 3) f32 — world-space vertex buffer (a gradient leaf)
    tri_vidx  : (T, 3) i32 — vertex indices per triangle
    normals   : (T, 3, 3) f32 — per-corner shading normals
    uvs       : (T, 3, 2) f32 — per-corner texcoords
    mat_id    : (T,) i32 — material table row per triangle
    obj_id    : (T,) i32 — source object id (the reference's TerraObject
                index; used for MIS same-light checks, Terra.c:1543, and
                mesh-level edits like ``mesh move``)

    The reference stores corner positions AoS per object
    (TerraTriangle/TerraTriangleProperties, Terra.h:109-122); flattening +
    indexing keeps a single differentiable vertex buffer.
    """

    positions: jax.Array
    tri_vidx: jax.Array
    normals: jax.Array
    uvs: jax.Array
    mat_id: jax.Array
    obj_id: jax.Array

    @property
    def num_triangles(self) -> int:
        return self.tri_vidx.shape[0]

    def corners(self):
        """Gather world-space triangle corners -> (T, 3) each."""
        a = self.positions[self.tri_vidx[:, 0]]
        b = self.positions[self.tri_vidx[:, 1]]
        c = self.positions[self.tri_vidx[:, 2]]
        return a, b, c

    def areas(self):
        """Per-triangle areas (terra_triangle_area, Terra.c:1833-1837)."""
        a, b, c = self.corners()
        return 0.5 * math3.length(math3.cross(b - a, c - a))


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["bsdf_type", "attrs", "attr_tex", "emissive", "emissive_tex", "ior"],
    meta_fields=["types_present", "tex_slots", "emissive_textured"],
)
@dataclass
class MaterialTable:
    """Material rows; the continuous fields are gradient leaves.

    bsdf_type    : (M,) i32 — BSDFType per material
    attrs        : (M, 8, 3) f32 — constant attribute values (Terra.h:84-99)
    attr_tex     : (M, 8) i32 — texture id per slot, -1 = use constant
    emissive     : (M, 3) f32 — constant emissive
    emissive_tex : (M,) i32 — emissive texture id, -1 = constant
    ior          : (M,) f32
    types_present: static tuple of the BSDFType ids that actually occur —
                   pytree metadata, so jit specializes the wavefront BSDF
                   dispatch to only the lobes the scene uses (set by
                   ``commit``; defaults to all).
    tex_slots    : static tuple of attribute slots where ANY material has a
                   texture bound — surface shading evaluates texture
                   overrides only for these (each slot costs 4 bilinear
                   texel gathers per lane, the dominant shade cost on big
                   wavefronts; set by ``commit``, defaults to all).
    emissive_textured: static bool — any emissive texture bound (same
                   specialization for the emissive attribute).
    """

    bsdf_type: jax.Array
    attrs: jax.Array
    attr_tex: jax.Array
    emissive: jax.Array
    emissive_tex: jax.Array
    ior: jax.Array
    types_present: tuple = (0, 1, 2, 3, 4, 5)
    tex_slots: tuple = tuple(range(MAX_ATTRS))
    emissive_textured: bool = True

    @property
    def num_materials(self) -> int:
        return self.bsdf_type.shape[0]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data", "size", "filter", "address"],
    meta_fields=[],
)
@dataclass
class TextureAtlas:
    """All scene textures padded into one device array.

    data    : (NT, H, W, 3) f32 (linear space; sRGB decode happens at load,
              mirroring terra_texture_finalize's pow-2.2, Terra.c:484-507)
    size    : (NT, 2) i32 — (height, width) of the valid region
    filter  : (NT,) i32 — 0 point / 1 bilinear (Terra.h:57-62)
    address : (NT,) i32 — 0 wrap / 1 mirror / 2 clamp (Terra.h:65-69)
    """

    data: jax.Array
    size: jax.Array
    filter: jax.Array
    address: jax.Array

    @staticmethod
    def empty() -> "TextureAtlas":
        return TextureAtlas(
            data=jnp.zeros((0, 1, 1, 3), jnp.float32),
            size=jnp.zeros((0, 2), jnp.int32),
            filter=jnp.zeros((0,), jnp.int32),
            address=jnp.zeros((0,), jnp.int32),
        )

    @property
    def num_textures(self) -> int:
        return self.data.shape[0]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["tri_idx", "area", "cdf", "emissive", "mat_id", "num"],
    meta_fields=[],
)
@dataclass
class LightTable:
    """Flattened emissive-triangle table (replaces TerraLight,
    TerraPrivate.h:19-29, built in Terra.c:194-231).

    The reference picks a light object uniformly then a triangle uniformly
    but uses pdf = 1/total_light_triangles (Terra.c:1616-1620, 1662-1666);
    flattening to per-triangle granularity makes the implementation actually
    consistent with that pdf. Buffers are padded to a static capacity so the
    pytree shape does not change with scene edits; ``num`` is the live count.

    tri_idx : (Lcap,) i32 — global triangle index of each emissive triangle
    area    : (Lcap,) f32 — per-triangle world area
    cdf     : (Lcap,) f32 — area-weighted CDF over live entries (for the
              importance-sampled light picking extension; reference samples
              uniformly)
    emissive: (Lcap, 3) f32 — constant emissive of each light triangle (so
              NEE shading needs no per-lane gather through the material
              table; texture-emissive lights override at the sampled uv)
    mat_id  : (Lcap,) i32 — material of each light triangle
    num     : () i32 — number of live entries
    """

    tri_idx: jax.Array
    area: jax.Array
    cdf: jax.Array
    emissive: jax.Array
    mat_id: jax.Array
    num: jax.Array


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["position", "direction", "up", "fov_deg"],
    meta_fields=[],
)
@dataclass
class Camera:
    """Pinhole camera (TerraCamera, Terra.h:176-181). fov in degrees."""

    position: jax.Array
    direction: jax.Array
    up: jax.Array
    fov_deg: jax.Array

    @staticmethod
    def make(position, direction, up=(0.0, 1.0, 0.0), fov_deg=45.0) -> "Camera":
        return Camera(
            position=jnp.asarray(position, jnp.float32),
            direction=jnp.asarray(direction, jnp.float32),
            up=jnp.asarray(up, jnp.float32),
            fov_deg=jnp.asarray(fov_deg, jnp.float32),
        )


@dataclass(frozen=True)
class RenderOptions:
    """Static render configuration (TerraSceneOptions, Terra.h:159-173).

    Frozen + hashable so it can be a jit static argument: resolution, spp
    and bounce count fix the wavefront shapes at trace time.
    """

    width: int = 256
    height: int = 256
    samples_per_pixel: int = 64
    bounces: int = 4
    integrator: Integrator = Integrator.SIMPLE
    sampling_method: SamplingMethod = SamplingMethod.RANDOM
    # BVH by default (matching the config registry): scenes committed
    # without a BVH (scene.bvh is None) fall back to the brute sweep in
    # make_raycast_fn, so small test scenes are unaffected.
    accelerator: Accelerator = Accelerator.BVH
    tonemap: Tonemap = Tonemap.NONE
    subpixel_jitter: float = 0.0
    strata: int = 4
    manual_exposure: float = 1.0
    gamma: float = 2.2
    # Wavefront scheduling: how many samples per pixel are traced in one
    # device program (bounds HBM footprint of the SoA path state).
    samples_per_launch: int = 0  # 0 = all spp in one launch
    # Persistent lanes: each lane traces this many samples sequentially,
    # regenerating a new camera ray the moment its path terminates (miss /
    # roulette / depth) instead of idling masked until the bounce scan ends.
    # 1 = classic fixed-depth wavefront (bit-matches the golden mirror);
    # >1 keeps lanes ~fully occupied (estimator unchanged: the exact same
    # (pixel, sample, bounce, stream) random draws are consumed).
    # NOTE: the API default is 1 so library users (and the golden tests) get
    # the deterministic accumulation order; the CLI/config registry default
    # is 8 (config.py "render_samples_per_lane") so interactive renders get
    # the fast persistent scheduler. The estimator is identical either way —
    # only f32 accumulation order differs.
    samples_per_lane: int = 1
    # Reference behavior: env radiance on miss is *not* added to Lo (the add
    # is commented out at Terra.c:1056). True enables the useful behavior.
    env_on_miss: bool = False
    # Russian roulette start bounce. The reference applies RR from bounce 0
    # (Terra.c:1081-1091); raising this lowers variance for tiny scenes.
    rr_start_bounce: int = 0
    # Ray/triangle algorithm (reference compile-time switch,
    # TerraGeometry.c:25-31). WATERTIGHT guarantees no cracks along shared
    # edges; MT is the default (matches the golden-test mirror).
    intersector: Intersector = Intersector.MT
    # Environment next-event estimation (extension; the reference built the
    # 2D env distribution but never used it, Terra.c:811-846). When on, the
    # DIRECT/DIRECT_MIS integrators importance-sample the environment as a
    # light, and the miss-env add (env_on_miss) applies only where NEE
    # could not have seen the env — camera rays and rays leaving a delta
    # (MIRROR/GLASS) lobe, via the per-lane specular-bounce flag
    # (integrators._emit_gate) — to avoid double counting. DIRECT_MIS also
    # adds the env through its MIS-weighted BSDF strategy (covers rough
    # specular lobes).
    env_nee: bool = False
    # NEE light pick strategy: uniform (reference behavior) or area-CDF
    # importance sampling over the flattened light table.
    light_pick: LightPick = LightPick.UNIFORM
    # Debug-assert mode (the sanitizer analogue; the GPU kernel's stack
    # bound is checked at trace time regardless — gpu_traverse): when on,
    # render() host-validates each chunk's accumulator and raises on
    # non-finite radiance, naming the offending pixel rows. Costs one
    # device->host sync per chunk; off by default.
    debug_checks: bool = False

    def replace(self, **kw) -> "RenderOptions":
        return dataclasses.replace(self, **kw)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["geometry", "materials", "textures", "lights", "env_value", "env_tex", "bvh"],
    meta_fields=[],
)
@dataclass
class Scene:
    """Committed scene: geometry + material/light tables + env + accel.

    ``commit()`` (below) is the analogue of terra_scene_commit
    (Terra.c:162-236): it (re)builds the light table and the BVH.
    """

    geometry: Geometry
    materials: MaterialTable
    textures: TextureAtlas
    lights: LightTable
    env_value: jax.Array  # (3,) constant env color
    env_tex: jax.Array  # () i32 latlong env texture id, -1 = constant
    bvh: Any  # Optional[terra_tpu.accel.lbvh.LBVH]; None when BRUTE


# ------------------------------------------------------------------------
# Scene building / commit
# ------------------------------------------------------------------------

def build_light_table(geometry: Geometry, materials: MaterialTable, capacity: Optional[int] = None) -> LightTable:
    """Scan triangles whose material has nonzero constant emissive and build
    the flattened light table (Terra.c:194-231 equivalent).

    Runs at commit time. Uses NumPy on host for the scan (scene builds are
    host-side, like the reference's commit), producing device arrays.
    """
    mat_id = np.asarray(geometry.mat_id)
    emissive = np.asarray(materials.emissive)
    tri_emissive = emissive[mat_id]  # (T, 3)
    is_light = np.any(tri_emissive != 0.0, axis=-1)
    idx = np.nonzero(is_light)[0].astype(np.int32)

    a = np.asarray(geometry.positions)[np.asarray(geometry.tri_vidx)[idx, 0]]
    b = np.asarray(geometry.positions)[np.asarray(geometry.tri_vidx)[idx, 1]]
    c = np.asarray(geometry.positions)[np.asarray(geometry.tri_vidx)[idx, 2]]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1).astype(np.float32)

    n = len(idx)
    cap = capacity if capacity is not None else max(n, 1)
    assert cap >= n, "light table capacity too small"
    tri_idx = np.zeros((cap,), np.int32)
    areas = np.zeros((cap,), np.float32)
    cdf = np.ones((cap,), np.float32)
    emis = np.zeros((cap, 3), np.float32)
    mats = np.zeros((cap,), np.int32)
    tri_idx[:n] = idx
    areas[:n] = area
    emis[:n] = tri_emissive[idx]
    mats[:n] = mat_id[idx]
    if n > 0:
        c_ = np.cumsum(area)
        cdf[:n] = (c_ / c_[-1]).astype(np.float32)
    return LightTable(
        tri_idx=jnp.asarray(tri_idx),
        area=jnp.asarray(areas),
        cdf=jnp.asarray(cdf),
        emissive=jnp.asarray(emis),
        mat_id=jnp.asarray(mats),
        num=jnp.asarray(n, jnp.int32),
    )


def commit(
    geometry: Geometry,
    materials: MaterialTable,
    textures: Optional[TextureAtlas] = None,
    env_value=(0.0, 0.0, 0.0),
    env_tex: int = -1,
    accelerator: Accelerator = Accelerator.BRUTE,
    light_capacity: Optional[int] = None,
    bvh_builder: str = "sah",
) -> Scene:
    """Build a committed :class:`Scene` (terra_scene_commit equivalent,
    Terra.c:162-236): light table scan + optional BVH build.

    ``bvh_builder``: "sah" (binned SAH — the reference's builder family,
    TerraBVH.c:79-126; best traversal speed) or "lbvh" (Morton — fastest
    rebuilds for dynamic geometry)."""
    bvh = None
    if accelerator == Accelerator.BVH:
        from .accel import lbvh

        bvh = lbvh.build(geometry, builder=bvh_builder)
    # Record which BSDF lobes the scene uses (static dispatch specialization).
    used = np.unique(np.asarray(materials.bsdf_type)[np.unique(np.asarray(geometry.mat_id))])
    attr_tex_np = np.asarray(materials.attr_tex)
    tex_slots = tuple(
        s for s in range(attr_tex_np.shape[1]) if np.any(attr_tex_np[:, s] >= 0)
    )
    materials = dataclasses.replace(
        materials,
        types_present=tuple(int(t) for t in used),
        tex_slots=tex_slots,
        emissive_textured=bool(np.any(np.asarray(materials.emissive_tex) >= 0)),
    )
    return Scene(
        geometry=geometry,
        materials=materials,
        textures=textures if textures is not None else TextureAtlas.empty(),
        lights=build_light_table(geometry, materials, light_capacity),
        env_value=jnp.asarray(env_value, jnp.float32),
        env_tex=jnp.asarray(env_tex, jnp.int32),
        bvh=bvh,
    )
