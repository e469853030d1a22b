"""Independent NumPy CPU mirror of the renderer — the golden-image oracle.

This is the "fixed-seed CPU reference render" required by BASELINE.md: a
from-scratch float32 NumPy implementation of the same math (camera, threefry
streams, intersection, surfaces, BSDFs, integrators, roulette) with **no JAX
anywhere**. Golden tests render the same scene/seed through both paths and
require lane-wise agreement (tests/test_golden.py).

It mirrors the behavior of the reference renderer's inner loop
(reference src/Terra.c:1039-1097) under this package's RNG
discipline. Kept deliberately simple and scalar-ish; only meant for tiny
test configs.
"""
from __future__ import annotations

import numpy as np

F32 = np.float32
U32 = np.uint32
EPS = F32(1e-4)
RAY_OFFSET_DIR = F32(1e-3)
SURFACE_OFFSET_NORMAL = F32(1e-4)
T_FAR = F32(3.4e38)
PI = F32(np.pi)

# stream ids — must match terra_tpu.ops.rng.PathStreams
JITTER_X, JITTER_Y = 0, 1
BSDF_E0, BSDF_E1, BSDF_E2 = 2, 3, 4
ROULETTE = 5
LIGHT_PICK, LIGHT_U, LIGHT_V = 6, 8, 9  # id 7 unassigned (see ops/rng.py)
MIS_E0, MIS_E1, MIS_E2 = 10, 11, 12
ENV_U, ENV_V = 13, 14

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << U32(r)) | (x >> U32(32 - r))).astype(U32)


def threefry2x32_np(k0, k1, x0, x1):
    """NumPy twin of terra_tpu.ops.rng.threefry2x32 (bit-exact)."""
    x0 = np.asarray(x0, U32).copy()
    x1 = np.asarray(x1, U32).copy()
    ks = (U32(k0), U32(k1), U32(k0) ^ U32(k1) ^ U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = (x0 + ks[0]).astype(U32)
        x1 = (x1 + ks[1]).astype(U32)
        for g in range(5):
            for r in _ROT[g % 2]:
                x0 = (x0 + x1).astype(U32)
                x1 = _rotl(x1, r)
                x1 = (x1 ^ x0).astype(U32)
            x0 = (x0 + ks[(g + 1) % 3]).astype(U32)
            x1 = (x1 + ks[(g + 2) % 3] + U32(g + 1)).astype(U32)
    return x0, x1


def key_from_seed_np(seed):
    mask = (1 << 64) - 1
    z = (int(seed) + 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    z = z ^ (z >> 31)
    return U32(z & 0xFFFFFFFF), U32(z >> 32)


def uniform_np(key, pixel, sample, bounce, stream):
    """Stream-pair convention (must match terra_tpu.ops.rng.path_uniform):
    streams 2k / 2k+1 are the two output words of one cipher at counter
    stream 2k."""
    base = (int(stream) // 2) * 2
    ctr1 = ((np.asarray(sample, U32) << U32(12)) | U32(int(bounce) << 6) | U32(base)).astype(U32)
    b0, b1 = threefry2x32_np(key[0], key[1], np.asarray(pixel, U32), ctr1)
    word = b1 if int(stream) % 2 else b0
    return ((word >> U32(8)).astype(F32) * F32(1.0 / (1 << 24))).astype(F32)


def uniform2_np(key, pixel, sample, bounce, stream):
    ctr1 = ((np.asarray(sample, U32) << U32(12)) | U32(int(bounce) << 6) | U32(stream)).astype(U32)
    b0, b1 = threefry2x32_np(key[0], key[1], np.asarray(pixel, U32), ctr1)
    s = F32(1.0 / (1 << 24))
    return (b0 >> U32(8)).astype(F32) * s, (b1 >> U32(8)).astype(F32) * s


# ---------------------------------------------------------------- vec utils

def dot(a, b):
    return np.sum(a * b, axis=-1)


def cross(a, b):
    return np.cross(a, b).astype(F32)


def normalize(a):
    n = np.sqrt(np.maximum(dot(a, a), F32(1e-20)))[..., None]
    return (a / n).astype(F32)


def build_basis(n):
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    cond = np.abs(nx) > np.abs(ny)
    inv = 1.0 / np.sqrt(np.where(cond, nx * nx + nz * nz, ny * ny + nz * nz))
    t = np.where(
        cond[..., None],
        np.stack([nz * inv, np.zeros_like(nz), -nx * inv], -1),
        np.stack([np.zeros_like(nz), -nz * inv, ny * inv], -1),
    ).astype(F32)
    b = cross(n, t)
    return t, b


def to_world(local, t, n, b):
    return local[..., 0:1] * t + local[..., 1:2] * n + local[..., 2:3] * b


def reflect(wo, n):
    return 2.0 * dot(wo, n)[..., None] * n - wo


# ------------------------------------------------------------------- scene

class SceneNp:
    """NumPy view of a committed terra_tpu Scene (constant attrs only)."""

    def __init__(self, scene):
        g = scene.geometry
        self.positions = np.asarray(g.positions, F32)
        self.tri_vidx = np.asarray(g.tri_vidx, np.int32)
        self.normals = np.asarray(g.normals, F32)
        self.uvs = np.asarray(g.uvs, F32)
        self.mat_id = np.asarray(g.mat_id, np.int32)
        self.obj_id = np.asarray(g.obj_id, np.int32)
        m = scene.materials
        self.bsdf_type = np.asarray(m.bsdf_type, np.int32)
        self.attrs = np.asarray(m.attrs, F32)
        self.emissive = np.asarray(m.emissive, F32)
        self.ior = np.asarray(m.ior, F32)
        l = scene.lights
        self.light_tri = np.asarray(l.tri_idx, np.int32)
        self.light_area = np.asarray(l.area, F32)
        self.light_cdf = np.asarray(l.cdf, F32)
        self.light_num = int(np.asarray(l.num))
        self.env_value = np.asarray(scene.env_value, F32)
        self.env_tex = int(np.asarray(scene.env_tex))
        self.tri_a = self.positions[self.tri_vidx[:, 0]]
        self.tri_b = self.positions[self.tri_vidx[:, 1]]
        self.tri_c = self.positions[self.tri_vidx[:, 2]]
        t = scene.textures
        self.num_textures = int(t.num_textures)
        if self.num_textures:
            self.tex_data = np.asarray(t.data, F32)
            self.tex_size = np.asarray(t.size, np.int32)
            self.tex_filter = np.asarray(t.filter, np.int32)
            self.tex_address = np.asarray(t.address, np.int32)
            self.attr_tex = np.asarray(m.attr_tex, np.int32)
            self.emissive_tex = np.asarray(m.emissive_tex, np.int32)


# ---------------------------------------------------------------- textures

def _tex_address(coord, size, mode):
    """NumPy twin of textures._address (wrap/mirror/clamp, Terra.c:368-394)."""
    size = np.maximum(size, 1)
    wrap = np.remainder(coord, size)
    m = np.remainder(coord, 2 * size)
    mirror = np.where(m >= size, 2 * size - 1 - m, m)
    clamp = np.clip(coord, 0, size - 1)
    return np.where(mode == 0, wrap, np.where(mode == 1, mirror, clamp))


def _tex_read(sc: SceneNp, tex_id, x, y):
    h = sc.tex_size[tex_id, 0]
    w = sc.tex_size[tex_id, 1]
    mode = sc.tex_address[tex_id]
    x = _tex_address(x, w, mode)
    y = _tex_address(y, h, mode)
    return sc.tex_data[tex_id, y, x]


def tex_sample(sc: SceneNp, tex_id, uv):
    """NumPy twin of textures.sample (point/bilinear, Terra.c:410-466)."""
    h = sc.tex_size[tex_id, 0].astype(F32)
    w = sc.tex_size[tex_id, 1].astype(F32)
    fx = (uv[..., 0] * w).astype(F32)
    fy = (uv[..., 1] * h).astype(F32)
    ix = np.floor(fx).astype(np.int32)
    iy = np.floor(fy).astype(np.int32)
    point = _tex_read(sc, tex_id, ix, iy)
    n2 = _tex_read(sc, tex_id, ix + 1, iy)
    n3 = _tex_read(sc, tex_id, ix, iy + 1)
    n4 = _tex_read(sc, tex_id, ix + 1, iy + 1)
    w_u = (fx - ix.astype(F32))[..., None]
    w_v = (fy - iy.astype(F32))[..., None]
    bilinear = ((point * (1 - w_u) + n2 * w_u) * (1 - w_v)
                + (n3 * (1 - w_u) + n4 * w_u) * w_v).astype(F32)
    filt = sc.tex_filter[tex_id][..., None]
    return np.where(filt == 1, bilinear, point).astype(F32)


def tex_sample_latlong(sc: SceneNp, tex_id, direction):
    """NumPy twin of textures.sample_latlong (Terra.c:468-477)."""
    d = normalize(direction)
    theta = np.arccos(np.clip(d[..., 1], -1.0, 1.0)).astype(F32)
    phi = (np.arctan2(d[..., 2], d[..., 0]) + PI).astype(F32)
    u = phi / F32(2 * np.pi)
    v = theta / PI
    return tex_sample(sc, tex_id, np.stack([u, v], axis=-1))


def env_radiance(sc: SceneNp, d):
    """NumPy twin of envmap.radiance."""
    const = np.broadcast_to(sc.env_value, d.shape).astype(F32)
    if sc.num_textures == 0 or sc.env_tex < 0:
        return const
    return tex_sample_latlong(sc, np.full(d.shape[:-1], sc.env_tex, np.int32), d)


def raycast(sc: SceneNp, o, d):
    """Brute-force closest hit; origin offset dir*1e-3 applied here."""
    o = o + d * RAY_OFFSET_DIR
    a, b, c = sc.tri_a[None], sc.tri_b[None], sc.tri_c[None]
    ro, rd = o[:, None, :], d[:, None, :]
    e1 = b - a
    e2 = c - a
    h = cross(rd, e2)
    det = dot(e1, h)
    valid = np.abs(det) > EPS
    f = np.where(valid, 1.0 / np.where(valid, det, 1.0), 0.0).astype(F32)
    s = ro - a
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(rd, q)
    t = f * dot(e2, q)
    valid &= (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > EPS)
    t = np.where(valid, t, T_FAR).astype(F32)
    tri = np.argmin(t, axis=1).astype(np.int32)
    best = t[np.arange(t.shape[0]), tri]
    hit = best < T_FAR
    return best, np.where(hit, tri, 0), hit, o


def surface_init(sc: SceneNp, o, d, tri):
    va, vb, vc = sc.tri_a[tri], sc.tri_b[tri], sc.tri_c[tri]
    e0, e1 = vb - va, vc - va
    ng = cross(e0, e1)
    denom = dot(d, ng)
    safe = np.abs(denom) > 1e-12
    t = np.where(safe, dot(va - o, ng) / np.where(safe, denom, 1.0), 0.0).astype(F32)
    point = o + t[..., None] * d
    p = point - va
    d00, d11, d01 = dot(e0, e0), dot(e1, e1), dot(e0, e1)
    dp0, dp1 = dot(p, e0), dot(p, e1)
    div = d00 * d11 - d01 * d01
    inv = (1.0 / np.where(np.abs(div) > 1e-20, div, 1.0)).astype(F32)
    wb = (d11 * dp0 - d01 * dp1) * inv
    wc = (d00 * dp1 - d01 * dp0) * inv
    wa = 1.0 - wb - wc
    nc = sc.normals[tri]
    normal = normalize(
        wa[..., None] * nc[:, 0] + wb[..., None] * nc[:, 1] + wc[..., None] * nc[:, 2]
    )
    mat = sc.mat_id[tri]
    tangent, bitangent = build_basis(normal)
    attrs = sc.attrs[mat]
    emissive = sc.emissive[mat]
    if sc.num_textures > 0:
        # texture-driven attributes override constants (surface._eval_attribute)
        uvc = sc.uvs[tri]  # (N, 3, 2)
        uv = (wa[..., None] * uvc[:, 0] + wb[..., None] * uvc[:, 1]
              + wc[..., None] * uvc[:, 2]).astype(F32)
        attrs = attrs.copy()
        for s in range(attrs.shape[-2]):
            tid = sc.attr_tex[mat, s]
            tval = tex_sample(sc, np.maximum(tid, 0), uv)
            attrs[..., s, :] = np.where((tid >= 0)[..., None], tval, attrs[..., s, :])
        etid = sc.emissive_tex[mat]
        eval_ = tex_sample(sc, np.maximum(etid, 0), uv)
        emissive = np.where((etid >= 0)[..., None], eval_, emissive).astype(F32)
    return dict(
        point=point, normal=normal, tangent=tangent, bitangent=bitangent,
        attrs=attrs, emissive=emissive, bsdf_type=sc.bsdf_type[mat],
        ior=sc.ior[mat], t=t, mat=mat,
    )


# ------------------------------------------------------------------- bsdfs

def _cosine_hemisphere(surf, e1, e2):
    r = np.sqrt(e1)
    th = F32(2) * PI * e2
    local = np.stack([r * np.cos(th), np.sqrt(np.maximum(0, 1 - e1)), r * np.sin(th)], -1).astype(F32)
    return normalize(to_world(local, surf["tangent"], surf["normal"], surf["bitangent"]))


def _phong_kd_ks(surf):
    albedo = surf["attrs"][..., 0, :]
    spec = surf["attrs"][..., 1, :]
    diffuse = np.maximum(albedo.sum(-1), EPS)
    specular = spec.sum(-1)
    gt = specular > diffuse
    kd = np.where(gt, 0.5 * diffuse / np.maximum(specular, EPS), 1.0 - 0.5 * specular / diffuse)
    return kd.astype(F32), (1.0 - kd).astype(F32)


def _glass_geom(surf, wo):
    """NumPy twin of bsdf._glass_geometry (op-for-op in f32)."""
    n = surf["normal"]
    ior = np.maximum(surf["ior"], F32(1.0 + 1e-4))
    now = dot(n, wo)
    entering = now > 0.0
    n_eff = np.where(entering[..., None], n, -n).astype(F32)
    cos_i = np.abs(now)
    eta = np.where(entering, 1.0 / ior, ior).astype(F32)
    refl = normalize(reflect(wo, n_eff))
    cos_t2 = (1.0 - eta * eta * (1.0 - cos_i * cos_i)).astype(F32)
    tir = cos_t2 < 0.0
    cos_t = np.sqrt(np.maximum(cos_t2, 0.0)).astype(F32)
    tbase = np.where(eta <= 1.0, cos_i, cos_t).astype(F32)
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = (r0 * r0).astype(F32)
    R = (r0 + (1.0 - r0) * _schlick_w(tbase)).astype(F32)
    R = np.where(tir, F32(1.0), np.clip(R, 0.0, 1.0)).astype(F32)
    trans = normalize(-wo * eta[..., None] + n_eff * (eta * cos_i - cos_t)[..., None])
    trans = np.where(tir[..., None], refl, trans).astype(F32)
    return n_eff, refl, trans, R, tir


def _glass_match(surf, wi, wo):
    _, refl, trans, R, tir = _glass_geom(surf, wo)
    aligned_r = dot(wi, refl) > (1.0 - 1e-5)
    aligned_t = (~tir) & (dot(wi, trans) > (1.0 - 1e-5)) & ~aligned_r
    w = np.where(aligned_r, R, np.where(aligned_t, 1.0 - R, 0.0)).astype(F32)
    return w, aligned_r | aligned_t


def _lerp(a, b, t):
    return (a + (b - a) * t).astype(F32)


def _disney_params(surf):
    """NumPy twin of bsdf._disney_params (slot layout TerraPresets.c:217-224)."""
    a = surf["attrs"]
    return (a[..., 0, :], a[..., 1, 0], a[..., 1, 1], a[..., 2, 0], a[..., 2, 1],
            a[..., 3, 0], a[..., 3, 1], a[..., 4, 0], a[..., 4, 1],
            a[..., 5, 0], a[..., 5, 1])


def _gtr1_np(ndoth, a):
    a2 = np.maximum(a * a, F32(1e-6))
    t = np.maximum(1.0 + (a2 - 1.0) * ndoth * ndoth, F32(1e-8))
    iso = np.full_like(ndoth, F32(1.0 / np.pi))
    val = (1.0 - a2) / np.maximum(PI * (-np.log(a2)) * t, F32(1e-8))
    return np.where(a >= 1.0, iso, val).astype(F32)


def _gtr2_aniso_np(ndoth, hdx, hdy, ax, ay):
    x = hdx / ax
    y = hdy / ay
    s = x * x + y * y + ndoth * ndoth
    return (1.0 / np.maximum(PI * ax * ay * s * s, F32(1e-8))).astype(F32)


def _smith_ggx_aniso_np(ndotv, vdx, vdy, ax, ay):
    x = vdx * ax
    y = vdy * ay
    return (1.0 / np.maximum(ndotv + np.sqrt(x * x + y * y + ndotv * ndotv), F32(1e-8))).astype(F32)


def _smith_ggx_np(ndotv, alpha_g):
    a = alpha_g * alpha_g
    b = ndotv * ndotv
    return (1.0 / np.maximum(ndotv + np.sqrt(a + b - a * b), F32(1e-8))).astype(F32)


def _disney_lobe_probs(surf):
    a = surf["attrs"]
    metalness = np.clip(a[..., 4, 0], 0.0, 1.0)
    clearcoat = np.clip(a[..., 3, 0], 0.0, 1.0)
    p_clear = 0.25 * clearcoat / (1.0 + clearcoat)
    p_spec_inner = _lerp(F32(0.5), F32(1.0), metalness)
    p_spec = (1.0 - p_clear) * p_spec_inner
    p_diff = (1.0 - p_clear) * (1.0 - p_spec_inner)
    return p_diff.astype(F32), p_spec.astype(F32), p_clear.astype(F32)


def _disney_alphas(surf):
    a = surf["attrs"]
    roughness = np.clip(a[..., 4, 1], 0.0, 1.0)
    anisotropic = np.clip(a[..., 5, 0], 0.0, 1.0)
    clearcoat_gloss = np.clip(a[..., 3, 1], 0.0, 1.0)
    aspect = np.sqrt(np.maximum(1.0 - anisotropic * 0.9, F32(1e-4))).astype(F32)
    ax = np.maximum(F32(1e-3), roughness * roughness / aspect)
    ay = np.maximum(F32(1e-3), roughness * roughness * aspect)
    a_clear = _lerp(F32(0.1), F32(0.001), clearcoat_gloss)
    return ax.astype(F32), ay.astype(F32), a_clear


def _disney_sample(surf, e0, e1, e2, wo):
    """NumPy twin of bsdf._disney_sample (3-lobe mixture)."""
    p_diff, p_spec, _ = _disney_lobe_probs(surf)
    ax, ay, a_clear = _disney_alphas(surf)
    n, tx, bz = surf["normal"], surf["tangent"], surf["bitangent"]
    wi_d = _cosine_hemisphere(surf, e0, e1)
    phi = F32(2) * PI * e1
    tanv = np.sqrt(e0 / np.maximum(1.0 - e0, F32(1e-7))).astype(F32)
    hx = tanv * ax * np.cos(phi)
    hz = tanv * ay * np.sin(phi)
    h_spec = normalize(tx * hx[..., None].astype(F32) + n + bz * hz[..., None].astype(F32))
    wi_s = normalize(reflect(wo, h_spec))
    a2 = a_clear * a_clear
    cos2 = ((1.0 - np.power(a2, 1.0 - e0)) / np.maximum(1.0 - a2, F32(1e-7))).astype(F32)
    cos_t = np.sqrt(np.clip(cos2, 0.0, 1.0)).astype(F32)
    sin_t = np.sqrt(np.maximum(0.0, 1.0 - cos2)).astype(F32)
    local_h = np.stack([sin_t * np.cos(phi), cos_t, sin_t * np.sin(phi)], -1).astype(F32)
    h_clear = normalize(to_world(local_h, tx, n, bz))
    wi_c = normalize(reflect(wo, h_clear))
    wi = np.where((e2 < p_diff)[..., None], wi_d,
                  np.where((e2 < p_diff + p_spec)[..., None], wi_s, wi_c))
    return wi.astype(F32)


def _disney_pdf(surf, wi, wo):
    p_diff, p_spec, p_clear = _disney_lobe_probs(surf)
    ax, ay, a_clear = _disney_alphas(surf)
    n = surf["normal"]
    h = normalize(wi + wo)
    noh = np.maximum(dot(n, h), F32(1e-6))
    how = np.maximum(dot(h, wo), F32(1e-6))
    ds = _gtr2_aniso_np(noh, dot(h, surf["tangent"]), dot(h, surf["bitangent"]), ax, ay)
    dr = _gtr1_np(noh, a_clear)
    pdf_spec = ds * noh / (4.0 * how)
    pdf_clear = dr * noh / (4.0 * how)
    return (p_diff * _diffuse_pdf(surf, wi) + p_spec * pdf_spec
            + p_clear * pdf_clear).astype(F32)


def _disney_eval(surf, wi, wo):
    """NumPy twin of bsdf._disney_eval (TerraPresets.c:226-296)."""
    (base_color, specular, specular_tint, sheen_p, sheen_tint, clearcoat,
     clearcoat_gloss, metalness, roughness, anisotropic, subsurface) = _disney_params(surf)
    n = surf["normal"]
    ndotl = dot(n, wi)
    ndotv = dot(n, wo)
    behind = (ndotl < 0.0) | (ndotv < 0.0)
    ndotl = np.maximum(ndotl, F32(1e-6))
    ndotv = np.maximum(ndotv, F32(1e-6))
    h = normalize(wi + wo)
    ndoth = dot(n, h)
    ldoth = dot(wi, h)
    lum = 0.3 * base_color[..., 0] + 0.6 * base_color[..., 1] + 1.0 * base_color[..., 2]
    tint = np.where((lum > 0.0)[..., None],
                    base_color / np.maximum(lum, F32(1e-8))[..., None], F32(1.0)).astype(F32)
    spec0 = _lerp(np.ones_like(base_color), tint, specular_tint[..., None])
    spec0 = spec0 * (specular * F32(0.8))[..., None]
    spec0 = _lerp(spec0, base_color, metalness[..., None])
    sheen_c = _lerp(np.ones_like(base_color), tint, sheen_tint[..., None])
    fl = _schlick_w(ndotl)
    fv = _schlick_w(ndotv)
    fd90 = 0.5 + 2.0 * ldoth * ldoth * roughness
    fd = _lerp(F32(1.0), fd90, fl) * _lerp(F32(1.0), fd90, fv)
    fss90 = ldoth * ldoth * roughness
    fss = _lerp(F32(1.0), fss90, fl) * _lerp(F32(1.0), fss90, fv)
    ss = 1.25 * (fss * (1.0 / (ndotl * ndotv) - 0.5) + 0.5)
    aspect = np.sqrt(np.maximum(1.0 - anisotropic * 0.9, F32(1e-4))).astype(F32)
    ax = np.maximum(F32(1e-3), roughness * roughness / aspect)
    ay = np.maximum(F32(1e-3), roughness * roughness * aspect)
    X = surf["tangent"]
    Y = surf["bitangent"]
    ds = _gtr2_aniso_np(ndoth, dot(h, X), dot(h, Y), ax, ay)
    fh = _schlick_w(ldoth)
    fs = _lerp(spec0, np.ones_like(spec0), fh[..., None])
    gs = _smith_ggx_aniso_np(ndotl, dot(wi, X), dot(wi, Y), ax, ay)
    gs = gs * _smith_ggx_aniso_np(ndotv, dot(wo, X), dot(wo, Y), ax, ay)
    sheen = sheen_c * (fh * sheen_p)[..., None]
    dr = _gtr1_np(ndoth, _lerp(F32(0.1), F32(0.001), clearcoat_gloss))
    fr = _lerp(F32(0.04), F32(1.0), fh)
    gr = _smith_ggx_np(ndotl, F32(0.25)) * _smith_ggx_np(ndotv, F32(0.25))
    result_a = base_color * (F32(1.0 / np.pi) * _lerp(fd, ss, subsurface))[..., None]
    result_a = (result_a + sheen) * (1.0 - metalness)[..., None]
    result_b = fs * (gs * ds)[..., None]
    result_c = (0.25 * clearcoat * gr * fr * dr)[..., None] * np.ones_like(result_b)
    result = result_a + result_b + result_c
    return np.where(behind[..., None], F32(0.0), result).astype(F32)


def bsdf_sample(surf, e0, e1, e2, wo):
    ty = surf["bsdf_type"]
    wi_d = _cosine_hemisphere(surf, e0, e1)
    # phong
    kd, _ = _phong_kd_ks(surf)
    take_d = e2 < kd
    wr = reflect(wo, surf["normal"])
    t, b = build_basis(wr)
    n_exp = surf["attrs"][..., 2, 0]
    phi = F32(2) * PI * e0
    ct = np.power(np.maximum(1 - e1, 0), 1.0 / (n_exp + 1)).astype(F32)
    st = np.sqrt(np.maximum(0, 1 - ct * ct))
    local = np.stack([st * np.cos(phi), ct, st * np.sin(phi)], -1).astype(F32)
    wi_ps = normalize(to_world(local, t, wr, b))
    wi_p = np.where(take_d[..., None], wi_d, wi_ps)
    lobe = np.where(take_d, F32(1), F32(-1))
    # ggx
    rough = np.clip(surf["attrs"][..., 1, 0], 1e-3, 1.0)
    metal = np.clip(surf["attrs"][..., 2, 0], 0.0, 1.0)
    alpha = (rough * rough).astype(F32)
    pd = np.clip(1.0 - metal * 0.5 - 0.25, 0.05, 0.95).astype(F32)
    take_gd = e2 < pd
    tan_t = alpha * np.sqrt(e0) / np.sqrt(np.maximum(1 - e0, 1e-8))
    ct_g = (1.0 / np.sqrt(1 + tan_t * tan_t)).astype(F32)
    st_g = np.sqrt(np.maximum(0, 1 - ct_g * ct_g))
    phi_g = F32(2) * PI * e1
    local_h = np.stack([st_g * np.cos(phi_g), ct_g, st_g * np.sin(phi_g)], -1).astype(F32)
    h = normalize(to_world(local_h, surf["tangent"], surf["normal"], surf["bitangent"]))
    wi_gs = normalize(reflect(wo, h))
    wi_g = np.where(take_gd[..., None], _cosine_hemisphere(surf, e0, e1), wi_gs)
    # mirror
    wi_m = normalize(reflect(wo, surf["normal"]))
    # glass: Fresnel lobe roulette on e2
    _, refl_gl, trans_gl, R_gl, _ = _glass_geom(surf, wo)
    wi_gl = np.where((e2 < R_gl)[..., None], refl_gl, trans_gl)

    wi = wi_d.copy()
    wi = np.where((ty == 1)[..., None], wi_p, wi)
    wi = np.where((ty == 2)[..., None], wi_g, wi)
    wi = np.where((ty == 3)[..., None], wi_m, wi)
    wi = np.where((ty == 4)[..., None], _disney_sample(surf, e0, e1, e2, wo), wi)
    wi = np.where((ty == 5)[..., None], wi_gl, wi)
    aux = np.where(ty == 1, lobe, F32(0))
    return wi, aux


def _diffuse_pdf(surf, wi):
    return (np.maximum(0, dot(surf["normal"], wi)) / PI).astype(F32)


def bsdf_pdf(surf, wi, wo, aux):
    ty = surf["bsdf_type"]
    p = _diffuse_pdf(surf, wi)
    # phong
    wr = reflect(wo, surf["normal"])
    ca = np.maximum(0, dot(wi, wr))
    n_exp = surf["attrs"][..., 2, 0]
    p_spec = (n_exp + 1) / (2 * PI) * np.power(ca, n_exp)
    p_ph = np.where(aux > 0, _diffuse_pdf(surf, wi), p_spec.astype(F32))
    # ggx
    rough = np.clip(surf["attrs"][..., 1, 0], 1e-3, 1.0)
    metal = np.clip(surf["attrs"][..., 2, 0], 0.0, 1.0)
    alpha = rough * rough
    pd = np.clip(1.0 - metal * 0.5 - 0.25, 0.05, 0.95)
    h = normalize(wi + wo)
    noh = np.maximum(dot(surf["normal"], h), 0)
    hov = np.maximum(dot(h, wo), 1e-6)
    a2 = alpha * alpha
    den = noh * noh * (a2 - 1) + 1
    D = a2 / np.maximum(PI * den * den, 1e-8)
    p_g = pd * _diffuse_pdf(surf, wi) + (1 - pd) * D * noh / (4 * hov)
    # mirror
    aligned = dot(wi, wr) > (1.0 - 1e-5)
    p_m = np.where(aligned, F32(1), F32(0))
    # glass
    p_gl, _ = _glass_match(surf, wi, wo)
    out = p
    out = np.where(ty == 1, p_ph, out)
    out = np.where(ty == 2, p_g.astype(F32), out)
    out = np.where(ty == 3, p_m, out)
    out = np.where(ty == 4, _disney_pdf(surf, wi, wo), out)
    out = np.where(ty == 5, p_gl, out)
    return out.astype(F32)


def _schlick_w(c):
    m = np.clip(1 - c, 0, 1)
    return (m * m) * (m * m) * m


def bsdf_eval(surf, wi, wo):
    ty = surf["bsdf_type"]
    albedo = surf["attrs"][..., 0, :]
    f_d = albedo / PI
    # phong
    kd, ks = _phong_kd_ks(surf)
    spec = surf["attrs"][..., 1, :]
    n_exp = surf["attrs"][..., 2, 0]
    wr = reflect(wo, surf["normal"])
    ca = np.maximum(0, dot(wi, wr))
    f_p = albedo * (kd / PI)[..., None] + spec * (ks * np.power(ca, n_exp) * (n_exp + 2) / (2 * PI))[..., None]
    # ggx
    rough = np.clip(surf["attrs"][..., 1, 0], 1e-3, 1.0)
    metal = np.clip(surf["attrs"][..., 2, 0], 0.0, 1.0)
    alpha = rough * rough
    n = surf["normal"]
    nol = np.maximum(dot(n, wi), 1e-6)
    nov = np.maximum(dot(n, wo), 1e-6)
    h = normalize(wi + wo)
    noh = np.maximum(dot(n, h), 0)
    loh = np.maximum(dot(wi, h), 0)
    ior = surf["ior"]
    fr = ((1 - ior) / (1 + ior)) ** 2
    f0 = fr[..., None] * np.ones_like(albedo)
    f0 = f0 + (albedo - f0) * metal[..., None]
    F = f0 + (1 - f0) * _schlick_w(loh)[..., None]
    a2 = alpha * alpha
    den = noh * noh * (a2 - 1) + 1
    D = a2 / np.maximum(PI * den * den, 1e-8)
    g1l = 2 * nol / np.maximum(nol + np.sqrt(a2 + (1 - a2) * nol * nol), 1e-8)
    g1v = 2 * nov / np.maximum(nov + np.sqrt(a2 + (1 - a2) * nov * nov), 1e-8)
    f_g = F * (D * g1l * g1v / (4 * nol * nov))[..., None] + albedo / PI * (1 - metal)[..., None] * (1 - F)
    # mirror
    color = surf["attrs"][..., 0, :]
    aligned = dot(wi, wr) > (1.0 - 1e-5)
    nol_m = np.maximum(dot(surf["normal"], wi), 1e-6)
    f_m = np.where(aligned[..., None], color / nol_m[..., None], 0)
    # glass
    w_gl, matched_gl = _glass_match(surf, wi, wo)
    anol = np.maximum(np.abs(dot(surf["normal"], wi)), 1e-6)
    f_gl = np.where(matched_gl[..., None], color * (w_gl / anol)[..., None], 0)
    out = f_d
    out = np.where((ty == 1)[..., None], f_p, out)
    out = np.where((ty == 2)[..., None], f_g.astype(F32), out)
    out = np.where((ty == 3)[..., None], f_m.astype(F32), out)
    out = np.where((ty == 4)[..., None], _disney_eval(surf, wi, wo), out)
    out = np.where((ty == 5)[..., None], f_gl.astype(F32), out)
    return out.astype(F32)


# ------------------------------------------------------------------ env-NEE

GRID_H, GRID_W = 64, 128  # must match envmap.GRID_H/GRID_W
TWO_PI2 = F32(2.0 * np.pi * np.pi)


class EnvDistNp:
    """NumPy twin of envmap.build_distribution (marginal x conditionals)."""

    def __init__(self, sc: SceneNp):
        v = (np.arange(GRID_H, dtype=F32) + F32(0.5)) / F32(GRID_H)
        u = (np.arange(GRID_W, dtype=F32) + F32(0.5)) / F32(GRID_W)
        theta = v * PI
        phi = u * F32(2) * PI - PI
        sin_t = np.sin(theta)[:, None].astype(F32)
        cos_t = np.cos(theta)[:, None].astype(F32)
        dx = sin_t * np.cos(phi)[None, :].astype(F32)
        dz = sin_t * np.sin(phi)[None, :].astype(F32)
        dy = np.broadcast_to(cos_t, (GRID_H, GRID_W)).astype(F32)
        dirs = np.stack([dx, dy, dz], axis=-1).astype(F32)
        rad = env_radiance(sc, dirs.reshape(-1, 3)).reshape(GRID_H, GRID_W, 3)
        lum = (F32(0.2126) * rad[..., 0] + F32(0.7152) * rad[..., 1]
               + F32(0.0722) * rad[..., 2]).astype(F32)
        f = (lum * sin_t).astype(F32)
        floor = np.maximum(np.mean(f, dtype=F32), F32(1e-12)) * F32(1e-2)
        f = (f + floor * sin_t).astype(F32)
        # conditionals (per row) + marginal over row integrals (build_1d twin)
        self.cond_f = f
        c = np.cumsum(f, axis=-1, dtype=F32)
        self.cond_integral = c[..., -1].astype(F32)
        self.cond_cdf = (c / np.maximum(self.cond_integral, F32(1e-20))[..., None]).astype(F32)
        cm = np.cumsum(self.cond_integral, axis=-1, dtype=F32)
        self.marg_f = self.cond_integral
        self.marg_integral = cm[-1].astype(F32)
        self.marg_cdf = (cm / np.maximum(self.marg_integral, F32(1e-20))).astype(F32)


def env_sample(dist: EnvDistNp, e1, e2):
    """NumPy twin of envmap.sample via distributions.sample_2d."""
    n_r = GRID_H
    row = np.clip(np.searchsorted(dist.marg_cdf, e1, side="right"), 0, n_r - 1)
    prev = np.where(row > 0, dist.marg_cdf[np.maximum(row - 1, 0)], F32(0.0))
    curr = dist.marg_cdf[row]
    frac = ((e1 - prev) / np.maximum(curr - prev, F32(1e-12))).astype(F32)
    v = ((row.astype(F32) + frac) / F32(n_r)).astype(F32)
    pdf_y = dist.marg_f[row] / np.maximum(dist.marg_integral, F32(1e-20))
    cdf = dist.cond_cdf[row]  # (N, GRID_W)
    n_c = GRID_W
    idx = np.clip(np.sum((cdf < e2[..., None]).astype(np.int32), axis=-1), 0, n_c - 1)
    prev_c = np.where(idx > 0, np.take_along_axis(cdf, np.maximum(idx - 1, 0)[..., None], -1)[..., 0], F32(0.0))
    curr_c = np.take_along_axis(cdf, idx[..., None], -1)[..., 0]
    frac_c = ((e2 - prev_c) / np.maximum(curr_c - prev_c, F32(1e-12))).astype(F32)
    u = ((idx.astype(F32) + frac_c) / F32(n_c)).astype(F32)
    fr = np.take_along_axis(dist.cond_f[row], idx[..., None], -1)[..., 0]
    integ = dist.cond_integral[row]
    pdf_x = fr / np.maximum(integ, F32(1e-20))
    p_bucket = (pdf_y * pdf_x).astype(F32)
    theta = v * PI
    phi = u * F32(2) * PI - PI
    sin_t = np.sin(theta).astype(F32)
    wi = np.stack([sin_t * np.cos(phi), np.cos(theta), sin_t * np.sin(phi)], -1).astype(F32)
    density_uv = p_bucket * F32(GRID_W * GRID_H)
    pdf_w = (density_uv / np.maximum(TWO_PI2 * sin_t, F32(1e-6))).astype(F32)
    return wi, pdf_w


def env_pdf(dist: EnvDistNp, wi):
    """NumPy twin of envmap.pdf (solid-angle pdf of arbitrary direction)."""
    d = normalize(wi)
    theta = np.arccos(np.clip(d[..., 1], -1.0, 1.0)).astype(F32)
    phi = (np.arctan2(d[..., 2], d[..., 0]) + PI).astype(F32)
    u = phi / (F32(2) * PI)
    v = theta / PI
    col = np.clip((u * GRID_W).astype(np.int32), 0, GRID_W - 1)
    row = np.clip((v * GRID_H).astype(np.int32), 0, GRID_H - 1)
    total = np.maximum(dist.marg_integral, F32(1e-20))
    density_uv = dist.cond_f[row, col] * F32(GRID_W * GRID_H) / total
    sin_t = np.maximum(np.sin(theta), F32(1e-6)).astype(F32)
    return (density_uv / (TWO_PI2 * sin_t)).astype(F32)


def _delta_mask(surf):
    """Twin of bsdf.delta_mask: MIRROR (3) / GLASS (5) lanes."""
    ty = surf["bsdf_type"]
    return (ty == 3) | (ty == 5)


def _nee_env(sc, dist, key, pix, smp, bounce, surf, wo, want_weight, aux):
    """NumPy twin of integrators._nee_env_strategy."""
    e1 = uniform_np(key, pix, smp, bounce, ENV_U)
    e2 = uniform_np(key, pix, smp, bounce, ENV_V)
    wi, epdf = env_sample(dist, e1, e2)
    nol = dot(wi, surf["normal"])
    o_sh = surf["point"] + surf["normal"] * SURFACE_OFFSET_NORMAL
    t, tri_h, hit, _ = raycast(sc, o_sh, wi)
    visible = (~hit) & (nol > 0) & (epdf > 0) & ~_delta_mask(surf)
    f = bsdf_eval(surf, wi, wo)
    Le = env_radiance(sc, wi)
    if want_weight:
        bp = bsdf_pdf(surf, wi, wo, aux)
        w = _power2_weight(epdf, bp)
    else:
        w = np.ones_like(epdf)
    contrib = Le * f * (nol * w / np.where(visible, epdf, F32(1.0)))[..., None]
    return np.where(visible[..., None], contrib, 0).astype(F32)


def _mis_bsdf_env_term(sc, dist, surf, wo, wi, f, bp, hit):
    """NumPy twin of integrators._mis_bsdf_env_term."""
    epdf = env_pdf(dist, wi)
    nol = dot(wi, surf["normal"])
    ok = (~hit) & (bp > 0) & (nol > 0) & ~_delta_mask(surf)
    w = _power2_weight(bp, epdf)
    Le = env_radiance(sc, wi)
    contrib = Le * f * (nol * w / np.where(ok, bp, F32(1.0)))[..., None]
    return np.where(ok[..., None], contrib, 0).astype(F32)


# -------------------------------------------------------------- integrators

SHADOW_TMAX_SCALE = F32(1.0 - 1e-3)  # must match integrators.SHADOW_TMAX_SCALE


def _light_pick_sample(sc: SceneNp, e_pick, e1, e2, area_weighted=False):
    num = max(sc.light_num, 1)
    if area_weighted:
        slot = np.searchsorted(sc.light_cdf, e_pick).astype(np.int32)
        slot = np.minimum(slot, num - 1)
        live = np.arange(len(sc.light_area)) < num
        total = np.sum(np.where(live, sc.light_area, 0.0), dtype=F32)
        pick_pdf = (sc.light_area[slot] / np.maximum(total, F32(1e-12))).astype(F32)
    else:
        slot = np.minimum((e_pick * F32(num)).astype(np.int32), num - 1)
        pick_pdf = np.full_like(e_pick, F32(1.0 / num))
    tri = sc.light_tri[slot]
    a, b, c = sc.tri_a[tri], sc.tri_b[tri], sc.tri_c[tri]
    s = np.sqrt(e1)
    wa, wb = 1 - s, e2 * s
    wc = 1 - wa - wb
    pos = wa[..., None] * a + wb[..., None] * b + wc[..., None] * c
    ncr = sc.normals[tri]
    norm = normalize(wa[..., None] * ncr[:, 0] + wb[..., None] * ncr[:, 1] + wc[..., None] * ncr[:, 2])
    area = sc.light_area[slot]
    # emissive at the sampled point (twin of lights.pick_and_sample)
    mat = sc.mat_id[tri]
    Le = sc.emissive[mat]
    if sc.num_textures > 0:
        uvc = sc.uvs[tri]
        uv = (wa[..., None] * uvc[:, 0] + wb[..., None] * uvc[:, 1]
              + wc[..., None] * uvc[:, 2]).astype(F32)
        etid = sc.emissive_tex[mat]
        tval = tex_sample(sc, np.maximum(etid, 0), uv)
        Le = np.where((etid >= 0)[..., None], tval, Le).astype(F32)
    return tri, pos.astype(F32), norm, area, pick_pdf, Le


PDF_CLAMP = F32(1e17)  # must match integrators._power2_weight


def _power2_weight(pa, pb):
    pa = np.minimum(pa, PDF_CLAMP)
    pb = np.minimum(pb, PDF_CLAMP)
    return (pa * pa) / np.maximum(pa * pa + pb * pb, F32(1e-20))


def _nee(sc, key, pix, smp, bounce, surf, wo, want_weight, aux, area_weighted=False):
    e_pick = uniform_np(key, pix, smp, bounce, LIGHT_PICK)
    e1 = uniform_np(key, pix, smp, bounce, LIGHT_U)
    e2 = uniform_np(key, pix, smp, bounce, LIGHT_V)
    tri_l, pos, norm_l, area, pick_pdf, Le = _light_pick_sample(sc, e_pick, e1, e2, area_weighted)
    p2l = pos - surf["point"]
    wi = normalize(p2l)
    o_sh = surf["point"] + surf["normal"] * SURFACE_OFFSET_NORMAL
    # ranged occlusion (twin of integrators._nee_light_strategy): anything
    # strictly closer than the sampled point blocks it
    t_light = np.sqrt(dot(pos - o_sh, pos - o_sh)).astype(F32) * SHADOW_TMAX_SCALE
    t, tri_h, hit, o_off = raycast(sc, o_sh, wi)
    visible = ~(hit & (t < t_light))
    cos_l = dot(norm_l, -wi)
    visible &= cos_l > 0
    visible &= ~_delta_mask(surf)  # NEE skips delta lanes (integrators._skip_delta)
    light_pdf = dot(p2l, p2l) / np.maximum(np.abs(cos_l * area), 1e-12)
    f = bsdf_eval(surf, wi, wo)
    nol = dot(wi, surf["normal"])
    if want_weight:
        bp = bsdf_pdf(surf, wi, wo, aux)
        w = _power2_weight(light_pdf, bp)
        visible &= light_pdf != 0
    else:
        w = np.ones_like(light_pdf)
    contrib = Le * f * (nol * w / (light_pdf * pick_pdf))[..., None]
    return np.where(visible[..., None], contrib, 0).astype(F32), tri_l


def _mis_bsdf(sc, key, pix, smp, bounce, surf, wo, tri_l, env_dist=None):
    e0 = uniform_np(key, pix, smp, bounce, MIS_E0)
    e1 = uniform_np(key, pix, smp, bounce, MIS_E1)
    e2 = uniform_np(key, pix, smp, bounce, MIS_E2)
    wi, aux = bsdf_sample(surf, e0, e1, e2, wo)
    f = bsdf_eval(surf, wi, wo)
    bp = bsdf_pdf(surf, wi, wo, aux)
    o_sh = surf["point"] + surf["normal"] * SURFACE_OFFSET_NORMAL
    t, tri_h, hit, o_off = raycast(sc, o_sh, wi)
    hsurf = surface_init(sc, o_off, wi, tri_h)
    ok = hit & (sc.obj_id[tri_h] == sc.obj_id[tri_l])
    now = dot(hsurf["normal"], -wi)
    ok &= now > 0
    ok &= ~_delta_mask(surf)  # MIS BSDF strategy skips delta lanes
    dist2 = dot(hsurf["point"] - surf["point"], hsurf["point"] - surf["point"])
    a, b, c = sc.tri_a[tri_h], sc.tri_b[tri_h], sc.tri_c[tri_h]
    hit_area = 0.5 * np.sqrt(dot(cross(b - a, c - a), cross(b - a, c - a)))
    light_pdf = dist2 / np.maximum(now * hit_area, 1e-12)
    w = _power2_weight(bp, light_pdf)
    ok &= bp != 0
    nol = dot(wi, surf["normal"])
    contrib = hsurf["emissive"] * f * (nol * w / np.maximum(bp, 1e-20))[..., None]
    contrib = np.where(ok[..., None], contrib, 0).astype(F32)
    if env_dist is not None:
        contrib = contrib + _mis_bsdf_env_term(sc, env_dist, surf, wo, wi, f, bp, hit)
    return contrib


def render_mirror(scene, camera, opts, seed=0):
    """Full mirror render -> (H, W, 3) float32 radiance mean."""
    sc = SceneNp(scene)
    key = key_from_seed_np(seed)
    W, H, spp = opts.width, opts.height, opts.samples_per_pixel
    n = W * H * spp
    pix = np.repeat(np.arange(W * H, dtype=np.int32), spp)
    smp = np.tile(np.arange(spp, dtype=np.int32), W * H)
    px = (pix % W).astype(F32)
    py = (pix // W).astype(F32)

    # camera (matches terra_tpu.camera)
    jit = F32(opts.subpixel_jitter)
    if opts.sampling_method == 1:  # stratified
        strata = max(int(opts.strata), 1)
        stratum = smp % (strata * strata)
        sx = (stratum % strata).astype(F32)
        sy = (stratum // strata).astype(F32)
        u1, u2 = uniform2_np(key, pix, smp, 0, JITTER_X)
        r1 = np.minimum((sx + u1) / strata, 1 - 1e-4).astype(F32)
        r2 = np.minimum((sy + u2) / strata, 1 - 1e-4).astype(F32)
    elif opts.sampling_method == 2:  # halton
        r1 = _radical_inverse_np(3, smp)
        r2 = _radical_inverse_np(2, smp)
    else:
        r1, r2 = uniform2_np(key, pix, smp, 0, JITTER_X)
    dx = -jit + 2 * r1 * jit
    dy = -jit + 2 * r2 * jit
    ndc_x = (px + F32(0.5) + dx) / F32(W)
    ndc_y = (py + F32(0.5) + dy) / F32(H)
    sx_ = 2 * ndc_x - 1
    sy_ = 1 - 2 * ndc_y
    aspect = F32(W / H)
    pos = np.asarray(camera.position, F32)
    direction = np.asarray(camera.direction, F32)
    up = np.asarray(camera.up, F32)
    fov = F32(np.asarray(camera.fov_deg))
    thf = np.tan(fov * F32(0.0174533) / 2).astype(F32)
    fx = sx_ * aspect * thf
    fy = sy_ * thf
    local = normalize(np.stack([fx, fy, np.ones_like(fx)], -1).astype(F32))
    z = normalize(direction)
    x = normalize(cross(up, z))
    y = cross(z, x)
    d = local[..., 0:1] * x + local[..., 1:2] * y + local[..., 2:3] * z
    o = np.broadcast_to(pos, d.shape).astype(F32).copy()

    Lo = np.zeros((n, 3), F32)
    tp = np.ones((n, 3), F32)
    active = np.ones(n, bool)
    # specular-bounce flag (twin of render.trace's emit_ok carry): emissive
    # pickup under DIRECT/DIRECT_MIS at bounce 0 and after delta lobes.
    emit_ok = np.ones(n, bool)
    env_dist = EnvDistNp(sc) if getattr(opts, "env_nee", False) else None

    for bounce in range(opts.bounces + 1):
        t, tri, hit, o_off = raycast(sc, o, d)
        surf = surface_init(sc, o_off, d, tri)
        wo = -d
        if opts.env_on_miss:
            miss = active & ~hit
            if env_dist is not None:
                miss = miss & emit_ok
            Lo += np.where(miss[..., None], tp * env_radiance(sc, d), 0)
        active = active & hit

        integ = int(opts.integrator)
        area_pick = bool(int(getattr(opts, "light_pick", 0)))
        if integ == 0:  # simple
            facing = dot(wo, surf["normal"]) > 0
            rad = np.where(facing[..., None], surf["emissive"], 0) * tp
        elif integ == 1:  # direct
            facing = (dot(wo, surf["normal"]) > 0) & emit_ok
            Le0 = np.where(facing[..., None], surf["emissive"], 0)
            c, _ = _nee(sc, key, pix, smp, bounce, surf, wo, False, None, area_pick)
            if env_dist is not None:
                c = c + _nee_env(sc, env_dist, key, pix, smp, bounce, surf, wo, False, None)
            rad = (Le0 + c) * tp
        elif integ == 2:  # direct mis
            facing = (dot(wo, surf["normal"]) > 0) & emit_ok
            Le0 = np.where(facing[..., None], surf["emissive"], 0)
            e0 = uniform_np(key, pix, smp, bounce, MIS_E0)
            e1 = uniform_np(key, pix, smp, bounce, MIS_E1)
            e2 = uniform_np(key, pix, smp, bounce, MIS_E2)
            _, aux = bsdf_sample(surf, e0, e1, e2, wo)
            lc, tri_l = _nee(sc, key, pix, smp, bounce, surf, wo, True, aux, area_pick)
            bc = _mis_bsdf(sc, key, pix, smp, bounce, surf, wo, tri_l, env_dist)
            rad = (Le0 + lc + bc) * tp
            if env_dist is not None:
                rad = rad + _nee_env(sc, env_dist, key, pix, smp, bounce, surf, wo, True, aux) * tp
        else:
            rad = np.zeros((n, 3), F32)
        Lo += np.where(active[..., None], rad, 0)

        e0 = uniform_np(key, pix, smp, bounce, BSDF_E0)
        e1 = uniform_np(key, pix, smp, bounce, BSDF_E1)
        e2 = uniform_np(key, pix, smp, bounce, BSDF_E2)
        wi, aux = bsdf_sample(surf, e0, e1, e2, wo)
        pdf = np.maximum(bsdf_pdf(surf, wi, wo, aux), EPS)
        f = bsdf_eval(surf, wi, wo)
        nol = dot(surf["normal"], wi)
        # glass lanes: |N.wi| and far-side origin offset (bsdf.continuation_factors)
        is_glass = surf["bsdf_type"] == 5
        nol = np.where(is_glass, np.abs(nol), nol).astype(F32)
        off_sign = np.where(is_glass & (dot(surf["normal"], wi) < 0), F32(-1), F32(1))
        new_tp = tp * f * (nol / pdf)[..., None]
        p = new_tp.max(-1)
        e3 = uniform_np(key, pix, smp, bounce, ROULETTE)
        rr_on = bounce >= opts.rr_start_bounce
        survive = (e3 <= p) if rr_on else np.ones(n, bool)
        if rr_on:
            new_tp = new_tp / (p + EPS)[..., None]
        active = active & survive
        new_o = surf["point"] + surf["normal"] * (off_sign * SURFACE_OFFSET_NORMAL)[..., None]
        o = np.where(active[..., None], new_o, o)
        d = np.where(active[..., None], wi, d)
        tp = np.where(active[..., None], new_tp, tp).astype(F32)
        emit_ok = _delta_mask(surf)  # dead lanes: value never read

    img = Lo.reshape(H, W, spp, 3).mean(axis=2)
    return img


def _radical_inverse_np(base, index):
    a = np.asarray(index, np.uint32)
    seq = np.zeros_like(a)
    denom = np.ones(a.shape, F32)
    for _ in range(32):
        live = a > 0
        nxt = a // base
        digit = a - nxt * base
        seq = np.where(live, seq * base + digit, seq)
        denom = np.where(live, denom * F32(1.0 / base), denom)
        a = nxt
    return np.minimum(seq.astype(F32) * denom, F32(1 - 1e-4))
