"""Differentiable BSDFs: sample / pdf / eval triplets with masked dispatch.

Replaces the function-pointer BSDF vtable of the reference
(/root/reference/include/Terra.h:46-54, presets in src/TerraPresets.c) with
static integer dispatch: every preset is evaluated wavefront-wide and lanes
select their material's result by mask. With a handful of cheap analytic
lobes this is cheaper than per-lane branching (no divergence, no
gathers) and keeps everything differentiable w.r.t. the attribute tensor.

Presets:
  DIFFUSE — cosine-weighted Lambert (TerraPresets.c:34-60)
  PHONG   — kd/ks energy split + lobe roulette (TerraPresets.c:66-146).
            The reference smuggles the lobe pick through a surface attribute
            slot (TerraPresets.c:87-95, 109-122); here it is an explicit
            ``aux`` value threaded through sample->pdf.
  GGX     — Cook-Torrance microfacet with Smith G and Schlick Fresnel; a
            proper rebuild of the reference's disabled rough-dielectric
            preset (TerraPresets.c:298-395).
  MIRROR  — perfect specular delta lobe (extension).
  DISNEY  — full principled eval (TerraPresets.c:154-296; the reference
            stubs every parameter to 0 and ships NO sample/pdf) plus an
            importance sampler the reference lacks: a three-lobe mixture
            (cosine diffuse / GTR2-aniso specular / GTR1 clearcoat) with
            the matching mixture pdf.

All functions are batched: attrs (N,8,3), directions (N,3).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .ops import math3
from .scene import ATTR, BSDFType
from .surface import Surface

__all__ = ["sample", "pdf", "eval_f", "continuation_factors", "delta_mask",
           "DELTA_TYPES", "NUM_BSDF_TYPES"]

NUM_BSDF_TYPES = 6

# Delta (perfectly specular) lobes: their "pdf" is not a density, so the
# DIRECT/DIRECT_MIS strategies treat them specially — NEE and the MIS BSDF
# strategy are skipped at delta lanes, and the path continuation picks up
# the next hit's emissive with weight 1 instead (pbrt-style specular-bounce
# flag; the reference disabled both lobes, TerraPresets.c:298-465, so there
# is no reference behavior to match).
DELTA_TYPES = (3, 5)  # BSDFType.MIRROR, BSDFType.GLASS
PI = np.float32(np.pi)
INV_PI = np.float32(1.0 / np.pi)
EPS = np.float32(1e-4)


def _cosine_hemisphere(surface: Surface, e1, e2):
    """Cosine-weighted hemisphere about the shading normal
    (terra_bsdf_diffuse_sample, TerraPresets.c:34-45)."""
    r = jnp.sqrt(e1)
    theta = 2.0 * PI * e2
    local = jnp.stack(
        [r * jnp.cos(theta), jnp.sqrt(jnp.maximum(0.0, 1.0 - e1)), r * jnp.sin(theta)],
        axis=-1,
    )
    wi = math3.to_world(local, surface.tangent, surface.normal, surface.bitangent)
    return math3.normalize(wi)


# ------------------------------------------------------------------ diffuse

def _diffuse_pdf(surface: Surface, wi):
    nol = jnp.maximum(0.0, math3.dot(surface.normal, wi))
    return nol * INV_PI


def _diffuse_eval(surface: Surface, wi, wo):
    return surface.attrs[..., ATTR.DIFFUSE_ALBEDO, :] * INV_PI


# -------------------------------------------------------------------- phong

def _phong_kd_ks(surface: Surface):
    """Energy split (terra_bsdf_phong_calculate_kd_ks, TerraPresets.c:66-82)."""
    albedo = surface.attrs[..., ATTR.PHONG_ALBEDO, :]
    spec = surface.attrs[..., ATTR.PHONG_SPECULAR_COLOR, :]
    diffuse = jnp.maximum(jnp.sum(albedo, axis=-1), EPS)
    specular = jnp.sum(spec, axis=-1)
    spec_gt = specular > diffuse
    kd_a = 0.5 * diffuse / jnp.maximum(specular, EPS)
    ks_b = 0.5 * specular / diffuse
    kd = jnp.where(spec_gt, kd_a, 1.0 - ks_b)
    ks = 1.0 - kd
    return kd, ks


def _phong_sample(surface: Surface, e1, e2, e3, wo):
    """TerraPresets.c:84-106. Returns (wi, lobe) with lobe=+1 diffuse,
    -1 specular — the reference writes this into attribute slot
    TERRA_PHONG_SAMPLE_PICK; we return it as aux."""
    kd, _ = _phong_kd_ks(surface)
    take_diffuse = e3 < kd
    wi_d = _cosine_hemisphere(surface, e1, e2)
    # Specular lobe about the reflection direction.
    wr = math3.reflect(wo, surface.normal)
    t, b = math3.build_basis(wr)
    n_exp = surface.attrs[..., ATTR.PHONG_SPECULAR_INTENSITY, 0]
    phi = 2.0 * PI * e1
    cos_theta = jnp.power(jnp.maximum(1.0 - e2, 0.0), 1.0 / (n_exp + 1.0))
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    local = jnp.stack(
        [sin_theta * jnp.cos(phi), cos_theta, sin_theta * jnp.sin(phi)], axis=-1
    )
    wi_s = math3.normalize(math3.to_world(local, t, wr, b))
    wi = jnp.where(take_diffuse[..., None], wi_d, wi_s)
    lobe = jnp.where(take_diffuse, 1.0, -1.0)
    return wi, lobe


def _phong_pdf(surface: Surface, wi, wo, lobe):
    """TerraPresets.c:108-123 — pdf of the *picked* lobe (reference
    semantics; the lobe flag rides along instead of an attribute slot)."""
    diffuse_pdf = _diffuse_pdf(surface, wi)
    wr = math3.reflect(wo, surface.normal)
    cos_alpha = jnp.maximum(0.0, math3.dot(wi, wr))
    n_exp = surface.attrs[..., ATTR.PHONG_SPECULAR_INTENSITY, 0]
    spec_pdf = (n_exp + 1.0) / (2.0 * PI) * jnp.power(cos_alpha, n_exp)
    return jnp.where(lobe > 0.0, diffuse_pdf, spec_pdf)


def _phong_eval(surface: Surface, wi, wo):
    """TerraPresets.c:125-140."""
    kd, ks = _phong_kd_ks(surface)
    albedo = surface.attrs[..., ATTR.PHONG_ALBEDO, :]
    spec = surface.attrs[..., ATTR.PHONG_SPECULAR_COLOR, :]
    n_exp = surface.attrs[..., ATTR.PHONG_SPECULAR_INTENSITY, 0]
    wr = math3.reflect(wo, surface.normal)
    cos_alpha = jnp.maximum(0.0, math3.dot(wi, wr))
    diffuse_term = albedo * (kd * INV_PI)[..., None]
    spec_term = spec * (
        ks * jnp.power(cos_alpha, n_exp) * (n_exp + 2.0) / (2.0 * PI)
    )[..., None]
    return diffuse_term + spec_term


# ---------------------------------------------------------------------- ggx

def _schlick_weight(cos_theta):
    """(1-cos)^5 (TerraPresets.c:7-11)."""
    m = jnp.clip(1.0 - cos_theta, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def _ggx_params(surface: Surface):
    rough = jnp.clip(surface.attrs[..., ATTR.GGX_ROUGHNESS, 0], 1e-3, 1.0)
    metal = jnp.clip(surface.attrs[..., ATTR.GGX_METALNESS, 0], 0.0, 1.0)
    albedo = surface.attrs[..., ATTR.GGX_ALBEDO, :]
    alpha = rough * rough
    return albedo, rough, metal, alpha


def _ggx_D(noh, alpha):
    a2 = alpha * alpha
    den = noh * noh * (a2 - 1.0) + 1.0
    return a2 / jnp.maximum(PI * den * den, 1e-8)


def _smith_g1(nov, alpha):
    a2 = alpha * alpha
    return 2.0 * nov / jnp.maximum(nov + jnp.sqrt(a2 + (1.0 - a2) * nov * nov), 1e-8)


def _ggx_F0(surface: Surface, albedo, metal):
    """F0 from ior, lerped to albedo by metalness (the reference's
    terra_bsdf_R0, TerraPresets.c:21-27)."""
    ior = surface.ior
    f = (1.0 - ior) / (1.0 + ior)
    f0 = (f * f)[..., None] * jnp.ones_like(albedo)
    return math3.lerp(f0, albedo, metal[..., None])


def _ggx_sample(surface: Surface, e1, e2, e3, wo):
    """Mixture: diffuse with prob (1 - metalness), else GGX NDF half-vector
    (theta = atan(alpha sqrt(e1) / sqrt(1-e1)), TerraPresets.c:334-344)."""
    albedo, rough, metal, alpha = _ggx_params(surface)
    pd = jnp.clip(1.0 - metal * 0.5 - 0.25, 0.05, 0.95)  # diffuse pick prob; keep both lobes alive
    take_diffuse = e3 < pd
    wi_d = _cosine_hemisphere(surface, e1, e2)
    tan_theta = alpha * jnp.sqrt(e1) / jnp.sqrt(jnp.maximum(1.0 - e1, 1e-8))
    cos_theta = jnp.reciprocal(jnp.sqrt(1.0 + tan_theta * tan_theta))
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    phi = 2.0 * PI * e2
    local_h = jnp.stack(
        [sin_theta * jnp.cos(phi), cos_theta, sin_theta * jnp.sin(phi)], axis=-1
    )
    h = math3.normalize(
        math3.to_world(local_h, surface.tangent, surface.normal, surface.bitangent)
    )
    wi_s = math3.normalize(math3.reflect(wo, h))
    wi = jnp.where(take_diffuse[..., None], wi_d, wi_s)
    return wi, jnp.zeros(wi.shape[:-1], wi.dtype)


def _ggx_pdf(surface: Surface, wi, wo):
    """Mixture pdf: pd * cos/pi + (1-pd) * D*NoH / (4 HoV)."""
    albedo, rough, metal, alpha = _ggx_params(surface)
    pd = jnp.clip(1.0 - metal * 0.5 - 0.25, 0.05, 0.95)
    h = math3.normalize(wi + wo)
    noh = jnp.maximum(math3.dot(surface.normal, h), 0.0)
    hov = jnp.maximum(math3.dot(h, wo), 1e-6)
    spec_pdf = _ggx_D(noh, alpha) * noh / (4.0 * hov)
    return pd * _diffuse_pdf(surface, wi) + (1.0 - pd) * spec_pdf


def _ggx_eval(surface: Surface, wi, wo):
    """Cook-Torrance: F G D / (4 NoL NoV) + (1-F)(1-metal) albedo/pi."""
    albedo, rough, metal, alpha = _ggx_params(surface)
    n = surface.normal
    nol = jnp.maximum(math3.dot(n, wi), 1e-6)
    nov = jnp.maximum(math3.dot(n, wo), 1e-6)
    h = math3.normalize(wi + wo)
    noh = jnp.maximum(math3.dot(n, h), 0.0)
    loh = jnp.maximum(math3.dot(wi, h), 0.0)
    f0 = _ggx_F0(surface, albedo, metal)
    F = f0 + (1.0 - f0) * _schlick_weight(loh)[..., None]
    D = _ggx_D(noh, alpha)
    G = _smith_g1(nol, alpha) * _smith_g1(nov, alpha)
    spec = F * (D * G / (4.0 * nol * nov))[..., None]
    diff = albedo * INV_PI * ((1.0 - metal))[..., None] * (1.0 - F)
    return spec + diff


# ------------------------------------------------------------------- disney

def _disney_params(surface: Surface):
    """Attribute slot layout matches the reference comment block
    (TerraPresets.c:217-224): base_color; [specular, specular_tint];
    [sheen, sheen_tint]; [clearcoat, clearcoat_gloss];
    [metalness, roughness]; [anisotropic, subsurface]."""
    a = surface.attrs
    base_color = a[..., 0, :]
    specular, specular_tint = a[..., 1, 0], a[..., 1, 1]
    sheen, sheen_tint = a[..., 2, 0], a[..., 2, 1]
    clearcoat, clearcoat_gloss = a[..., 3, 0], a[..., 3, 1]
    metalness, roughness = a[..., 4, 0], a[..., 4, 1]
    anisotropic, subsurface = a[..., 5, 0], a[..., 5, 1]
    return (base_color, specular, specular_tint, sheen, sheen_tint,
            clearcoat, clearcoat_gloss, metalness, roughness, anisotropic, subsurface)


def _gtr1(ndoth, a):
    """TerraPresets.c:201-209. For a < 1 both (a2-1) and log(a2) are
    negative; compute with positive factors so the epsilon guard cannot
    flip the sign."""
    a2 = jnp.maximum(a * a, 1e-6)
    t = jnp.maximum(1.0 + (a2 - 1.0) * ndoth * ndoth, 1e-8)
    iso = jnp.full_like(ndoth, INV_PI)
    val = (1.0 - a2) / jnp.maximum(PI * (-jnp.log(a2)) * t, 1e-8)
    return jnp.where(a >= 1.0, iso, val)


def _gtr2_aniso(ndoth, hdx, hdy, ax, ay):
    """TerraPresets.c:182-187."""
    x = hdx / ax
    y = hdy / ay
    s = x * x + y * y + ndoth * ndoth
    return 1.0 / jnp.maximum(PI * ax * ay * s * s, 1e-8)


def _smith_ggx_aniso(ndotv, vdx, vdy, ax, ay):
    """TerraPresets.c:189-193."""
    x = vdx * ax
    y = vdy * ay
    return 1.0 / jnp.maximum(ndotv + jnp.sqrt(x * x + y * y + ndotv * ndotv), 1e-8)


def _smith_ggx(ndotv, alpha_g):
    """TerraPresets.c:195-199."""
    a = alpha_g * alpha_g
    b = ndotv * ndotv
    return 1.0 / jnp.maximum(ndotv + jnp.sqrt(a + b - a * b), 1e-8)


def _disney_eval(surface: Surface, wi, wo):
    """Full Disney principled eval (terra_bsdf_disney_eval,
    TerraPresets.c:226-296). The reference stubs every parameter to 0
    (TerraPresets.c:246-287, '// =') and ships no sample/pdf; here the
    parameters come from the attribute slots so the lobe actually works."""
    (base_color, specular, specular_tint, sheen_p, sheen_tint, clearcoat,
     clearcoat_gloss, metalness, roughness, anisotropic, subsurface) = _disney_params(surface)
    n = surface.normal
    ndotl = math3.dot(n, wi)
    ndotv = math3.dot(n, wo)
    behind = (ndotl < 0.0) | (ndotv < 0.0)
    ndotl = jnp.maximum(ndotl, 1e-6)
    ndotv = jnp.maximum(ndotv, 1e-6)
    h = math3.normalize(wi + wo)
    ndoth = math3.dot(n, h)
    ldoth = math3.dot(wi, h)
    # tint from luminance (TerraPresets.c:240-244)
    lum = 0.3 * base_color[..., 0] + 0.6 * base_color[..., 1] + 1.0 * base_color[..., 2]
    tint = jnp.where(
        (lum > 0.0)[..., None], base_color / jnp.maximum(lum, 1e-8)[..., None], 1.0
    )
    spec0 = math3.lerp(jnp.ones_like(base_color), tint, specular_tint[..., None])
    spec0 = spec0 * (specular * 0.8)[..., None]
    spec0 = math3.lerp(spec0, base_color, metalness[..., None])
    sheen_c = math3.lerp(jnp.ones_like(base_color), tint, sheen_tint[..., None])
    # diffuse fresnel (TerraPresets.c:256-260)
    fl = _schlick_weight(ndotl)
    fv = _schlick_weight(ndotv)
    fd90 = 0.5 + 2.0 * ldoth * ldoth * roughness
    fd = math3.lerp(1.0, fd90, fl) * math3.lerp(1.0, fd90, fv)
    # subsurface (TerraPresets.c:262-264)
    fss90 = ldoth * ldoth * roughness
    fss = math3.lerp(1.0, fss90, fl) * math3.lerp(1.0, fss90, fv)
    ss = 1.25 * (fss * (1.0 / (ndotl * ndotv) - 0.5) + 0.5)
    # anisotropic specular (TerraPresets.c:266-276)
    aspect = jnp.sqrt(jnp.maximum(1.0 - anisotropic * 0.9, 1e-4))
    ax = jnp.maximum(1e-3, roughness * roughness / aspect)
    ay = jnp.maximum(1e-3, roughness * roughness * aspect)
    X = surface.tangent
    Y = surface.bitangent
    ds = _gtr2_aniso(ndoth, math3.dot(h, X), math3.dot(h, Y), ax, ay)
    fh = _schlick_weight(ldoth)
    fs = math3.lerp(spec0, jnp.ones_like(spec0), fh[..., None])
    gs = _smith_ggx_aniso(ndotl, math3.dot(wi, X), math3.dot(wi, Y), ax, ay)
    gs = gs * _smith_ggx_aniso(ndotv, math3.dot(wo, X), math3.dot(wo, Y), ax, ay)
    sheen = sheen_c * (fh * sheen_p)[..., None]
    # clearcoat (TerraPresets.c:281-284)
    dr = _gtr1(ndoth, math3.lerp(0.1, 0.001, clearcoat_gloss))
    fr = math3.lerp(0.04, 1.0, fh)
    gr = _smith_ggx(ndotl, 0.25) * _smith_ggx(ndotv, 0.25)
    # combine (TerraPresets.c:286-295)
    result_a = base_color * (INV_PI * math3.lerp(fd, ss, subsurface))[..., None]
    result_a = (result_a + sheen) * (1.0 - metalness)[..., None]
    result_b = fs * (gs * ds)[..., None]
    result_c = (0.25 * clearcoat * gr * fr * dr)[..., None] * jnp.ones_like(result_b)
    result = result_a + result_b + result_c
    return jnp.where(behind[..., None], 0.0, result)


def _disney_lobe_probs(surface: Surface):
    """Lobe pick probabilities (diffuse, GTR2 specular, GTR1 clearcoat).

    The reference ships NO Disney sample/pdf (TerraPresets.c:154-296 is
    eval-only and stubbed); this importance sampler is an extension. Any
    positive mixture keeps the estimator unbiased — these weights roughly
    track lobe energy: metals lose their diffuse term entirely
    (TerraPresets.c:288 scales it by 1-metalness), clearcoat is a thin
    0.25-weighted lobe (TerraPresets.c:294)."""
    a = surface.attrs
    metalness = jnp.clip(a[..., 4, 0], 0.0, 1.0)
    clearcoat = jnp.clip(a[..., 3, 0], 0.0, 1.0)
    p_clear = 0.25 * clearcoat / (1.0 + clearcoat)
    p_spec_inner = math3.lerp(0.5, 1.0, metalness)
    p_spec = (1.0 - p_clear) * p_spec_inner
    p_diff = (1.0 - p_clear) * (1.0 - p_spec_inner)
    return p_diff, p_spec, p_clear


def _disney_alphas(surface: Surface):
    """Anisotropic GTR2 alphas + GTR1 clearcoat alpha (same formulas as
    _disney_eval, TerraPresets.c:266-284)."""
    a = surface.attrs
    roughness = jnp.clip(a[..., 4, 1], 0.0, 1.0)
    anisotropic = jnp.clip(a[..., 5, 0], 0.0, 1.0)
    clearcoat_gloss = jnp.clip(a[..., 3, 1], 0.0, 1.0)
    aspect = jnp.sqrt(jnp.maximum(1.0 - anisotropic * 0.9, 1e-4))
    ax = jnp.maximum(1e-3, roughness * roughness / aspect)
    ay = jnp.maximum(1e-3, roughness * roughness * aspect)
    a_clear = math3.lerp(0.1, 0.001, clearcoat_gloss)
    return ax, ay, a_clear


def _disney_sample(surface: Surface, e0, e1, e2, wo):
    """Three-lobe mixture sample: e2 picks the lobe, (e0, e1) drive it.

    GTR2-aniso half vector: h ∝ sqrt(e0/(1-e0))·(ax cosφ X + ay sinφ Z) + N
    (Burley 2012 course notes, eq. for the aniso NDF the eval uses).
    GTR1: cos²θ = (1 - a²^(1-e0)) / (1 - a²)."""
    p_diff, p_spec, _ = _disney_lobe_probs(surface)
    ax, ay, a_clear = _disney_alphas(surface)
    n, tx, bz = surface.normal, surface.tangent, surface.bitangent

    wi_d = _cosine_hemisphere(surface, e0, e1)

    phi = 2.0 * PI * e1
    tanv = jnp.sqrt(e0 / jnp.maximum(1.0 - e0, 1e-7))
    hx = tanv * ax * jnp.cos(phi)
    hz = tanv * ay * jnp.sin(phi)
    h_spec = math3.normalize(
        tx * hx[..., None] + n + bz * hz[..., None]
    )
    wi_s = math3.normalize(math3.reflect(wo, h_spec))

    a2 = a_clear * a_clear
    cos2 = (1.0 - jnp.power(a2, 1.0 - e0)) / jnp.maximum(1.0 - a2, 1e-7)
    cos_t = jnp.sqrt(jnp.clip(cos2, 0.0, 1.0))
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos2))
    local_h = jnp.stack(
        [sin_t * jnp.cos(phi), cos_t, sin_t * jnp.sin(phi)], axis=-1
    )
    h_clear = math3.normalize(math3.to_world(local_h, tx, n, bz))
    wi_c = math3.normalize(math3.reflect(wo, h_clear))

    wi = jnp.where(
        (e2 < p_diff)[..., None], wi_d,
        jnp.where((e2 < p_diff + p_spec)[..., None], wi_s, wi_c),
    )
    return wi


def _disney_pdf(surface: Surface, wi, wo):
    """Mixture pdf for ANY direction (not just the sampled lobe): required
    for the MIS light-strategy weights. pdf_h→pdf_wi Jacobian = 1/(4 h·wo).
    GTR2 has infinite tails so the mixture is > 0 over the hemisphere
    wherever eval is nonzero."""
    p_diff, p_spec, p_clear = _disney_lobe_probs(surface)
    ax, ay, a_clear = _disney_alphas(surface)
    n = surface.normal
    h = math3.normalize(wi + wo)
    noh = jnp.maximum(math3.dot(n, h), 1e-6)
    how = jnp.maximum(math3.dot(h, wo), 1e-6)
    ds = _gtr2_aniso(noh, math3.dot(h, surface.tangent), math3.dot(h, surface.bitangent), ax, ay)
    dr = _gtr1(noh, a_clear)
    pdf_spec = ds * noh / (4.0 * how)
    pdf_clear = dr * noh / (4.0 * how)
    return p_diff * _diffuse_pdf(surface, wi) + p_spec * pdf_spec + p_clear * pdf_clear


# ------------------------------------------------------------------- mirror

def _mirror_sample(surface: Surface, wo):
    return math3.normalize(math3.reflect(wo, surface.normal))


def _mirror_pdf(surface: Surface, wi, wo):
    """Delta lobe: pdf is 1 for the sampled direction. For arbitrary
    directions (NEE/MIS light strategy) the pdf is 0; we return 1 where wi is
    (numerically) the reflection and 0 elsewhere."""
    wr = math3.reflect(wo, surface.normal)
    aligned = math3.dot(wi, wr) > (1.0 - 1e-5)
    return jnp.where(aligned, 1.0, 0.0)


def _mirror_eval(surface: Surface, wi, wo):
    """eval * NoL / pdf must equal the mirror color, so eval = color / NoL
    on the reflection ray, 0 elsewhere."""
    color = surface.attrs[..., ATTR.MIRROR_COLOR, :]
    wr = math3.reflect(wo, surface.normal)
    aligned = math3.dot(wi, wr) > (1.0 - 1e-5)
    nol = jnp.maximum(math3.dot(surface.normal, wi), 1e-6)
    return jnp.where(aligned[..., None], color / nol[..., None], 0.0)


# -------------------------------------------------------------------- glass

def _glass_geometry(surface: Surface, wo):
    """Shared dielectric geometry (rebuild of the reference's disabled
    perfect-glass preset, TerraPresets.c:399-449): side-aware normal, Snell
    cos_t, TIR flag and the unpolarized Schlick Fresnel R.

    entering = ray arrives from the front side (reference flips n1/n2 and
    the normal when dot(normal, incident) > 0, TerraPresets.c:406-414).
    Returns (n_eff, refl, trans, R, tir)."""
    n = surface.normal
    ior = jnp.maximum(surface.ior, 1.0 + 1e-4)
    now = math3.dot(n, wo)
    entering = now > 0.0
    n_eff = jnp.where(entering[..., None], n, -n)
    cos_i = jnp.abs(now)
    eta = jnp.where(entering, 1.0 / ior, ior)  # n1/n2
    refl = math3.normalize(math3.reflect(wo, n_eff))
    cos_t2 = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = cos_t2 < 0.0
    cos_t = jnp.sqrt(jnp.maximum(cos_t2, 0.0))
    # Schlick with t = 1 - (n1<=n2 ? cos_i : cos_t) (TerraPresets.c:430-433)
    tbase = jnp.where(eta <= 1.0, cos_i, cos_t)
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    R = r0 + (1.0 - r0) * _schlick_weight(tbase)
    R = jnp.where(tir, 1.0, jnp.clip(R, 0.0, 1.0))
    # Transmitted direction (TerraPresets.c:441-446): t = eta*i +
    # (eta*cos_i - cos_t)*n with i = -wo and n against the incident ray.
    trans = math3.normalize(
        -wo * eta[..., None] + n_eff * (eta * cos_i - cos_t)[..., None]
    )
    trans = jnp.where(tir[..., None], refl, trans)
    return n_eff, refl, trans, R, tir


def _glass_sample(surface: Surface, e2, wo):
    """Fresnel lobe roulette (TerraPresets.c:436-448): reflect with
    probability R (always under TIR), else refract."""
    _, refl, trans, R, _ = _glass_geometry(surface, wo)
    take_refl = e2 < R
    return jnp.where(take_refl[..., None], refl, trans)


def _glass_match(surface: Surface, wi, wo):
    """(R-weight of the matched lobe, matched?) for an arbitrary direction:
    delta lobes match by alignment like MIRROR."""
    _, refl, trans, R, tir = _glass_geometry(surface, wo)
    aligned_r = math3.dot(wi, refl) > (1.0 - 1e-5)
    aligned_t = (~tir) & (math3.dot(wi, trans) > (1.0 - 1e-5)) & ~aligned_r
    w = jnp.where(aligned_r, R, jnp.where(aligned_t, 1.0 - R, 0.0))
    return w, aligned_r | aligned_t


def _glass_pdf(surface: Surface, wi, wo):
    """pdf of the lobe roulette: R on the reflection ray, 1-R on the
    transmission ray, 0 elsewhere (the reference returns state->fresnel,
    TerraPresets.c:451-453)."""
    w, _ = _glass_match(surface, wi, wo)
    return w


def _glass_eval(surface: Surface, wi, wo):
    """eval * |NoL| / pdf must equal the tint (the reference's shade returns
    albedo * fresnel with weight = fresnel, TerraPresets.c:455-458), so
    eval = tint * lobe_weight / |NoL| on the two delta rays, 0 elsewhere.
    |NoL| (not NoL) because transmission crosses the surface."""
    color = surface.attrs[..., ATTR.GLASS_COLOR, :]
    w, matched = _glass_match(surface, wi, wo)
    anol = jnp.maximum(jnp.abs(math3.dot(surface.normal, wi)), 1e-6)
    return jnp.where(matched[..., None], color * (w / anol)[..., None], 0.0)


# ----------------------------------------------------------------- dispatch

ALL_TYPES = tuple(range(NUM_BSDF_TYPES))


def delta_mask(surface: Surface, present=ALL_TYPES):
    """Per-lane bool mask of delta (MIRROR/GLASS) materials, or None when
    the scene statically has none (``present`` metadata) — the None path
    keeps delta-free programs compiling unchanged."""
    types = [t for t in DELTA_TYPES if t in present]
    if not types:
        return None
    m = surface.bsdf_type == types[0]
    for t in types[1:]:
        m = m | (surface.bsdf_type == t)
    return m


def _select(bsdf_type, results, present):
    """Mask-select per-lane results from {type: value}, restricted to the
    statically-known ``present`` types (scene.materials.types_present): the
    wavefront only pays for lobes the scene actually uses."""
    present = tuple(present)
    out = results[present[0]]
    for ty in present[1:]:
        r = results[ty]
        mask = bsdf_type == ty
        if r.ndim > mask.ndim:
            mask = mask[..., None]
        out = jnp.where(mask, r, out)
    return out


def sample(surface: Surface, e0, e1, e2, wo, present=ALL_TYPES):
    """BSDF importance sample. Returns (wi, aux); aux carries the phong lobe
    pick (cf. TerraPresets.c:87-95) and is threaded into :func:`pdf`."""
    results = {}
    if BSDFType.DIFFUSE in present:
        results[BSDFType.DIFFUSE] = _cosine_hemisphere(surface, e0, e1)
    if BSDFType.PHONG in present:
        wi_p, lobe = _phong_sample(surface, e0, e1, e2, wo)
        results[BSDFType.PHONG] = wi_p
    if BSDFType.GGX in present:
        results[BSDFType.GGX] = _ggx_sample(surface, e0, e1, e2, wo)[0]
    if BSDFType.MIRROR in present:
        results[BSDFType.MIRROR] = _mirror_sample(surface, wo)
    if BSDFType.DISNEY in present:
        results[BSDFType.DISNEY] = _disney_sample(surface, e0, e1, e2, wo)
    if BSDFType.GLASS in present:
        results[BSDFType.GLASS] = _glass_sample(surface, e2, wo)
    wi = _select(surface.bsdf_type, results, present)
    if BSDFType.PHONG in present:
        aux = jnp.where(surface.bsdf_type == BSDFType.PHONG, lobe, 0.0)
    else:
        aux = jnp.zeros(wi.shape[:-1], wi.dtype)
    return wi, aux


def pdf(surface: Surface, wi, wo, aux, present=ALL_TYPES):
    """BSDF pdf for direction wi; ``aux`` is the lobe pick from the current
    bounce's :func:`sample` (reference semantics, TerraPresets.c:108-123)."""
    results = {}
    if BSDFType.DIFFUSE in present:
        results[BSDFType.DIFFUSE] = _diffuse_pdf(surface, wi)
    if BSDFType.PHONG in present:
        results[BSDFType.PHONG] = _phong_pdf(surface, wi, wo, aux)
    if BSDFType.GGX in present:
        results[BSDFType.GGX] = _ggx_pdf(surface, wi, wo)
    if BSDFType.MIRROR in present:
        results[BSDFType.MIRROR] = _mirror_pdf(surface, wi, wo)
    if BSDFType.DISNEY in present:
        results[BSDFType.DISNEY] = _disney_pdf(surface, wi, wo)
    if BSDFType.GLASS in present:
        results[BSDFType.GLASS] = _glass_pdf(surface, wi, wo)
    return _select(surface.bsdf_type, results, present)


def eval_f(surface: Surface, wi, wo, present=ALL_TYPES):
    """BSDF value f(wi, wo) (N, 3)."""
    results = {}
    if BSDFType.DIFFUSE in present:
        results[BSDFType.DIFFUSE] = _diffuse_eval(surface, wi, wo)
    if BSDFType.PHONG in present:
        results[BSDFType.PHONG] = _phong_eval(surface, wi, wo)
    if BSDFType.GGX in present:
        results[BSDFType.GGX] = _ggx_eval(surface, wi, wo)
    if BSDFType.MIRROR in present:
        results[BSDFType.MIRROR] = _mirror_eval(surface, wi, wo)
    if BSDFType.DISNEY in present:
        results[BSDFType.DISNEY] = _disney_eval(surface, wi, wo)
    if BSDFType.GLASS in present:
        results[BSDFType.GLASS] = _glass_eval(surface, wi, wo)
    return _select(surface.bsdf_type, results, present)


def continuation_factors(surface: Surface, wi, present=ALL_TYPES):
    """Per-lane (cos_factor, offset_sign) for the path-continuation update
    (Terra.c:1075-1093). Non-transmissive lanes keep the reference's signed
    N.wi and +normal origin offset; GLASS lanes use |N.wi| (the ray legally
    crosses the surface) and offset the new origin to the transmitted side.
    offset_sign is None when the scene has no transmissive material, so
    existing programs compile unchanged."""
    nol = math3.dot(surface.normal, wi)
    if BSDFType.GLASS not in present:
        return nol, None
    is_glass = surface.bsdf_type == BSDFType.GLASS
    cos_f = jnp.where(is_glass, jnp.abs(nol), nol)
    sign = jnp.where(is_glass & (nol < 0.0), np.float32(-1.0), np.float32(1.0))
    return cos_f, sign
