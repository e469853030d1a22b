"""Environment lighting: radiance lookup + importance sampling.

The reference builds a 2D marginal x conditional distribution *for* env-map
importance sampling (terra_distribution_2d_init, /root/reference/src/
Terra.c:811-846) but never wires it into any integrator (SURVEY.md §2 #9
"currently unused"). Here it actually works: ``build_distribution``
resamples the environment onto a fixed lat-long proposal grid,
``sample`` draws directions from it, and ``pdf`` evaluates the
solid-angle density of any direction — enabling next-event estimation of
the environment (``RenderOptions.env_nee``) with MIS against the BSDF
strategy.

Design notes:
  * The proposal grid is FIXED-size (GRID_H x GRID_W), built inside the
    traced program by evaluating :func:`radiance` at the grid directions —
    static shapes regardless of the env texture's resolution (the atlas
    pads textures, so building the CDF over raw texels would mix in
    padding); XLA hoists the build out of the bounce loop.
  * A small floor is mixed into the proposal weights so the pdf is > 0
    everywhere: a coarse grid cell that averages to zero could otherwise
    hide a bright sub-cell feature and bias the estimator. The floor keeps
    the estimator unbiased at any grid resolution (only variance changes).
  * Mapping matches ``textures.sample_latlong`` exactly
    (theta = acos(y), phi = atan2(z, x) + pi — Terra.c:468-477), so the
    sampled direction's radiance lookup and the pdf are consistent.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from . import textures as textures_mod
from .ops import distributions, math3
from .scene import Scene

__all__ = ["radiance", "build_distribution", "sample", "pdf", "GRID_H", "GRID_W"]

GRID_H = 64
GRID_W = 128
PI = np.float32(np.pi)
TWO_PI2 = np.float32(2.0 * np.pi * np.pi)
FLOOR_FRAC = np.float32(1e-2)  # proposal floor as a fraction of mean weight


def radiance(scene: Scene, d):
    """Environment radiance along direction d (Terra.c:1054): the lat-long
    texture when ``scene.env_tex`` >= 0, else the constant env color."""
    const = jnp.broadcast_to(scene.env_value, d.shape)
    if scene.textures.num_textures == 0:
        return const
    safe_id = jnp.maximum(scene.env_tex, 0)
    tex = textures_mod.sample_latlong(
        scene.textures, jnp.broadcast_to(safe_id, d.shape[:-1]), d
    )
    return jnp.where(scene.env_tex >= 0, tex, const)


def _grid_dirs():
    """Directions at the proposal-grid cell centers (lat-long layout)."""
    v = (jnp.arange(GRID_H, dtype=jnp.float32) + 0.5) / GRID_H
    u = (jnp.arange(GRID_W, dtype=jnp.float32) + 0.5) / GRID_W
    theta = v * PI  # rows
    phi = u * (2.0 * PI) - PI  # cols
    sin_t = jnp.sin(theta)[:, None]
    cos_t = jnp.cos(theta)[:, None]
    dx = sin_t * jnp.cos(phi)[None, :]
    dz = sin_t * jnp.sin(phi)[None, :]
    dy = jnp.broadcast_to(cos_t, (GRID_H, GRID_W))
    return jnp.stack([dx, dy, dz], axis=-1)  # (GRID_H, GRID_W, 3)


def build_distribution(scene: Scene) -> distributions.Distribution2D:
    """Proposal over the lat-long grid: luminance x sin(theta) + floor.

    The sin(theta) factor is the area element of the lat-long
    parameterization — without it the poles are oversampled."""
    dirs = _grid_dirs()
    rad = radiance(scene, dirs.reshape(-1, 3)).reshape(GRID_H, GRID_W, 3)
    lum = 0.2126 * rad[..., 0] + 0.7152 * rad[..., 1] + 0.0722 * rad[..., 2]
    theta = ((jnp.arange(GRID_H, dtype=jnp.float32) + 0.5) / GRID_H) * PI
    sin_t = jnp.sin(theta)[:, None]
    f = lum * sin_t
    floor = jnp.maximum(jnp.mean(f), np.float32(1e-12)) * FLOOR_FRAC
    return distributions.build_2d(f + floor * sin_t)


def sample(dist: distributions.Distribution2D, e1, e2):
    """Draw a direction from the proposal. Returns (wi, pdf_solid_angle).

    Jacobian: theta = v*pi, phi = u*2pi => d(omega) = 2 pi^2 sin(theta) du dv,
    and the discrete bucket probability converts to a (u, v) density by the
    grid size."""
    (u, v), p_bucket = distributions.sample_2d(dist, e1, e2)
    theta = v * PI
    phi = u * (2.0 * PI) - PI
    sin_t = jnp.sin(theta)
    wi = jnp.stack(
        [sin_t * jnp.cos(phi), jnp.cos(theta), sin_t * jnp.sin(phi)], axis=-1
    )
    density_uv = p_bucket * np.float32(GRID_W * GRID_H)
    pdf_w = density_uv / jnp.maximum(TWO_PI2 * sin_t, np.float32(1e-6))
    return wi, pdf_w


def pdf(dist: distributions.Distribution2D, wi):
    """Solid-angle pdf of an arbitrary direction under the proposal
    (needed by the MIS BSDF strategy)."""
    d = math3.normalize(wi)
    theta = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0))
    phi = jnp.arctan2(d[..., 2], d[..., 0]) + PI
    u = phi / (2.0 * PI)
    v = theta / PI
    col = jnp.clip((u * GRID_W).astype(jnp.int32), 0, GRID_W - 1)
    row = jnp.clip((v * GRID_H).astype(jnp.int32), 0, GRID_H - 1)
    total = jnp.maximum(dist.marginal.integral, np.float32(1e-20))
    # two-stage one-hot fetch (row matmul + column multiply-reduce) in
    # place of a flat (N,) gather into the 8k-entry grid, like
    # distributions.sample_2d (its A/B against the gather is not measured)
    f_at = distributions._oh_at(distributions._oh_pick(dist.conditionals.f, row), col)
    density_uv = f_at * np.float32(GRID_W * GRID_H) / total
    sin_t = jnp.maximum(jnp.sin(theta), np.float32(1e-6))
    return density_uv / (TWO_PI2 * sin_t)
