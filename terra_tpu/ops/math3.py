"""Vectorized 3D vector math over stacked ``(..., 3)`` arrays.

Re-design of the reference float3 math library
(``/root/reference/include/TerraMath.h:17-98`` and ``TerraMath.inl``): instead
of a scalar struct-of-one-vector API, every helper here operates on batched
arrays so the whole wavefront of rays is processed in one shot.

Coordinate conventions follow the reference: left-handed, Y-up
(``TerraMath.h:10-12``).
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "dot",
    "cross",
    "length",
    "sqlen",
    "normalize",
    "lerp",
    "luminance",
    "reflect",
    "max3",
    "build_basis",
    "to_local",
    "to_world",
]

EPS = 1e-4  # terra_Epsilon (/root/reference/include/TerraMath.h:15)


def dot(a, b):
    """Batched dot product over the trailing axis (terra_dotf3)."""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    """Batched cross product (terra_crossf3). Manual expansion (faster than
    jnp.cross for the common (..., 3) case because it avoids moveaxis)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def sqlen(a):
    """Squared length (terra_sqlenf3)."""
    return jnp.sum(a * a, axis=-1)


def length(a):
    """Euclidean length (terra_lenf3)."""
    return jnp.sqrt(sqlen(a))


def normalize(a, eps: float = 1e-20):
    """Safe normalize (terra_normf3). ``eps`` guards the degenerate zero
    vector so gradients stay finite."""
    return a * jnp.reciprocal(jnp.sqrt(jnp.maximum(sqlen(a), eps)))[..., None]


def lerp(a, b, t):
    """terra_lerpf3; ``t`` may be scalar or broadcastable."""
    return a + (b - a) * t


def luminance(c):
    """terra_luminance (Rec.601 weights, Terra.c:1030-1033)."""
    return 0.212655 * c[..., 0] + 0.715158 * c[..., 1] + 0.072187 * c[..., 2]


def reflect(wo, n):
    """Mirror ``wo`` about ``n``: ``2 (wo . n) n - wo`` (the reference builds
    this inline in the Phong lobe, TerraPresets.c:96-97)."""
    return 2.0 * dot(wo, n)[..., None] * n - wo


def max3(c):
    """Max component (used by Russian roulette, Terra.c:1082)."""
    return jnp.max(c, axis=-1)


def build_basis(n):
    """Branchless orthonormal tangent frame from unit normals.

    Returns ``(tangent, bitangent)`` with ``cross(n, tangent) == bitangent``
    so that ``(tangent, n, bitangent)`` matches the reference's column layout
    (terra_f4x4_basis, TerraMath.inl:250-271): local +Y is the normal.

    NOTE: the reference *multiplies* the Hughes-Moller tangent by
    ``sqrt(x^2+z^2)`` (TerraMath.inl:259-264) instead of normalizing, which
    yields a non-orthonormal frame and slightly distorts hemisphere samples.
    We build a correct orthonormal frame instead (documented deviation).
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    cond = jnp.abs(nx) > jnp.abs(ny)
    # Hughes-Moller: pick the axis-aligned perpendicular with the larger
    # denominator, then normalize.
    inv_a = jnp.reciprocal(jnp.sqrt(jnp.where(cond, nx * nx + nz * nz, ny * ny + nz * nz)))
    tx = jnp.where(cond, nz * inv_a, jnp.zeros_like(nz))
    ty = jnp.where(cond, jnp.zeros_like(nz), -nz * inv_a)
    tz = jnp.where(cond, -nx * inv_a, ny * inv_a)
    tangent = jnp.stack([tx, ty, tz], axis=-1)
    bitangent = cross(n, tangent)
    return tangent, bitangent


def to_world(local, tangent, normal, bitangent):
    """Transform a local-frame direction (x=tangent, y=normal, z=bitangent)
    to world space; matches terra_transformf3 with the basis from
    terra_f4x4_basis (TerraMath.inl:230-234, 250-271)."""
    return (
        local[..., 0:1] * tangent
        + local[..., 1:2] * normal
        + local[..., 2:3] * bitangent
    )


def to_local(world, tangent, normal, bitangent):
    """Inverse of :func:`to_world` for an orthonormal frame."""
    return jnp.stack(
        [dot(world, tangent), dot(world, normal), dot(world, bitangent)], axis=-1
    )
