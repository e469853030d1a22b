"""Texture atlas sampling: batched gathers + bilinear filtering.

Replaces the reference texture system (/root/reference/src/Terra.c:350-507):
LDR/HDR textures with point/bilinear filters and wrap/mirror/clamp address
modes, plus lat-long environment lookup (Terra.c:468-477). All textures live
in one padded (NT, H, W, 3) device array so a per-lane texture id can be
gathered in a single XLA gather.

Deviations from the reference (documented):
  * UVs are interpreted in the standard [0,1] convention and scaled by the
    texture size; the reference indexes texels with the raw uv value
    (Terra.c:413-414), which only works for pixel-space uvs.
  * sRGB decode (pow 2.2, terra_texture_finalize, Terra.c:484-507) happens
    once at load time in the importer, not lazily.

Bilinear sampling is differentiable w.r.t. texel values (and piecewise
w.r.t. uv), so texture contents can be optimized by inverse rendering.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .ops import math3
from .scene import TextureAtlas

__all__ = ["sample", "sample_latlong", "FILTER_POINT", "FILTER_BILINEAR", "ADDR_WRAP", "ADDR_MIRROR", "ADDR_CLAMP"]

FILTER_POINT = 0
FILTER_BILINEAR = 1
ADDR_WRAP = 0
ADDR_MIRROR = 1
ADDR_CLAMP = 2


def _address(coord, size, mode):
    """Apply per-lane address mode in integer texel space
    (terra_texture_read, Terra.c:368-394). coord/size/mode: int32 arrays."""
    size = jnp.maximum(size, 1)
    wrap = jnp.remainder(coord, size)
    # mirror with period 2*size: fold the second half back
    m = jnp.remainder(coord, 2 * size)
    mirror = jnp.where(m >= size, 2 * size - 1 - m, m)
    clamp = jnp.clip(coord, 0, size - 1)
    out = jnp.where(mode == ADDR_WRAP, wrap, jnp.where(mode == ADDR_MIRROR, mirror, clamp))
    return out


def _read(atlas: TextureAtlas, tex_id, x, y):
    """Gather texels: tex_id/x/y int32 lane arrays -> (N, 3) f32.

    The fetch flattens (tex, y, x) into ONE index into the row-major
    atlas: a single 1D row gather instead of a 3-index gather (texel
    values identical)."""
    h = atlas.size[tex_id, 0]
    w = atlas.size[tex_id, 1]
    mode = atlas.address[tex_id]
    x = _address(x, w, mode)
    y = _address(y, h, mode)
    nt, H, W, _ = atlas.data.shape
    flat = (tex_id * jnp.int32(H) + y) * jnp.int32(W) + x
    return atlas.data.reshape(nt * H * W, 3)[flat]


def sample(atlas: TextureAtlas, tex_id, uv):
    """Sample per-lane textures at uv in [0,1] (terra_texture_sample,
    Terra.c:410-466). tex_id: (N,) i32 (valid ids only), uv: (N, 2) f32."""
    h = atlas.size[tex_id, 0].astype(jnp.float32)
    w = atlas.size[tex_id, 1].astype(jnp.float32)
    fx = uv[..., 0] * w
    fy = uv[..., 1] * h
    ix = jnp.floor(fx).astype(jnp.int32)
    iy = jnp.floor(fy).astype(jnp.int32)
    # Point
    point = _read(atlas, tex_id, ix, iy)
    # Bilinear (Terra.c:422-449)
    n1 = point
    n2 = _read(atlas, tex_id, ix + 1, iy)
    n3 = _read(atlas, tex_id, ix, iy + 1)
    n4 = _read(atlas, tex_id, ix + 1, iy + 1)
    w_u = (fx - ix.astype(jnp.float32))[..., None]
    w_v = (fy - iy.astype(jnp.float32))[..., None]
    bilinear = (n1 * (1 - w_u) + n2 * w_u) * (1 - w_v) + (n3 * (1 - w_u) + n4 * w_u) * w_v
    filt = atlas.filter[tex_id][..., None]
    return jnp.where(filt == FILTER_BILINEAR, bilinear, point)


def sample_latlong(atlas: TextureAtlas, tex_id, direction):
    """Lat-long environment lookup (terra_texture_sample_latlong,
    Terra.c:468-477): theta = acos(y), phi = atan2(z, x) + pi."""
    d = math3.normalize(direction)
    theta = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0))
    phi = jnp.arctan2(d[..., 2], d[..., 0]) + np.float32(np.pi)
    u = phi / np.float32(2 * np.pi)
    v = theta / np.float32(np.pi)
    return sample(atlas, tex_id, jnp.stack([u, v], axis=-1))
