"""Discrete 1D/2D distributions: CDF build + inverse-CDF sampling.

Replaces TerraDistribution1D/2D (/root/reference/src/Terra.c:760-846,
TerraPrivate.h:86-102): the reference builds normalized CDFs with a linear
scan sample (Terra.c:781-809); here the build is a ``cumsum`` and sampling
is a vectorized ``searchsorted`` over the whole wavefront — O(log n) per
lane with no divergence.

Used for area-weighted light picking (lights.py) and lat-long environment
importance sampling (2D marginal x conditional product, as the reference
intended for env maps, Terra.c:811-846).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["Distribution1D", "Distribution2D", "build_1d", "sample_1d", "build_2d", "sample_2d"]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["f", "cdf", "integral"],
    meta_fields=[],
)
@dataclass
class Distribution1D:
    """f: (n,) weights; cdf: (n,) normalized inclusive cumsum; integral: ()"""

    f: jax.Array
    cdf: jax.Array
    integral: jax.Array


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["conditionals", "marginal"],
    meta_fields=[],
)
@dataclass
class Distribution2D:
    """conditionals: stacked per-row 1D distributions ((ny,nx) leaves);
    marginal over rows (terra_distribution_2d_init, Terra.c:811-833)."""

    conditionals: Distribution1D
    marginal: Distribution1D


def build_1d(f) -> Distribution1D:
    """terra_distribution_1d_init (Terra.c:760-779); works batched over
    leading axes."""
    f = jnp.asarray(f, jnp.float32)
    c = jnp.cumsum(f, axis=-1)
    integral = c[..., -1]
    safe = jnp.maximum(integral, 1e-20)
    return Distribution1D(f=f, cdf=c / safe[..., None], integral=integral)


# Max table rows for the one-hot matmul fetch (as surface.fetch_rows):
# one dense dot instead of a per-lane gather from a small table. Exact: one
# nonzero term per dot row, so sums add zeros and copy the value
# bit-for-bit. Whether it beats a plain gather on the GPU is not measured.
_ONEHOT_MAX = 512


def _oh_pick(table, idx):
    """table[idx] for (N,) idx via one-hot matmul when the table is small.
    table: (n,) or (n, k); returns (N,) or (N, k)."""
    n = table.shape[0]
    if n > _ONEHOT_MAX:
        return table[idx]
    oh = jax.nn.one_hot(idx, n, dtype=jnp.float32)
    t = table if table.ndim == 2 else table[:, None]
    # precision=HIGHEST: a reduced-precision matmul (bf16 passes, TF32)
    # would quantize the fetched values (see surface.fetch_rows)
    out = jnp.dot(oh, t, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    return out if table.ndim == 2 else out[..., 0]


def _oh_at(rows, idx):
    """rows[lane, idx[lane]] for (N, n) rows via one-hot multiply-reduce
    (instead of a minor-dim take_along_axis per-lane gather)."""
    n = rows.shape[-1]
    if n > _ONEHOT_MAX:
        return jnp.take_along_axis(rows, idx[..., None], -1)[..., 0]
    oh = jax.nn.one_hot(idx, n, dtype=rows.dtype)
    return jnp.sum(rows * oh, axis=-1)


def sample_1d(dist: Distribution1D, e):
    """Inverse-CDF with in-bucket interpolation (terra_distribution_1d_sample,
    Terra.c:781-809). Returns (x in [0,1), pdf, idx)."""
    n = dist.cdf.shape[-1]
    idx = jnp.clip(jnp.searchsorted(dist.cdf, e, side="right"), 0, n - 1)
    picked = _oh_pick(
        jnp.stack([dist.cdf, jnp.concatenate([jnp.zeros((1,), dist.cdf.dtype),
                                              dist.cdf[:-1]]),
                   dist.f], axis=1),
        idx,
    )
    curr, prev, f_at = picked[..., 0], picked[..., 1], picked[..., 2]
    denom = jnp.maximum(curr - prev, 1e-12)
    frac = (e - prev) / denom
    x = (idx.astype(jnp.float32) + frac) / n
    pdf = f_at / jnp.maximum(dist.integral, 1e-20)
    return x, pdf, idx


def build_2d(f) -> Distribution2D:
    """f: (ny, nx) weights -> marginal x conditional product distribution."""
    conditionals = build_1d(f)  # batched over rows
    marginal = build_1d(conditionals.integral)
    return Distribution2D(conditionals=conditionals, marginal=marginal)


def sample_2d(dist: Distribution2D, e1, e2):
    """terra_distribution_2d_sample (Terra.c:835-846). Returns
    ((u, v), pdf) with u along x, v along y, both in [0,1).

    Row/bucket fetches go through one-hot matmuls (see _oh_pick),
    bit-identical to the per-lane row-gather + take_along_axis form."""
    v, pdf_y, row = sample_1d(dist.marginal, e1)
    cdf = _oh_pick(dist.conditionals.cdf, row)       # (N, nx)
    fr = _oh_pick(dist.conditionals.f, row)
    integ = _oh_pick(dist.conditionals.integral, row)
    n = cdf.shape[-1]
    idx = jnp.clip(
        jnp.sum((cdf < e2[..., None]).astype(jnp.int32), axis=-1), 0, n - 1
    )
    prev = jnp.where(idx > 0, _oh_at(cdf, jnp.maximum(idx - 1, 0)), 0.0)
    curr = _oh_at(cdf, idx)
    frac = (e2 - prev) / jnp.maximum(curr - prev, 1e-12)
    u = (idx.astype(jnp.float32) + frac) / n
    pdf_x = _oh_at(fr, idx) / jnp.maximum(integ, 1e-20)
    return (u, v), pdf_y * pdf_x
