"""Counter-based RNG: Threefry-2x32 keyed by (pixel, sample, bounce, stream).

The reference mixes a seedable PCG32 pixel-jitter sampler (Terra.c:678-701)
with **unseeded libc rand()** for every BSDF / light / roulette decision
(Terra.c:115, 1068-1070, 1084), making renders non-reproducible. This
package replaces all of it with a stateless counter-based generator so that

  * every random decision is a pure function of (seed, pixel, sample,
    bounce, stream) — the exact same numbers are replayed in forward and
    backward sweeps (replay-exact reverse mode), and
  * the stream is invariant to sharding: a pixel draws identical numbers no
    matter which chip it lands on.

Threefry-2x32 (Salmon et al., "Parallel Random Numbers: As Easy as 1, 2, 3",
SC'11) with the full 20 rounds; pure uint32 adds/xors/rolls — VPU friendly.
A NumPy twin lives in ``terra_tpu/testing/mirror.py`` as the CPU oracle.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = [
    "threefry2x32",
    "uniform_from_bits",
    "PathStreams",
    "path_uniform",
    "path_uniform2",
    "key_from_seed",
    "radical_inverse",
]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl32(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32-20 block cipher. All args uint32 arrays (broadcastable).

    Returns two uint32 arrays of the broadcast shape. Matches the algorithm
    used by jax.random's threefry; implemented locally so the CPU mirror can
    reproduce it bit-exactly in NumPy.
    """
    k0 = jnp.asarray(k0, jnp.uint32)
    k1 = jnp.asarray(k1, jnp.uint32)
    x0 = jnp.asarray(x0, jnp.uint32)
    x1 = jnp.asarray(x1, jnp.uint32)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)

    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for group in range(5):
        rots = _ROTATIONS[group % 2]
        for r in rots:
            x0 = x0 + x1
            x1 = _rotl32(x1, r)
            x1 = x1 ^ x0
        x0 = x0 + ks[(group + 1) % 3]
        x1 = x1 + ks[(group + 2) % 3] + np.uint32(group + 1)
    return x0, x1


def uniform_from_bits(bits):
    """uint32 -> float32 uniform in [0, 1) using the top 24 bits."""
    return (bits >> np.uint32(8)).astype(jnp.float32) * np.float32(1.0 / (1 << 24))


def key_from_seed(seed: int):
    """Derive the two threefry key words from a python/int32 seed
    (splitmix-style finalizer so nearby seeds give unrelated streams)."""
    mask = (1 << 64) - 1
    z = (int(seed) + 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    z = z ^ (z >> 31)
    return np.uint32(z & 0xFFFFFFFF), np.uint32(z >> 32)


class PathStreams:
    """Stream ids for every random decision along a path (one per rand() call
    site in the reference; citations inline)."""

    JITTER_X = 0        # pixel jitter r1             (Terra.c:555)
    JITTER_Y = 1        # pixel jitter r2             (Terra.c:556)
    BSDF_E0 = 2         # bsdf.sample e0              (Terra.c:1068)
    BSDF_E1 = 3         # bsdf.sample e1              (Terra.c:1069)
    BSDF_E2 = 4         # bsdf.sample e2              (Terra.c:1070)
    ROULETTE = 5        # russian roulette e3         (Terra.c:1084)
    LIGHT_PICK = 6      # light pick e                (Terra.c:1370)
    # id 7 is intentionally unassigned: the reference draws a second uniform
    # to pick a triangle within the light object (Terra.c:1377); the
    # flattened light table picks the triangle directly with LIGHT_PICK
    # (uniform or area-CDF), so one draw covers both. The gap keeps every
    # other stream's counter stable (golden images depend on the ids).
    LIGHT_U = 8         # light surface sample e1     (Terra.c:1386)
    LIGHT_V = 9         # light surface sample e2     (Terra.c:1387)
    MIS_E0 = 10         # mis bsdf-strategy sample e1 (Terra.c:1447)
    MIS_E1 = 11         # mis bsdf-strategy sample e2 (Terra.c:1448)
    MIS_E2 = 12         # mis bsdf-strategy sample e3 (Terra.c:1449)
    ENV_U = 13          # env-NEE sample u (extension: the reference
    ENV_V = 14          #   built the 2D env dist but never drew from it)


def _pack_counter(sample_idx, bounce, stream):
    """Pack (sample, bounce, stream) into the second counter word.

    Layout: sample in the top 20 bits, bounce in 6, stream in 6. Supports
    2^20 samples/pixel, 64 bounces, 64 streams.
    """
    sample_idx = jnp.asarray(sample_idx, jnp.uint32)
    return (
        (sample_idx << np.uint32(12))
        | (jnp.asarray(bounce, jnp.uint32) << np.uint32(6))
        | jnp.asarray(stream, jnp.uint32)
    )


def path_uniform(key, pixel_idx, sample_idx, bounce, stream):
    """One float32 uniform in [0,1) per lane.

    Stream-pair convention: streams 2k and 2k+1 are the two output words of
    ONE threefry evaluation at counter stream 2k — adjacent streams cost a
    single cipher (the bundle exploits this). The NumPy mirror implements
    the identical mapping.

    ``key``: (k0, k1) uint32 pair from :func:`key_from_seed`.
    ``pixel_idx``/``sample_idx``: integer arrays (lane-shaped).
    ``bounce``/``stream``: scalars (traced or static).
    """
    base = (int(stream) // 2) * 2 if not hasattr(stream, "dtype") else (stream // 2) * 2
    ctr1 = _pack_counter(sample_idx, bounce, base)
    b0, b1 = threefry2x32(key[0], key[1], jnp.asarray(pixel_idx, jnp.uint32), ctr1)
    odd = (stream % 2) if hasattr(stream, "dtype") else int(stream) % 2
    if hasattr(odd, "dtype"):
        return uniform_from_bits(jnp.where(odd == 1, b1, b0))
    return uniform_from_bits(b1 if odd else b0)


def path_uniform2(key, pixel_idx, sample_idx, bounce, stream):
    """Two float32 uniforms per lane from one threefry call: streams
    (stream, stream+1) with ``stream`` even (the pair convention)."""
    ctr1 = _pack_counter(sample_idx, bounce, stream)
    b0, b1 = threefry2x32(key[0], key[1], jnp.asarray(pixel_idx, jnp.uint32), ctr1)
    return uniform_from_bits(b0), uniform_from_bits(b1)


def path_uniform_bundle(key, pixel_idx, sample_idx, bounce, streams):
    """All of a bounce's uniforms in ONE threefry launch.

    ``streams``: static tuple of stream ids. Returns {stream: (N,) f32}.
    Streams are grouped into even-base pairs (see :func:`path_uniform`):
    one cipher evaluation yields two streams from its two output words, so
    a bounce needing S streams costs ceil(S/2) cipher lanes in a single
    kernel launch.
    """
    pixel_idx = jnp.asarray(pixel_idx, jnp.uint32)
    sample_idx = jnp.asarray(sample_idx, jnp.uint32)
    bases = sorted({(int(s) // 2) * 2 for s in streams})
    ctrs = jnp.stack(
        [_pack_counter(sample_idx, bounce, b) for b in bases], axis=0
    )  # (P, N)
    x0 = jnp.broadcast_to(pixel_idx[None, :], ctrs.shape)
    b0, b1 = threefry2x32(key[0], key[1], x0, ctrs)
    u0 = uniform_from_bits(b0)
    u1 = uniform_from_bits(b1)
    row = {b: i for i, b in enumerate(bases)}
    return {
        s: (u1 if int(s) % 2 else u0)[row[(int(s) // 2) * 2]] for s in streams
    }


def radical_inverse(base: int, index, iters: int = 32):
    """Vectorized van der Corput radical inverse (terra_radical_inverse,
    Terra.c:734-748) for the Halton pixel sampler. ``index`` int32 array."""
    a = jnp.asarray(index, jnp.uint32)
    inv_base = np.float32(1.0 / base)
    seq = jnp.zeros_like(a)
    denom = jnp.ones_like(a, dtype=jnp.float32)
    base_u = np.uint32(base)
    for _ in range(iters):
        live = a > 0
        nxt = a // base_u
        digit = a - nxt * base_u
        seq = jnp.where(live, seq * base_u + digit, seq)
        denom = jnp.where(live, denom * inv_base, denom)
        a = nxt
    val = seq.astype(jnp.float32) * denom
    return jnp.minimum(val, np.float32(1.0 - 1e-4))
