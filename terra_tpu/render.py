"""Wavefront path-tracing driver: the jit-compiled render step.

This is the wavefront re-architecture of the reference's megakernel
(terra_render + terra_trace, /root/reference/src/Terra.c:512-635, 1039-1097):

  * the per-pixel/per-sample double loop becomes one flat SoA wavefront of
    ``H*W*spp_chunk`` lanes;
  * the data-dependent bounce loop becomes a fixed-length ``lax.scan`` over
    bounces with per-lane active masks (terminated lanes are masked, not
    compacted — regular masked array work instead of divergent branches);
  * the tile/thread-pool scheduler (satellite Renderer.cpp + Cloto.h) is
    replaced by XLA: one jit program per sample chunk, sharded over devices
    by the ``parallel`` module;
  * libc rand() becomes counter-based threefry keyed by
    (pixel, sample, bounce, stream) — replay-exact in reverse mode.

Sample chunking (``opts.samples_per_launch``) bounds the device-memory
footprint of the wavefront state, mirroring how the reference's ``loop``
command adds spp progressively (Renderer.cpp:134-151).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import bsdf, camera as camera_mod, intersect
from .film import Film
from .integrators import make_integrator
from .ops import math3, rng as rng_mod
from .ops.rng import PathStreams as S
from .scene import Accelerator, LightPick, RenderOptions, SamplingMethod, Scene, Camera
from .surface import surface_init
from . import textures as textures_mod

__all__ = ["render", "render_chunk", "render_chunks", "trace", "make_raycast_fn"]

EPS = np.float32(1e-4)

_mask_dead_rays = intersect.mask_dead_rays


def bvh_traversal(platform: str, scene: Scene):
    """The BVH traversal for a JAX platform: the CUDA kernel on ``"gpu"``
    (its tables packed once here), the XLA skip-link walk on ``"cpu"``.
    Any other platform has none and raises (``Accelerator.BRUTE`` needs no
    traversal).

    Both take ``(scene, o, d, algo=, t_max=, any_hit=, sort_hint=)``.
    ``sort_hint`` is the previous hit's triangle id per ray: the walk sorts
    rays leaving the same BVH leaf together; the kernel takes rays in the
    order given and ignores it."""
    if platform == "gpu":
        from .accel import gpu_traverse

        packed = gpu_traverse.pack(scene.bvh, *scene.geometry.corners())

        def kernel(scene, o, d, sort_hint=None, **kw):
            return gpu_traverse.raycast(scene, o, d, packed=packed, **kw)

        return kernel
    if platform == "cpu":
        from .accel import traverse

        return partial(traverse.raycast,
                       leaf_of_tri=traverse.leaf_of_tri_table(scene.bvh))
    raise ValueError(f"no BVH traversal for platform {platform!r} "
                     "(supported: gpu, cpu); use Accelerator.BRUTE")


def make_raycast_fn(scene: Scene, opts: RenderOptions):
    """Closest-hit raycast closure (terra_scene_raycast, Terra.c:1623-1657):
    offsets the origin by dir*1e-3 and dispatches on the accelerator.

    The closure takes an optional per-ray ``t_max``: the ranged occlusion
    query used by NEE shadow rays. On the BVH paths t_max seeds the
    traversal's best-t, pruning everything beyond the light sample;
    ``hit.hit`` then means "occluded within t_max"."""
    from .scene import Intersector

    algo = "watertight" if opts.intersector == Intersector.WATERTIGHT else "mt"
    if opts.accelerator == Accelerator.BVH and scene.bvh is not None:
        traversal = bvh_traversal(jax.default_backend(), scene)

        def raycast(o, d, t_max=None, any_hit=False, sort_hint=None):
            o = o + d * intersect.RAY_OFFSET_DIR
            return traversal(scene, o, d, algo=algo, t_max=t_max,
                             any_hit=any_hit, sort_hint=sort_hint)

        return raycast

    tri_a, tri_b, tri_c = scene.geometry.corners()

    def raycast(o, d, t_max=None, any_hit=False, sort_hint=None):
        o = o + d * intersect.RAY_OFFSET_DIR
        h = intersect.raycast_brute(o, d, tri_a, tri_b, tri_c, algo=algo)
        if t_max is None:
            return h
        occ = h.t < t_max
        return intersect.RayHit(t=h.t, tri=jnp.where(occ, h.tri, 0), hit=occ)

    return raycast


def _env_radiance(scene: Scene, d):
    """Environment attribute eval on miss (Terra.c:1054)."""
    from . import envmap

    return envmap.radiance(scene, d)


def _make_env_dist(scene: Scene, opts: RenderOptions):
    """Env-NEE proposal distribution, or None when the feature is off
    (built once per trace; XLA hoists it out of the bounce loop)."""
    if not opts.env_nee:
        return None
    from . import envmap

    return envmap.build_distribution(scene)


def _pixel_jitter(opts: RenderOptions, key, pixel_idx, sample_idx):
    """Pixel-jitter uniforms per sampling method (Terra.h:143-147).

    The reference constructs stratified/Halton samplers but feeds the camera
    jitter from the PCG sampler regardless (Terra.c:553-556); here the
    selected method actually drives the jitter (documented deviation).
    """
    method = opts.sampling_method
    if method == SamplingMethod.STRATIFIED:
        strata = max(int(opts.strata), 1)
        stratum = (sample_idx % (strata * strata)).astype(jnp.uint32)
        sx = (stratum % strata).astype(jnp.float32)
        sy = (stratum // strata).astype(jnp.float32)
        u1, u2 = rng_mod.path_uniform2(key, pixel_idx, sample_idx, 0, S.JITTER_X)
        inv = np.float32(1.0 / strata)
        r1 = jnp.minimum((sx + u1) * inv, np.float32(1.0 - 1e-4))
        r2 = jnp.minimum((sy + u2) * inv, np.float32(1.0 - 1e-4))
        return r1, r2
    if method == SamplingMethod.HALTON:
        r1 = rng_mod.radical_inverse(3, sample_idx)
        r2 = rng_mod.radical_inverse(2, sample_idx)
        return r1, r2
    return rng_mod.path_uniform2(key, pixel_idx, sample_idx, 0, S.JITTER_X)


# RNG streams each integrator draws per bounce (all fetched in ONE
# threefry launch per bounce; see ops/rng.py path_uniform_bundle).
_CONTINUATION_STREAMS = (S.BSDF_E0, S.BSDF_E1, S.BSDF_E2, S.ROULETTE)


def _streams_for(integrator, env_nee: bool = False) -> tuple:
    from .scene import Integrator as I

    integ = I(integrator)
    if integ == I.DIRECT:
        extra = (S.LIGHT_PICK, S.LIGHT_U, S.LIGHT_V)
    elif integ in (I.DIRECT_MIS, I.DEBUG_MIS_WEIGHTS):
        extra = (S.MIS_E0, S.MIS_E1, S.MIS_E2, S.LIGHT_PICK, S.LIGHT_U, S.LIGHT_V)
    else:
        extra = ()
    if env_nee and integ in (I.DIRECT, I.DIRECT_MIS):
        extra = extra + (S.ENV_U, S.ENV_V)
    return _CONTINUATION_STREAMS + extra


def trace(scene: Scene, opts: RenderOptions, key, o, d, pixel_idx, sample_idx):
    """Trace a wavefront of primary rays to radiance (terra_trace,
    Terra.c:1039-1097). Returns (N, 3) f32 radiance per lane."""
    from .surface import build_shade_tables

    raycast = make_raycast_fn(scene, opts)
    integrator = make_integrator(opts.integrator)
    tables = build_shade_tables(scene)
    present = scene.materials.types_present
    streams = _streams_for(opts.integrator, opts.env_nee)
    env_dist = _make_env_dist(scene, opts)

    n = o.shape[0]
    # Specular-bounce flag (only carried when the scene has delta lobes):
    # emissive pickup under DIRECT/DIRECT_MIS is allowed at bounce 0 and
    # after MIRROR/GLASS bounces (see integrators._emit_gate).
    has_delta = any(t in present for t in bsdf.DELTA_TYPES)
    init = dict(
        o=o,
        d=d,
        throughput=jnp.ones((n, 3), jnp.float32),
        Lo=jnp.zeros((n, 3), jnp.float32),
        active=jnp.ones((n,), bool),
    )
    if has_delta:
        init["emit_ok"] = jnp.ones((n,), bool)
    # parent-hit sort hint: -1 = no parent (bounce 0 / dead lanes); rays
    # leaving the same BVH leaf sort into the same packets
    init["prev_tri"] = jnp.full((n,), -1, jnp.int32)

    def bounce_body(carry, bounce):
        o, d = carry["o"], carry["d"]
        throughput, Lo, active = carry["throughput"], carry["Lo"], carry["active"]
        emit_ok = carry.get("emit_ok")
        prev_tri = carry["prev_tri"]

        # One threefry launch covers every stream this bounce will draw.
        u = rng_mod.path_uniform_bundle(key, pixel_idx, sample_idx, bounce, streams)

        def rng(_bounce, stream):
            return u[stream]

        hit = raycast(*_mask_dead_rays(active, o, d),
                      sort_hint=jnp.where(active, prev_tri, -1))
        o_off = o + d * intersect.RAY_OFFSET_DIR
        surf = surface_init(scene, tables, o_off, d, hit.tri)
        wo = -d

        # Miss: reference multiplies throughput by the env color and ends
        # the path WITHOUT adding to Lo (the add is commented out at
        # Terra.c:1056); opts.env_on_miss enables the useful behavior.
        if opts.env_on_miss:
            env = _env_radiance(scene, d)
            miss_mask = active & ~hit.hit
            if opts.env_nee:
                # env-NEE covers direct env light at every shaded vertex;
                # the miss add stays only where NEE could not have seen the
                # env: camera rays and rays leaving a delta lobe.
                miss_mask = miss_mask & (
                    emit_ok if emit_ok is not None else bounce == 0
                )
            Lo = Lo + jnp.where(miss_mask[..., None], throughput * env, 0.0)
        active = active & hit.hit

        ctx = dict(
            scene=scene, rng=rng, raycast=raycast, ray_origin=o,
            tables=tables, present=present, env_dist=env_dist,
            light_area=opts.light_pick == LightPick.AREA,
            active=active,
            emit_ok=emit_ok, delta=bsdf.delta_mask(surf, present),
            hit_tri=jnp.where(active, hit.tri, -1),
        )
        radiance = integrator(ctx, surf, wo, throughput, bounce)
        Lo = Lo + jnp.where(active[..., None], radiance, 0.0)

        # Path continuation (Terra.c:1064-1093).
        e0 = u[S.BSDF_E0]
        e1 = u[S.BSDF_E1]
        e2 = u[S.BSDF_E2]
        wi, aux = bsdf.sample(surf, e0, e1, e2, wo, present)
        pdf = jnp.maximum(bsdf.pdf(surf, wi, wo, aux, present), EPS)
        f = bsdf.eval_f(surf, wi, wo, present)
        nol, off_sign = bsdf.continuation_factors(surf, wi, present)
        new_tp = throughput * f * (nol / pdf)[..., None]

        # Russian roulette (Terra.c:1081-1091), optionally deferred.
        p = math3.max3(new_tp)
        e3 = u[S.ROULETTE]
        rr_on = bounce >= opts.rr_start_bounce
        survive = jnp.where(rr_on, e3 <= p, True)
        new_tp = jnp.where(rr_on, new_tp / (p + EPS)[..., None], new_tp)
        active = active & survive

        if off_sign is None:
            new_o = surf.point + surf.normal * intersect.SURFACE_OFFSET_NORMAL
        else:  # transmitted rays continue on the far side of the surface
            new_o = surf.point + surf.normal * (
                off_sign * intersect.SURFACE_OFFSET_NORMAL
            )[..., None]
        carry = dict(
            o=jnp.where(active[..., None], new_o, o),
            d=jnp.where(active[..., None], wi, d),
            throughput=jnp.where(active[..., None], new_tp, throughput),
            Lo=Lo,
            active=active,
            prev_tri=jnp.where(active, hit.tri, -1),
        )
        if has_delta:  # next bounce may pick up emissive after a delta lobe
            carry["emit_ok"] = ctx["delta"]
        return carry, None

    bounces = jnp.arange(opts.bounces + 1, dtype=jnp.int32)
    final, _ = jax.lax.scan(bounce_body, init, bounces)
    return final["Lo"]


def trace_persistent(scene: Scene, opts: RenderOptions, cam: Camera, key,
                     pixel_idx, px, py, sample_base, quota: int):
    """Persistent-lane wavefront: each lane traces ``quota`` samples of its
    pixel back-to-back, regenerating a fresh camera ray the moment a path
    terminates. The fixed-depth scan in :func:`trace` keeps every lane
    busy for bounces+1 iterations even though most paths die early (Cornell
    survival per bounce: ~0.93/0.49/0.30/0.20/0.13); here a lane's dead
    time is only the tail where its quota finished before its neighbours'.

    Identical estimator to :func:`trace`: every (pixel, sample, bounce,
    stream) random draw, every bounce decision and every radiance term is
    the same — only the scheduling (and thus f32 accumulation order across
    samples) differs.

    Returns (N_lanes, 3) radiance *sums* over each lane's quota.
    """
    raycast = make_raycast_fn(scene, opts)
    integrator = make_integrator(opts.integrator)
    from .surface import build_shade_tables

    tables = build_shade_tables(scene)
    present = scene.materials.types_present
    streams = _streams_for(opts.integrator, opts.env_nee)
    env_dist = _make_env_dist(scene, opts)
    n = pixel_idx.shape[0]

    def new_ray(sample_idx):
        r1, r2 = _pixel_jitter(opts, key, pixel_idx, sample_idx)
        return camera_mod.generate_rays(
            cam, opts.width, opts.height, px, py, opts.subpixel_jitter, r1, r2
        )

    o0, d0 = new_ray(sample_base)
    has_delta = any(t in present for t in bsdf.DELTA_TYPES)
    init = dict(
        o=o0,
        d=d0,
        throughput=jnp.ones((n, 3), jnp.float32),
        lo_sample=jnp.zeros((n, 3), jnp.float32),
        lo_total=jnp.zeros((n, 3), jnp.float32),
        sample=jnp.broadcast_to(jnp.asarray(sample_base, jnp.int32), (n,)).astype(jnp.int32),
        bounce=jnp.zeros((n,), jnp.int32),
        done=jnp.zeros((n,), jnp.int32),  # completed samples per lane
        finished=jnp.zeros((n,), bool),
        iters=jnp.int32(0),
    )
    if has_delta:  # specular-bounce flag (see trace); True at path starts
        init["emit_ok"] = jnp.ones((n,), bool)
    init["prev_tri"] = jnp.full((n,), -1, jnp.int32)  # parent-hit sort hint
    max_iters = quota * (opts.bounces + 1)

    def cond(st):
        return (~jnp.all(st["finished"])) & (st["iters"] < max_iters)

    def body(st):
        o, d, bounce = st["o"], st["d"], st["bounce"]
        throughput = st["throughput"]
        active = ~st["finished"]

        # per-lane (sample, bounce) counters — one threefry launch
        u = rng_mod.path_uniform_bundle(key, pixel_idx, st["sample"], bounce, streams)

        def rng(_bounce, stream):
            return u[stream]

        hit = raycast(*_mask_dead_rays(active, o, d),
                      sort_hint=jnp.where(active, st["prev_tri"], -1))
        o_off = o + d * intersect.RAY_OFFSET_DIR
        surf = surface_init(scene, tables, o_off, d, hit.tri)
        wo = -d

        lo_sample = st["lo_sample"]
        emit_ok = st.get("emit_ok")
        if opts.env_on_miss:
            env = _env_radiance(scene, d)
            miss_mask = active & ~hit.hit
            if opts.env_nee:
                miss_mask = miss_mask & (
                    emit_ok if emit_ok is not None else bounce == 0
                )
            lo_sample = lo_sample + jnp.where(miss_mask[..., None], throughput * env, 0.0)
        alive = active & hit.hit

        ctx = dict(
            scene=scene, rng=rng, raycast=raycast, ray_origin=o,
            tables=tables, present=present, env_dist=env_dist,
            light_area=opts.light_pick == LightPick.AREA,
            active=alive,
            emit_ok=emit_ok, delta=bsdf.delta_mask(surf, present),
            hit_tri=jnp.where(alive, hit.tri, -1),
        )
        radiance = integrator(ctx, surf, wo, throughput, bounce)
        lo_sample = lo_sample + jnp.where(alive[..., None], radiance, 0.0)

        # continuation (Terra.c:1064-1093)
        wi, aux = bsdf.sample(surf, u[S.BSDF_E0], u[S.BSDF_E1], u[S.BSDF_E2], wo, present)
        pdf = jnp.maximum(bsdf.pdf(surf, wi, wo, aux, present), EPS)
        f = bsdf.eval_f(surf, wi, wo, present)
        nol, off_sign = bsdf.continuation_factors(surf, wi, present)
        new_tp = throughput * f * (nol / pdf)[..., None]
        p = math3.max3(new_tp)
        rr_on = bounce >= opts.rr_start_bounce
        survive = alive & jnp.where(rr_on, u[S.ROULETTE] <= p, True) & (bounce < opts.bounces)
        new_tp = jnp.where(rr_on[..., None], new_tp / (p + EPS)[..., None], new_tp)

        # path end -> bank the sample, regenerate or finish
        path_end = active & ~survive
        done = st["done"] + path_end.astype(jnp.int32)
        lo_total = st["lo_total"] + jnp.where(path_end[..., None], lo_sample, 0.0)
        need_more = done < quota
        regen = path_end & need_more
        finished = st["finished"] | (path_end & ~need_more)
        sample = st["sample"] + path_end.astype(jnp.int32)

        ro, rd = new_ray(sample)
        if off_sign is None:
            cont_o = surf.point + surf.normal * intersect.SURFACE_OFFSET_NORMAL
        else:  # transmitted rays continue on the far side of the surface
            cont_o = surf.point + surf.normal * (
                off_sign * intersect.SURFACE_OFFSET_NORMAL
            )[..., None]
        out = dict(
            o=jnp.where(regen[..., None], ro, jnp.where(survive[..., None], cont_o, o)),
            d=jnp.where(regen[..., None], rd, jnp.where(survive[..., None], wi, d)),
            throughput=jnp.where(
                regen[..., None], 1.0,
                jnp.where(survive[..., None], new_tp, throughput),
            ),
            lo_sample=jnp.where(path_end[..., None], 0.0, lo_sample),
            lo_total=lo_total,
            sample=sample,
            bounce=jnp.where(regen, 0, jnp.where(survive, bounce + 1, bounce)),
            done=done,
            finished=finished,
            iters=st["iters"] + 1,
        )
        # regenerated camera paths have no parent; continuations carry
        # their hit's triangle as the next raycast's coherence hint
        out["prev_tri"] = jnp.where(regen, -1,
                                    jnp.where(survive, hit.tri, st["prev_tri"]))
        if has_delta:  # fresh paths start True; continuations carry delta
            out["emit_ok"] = jnp.where(regen, True, ctx["delta"])
        return out

    final = jax.lax.while_loop(cond, body, init)
    return final["lo_total"]


def _lane_ids(opts: RenderOptions, spp_chunk: int, sample_offset, row0=0, rows: int = 0):
    """Flat lane layout: pixel-major, ``spp_chunk`` consecutive lanes per
    pixel. ``row0``/``rows`` select a horizontal band (for row-sharded
    rendering); pixel_idx stays GLOBAL so the RNG stream is invariant to
    sharding. Returns (pixel_idx, px, py, sample_idx)."""
    rows = rows or opts.height
    band = jnp.arange(rows * opts.width, dtype=jnp.int32)
    band_pixel = jnp.repeat(band, spp_chunk)
    pixel_idx = band_pixel + row0 * opts.width
    px = pixel_idx % opts.width
    py = pixel_idx // opts.width
    sample_idx = (
        jnp.tile(jnp.arange(spp_chunk, dtype=jnp.int32), rows * opts.width) + sample_offset
    )
    return pixel_idx, px, py, sample_idx


def render_rows(scene: Scene, cam: Camera, opts: RenderOptions, key, sample_offset, spp_chunk: int, row0, rows: int):
    """Trace a horizontal band of ``rows`` pixel rows starting at traced row
    index ``row0`` — the shard body for row-sharded rendering. Returns the
    (rows, W, 3) radiance sum over the chunk."""
    quota = max(int(opts.samples_per_lane), 1)
    while spp_chunk % quota:  # largest compatible divisor <= requested
        quota -= 1
    if quota > 1:
        lanes_pp = spp_chunk // quota
        pixel_idx, px, py, sample_idx = _lane_ids(opts, lanes_pp, sample_offset, row0, rows)
        # lane j of a pixel owns samples [offset + j*quota, offset + (j+1)*quota)
        lane_base = sample_offset + (sample_idx - sample_offset) * quota
        Lo = trace_persistent(scene, opts, cam, key, pixel_idx, px, py, lane_base, quota)
        return Lo.reshape(rows, opts.width, lanes_pp, 3).sum(axis=2)
    pixel_idx, px, py, sample_idx = _lane_ids(opts, spp_chunk, sample_offset, row0, rows)
    r1, r2 = _pixel_jitter(opts, key, pixel_idx, sample_idx)
    o, d = camera_mod.generate_rays(
        cam, opts.width, opts.height, px, py, opts.subpixel_jitter, r1, r2
    )
    Lo = trace(scene, opts, key, o, d, pixel_idx, sample_idx)
    return Lo.reshape(rows, opts.width, spp_chunk, 3).sum(axis=2)


@partial(jax.jit, static_argnames=("opts", "spp_chunk"))
def render_chunk(scene: Scene, cam: Camera, opts: RenderOptions, key, sample_offset, spp_chunk: int):
    """One jit-compiled launch: trace spp_chunk samples for every pixel and
    return the (H, W, 3) radiance *sum* over the chunk (the accumulation
    plane contribution, Terra.c:569-572)."""
    return render_rows(scene, cam, opts, key, sample_offset, spp_chunk, 0, opts.height)


# Largest wavefront a single launch may carry. XLA's memory analysis of a
# render launch on the H100 gives 520-760 bytes of temporaries per lane
# (courtyard DIRECT / DIRECT_MIS, Cornell GGX DIRECT_MIS; PERF.md), so the
# cap holds one launch to about 1.6 GB and leaves the card's memory to
# scenes and to several banded or sharded launches. render() splits bigger
# frames into row bands; one traced-band0 compile serves every band.
MAX_WAVEFRONT_LANES = 1 << 21


@partial(jax.jit, static_argnames=("opts", "spp_chunk", "rows"))
def render_band(scene: Scene, cam: Camera, opts: RenderOptions, key,
                sample_offset, row0, spp_chunk: int, rows: int):
    """``rows`` pixel rows starting at traced ``row0`` in one launch."""
    return render_rows(scene, cam, opts, key, sample_offset, spp_chunk, row0, rows)


def _band_rows(opts: RenderOptions, spp_chunk: int) -> int:
    """Row-band height keeping the wavefront under MAX_WAVEFRONT_LANES
    (whole frame when it already fits). Picks the largest divisor of the
    frame height so every band compiles once."""
    quota = max(int(opts.samples_per_lane), 1)
    while spp_chunk % quota:
        quota -= 1
    lanes_per_row = opts.width * spp_chunk // quota
    target = max(int(MAX_WAVEFRONT_LANES // max(lanes_per_row, 1)), 1)
    if target >= opts.height:
        return opts.height
    for b in range(target, 0, -1):
        if opts.height % b == 0:
            return b
    return 1


@partial(jax.jit, static_argnames=("opts", "spp_chunk", "n_chunks"))
def render_chunks(scene: Scene, cam: Camera, opts: RenderOptions, key,
                  sample_offset, spp_chunk: int, n_chunks: int):
    """``n_chunks`` sample chunks in ONE device launch: a ``lax.scan`` over
    sample offsets whose body is the whole chunk render. Identical
    estimator and accumulation order to looping :func:`render_chunk` on the
    host (the per-chunk sums add in the same sequence), but the fixed
    dispatch/launch overhead is paid once per pass instead of once per
    chunk — the launch-amortization the reference gets from re-pushing the
    whole tile grid per iteration (Renderer.cpp:134-151). The live
    wavefront footprint is still one chunk; the scan carry is only the
    (H, W, 3) film-accumulation plane."""

    def body(acc, i):
        off = sample_offset + i * spp_chunk
        acc = acc + render_rows(scene, cam, opts, key, off, spp_chunk, 0, opts.height)
        return acc, None

    init = jnp.zeros((opts.height, opts.width, 3), jnp.float32)
    acc, _ = jax.lax.scan(body, init, jnp.arange(n_chunks, dtype=jnp.int32))
    return acc


def _validate_acc(acc, where: str):
    """debug_checks: host-assert a chunk's radiance accumulator is finite,
    naming the offending rows (the render-level sanitizer analogue)."""
    a = np.asarray(jax.device_get(acc))
    bad = ~np.isfinite(a)
    if bad.any():
        rows = np.unique(np.nonzero(bad.reshape(a.shape[0], -1).any(axis=1))[0])
        raise FloatingPointError(
            f"non-finite radiance in {where}: {int(bad.sum())} values, "
            f"pixel rows {rows[:8].tolist()}{'...' if len(rows) > 8 else ''}"
        )


def render(
    scene: Scene,
    cam: Camera,
    opts: RenderOptions,
    seed: int = 0,
    film: Optional[Film] = None,
) -> Film:
    """Progressive render: adds ``opts.samples_per_pixel`` samples to the
    film (terra_render, Terra.c:512-635). Pass the returned film back in to
    keep accumulating (the reference's ``loop`` command)."""
    if film is None:
        film = Film.create(opts.width, opts.height)
    k0, k1 = rng_mod.key_from_seed(seed)
    key = jnp.array([k0, k1], dtype=jnp.uint32)

    spp = opts.samples_per_pixel
    chunk = opts.samples_per_launch or spp
    chunk = min(chunk, spp)
    # Start counting samples where the film left off so re-renders draw
    # fresh sample indices (progressive refinement). The film must be
    # uniformly sampled (progressive whole-frame passes); a non-uniform film
    # (e.g. future adaptive sampling) would silently reuse sample indices,
    # so refuse it here and resume from the max.
    samples_host = np.asarray(jax.device_get(film.samples))
    base = int(samples_host.max()) if samples_host.size else 0
    if samples_host.size and int(samples_host.min()) != base:
        raise ValueError(
            "render() resume requires a uniformly-sampled film "
            f"(min={int(samples_host.min())}, max={base}); render missing "
            "regions separately or reset the film"
        )
    band = _band_rows(opts, chunk)
    if band < opts.height:
        # 4k-class frame: row-banded launches in bounded HBM (see
        # MAX_WAVEFRONT_LANES); launch dispatch is negligible at this size
        done = 0
        while done < spp:
            cur = min(chunk, spp - done)
            acc = film.acc
            for b0 in range(0, opts.height, band):
                a = render_band(scene, cam, opts, key, jnp.int32(base + done),
                                jnp.int32(b0), cur, band)
                acc = jax.lax.dynamic_update_slice(
                    acc, acc[b0:b0 + band] + a, (b0, 0, 0))
            film = Film(acc=acc, samples=film.samples + cur)
            done += cur
        return film
    n_full = spp // chunk
    done = 0
    if n_full > 1 and not opts.debug_checks:
        # all full chunks in one launch (scan over offsets); debug_checks
        # keeps per-chunk launches so a failure names the chunk
        acc = render_chunks(scene, cam, opts, key, jnp.int32(base), chunk, n_full)
        film = Film(acc=film.acc + acc, samples=film.samples + n_full * chunk)
        done = n_full * chunk
    while done < spp:
        cur = min(chunk, spp - done)
        acc = render_chunk(scene, cam, opts, key, jnp.int32(base + done), cur)
        if opts.debug_checks:
            _validate_acc(acc, f"chunk at sample offset {base + done}")
        film = Film(acc=film.acc + acc, samples=film.samples + cur)
        done += cur
    return film
