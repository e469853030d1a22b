"""Headline benchmarks on one NVIDIA GPU: one JSON line per config.

Configs (BASELINE.md "Benchmark configs"; the courtyard scene is pinned at
its default build = 241,764 triangles):
  1   cornell_fwd_mrays   Cornell box, diffuse, SIMPLE, 64 spp, 256^2
  2   cornell_ggx_mis_mrays  Cornell + GGX walls + DIRECT_MIS, 512^2, 256 spp
  3   courtyard_bvh_mrays   courtyard traversal of 2^20 camera (primary) rays
  3i  courtyard_incoherent_mrays  2^20 uniform-random origins/directions
  3s  courtyard_bounce_mrays  2^20 cosine first-bounce rays from the camera
                      rays' hits, parent-hit sort keys
  3b  courtyard_render_mrays  the production render end to end (camera,
                      traversal, textured shading, NEE shadow rays), 384^2,
                      8 spp, DIRECT, 2 bounces
  3m  mega_bvh_mrays    1,013,964-triangle courtyard, 2^20 camera rays
  4   inverse_step_ms   inverse-rendering step (fwd+bwd+adam), 32^2, 8 spp

Every traversal config uses the production BVH traversal
(``render.bvh_traversal``); config 3 first checks it against brute force
and 3m against the XLA walk, and a mismatch fails the config.

Timing: one warm-up call (compile, reported as ``compile_s``), then
``REPS`` calls, each ended by ``block_until_ready``; the line reports the
median with min and max. Every line names the device and the card's
``nvidia-smi`` name and power limit. The benchmark needs a GPU and exits
non-zero when any config fails.

Ray accounting (a "ray" is one closest-hit traversal, TerraBVH.c:250):
primary + per-bounce extension rays counted via the measured average path
survival; integrator shadow rays counted on active lanes only.

    python bench.py [--only 3,3i]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

COURTYARD_TRIS = 241764  # pinned scene size; a drift means the scene changed
MEGA_TRIS = 1013964
RAYS = 1 << 20
REPS = 5  # timed calls per config (median, min, max)

_DEVICE: dict = {}


def card() -> str:
    """``nvidia-smi`` name and power limit of the card(s)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip()


def device_info() -> dict:
    """Platform, kind, count and card of the default device; raises unless
    it is a GPU (a CPU number is never reported as a device number)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"bench.py needs a GPU, found {dev.platform!r}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card()}


def timing(samples) -> dict:
    """Median, min, max and relative spread of per-call seconds."""
    med = statistics.median(samples)
    return {"median_s": med, "min_s": min(samples), "max_s": max(samples),
            "spread": (max(samples) - min(samples)) / med if med > 0 else 0.0,
            "reps": len(samples)}


def time_calls(fn, args_for, reps: int) -> dict:
    """Warm up with ``fn(*args_for(0))`` (compile), then time ``reps``
    calls on ``args_for(1..reps)``, each ended by block_until_ready."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args_for(0)))
    compile_s = time.perf_counter() - t0
    samples = []
    for i in range(1, reps + 1):
        args = args_for(i)
        jax.block_until_ready(args)
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append(time.perf_counter() - t0)
    return {"compile_s": compile_s, **timing(samples)}


def peak_bytes() -> int:
    import jax

    return int((jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use", 0))


def emit(metric, rays_or_value, unit, t: dict, **extra):
    """One JSON line. For Mrays/s metrics ``rays_or_value`` is the ray
    count per call and the value is rays / median seconds; otherwise it is
    the value itself."""
    if unit == "Mrays/s":
        value = rays_or_value / t["median_s"] / 1e6
    else:
        value = rays_or_value
    line = {"metric": metric, "value": value, "unit": unit, **t,
            "peak_bytes_in_use": peak_bytes(), "device": _DEVICE, **extra}
    print(json.dumps(line), flush=True)


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def measure_avg_active(scene, cam, opts, key):
    """Measured per-bounce active-lane fraction (for honest ray counting)."""
    import jax
    import jax.numpy as jnp

    from terra_tpu import bsdf as bsdf_mod
    from terra_tpu import camera as camera_mod
    from terra_tpu import intersect
    from terra_tpu.ops import math3, rng as rng_mod
    from terra_tpu.ops.rng import PathStreams as S
    from terra_tpu.render import _lane_ids, _pixel_jitter, make_raycast_fn
    from terra_tpu.surface import build_shade_tables, surface_init

    probe_opts = opts.replace(width=64, height=64, samples_per_pixel=8)

    @jax.jit
    def probe(scene):
        pixel_idx, px, py, sample_idx = _lane_ids(probe_opts, 8, jnp.int32(0))
        r1, r2 = _pixel_jitter(probe_opts, key, pixel_idx, sample_idx)
        o, d = camera_mod.generate_rays(cam, 64, 64, px, py, probe_opts.subpixel_jitter, r1, r2)
        raycast = make_raycast_fn(scene, probe_opts)
        tables = build_shade_tables(scene)
        active = jnp.ones(o.shape[0], bool)
        fractions = []
        for bounce in range(opts.bounces + 1):
            hit = raycast(o, d)
            o_off = o + d * intersect.RAY_OFFSET_DIR
            surf = surface_init(scene, tables, o_off, d, hit.tri)
            wo = -d
            active = active & hit.hit
            fractions.append(jnp.mean(active.astype(jnp.float32)))
            e0 = rng_mod.path_uniform(key, pixel_idx, sample_idx, bounce, S.BSDF_E0)
            e1 = rng_mod.path_uniform(key, pixel_idx, sample_idx, bounce, S.BSDF_E1)
            e2 = rng_mod.path_uniform(key, pixel_idx, sample_idx, bounce, S.BSDF_E2)
            wi, aux = bsdf_mod.sample(surf, e0, e1, e2, wo)
            pdf = jnp.maximum(bsdf_mod.pdf(surf, wi, wo, aux), 1e-4)
            f = bsdf_mod.eval_f(surf, wi, wo)
            tp_gain = math3.max3(f * (math3.dot(surf.normal, wi) / pdf)[..., None])
            e3 = rng_mod.path_uniform(key, pixel_idx, sample_idx, bounce, S.ROULETTE)
            # approximation of the roulette survival on unit throughput
            active = active & (e3 <= jnp.minimum(tp_gain, 1.0))
            o = surf.point + surf.normal * intersect.SURFACE_OFFSET_NORMAL
            d = wi
        return jnp.stack(fractions)

    return [float(x) for x in np.asarray(probe(scene))]


def render_rays(scene, cam, opts, key, shadow_rays_per_bounce: int) -> float:
    """Rays one render of ``opts`` traces (extension + shadow rays)."""
    fractions = measure_avg_active(scene, cam, opts, key)
    lanes = opts.width * opts.height * opts.samples_per_pixel
    path_rays = 1.0 + sum(fractions[:-1])
    shadow_rays = shadow_rays_per_bounce * (1.0 + sum(fractions[:-1]))
    return lanes * (path_rays + shadow_rays)


def timed_render(scene, cam, opts, key, reps: int) -> dict:
    """Time whole renders: all sample chunks in one launch
    (render_chunks) when there are several, else one render_chunk. Each
    rep folds a distinct key."""
    import jax
    import jax.numpy as jnp

    from terra_tpu.render import render_chunk, render_chunks

    spp_chunk = min(opts.samples_per_launch or opts.samples_per_pixel,
                    opts.samples_per_pixel)
    n_chunks = opts.samples_per_pixel // spp_chunk
    if n_chunks > 1:
        def run(scene, k):
            return render_chunks(scene, cam, opts, k, jnp.int32(0), spp_chunk, n_chunks)
    else:
        def run(scene, k):
            return render_chunk(scene, cam, opts, k, jnp.int32(0), spp_chunk)
    return time_calls(run, lambda i: (scene, jax.random.fold_in(key, i)), reps)


def courtyard(tt, **kw):
    """Build a courtyard scene; returns (scene, build seconds)."""
    import jax

    t0 = time.perf_counter()
    scene = tt.scenes.courtyard(**kw)
    jax.block_until_ready(scene)
    return scene, time.perf_counter() - t0


def camera_rays(tt, n: int = RAYS):
    import jax.numpy as jnp

    from terra_tpu import camera as camera_mod

    cam = tt.scenes.courtyard_camera()
    side = int(np.sqrt(n))
    px, py = jnp.meshgrid(jnp.arange(side), jnp.arange(side))
    px = px.reshape(-1).astype(jnp.float32)
    py = py.reshape(-1).astype(jnp.float32)
    zeros = jnp.zeros_like(px)
    return camera_mod.generate_rays(cam, side, side, px, py, 0.0, zeros, zeros)


def random_rays(scene, n: int = RAYS, seed: int = 11):
    """Uniformly random origins inside the scene bounds, uniform sphere
    directions (the incoherent regime)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    lo = np.asarray(scene.bvh.node_min[0])
    hi = np.asarray(scene.bvh.node_max[0])
    o = jnp.asarray(lo + rng.random((n, 3), np.float32) * (hi - lo))
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return o, jnp.asarray(v / np.linalg.norm(v, axis=1, keepdims=True))


def bounce_rays(scene, make_traversal, o, d, seed: int = 12):
    """Cosine-hemisphere rays leaving the camera rays' first hits, and the
    parent hits' triangle ids (the production bounce batch).
    ``make_traversal(scene)`` returns the raycast (built inside the jit so
    the scene's tables are traced arguments, not constants)."""
    import jax
    import jax.numpy as jnp

    from terra_tpu import intersect
    from terra_tpu.ops import math3
    from terra_tpu.surface import build_shade_tables, surface_init

    @jax.jit
    def make(scene, o, d, e1, e2):
        hit0 = make_traversal(scene)(scene, o, d)
        surf = surface_init(scene, build_shade_tables(scene),
                            o + d * intersect.RAY_OFFSET_DIR, d, hit0.tri)
        st = jnp.sqrt(jnp.maximum(1.0 - e1, 0.0))
        phi = np.float32(2.0 * np.pi) * e2
        nrm = surf.normal
        t_ax = math3.normalize(jnp.cross(nrm, jnp.asarray([0.12, 0.98, 0.17])))
        b_ax = jnp.cross(nrm, t_ax)
        d_s = math3.normalize(
            (st * jnp.cos(phi))[:, None] * t_ax + (st * jnp.sin(phi))[:, None] * b_ax
            + jnp.sqrt(e1)[:, None] * nrm)
        return surf.point + nrm * np.float32(1e-4), d_s, hit0.tri

    rng = np.random.default_rng(seed)
    n = o.shape[0]
    return make(scene, o, d, jnp.asarray(rng.random(n, np.float32)),
                jnp.asarray(rng.random(n, np.float32)))


def time_traversal(scene, make_traversal, o, d, reps: int, hint=None) -> dict:
    """Time one raycast of the whole batch with ``make_traversal(scene)``
    (``hint``: parent-hit triangle ids, passed as the wavefront passes
    them). Each rep shifts the origins by a distinct 1e-6 so no two calls are
    identical."""
    import jax

    @jax.jit
    def run(scene, o, d, hint):
        return make_traversal(scene)(scene, o, d, sort_hint=hint).t

    return time_calls(run, lambda i: (scene, o + np.float32(1e-6 * i), d, hint), reps)


def compare_hits(label, got_hit, got_t, ref_hit, ref_t, tie_rate: float = 1e-4) -> dict:
    """Hit masks must agree but for edge ties (at most ``tie_rate`` of the
    rays); t within rtol=atol=1e-4 where both hit (unless ``got_t`` is
    None: any-hit answers carry no closest t). Returns counts for a log."""
    gh, rh = np.asarray(got_hit), np.asarray(ref_hit)
    ties = int((gh != rh).sum())
    if ties > tie_rate * gh.size:
        raise AssertionError(f"{label}: hit mask mismatch on {ties}/{gh.size} rays")
    both = gh & rh
    worst = 0.0
    if got_t is not None and both.any():
        gt, rt = np.asarray(got_t)[both], np.asarray(ref_t)[both]
        np.testing.assert_allclose(gt, rt, rtol=1e-4, atol=1e-4, err_msg=label)
        worst = float(np.abs(gt - rt).max())
    return {"case": label, "rays": int(gh.size), "hits": int(rh.sum()),
            "edge_tie_mismatches": ties, "max_abs_dt": worst}


def bench_cornell(tt, key, reps):
    scene = tt.scenes.cornell_box(accelerator=tt.Accelerator.BRUTE)
    cam = tt.scenes.cornell_camera()
    opts = tt.RenderOptions(
        width=256, height=256, samples_per_pixel=64, bounces=4,
        integrator=tt.Integrator.SIMPLE, subpixel_jitter=0.5,
        samples_per_launch=64, samples_per_lane=64,
    )
    _log("config 1: cornell diffuse 256^2 ...")
    rays = render_rays(scene, cam, opts, key, shadow_rays_per_bounce=0)
    emit("cornell_fwd_mrays", rays, "Mrays/s", timed_render(scene, cam, opts, key, reps),
         config="1")


def bench_ggx_mis(tt, key, reps):
    scene = tt.scenes.cornell_box(accelerator=tt.Accelerator.BRUTE,
                                  wall_bsdf=tt.BSDFType.GGX)
    cam = tt.scenes.cornell_camera()
    opts = tt.RenderOptions(
        width=512, height=512, samples_per_pixel=256, bounces=4,
        integrator=tt.Integrator.DIRECT_MIS, subpixel_jitter=0.5,
        samples_per_launch=256, samples_per_lane=256,
    )
    _log("config 2: cornell GGX+MIS 512^2 256 spp ...")
    # DIRECT_MIS issues 2 strategy raycasts per shaded bounce (light + bsdf)
    rays = render_rays(scene, cam, opts, key, shadow_rays_per_bounce=2)
    emit("cornell_ggx_mis_mrays", rays, "Mrays/s", timed_render(scene, cam, opts, key, reps),
         config="2")


def courtyard_render_opts(tt):
    return tt.RenderOptions(
        width=384, height=384, samples_per_pixel=8, bounces=2,
        integrator=tt.Integrator.DIRECT, subpixel_jitter=0.5,
        samples_per_lane=8,  # one persistent lane per pixel traces all 8
    )


def bench_courtyard(tt, key, reps, only):
    import jax

    from terra_tpu import intersect
    from terra_tpu.render import bvh_traversal

    _log("config 3: courtyard 242k-tri build + traversal ...")
    scene, build_s = courtyard(tt)
    ntri = scene.geometry.num_triangles
    if ntri != COURTYARD_TRIS:
        raise AssertionError(f"courtyard drifted to {ntri} tris (pinned {COURTYARD_TRIS})")
    platform = jax.default_backend()

    def traversal(sc):
        return bvh_traversal(platform, sc)

    o, d = camera_rays(tt)
    o_i, d_i = random_rays(scene)
    ref = jax.jit(lambda sc, o, d: intersect.raycast_brute(
        o, d, *sc.geometry.corners()))(scene, o_i[:2048], d_i[:2048])
    got = jax.jit(lambda sc, o, d: traversal(sc)(sc, o, d))(scene, o_i[:2048], d_i[:2048])
    _log(compare_hits("traversal vs brute force", got.hit, got.t, ref.hit, ref.t))
    info = {"tris": ntri, "leaf_size": scene.bvh.leaf_size,
            "scene_build_s": build_s}
    if "3" in only:
        emit("courtyard_bvh_mrays", RAYS, "Mrays/s",
             time_traversal(scene, traversal, o, d, reps), config="3", **info)
    if "3i" in only:
        _log("config 3i: courtyard incoherent rays ...")
        emit("courtyard_incoherent_mrays", RAYS, "Mrays/s",
             time_traversal(scene, traversal, o_i, d_i, reps), config="3i", **info)
    if "3s" in only:
        _log("config 3s: courtyard first-bounce (cosine) rays ...")
        o_s, d_s, parent = bounce_rays(scene, traversal, o, d)
        emit("courtyard_bounce_mrays", RAYS, "Mrays/s",
             time_traversal(scene, traversal, o_s, d_s, reps, hint=parent),
             config="3s", **info)
    if "3b" in only:
        _log("config 3b: courtyard full render 384^2 ...")
        cam = tt.scenes.courtyard_camera()
        opts = courtyard_render_opts(tt)
        rays = render_rays(scene, cam, opts, key, shadow_rays_per_bounce=1)
        emit("courtyard_render_mrays", rays, "Mrays/s",
             timed_render(scene, cam, opts, key, reps), config="3b", **info)


def bench_mega(tt, key, reps):
    import jax

    from terra_tpu.accel import traverse as xla_traverse
    from terra_tpu.render import bvh_traversal

    _log("config 3m: 1M-tri courtyard ...")
    scene, build_s = courtyard(tt, grid=690, columns=40)
    if scene.geometry.num_triangles != MEGA_TRIS:
        raise AssertionError(f"1M courtyard has {scene.geometry.num_triangles} tris")
    platform = jax.default_backend()

    def traversal(sc):
        return bvh_traversal(platform, sc)

    o, d = camera_rays(tt)
    got = jax.jit(lambda sc, o, d: traversal(sc)(sc, o, d))(scene, o[:2048], d[:2048])
    ref = jax.jit(xla_traverse.raycast)(scene, o[:2048], d[:2048])
    _log(compare_hits("1M traversal vs XLA walk", got.hit, got.t, ref.hit, ref.t))
    emit("mega_bvh_mrays", RAYS, "Mrays/s", time_traversal(scene, traversal, o, d, reps),
         config="3m", tris=MEGA_TRIS, leaf_size=scene.bvh.leaf_size,
         scene_build_s=build_s)


def bench_inverse(tt, key, reps):
    import dataclasses

    import jax
    import jax.numpy as jnp
    import optax

    from terra_tpu import optim

    _log("config 4: inverse-render step ...")
    scene_gt = tt.scenes.cornell_box(with_blocks=False)
    cam = tt.scenes.cornell_camera()
    opts = tt.RenderOptions(
        width=32, height=32, samples_per_pixel=8,
        bounces=2, integrator=tt.Integrator.DIRECT, rr_start_bounce=8,
    )
    target = jax.lax.stop_gradient(jax.jit(lambda: optim.render_mean_image(
        scene_gt, cam, opts, key, jnp.int32(0), 8))())
    attrs0 = scene_gt.materials.attrs.at[0, 0, :].set(jnp.asarray([0.3, 0.5, 0.6]))
    scene0 = dataclasses.replace(
        scene_gt, materials=dataclasses.replace(scene_gt.materials, attrs=attrs0))
    optimizer = optax.adam(3e-2)
    params = optim.extract_params(scene0, ("attrs",))
    state = optim.TrainState(params, optimizer.init(params), jnp.int32(0))
    step = optim.make_train_step(cam, opts, target, optimizer)
    states = [state]

    def run(state):
        new_state, loss = step(state, scene0, key)
        states.append(new_state)  # the next rep steps from this one
        return loss

    t = time_calls(run, lambda i: (states[-1],), reps)
    emit("inverse_step_ms", t["median_s"] * 1e3, "ms/step", t, config="4")


CONFIGS = ("1", "2", "3", "3i", "3s", "3b", "3m", "4")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(CONFIGS),
                    help=f"comma-separated configs from {','.join(CONFIGS)}")
    args = ap.parse_args(argv)
    only = [c for c in args.only.split(",") if c]
    unknown = set(only) - set(CONFIGS)
    if unknown:
        ap.error(f"unknown configs {sorted(unknown)}")

    import jax.numpy as jnp

    import terra_tpu as tt
    from terra_tpu import compile_cache
    from terra_tpu.ops import rng as rng_mod

    compile_cache.enable()
    _DEVICE.update(device_info())
    key = jnp.array(rng_mod.key_from_seed(0), jnp.uint32)
    runs = [(bench_cornell, "1"), (bench_ggx_mis, "2"),
            (lambda tt, key, reps: bench_courtyard(tt, key, reps, only),
             ("3", "3i", "3s", "3b")),
            (bench_mega, "3m"), (bench_inverse, "4")]
    failed = []
    for fn, names in runs:
        names = (names,) if isinstance(names, str) else names
        if not set(names) & set(only):
            continue
        try:
            fn(tt, key, REPS)
        except Exception as e:  # later configs still run; the exit code fails
            failed.append(names)
            print(json.dumps({"configs": list(names), "error": f"{type(e).__name__}: {e}",
                              "device": _DEVICE}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
