"""Metrics registry + rays/s counters + jax.profiler hooks.

Equivalent of the TerraProfile subsystem (reference src/
TerraProfile.c, include/TerraProfile.h): where the reference brackets hot
scalar code with per-thread clock buffers merged into running stats
(TerraProfile.c:254-265), device work is opaque to host timers, so the
useful observables are:

  * wall-clock per launch (block_until_ready-timed),
  * derived throughput counters — rays/s, Mrays/s/chip — computed from the
    wavefront shape (the BASELINE headline metric),
  * XLA-level traces via ``jax.profiler.trace`` for kernel breakdowns.

Stats model mirrors the reference targets: n/avg/var/min/max/sum
(TerraProfile.h:33-78) via Welford updates.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = ["Stats", "Profiler", "ray_count", "profiler", "device_trace",
           "stage_breakdown"]


@dataclass
class Stats:
    """Welford running stats (terra_profile_update_stats_*,
    TerraProfile.c:254-265)."""

    n: int = 0
    mean: float = 0.0
    m2: float = 0.0
    min: float = float("inf")
    max: float = float("-inf")
    sum: float = 0.0

    def add(self, x: float):
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)
        self.min = min(self.min, x)
        self.max = max(self.max, x)
        self.sum += x

    @property
    def var(self) -> float:
        return self.m2 / self.n if self.n > 1 else 0.0

    def as_dict(self) -> dict:
        return dict(n=self.n, avg=self.mean, var=self.var, min=self.min, max=self.max, sum=self.sum)


class Profiler:
    """Named-target session (sessions/targets model, TerraProfile.h:33-78).
    Usage::

        with profiler.clock("render"):
            film = render(...)
    """

    def __init__(self):
        self.targets: Dict[str, Stats] = {}

    def stats(self, target: str) -> Stats:
        return self.targets.setdefault(target, Stats())

    @contextlib.contextmanager
    def clock(self, target: str):
        t0 = time.perf_counter()
        yield
        self.stats(target).add(time.perf_counter() - t0)

    def add_sample(self, target: str, value: float):
        self.stats(target).add(value)

    def report(self) -> str:
        lines = []
        for name in sorted(self.targets):
            s = self.targets[name]
            if "mrays" in name:  # throughput counters, not clocks
                lines.append(
                    f"{name:24s} n={s.n:6d} avg={s.mean:9.2f} Mrays/s "
                    f"min={s.min:9.2f} max={s.max:9.2f}"
                )
            else:
                lines.append(
                    f"{name:24s} n={s.n:6d} avg={s.mean * 1e3:9.3f}ms "
                    f"min={s.min * 1e3:9.3f}ms max={s.max * 1e3:9.3f}ms sum={s.sum:8.3f}s"
                )
        return "\n".join(lines)

    def clear(self):
        self.targets.clear()


profiler = Profiler()


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]):
    """XLA-level device trace via ``jax.profiler.trace`` — the analogue
    of the reference's TERRA_PROFILE build flag (TerraProfile.h:20): when
    ``trace_dir`` is set, every launch inside the context is recorded for
    TensorBoard/perfetto (per-kernel device timings, HBM traffic, fusion
    view). No-op when ``trace_dir`` is falsy."""
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        yield


def stage_breakdown(scene, cam, opts, seed: int = 0, probe_lanes: int = 65536):
    """Per-stage device timings on a probe wavefront — the equivalent of
    the reference's 4 bracketed hot targets (render / trace / ray / ray-tri,
    TerraPresets.h:54-60, TerraProfile.c). The megakernel's in-line clock
    deltas don't exist in one fused device program, so each stage is timed
    as its own compiled program on identical inputs:

      raycast   — closest-hit traversal only        (~ reference 'ray')
      surface   — raycast + shading-surface init    (~ 'trace' minus shade)
      bounce    — one full bounce: raycast + surface + integrator + BSDF
                  continuation                       (~ 'trace' per bounce)

    Results land in the module profiler under ``stage/*`` targets and are
    returned as {stage: seconds} (steady-state, min over reps)."""
    import jax
    import jax.numpy as jnp

    from . import bsdf, camera as camera_mod, intersect
    from .ops import rng as rng_mod
    from .ops.rng import PathStreams as S
    from .render import _lane_ids, _pixel_jitter, _streams_for, make_raycast_fn
    from .surface import build_shade_tables, surface_init
    from .integrators import make_integrator

    k0, k1 = rng_mod.key_from_seed(seed)
    key = jnp.array([k0, k1], jnp.uint32)
    spp = max(probe_lanes // (opts.width * opts.height), 1)
    pixel_idx, px, py, sample_idx = _lane_ids(opts, spp, jnp.int32(0))
    r1, r2 = _pixel_jitter(opts, key, pixel_idx, sample_idx)
    o, d = camera_mod.generate_rays(
        cam, opts.width, opts.height, px, py, opts.subpixel_jitter, r1, r2
    )
    raycast = make_raycast_fn(scene, opts)
    tables = build_shade_tables(scene)
    present = scene.materials.types_present
    integrator = make_integrator(opts.integrator)
    streams = _streams_for(opts.integrator, opts.env_nee)

    def stage_raycast(o, d):
        hit = raycast(o, d)
        return hit.t, hit.tri

    def stage_surface(o, d):
        hit = raycast(o, d)
        surf = surface_init(scene, tables, o + d * intersect.RAY_OFFSET_DIR, d, hit.tri)
        return surf.point, surf.normal

    def stage_bounce(o, d):
        u = rng_mod.path_uniform_bundle(key, pixel_idx, sample_idx, 0, streams)
        hit = raycast(o, d)
        surf = surface_init(scene, tables, o + d * intersect.RAY_OFFSET_DIR, d, hit.tri)
        wo = -d
        ctx = dict(scene=scene, rng=lambda b, s: u[s], raycast=raycast,
                   ray_origin=o, tables=tables, present=present, env_dist=None)
        rad = integrator(ctx, surf, wo, jnp.ones_like(o), jnp.int32(0))
        wi, aux = bsdf.sample(surf, u[S.BSDF_E0], u[S.BSDF_E1], u[S.BSDF_E2], wo, present)
        pdf = bsdf.pdf(surf, wi, wo, aux, present)
        f = bsdf.eval_f(surf, wi, wo, present)
        return rad, wi, pdf, f

    out = {}
    n = int(o.shape[0])
    for name, fn in (("raycast", stage_raycast), ("surface", stage_surface),
                     ("bounce", stage_bounce)):
        jfn = jax.jit(fn)
        jax.block_until_ready(jfn(o, d))  # compile
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(jfn(o, d))
            best = min(best, time.perf_counter() - t0)
        out[name] = best
        profiler.add_sample(f"stage/{name}", best)
        profiler.add_sample(f"stage/{name}_mrays", n / best / 1e6)
    return out


def ray_count(opts, avg_path_length: Optional[float] = None) -> float:
    """Nominal rays traced per full render at ``opts``: primary rays times
    bounce-loop raycasts (1 per bounce iteration + NEE/MIS shadow rays).

    The benchmark headline counts *closest-hit traversals actually issued by
    the wavefront*: (bounces+1) raycasts per lane for the path walk, plus 1
    (NEE) or 2 (MIS) per bounce iteration for the integrator. Early
    termination makes the true number lower; callers that want measured
    occupancy should pass avg_path_length.
    """
    lanes = opts.width * opts.height * opts.samples_per_pixel
    per_bounce = 1
    integ = int(opts.integrator)
    if integ == 1:  # DIRECT
        per_bounce += 1
    elif integ == 2 or integ == 6:  # DIRECT_MIS / DEBUG_MIS_WEIGHTS
        per_bounce += 2
    depth = avg_path_length if avg_path_length is not None else (opts.bounces + 1)
    return float(lanes) * per_bounce * depth
