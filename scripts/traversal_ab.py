"""Traversal A/B and leaf-size sweep on one GPU (the measurements behind
the GPU traversal choice and ``lbvh.DEFAULT_LEAF_SIZE``; PERF.md).

On the pinned 241,764-triangle courtyard, with 2^20 rays of each class
(camera primaries, uniform-random, cosine first-bounce):

  * A/B: the CUDA kernel (``gpu_traverse``) against the XLA skip-link walk
    (``traverse``), per ray class and
    end to end on the config-3b render (384^2, 8 spp, DIRECT, 2 bounces),
    in the order kernel, walk, kernel;
  * sweep: the kernel at each of ``LEAF_SIZES``, per ray class and
    on 3b.

Every line is JSON on stdout.

    python scripts/traversal_ab.py
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402


REPS = 5
WALK_REPS = 3  # the XLA walk is 6-40x slower
LEAF_SIZES = (4, 8, 16, 24)


def main() -> int:
    import jax
    import jax.numpy as jnp

    import terra_tpu as tt
    from terra_tpu import compile_cache
    from terra_tpu.accel import lbvh
    from terra_tpu.ops import rng as rng_mod

    render = importlib.import_module("terra_tpu.render")  # the module
    compile_cache.enable()
    device = bench.device_info()
    key = jnp.array(rng_mod.key_from_seed(0), jnp.uint32)

    def out(**line):
        print(json.dumps({**line, "device": device}), flush=True)

    scene, build_s = bench.courtyard(tt)
    out(event="scene", tris=scene.geometry.num_triangles, build_s=build_s,
        leaf_size=scene.bvh.leaf_size, depth=scene.bvh.depth)

    def kernel(sc):
        return render.bvh_traversal("gpu", sc)

    def walk(sc):
        return render.bvh_traversal("cpu", sc)

    o_p, d_p = bench.camera_rays(tt)
    o_i, d_i = bench.random_rays(scene)
    o_s, d_s, parent = bench.bounce_rays(scene, kernel, o_p, d_p)
    classes = (("3", o_p, d_p, None), ("3i", o_i, d_i, None),
               ("3s", o_s, d_s, parent))
    cam = tt.scenes.courtyard_camera()
    opts = bench.courtyard_render_opts(tt)
    rays_3b = bench.render_rays(scene, cam, opts, key, shadow_rays_per_bounce=1)

    def rays(sc, variant, reps, tag):
        for name, o, d, hint in classes:
            t = bench.time_traversal(sc, variant, o, d, reps, hint=hint)
            out(cell=name, traversal=tag, leaf_size=sc.bvh.leaf_size,
                mrays=bench.RAYS / t["median_s"] / 1e6, **t)

    saved_traversal = render.bvh_traversal

    def render_3b(sc, tag, reps, traversal_for=None):
        # the render looks its traversal up at trace time: swap it and drop
        # the traced programs around the swap
        if traversal_for is not None:
            render.bvh_traversal = traversal_for
            jax.clear_caches()
        try:
            t = bench.timed_render(sc, cam, opts, key, reps)
        finally:
            if traversal_for is not None:
                render.bvh_traversal = saved_traversal
                jax.clear_caches()
        out(cell="3b", traversal=tag, leaf_size=sc.bvh.leaf_size,
            mrays=rays_3b / t["median_s"] / 1e6, **t)

    def walk_for(platform, sc):
        return saved_traversal("cpu", sc)

    # A/B on the default build: kernel, walk, kernel
    rays(scene, kernel, REPS, "cuda")
    rays(scene, walk, WALK_REPS, "xla-walk")
    rays(scene, kernel, REPS, "cuda")
    render_3b(scene, "cuda", REPS)
    render_3b(scene, "xla-walk", WALK_REPS, traversal_for=walk_for)
    render_3b(scene, "cuda", REPS)

    for leaf in LEAF_SIZES:
        bvh = lbvh.build(scene.geometry, leaf_size=leaf)
        sc = dataclasses.replace(scene, bvh=bvh)
        out(event="leaf_build", leaf_size=leaf, leaves=bvh.num_leaves,
            depth=bvh.depth)
        rays(sc, kernel, REPS, "cuda")
        render_3b(sc, "cuda", REPS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
