"""Scaling-efficiency harness (BASELINE: >=0.85 efficiency at 4 hosts).

Measures rays/s of the sharded render at 1, 2, 4, ... N devices on the
current platform and reports efficiency vs the single-device rate. On a
multi-GPU host this measures real interconnect scaling; on a dev box run
with --cpu-mesh to validate the harness on the 8-device virtual CPU mesh
(efficiency numbers there reflect host-core contention, not a device
interconnect).

    python scripts/scaling_bench.py [--cpu-mesh] [--width 512 --spp 32]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=32)
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--cpu-mesh", action="store_true")
    args = p.parse_args()

    if args.cpu_mesh:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
        ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    import terra_tpu as tt
    from terra_tpu.ops import rng as rng_mod
    from terra_tpu.parallel.mesh import make_mesh, render_chunk_sharded

    scene = tt.scenes.cornell_box(accelerator=tt.Accelerator.BRUTE)
    cam = tt.scenes.cornell_camera()
    opts = tt.RenderOptions(
        width=args.width, height=args.height, samples_per_pixel=args.spp,
        bounces=args.bounces, integrator=tt.Integrator.SIMPLE, subpixel_jitter=0.5,
    )
    k0, k1 = rng_mod.key_from_seed(0)
    key = jnp.array([k0, k1], jnp.uint32)
    lanes = args.width * args.height * args.spp
    nominal_rays = lanes * 2.4  # conservative avg raycasts/lane (see bench.py)

    n_dev = jax.device_count()
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev]
    results = {}
    for n in sizes:
        mesh = make_mesh((n, 1), devices=jax.devices()[:n])
        fn = lambda off: render_chunk_sharded(scene, cam, opts, key, off, args.spp, mesh)
        acc = fn(jnp.int32(0))
        acc.block_until_ready()
        t0 = time.perf_counter()
        outs = [fn(jnp.int32(i * args.spp)) for i in range(args.iters)]
        jax.block_until_ready(outs)
        dt = (time.perf_counter() - t0) / args.iters
        results[n] = nominal_rays / dt / 1e6
        base = results[sizes[0]]
        eff = results[n] / (base * n / sizes[0])
        print(f"devices={n:3d}  {results[n]:9.1f} Mrays/s  efficiency={eff:5.2f}", flush=True)

    base = results[sizes[0]]
    print(json.dumps({
        "metric": "scaling_efficiency",
        "total_mrays_by_mesh_size": {str(k): round(v, 1) for k, v in results.items()},
        "efficiency_at_max": round(results[sizes[-1]] / (base * sizes[-1]), 3),
        "devices": sizes[-1],
    }))


if __name__ == "__main__":
    main()
