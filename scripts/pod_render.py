"""Multi-host pod render (BASELINE config 5): 4k x 4k, high spp, pixel rows
sharded over every device with sample-chunked progressive accumulation and
periodic checkpointing.

Run one process per host (``parallel.distributed`` joins them):

    python scripts/pod_render.py --width 4096 --height 4096 --spp 1024 \
        --chunk 8 --checkpoint pod_render.npz -o pod_render.png

On a dev box this runs on whatever devices exist (including the 8-device
virtual CPU mesh with --cpu-mesh).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=4096)
    p.add_argument("--height", type=int, default=4096)
    p.add_argument("--spp", type=int, default=1024)
    p.add_argument("--chunk", type=int, default=8, help="spp per launch")
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--integrator", default="direct-mis")
    p.add_argument("--sample-ways", type=int, default=1)
    p.add_argument("--row-band", type=int, default=0,
                   help="rows per launch (0 = whole frame); bounds the live "
                        "wavefront for 4k-class frames")
    p.add_argument("--samples-per-lane", type=int, default=1,
                   help="persistent-lane quota (see RenderOptions)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", default="")
    p.add_argument("--checkpoint-every", type=int, default=4, help="chunks")
    p.add_argument("-o", "--output", default="pod_render.png")
    p.add_argument("--cpu-mesh", action="store_true", help="8-device virtual CPU mesh (dev)")
    args = p.parse_args()

    if args.cpu_mesh:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
        ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np

    import terra_tpu as tt
    from terra_tpu.checkpoint import load_render_state, save_render_state
    from terra_tpu.config import _INTEGRATOR
    from terra_tpu.ops import rng as rng_mod
    from terra_tpu.parallel import distributed
    from terra_tpu.parallel.mesh import render_chunk_sharded
    from terra_tpu.film import Film, develop

    distributed.initialize()
    mesh = distributed.pod_mesh(args.sample_ways)
    coord = distributed.is_coordinator()
    if coord:
        print(f"mesh: {dict(mesh.shape)} over {jax.device_count()} devices")

    scene = tt.scenes.cornell_box(accelerator=tt.Accelerator.BRUTE)
    cam = tt.scenes.cornell_camera()
    opts = tt.RenderOptions(
        width=args.width, height=args.height, samples_per_pixel=args.spp,
        bounces=args.bounces, integrator=_INTEGRATOR[args.integrator],
        subpixel_jitter=0.5, samples_per_lane=args.samples_per_lane,
    )
    k0, k1 = rng_mod.key_from_seed(args.seed)
    key = jnp.array([k0, k1], jnp.uint32)

    film = None
    done = 0
    if args.checkpoint and os.path.exists(args.checkpoint):
        film, _, meta = load_render_state(args.checkpoint)
        done = int(np.asarray(film.samples).max())
        if coord:
            print(f"resumed at {done} spp")
    if film is None:
        film = Film.create(opts.width, opts.height)

    from terra_tpu.parallel.mesh import render_band_sharded

    band = args.row_band or args.height
    chunk_i = 0
    while done < args.spp:
        cur = min(args.chunk, args.spp - done)
        t0 = time.perf_counter()
        if band < args.height:
            acc_film = film.acc
            for b0 in range(0, args.height, band):
                acc = render_band_sharded(scene, cam, opts, key, jnp.int32(done),
                                          jnp.int32(b0), cur, band, mesh)
                acc_film = jax.lax.dynamic_update_slice(
                    acc_film, acc_film[b0:b0 + band] + acc, (b0, 0, 0))
            acc_film.block_until_ready()
            film = Film(acc=acc_film, samples=film.samples + cur)
        else:
            acc = render_chunk_sharded(scene, cam, opts, key, jnp.int32(done), cur, mesh)
            acc.block_until_ready()
            film = Film(acc=film.acc + acc, samples=film.samples + cur)
        done += cur
        chunk_i += 1
        dt = time.perf_counter() - t0
        lanes = opts.width * opts.height * cur
        if coord:
            print(f"spp {done}/{args.spp}  chunk {dt:.2f}s  "
                  f"{lanes * (opts.bounces + 1) / dt / 1e6:.1f} Mlane-bounces/s")
        if args.checkpoint and coord and chunk_i % args.checkpoint_every == 0:
            save_render_state(args.checkpoint, jax.device_get(film), args.seed)

    if coord:
        from terra_tpu.io.image import save_image

        img = develop(film, tt.Tonemap.LINEAR, 1.0, 2.2)
        save_image(args.output, np.asarray(jax.device_get(img)))
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
