"""Device-mesh sharding of the render wavefront: pixels x samples.

This replaces the reference's tile/thread-pool
parallelism (/root/reference/satellite/src/Renderer.cpp:322-402 + the
Cloto work-stealing pool, satellite/include/Cloto.h): instead of pushing
pixel tiles into a shared work queue, the pixel grid and the sample axis
are sharded over a ``jax.sharding.Mesh`` with ``shard_map`` and the partial
accumulators are combined with XLA collectives:

  * 'rows'    axis — data parallelism over pixel rows (tiles -> row bands);
  * 'samples' axis — sample-axis parallelism (spp split across devices,
    partial sums ``psum``-reduced; SURVEY.md §2 parallelism table).

Scene parameters are replicated (BASELINE replicates scene params); the RNG
is counter-based and keyed by global pixel/sample ids, so the image is
bit-identical for every mesh shape (tested in tests/test_sharding.py).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..film import Film
from ..ops import rng as rng_mod
from ..render import render_rows
from ..scene import Camera, RenderOptions, Scene

__all__ = ["make_mesh", "render_sharded", "render_chunk_sharded",
           "render_band_sharded"]


def make_mesh(shape: Optional[Tuple[int, int]] = None, devices=None) -> Mesh:
    """Build a ('rows', 'samples') mesh. Default: all devices on 'rows'."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    assert shape[0] * shape[1] == n, f"mesh {shape} != {n} devices"
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, ("rows", "samples"))


def _shard_body(scene, cam, key, sample_offset, opts: RenderOptions, spp_shard: int, rows_per: int):
    """Per-device body: render my row band x my sample slice, then psum the
    partial accumulator over the sample axis (the gradient/accum
    all-reduce runs over the device interconnect)."""
    ri = jax.lax.axis_index("rows")
    si = jax.lax.axis_index("samples")
    row0 = ri * rows_per
    local_off = sample_offset + si * spp_shard
    acc = render_rows(scene, cam, opts, key, local_off, spp_shard, row0, rows_per)
    return jax.lax.psum(acc, "samples")


@partial(jax.jit, static_argnames=("opts", "spp_chunk", "mesh"))
def render_chunk_sharded(scene: Scene, cam: Camera, opts: RenderOptions, key, sample_offset, spp_chunk: int, mesh: Mesh):
    """Sharded analogue of ``render_chunk``: returns the (H, W, 3) radiance
    sum for ``spp_chunk`` samples, rows sharded over mesh axis 'rows' and
    samples over 'samples'."""
    n_rows = mesh.shape["rows"]
    n_samp = mesh.shape["samples"]
    assert opts.height % n_rows == 0, (
        f"height {opts.height} must divide over {n_rows} row shards"
    )
    assert spp_chunk % n_samp == 0, (
        f"spp chunk {spp_chunk} must divide over {n_samp} sample shards"
    )
    rows_per = opts.height // n_rows
    spp_shard = spp_chunk // n_samp

    body = partial(_shard_body, opts=opts, spp_shard=spp_shard, rows_per=rows_per)
    acc = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),  # scene/camera/key replicated
        out_specs=P("rows", None, None),
        check_vma=False,
    )(scene, cam, key, sample_offset)
    return acc


@partial(jax.jit, static_argnames=("opts", "spp_chunk", "band_rows", "mesh"))
def render_band_sharded(scene: Scene, cam: Camera, opts: RenderOptions, key,
                        sample_offset, band0, spp_chunk: int, band_rows: int,
                        mesh: Mesh):
    """Rows [band0, band0+band_rows) of the frame for ``spp_chunk``
    samples, sharded like :func:`render_chunk_sharded`. Bounds the live
    wavefront of very large frames (render.MAX_WAVEFRONT_LANES: a launch
    holds 520-760 bytes of temporaries per lane). ``band0`` is traced —
    one compile serves every band."""
    n_rows = mesh.shape["rows"]
    n_samp = mesh.shape["samples"]
    assert band_rows % n_rows == 0 and spp_chunk % n_samp == 0
    rows_per = band_rows // n_rows
    spp_shard = spp_chunk // n_samp

    def body(scene, cam, key, sample_offset, band0):
        ri = jax.lax.axis_index("rows")
        si = jax.lax.axis_index("samples")
        row0 = band0 + ri * rows_per
        local_off = sample_offset + si * spp_shard
        acc = render_rows(scene, cam, opts, key, local_off, spp_shard, row0, rows_per)
        return jax.lax.psum(acc, "samples")

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=P("rows", None, None),
        check_vma=False,
    )(scene, cam, key, sample_offset, band0)


def render_sharded(
    scene: Scene,
    cam: Camera,
    opts: RenderOptions,
    mesh: Mesh,
    seed: int = 0,
    film: Optional[Film] = None,
) -> Film:
    """Progressive sharded render; the film accumulator stays sharded over
    rows (device-resident, like the per-pixel accumulation plane of
    Terra.h:183-186 but distributed)."""
    if film is None:
        film = Film.create(opts.width, opts.height)
        # both planes lead with the row axis -> shard rows across devices
        film = jax.device_put(film, NamedSharding(mesh, P("rows")))
    k0, k1 = rng_mod.key_from_seed(seed)
    key = jnp.array([k0, k1], dtype=jnp.uint32)

    spp = opts.samples_per_pixel
    chunk = opts.samples_per_launch or spp
    chunk = min(chunk, spp)
    base = int(np.asarray(jax.device_get(film.samples[0, 0])))
    done = 0
    while done < spp:
        cur = min(chunk, spp - done)
        acc = render_chunk_sharded(scene, cam, opts, key, jnp.int32(base + done), cur, mesh)
        film = Film(acc=film.acc + acc, samples=film.samples + cur)
        done += cur
    return film
