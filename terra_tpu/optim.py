"""Inverse rendering: pixel-loss gradients on scene parameters.

BASELINE.md config 4: recover BSDF albedo/roughness + emission (and
optionally vertex positions, texture data, or the camera pose) by gradient
descent on a pixel loss (see PARAM_FIELDS).
The reference renderer has no gradients at all — this subsystem is the
*point* of this re-design: the whole wavefront renderer is jnp, the RNG
is counter-based (replay-exact), and discrete choices are stop-gradiented,
so reverse-mode through the full bounce scan just works.

Distributed: the sharded train step runs the forward+backward wavefront
under ``shard_map`` with pixel rows / samples sharded; scene-parameter
gradients are ``psum``-all-reduced over the mesh, which XLA may overlap
with the backward sweep where profitable.

KNOWN LIMITATION — visibility gradients. Vertex-position gradients flow
through the *interior* terms only: the differentiable hit re-evaluation
(hit point, normal, barycentrics) and every shading term that depends on
them (NEE distance/cosine, BSDF frames). The raycast's discrete hit
choice is stop-gradiented, so the estimator carries NO gradient through
visibility discontinuities — moving a silhouette or shadow edge across a
pixel contributes zero gradient even though the true derivative has a
boundary term. This is the standard bias of interior-point differentiable
path tracing; edge-sampling / reparameterization schemes (Li 2018,
Loubet 2019) are out of scope. Consequence: geometry optimization works
when the loss signal comes from shading/position changes on *fixed*
topology (see tests/test_grad.py::test_grad_vertex_positions_matches_fd),
and silhouette-driven recovery may stall.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, PartitionSpec as P

from .ops import rng as rng_mod
from .render import render_rows
from .scene import Camera, RenderOptions, Scene

__all__ = ["inject_params", "extract_params", "inject_camera", "make_loss_fn",
           "make_train_step", "make_train_step_sharded", "recover"]

# Parameter groups that can be optimized. attrs/emissive/positions/textures
# are pytree leaf paths into Scene; "camera" optimizes the Camera pytree
# (position/direction/fov) passed alongside the scene.
PARAM_FIELDS = ("attrs", "emissive", "positions", "textures", "camera")


def extract_params(scene: Scene, fields=("attrs", "emissive"),
                   cam: Optional[Camera] = None) -> Dict[str, jax.Array]:
    """Pull the requested continuous leaves out of a scene (and camera)."""
    out: Dict[str, jax.Array] = {}
    for f in fields:
        if f == "attrs":
            out["attrs"] = scene.materials.attrs
        elif f == "emissive":
            out["emissive"] = scene.materials.emissive
        elif f == "positions":
            out["positions"] = scene.geometry.positions
        elif f == "textures":
            if scene.textures is None or scene.textures.num_textures == 0:
                raise ValueError("scene has no texture atlas to optimize")
            out["textures"] = scene.textures.data
        elif f == "camera":
            if cam is None:
                raise ValueError("pass cam= to extract camera parameters")
            out["camera"] = {
                "position": cam.position,
                "direction": cam.direction,
                "fov_deg": cam.fov_deg,
            }
        else:
            raise KeyError(f)
    return out


def inject_params(scene: Scene, params: Dict[str, jax.Array]) -> Scene:
    """Rebuild the scene with parameter leaves replaced (pure). The
    "camera" group is not part of the scene; see :func:`inject_camera`."""
    mats = scene.materials
    geom = scene.geometry
    tex = scene.textures
    if "attrs" in params:
        mats = dataclasses.replace(mats, attrs=params["attrs"])
    if "emissive" in params:
        mats = dataclasses.replace(mats, emissive=params["emissive"])
    if "positions" in params:
        geom = dataclasses.replace(geom, positions=params["positions"])
    if "textures" in params:
        tex = dataclasses.replace(tex, data=params["textures"])
    return dataclasses.replace(scene, materials=mats, geometry=geom, textures=tex)


def inject_camera(cam: Camera, params: Dict[str, jax.Array]) -> Camera:
    """Camera with the "camera" parameter group applied (identity when the
    group is absent; partial groups — e.g. position-only pose recovery,
    which avoids feeding Adam leaves of wildly different scales — override
    only their keys). Differentiable: ray generation normalizes direction,
    so an unnormalized optimized direction stays valid."""
    c = params.get("camera")
    if c is None:
        return cam
    return dataclasses.replace(
        cam,
        position=c.get("position", cam.position),
        direction=c.get("direction", cam.direction),
        fov_deg=c.get("fov_deg", cam.fov_deg),
    )


def render_mean_image(scene: Scene, cam: Camera, opts: RenderOptions, key, sample_offset, spp: int, row0=0, rows: int = 0):
    """Differentiable mean image over ``spp`` samples (no jit wrapper so it
    can sit inside a larger jitted/sharded computation)."""
    rows = rows or opts.height
    acc = render_rows(scene, cam, opts, key, sample_offset, spp, row0, rows)
    return acc / np.float32(spp)


def make_loss_fn(cam: Camera, opts: RenderOptions, target, spp: Optional[int] = None):
    """Returns loss(params, scene, key, sample_offset) -> scalar MSE between
    the rendered mean image and ``target`` (H, W, 3)."""
    spp = spp or opts.samples_per_pixel

    def loss_fn(params, scene, key, sample_offset):
        scene_p = inject_params(scene, params)
        cam_p = inject_camera(cam, params)
        img = render_mean_image(scene_p, cam_p, opts, key, sample_offset, spp)
        return jnp.mean((img - target) ** 2)

    return loss_fn


class TrainState(NamedTuple):
    params: Dict[str, jax.Array]
    opt_state: Any
    step: jax.Array


def make_train_step(cam: Camera, opts: RenderOptions, target, optimizer, spp: Optional[int] = None):
    """Single-device jitted train step. Each step uses fresh sample indices
    (sample_offset advances) so gradient noise is independent across steps."""
    loss_fn = make_loss_fn(cam, opts, target, spp)
    spp_eff = spp or opts.samples_per_pixel

    @jax.jit
    def step(state: TrainState, scene: Scene, key):
        offset = state.step * spp_eff
        loss, grads = jax.value_and_grad(loss_fn)(state.params, scene, key, offset)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    return step


def make_train_step_sharded(cam: Camera, opts: RenderOptions, target, optimizer, mesh: Mesh, spp: Optional[int] = None, grad_chunks: int = 1):
    """Sharded train step: forward+backward wavefront under shard_map with
    rows/samples sharded, scene-param grads psum-reduced over the mesh.

    The per-device loss is the *local sum* of squared error over its row
    band and sample slice; psum over both axes then normalizes to the
    global mean — so gradients equal the single-device step exactly.

    ``grad_chunks > 1`` splits the per-device sample slice into chunks and
    psum-reduces each chunk's gradient SEPARATELY, right after that
    chunk's backward — the structural form the north star's "grad
    all-reduce overlapped with the backward sweep" needs: chunk i's
    all-reduce has no data dependence on chunk i+1's backward, so an
    async-collective scheduler can run them concurrently (whether XLA:GPU
    does is not measured yet).

    Gradient math: manual shared-cotangent VJPs. jax.vjp over each chunk's
    accumulator returns the forward value too, the full image's loss
    cotangent is formed once, and each chunk's pullback runs with it —
    summing to the exact whole-step gradient. This replaces a
    value_and_grad(local_loss) formulation whose psum("samples") inside
    the loss TRANSPOSED to another psum under check_vma=False, silently
    scaling gradients by the sample-axis size (caught by
    tests/test_sharding.py::test_chunked_grad_allreduce_matches_unchunked
    against the unsharded ground truth — a round-<=3 latent bug).
    """
    grads_fn = make_grad_fn_sharded(cam, opts, target, mesh, spp=spp,
                                    grad_chunks=grad_chunks)
    spp_eff = spp or opts.samples_per_pixel

    @jax.jit
    def step(state: TrainState, scene: Scene, key):
        offset = state.step * spp_eff
        loss, grads = grads_fn(state.params, scene, key, offset)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    return step


def make_grad_fn_sharded(cam: Camera, opts: RenderOptions, target, mesh: Mesh,
                         spp: Optional[int] = None, grad_chunks: int = 1):
    """The sharded (loss, grads) computation of
    :func:`make_train_step_sharded`, exposed directly so tests can compare
    GRADIENTS bit-for-bit across process counts and mesh layouts
    (tests/test_distributed.py) without routing through an optimizer."""
    spp_eff = spp or opts.samples_per_pixel
    n_rows = mesh.shape["rows"]
    n_samp = mesh.shape["samples"]
    assert opts.height % n_rows == 0 and spp_eff % n_samp == 0
    rows_per = opts.height // n_rows
    spp_per = spp_eff // n_samp
    assert spp_per % grad_chunks == 0, (spp_per, grad_chunks)
    sub = spp_per // grad_chunks
    denom = np.float32(opts.width * opts.height * 3)

    def _local_acc(params, scene, key, base_offset, n_samples):
        scene_p = inject_params(scene, params)
        cam_p = inject_camera(cam, params)
        ri = jax.lax.axis_index("rows")
        return render_rows(
            scene_p, cam_p, opts, key, base_offset, n_samples,
            ri * rows_per, rows_per,
        )

    def sharded_grads(params, scene, key, sample_offset, tgt):
        si = jax.lax.axis_index("samples")
        base = sample_offset + si * spp_per
        # per-chunk forwards + pullbacks (vjp returns the forward value, so
        # no duplicated rendering)
        accs, vjps = [], []
        for i in range(grad_chunks):
            acc_i, vjp_fn = jax.vjp(
                lambda p, i=i: _local_acc(p, scene, key, base + i * sub, sub),
                params,
            )
            accs.append(acc_i)
            vjps.append(vjp_fn)
        acc = accs[0]
        for a in accs[1:]:
            acc = acc + a
        img = jax.lax.psum(acc, "samples") / np.float32(spp_eff)
        loss = jax.lax.psum(jnp.sum((img - tgt) ** 2) / denom, "rows")
        # d loss / d local_acc: the image cotangent is shared by every
        # sample shard (psum's mathematical transpose is broadcast)
        cot_acc = 2.0 * (img - tgt) / (denom * np.float32(spp_eff))
        grads = None
        for vjp_fn in vjps:
            (g_i,) = vjp_fn(cot_acc)
            g_i = jax.lax.psum(g_i, ("rows", "samples"))  # per-chunk reduce
            grads = g_i if grads is None else jax.tree_util.tree_map(
                jnp.add, grads, g_i)
        return loss, grads

    shard_fn = jax.shard_map(
        sharded_grads,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P("rows")),
        out_specs=(P(), P()),
        check_vma=False,
    )

    @jax.jit
    def grads_fn(params, scene: Scene, key, sample_offset):
        return shard_fn(params, scene, key, sample_offset, target)

    return grads_fn


def recover(
    scene_init: Scene,
    cam: Camera,
    opts: RenderOptions,
    target,
    fields=("attrs", "emissive"),
    steps: int = 100,
    learning_rate: float = 5e-2,
    seed: int = 0,
    mesh: Optional[Mesh] = None,
    log_every: int = 0,
    clip_to_physical: bool = True,
):
    """Run the inverse-rendering loop; returns (scene_recovered, losses),
    or (scene_recovered, cam_recovered, losses) when "camera" is among the
    optimized fields.

    ``clip_to_physical`` projects parameters after each step: attribute
    values to [0, attr_cap] where attr_cap keeps exponent-like slots that
    started above 1 free, and emission / texture data to >= 0."""
    optimizer = optax.adam(learning_rate)
    params = extract_params(scene_init, fields, cam=cam)
    attr_cap = None
    if clip_to_physical and "attrs" in params:
        # slots whose initial value exceeds 1 (phong exponents, etc.) keep a
        # generous cap; color-like slots are capped at 1.
        attr_cap = jnp.where(params["attrs"] > 1.0, 1e4, 1.0)
    state = TrainState(params, optimizer.init(params), jnp.int32(0))
    k0, k1 = rng_mod.key_from_seed(seed)
    key = jnp.array([k0, k1], jnp.uint32)
    if mesh is None:
        step_fn = make_train_step(cam, opts, target, optimizer)
    else:
        step_fn = make_train_step_sharded(cam, opts, target, optimizer, mesh)
    refit_bvh = "positions" in fields and scene_init.bvh is not None
    losses = []
    for i in range(steps):
        state, loss = step_fn(state, scene_init, key)
        if clip_to_physical:
            p = dict(state.params)
            if "attrs" in p:
                p["attrs"] = jnp.clip(p["attrs"], 0.0, attr_cap)
            if "emissive" in p:
                p["emissive"] = jnp.maximum(p["emissive"], 0.0)
            if "textures" in p:
                p["textures"] = jnp.maximum(p["textures"], 0.0)
            state = TrainState(p, state.opt_state, state.step)
        if refit_bvh:
            # vertex edits move triangle bounds: refit the BVH AABBs
            # host-side each step (the reference's "mesh move" forces a
            # full rebuild, Scene.cpp:271-321; topology is unchanged here
            # so a bottom-up refit suffices)
            from .accel import lbvh as lbvh_mod

            geom = dataclasses.replace(
                scene_init.geometry, positions=state.params["positions"]
            )
            scene_init = dataclasses.replace(
                scene_init, bvh=lbvh_mod.refit(scene_init.bvh, geom)
            )
        losses.append(float(loss))
        if log_every and (i % log_every == 0):
            print(f"step {i:4d} loss {losses[-1]:.6f}")
    if "camera" in fields:
        return (inject_params(scene_init, state.params),
                inject_camera(cam, state.params), losses)
    return inject_params(scene_init, state.params), losses
