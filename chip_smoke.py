#!/usr/bin/env python3
"""On-card smoke test of terra_tpu: the render and inverse-render path on
one NVIDIA GPU through the entry points a user calls.

    python chip_smoke.py              # every one-card phase, in order
    python chip_smoke.py --four-cards # only the sharded phase, on 4 cards

Phases (one process; each prints a JSON line with its name, ok, seconds):
  device      the default device is a GPU; nvidia-smi name and power limit;
              the native host BVH builder loaded
  gate        the compiled CUDA traversal against brute force on the
              241,764-triangle courtyard: 2^16 uniform-random + 2^16 camera
              rays, closest / ranged / any-hit, both leaf tests; then the
              1,013,964-triangle courtyard against the XLA walk
  oracle      16^2 8 spp DIRECT Cornell box (BVH) against the NumPy mirror
  main_path   CLI render with checkpoint and 2 passes writing a PNG; the
              courtyard through tt.render at 384^2 8 spp DIRECT and 512^2
              16 spp DIRECT_MIS (each reports its share of negative film
              values: ROADMAP B1)
  inverse     5 optim.make_train_step steps through the BVH traversal
              (albedo), then 2 optim.recover steps on vertex positions
  card_tests  the gpu-marked pytest tests (tests/test_gpu_smoke.py)

The last line of stdout is {"ok": true, "device": {...}} only when every
phase passed; any failure exits non-zero without it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

import bench  # the repo root's benchmark: scene sizes, rays, checks

ROOT = os.path.dirname(os.path.abspath(__file__))


def _print(obj):
    print(json.dumps(obj), flush=True)


def _peak_bytes() -> int:
    import jax

    return int((jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use", 0))


def phase_device(tt):
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"default device is {dev.platform!r}, not a GPU")
    from terra_tpu import native

    if not native.available():
        raise RuntimeError("native host BVH builder did not load")
    return {"device_kind": dev.device_kind, "count": len(jax.devices()),
            "nvidia_smi": bench.card()}


def phase_gate(tt):
    import jax
    import jax.numpy as jnp
    from terra_tpu import intersect
    from terra_tpu.accel import traverse as xla_traverse
    from terra_tpu.render import bvh_traversal

    cases = []
    t0 = time.perf_counter()
    scene = tt.scenes.courtyard()
    build_s = time.perf_counter() - t0
    ntri = scene.geometry.num_triangles
    if ntri != bench.COURTYARD_TRIS:
        raise AssertionError(f"courtyard has {ntri} triangles, not {bench.COURTYARD_TRIS}")
    o_r, d_r = bench.random_rays(scene, 1 << 16, seed=3)
    o_c, d_c = bench.camera_rays(tt, 1 << 16)
    o = jnp.concatenate([o_r, o_c])
    d = jnp.concatenate([d_r, d_c])
    n = o.shape[0]
    t_max = jnp.asarray(np.random.default_rng(5).uniform(0.05, 30.0, n)
                        .astype(np.float32))
    # scenes ride as jit arguments (closed-over arrays become constants)
    def brute(sc, o, d, algo):
        return intersect.raycast_brute(o, d, *sc.geometry.corners(), algo=algo)

    def kernel(sc, o, d, algo, t_max=None, any_hit=False):
        return bvh_traversal("gpu", sc)(sc, o, d, algo=algo, t_max=t_max,
                                        any_hit=any_hit)

    brute = jax.jit(brute, static_argnames="algo")
    kernel = jax.jit(kernel, static_argnames=("algo", "any_hit"))
    for algo in ("mt", "watertight"):
        ref = brute(scene, o, d, algo=algo)
        got = kernel(scene, o, d, algo=algo)
        cases.append(bench.compare_hits(f"courtyard closest {algo}", got.hit,
                                        got.t, ref.hit, ref.t))
        occluded = np.asarray(ref.t) < np.asarray(t_max)
        ranged = kernel(scene, o, d, algo=algo, t_max=t_max)
        cases.append(bench.compare_hits(f"courtyard ranged {algo}", ranged.hit,
                                        ranged.t, occluded, ref.t))
        anyhit = kernel(scene, o, d, algo=algo, t_max=t_max, any_hit=True)
        cases.append(bench.compare_hits(f"courtyard any-hit {algo}", anyhit.hit,
                                        None, occluded, None))

    t0 = time.perf_counter()
    mega = tt.scenes.courtyard(grid=690, columns=40)
    mega_build_s = time.perf_counter() - t0
    if mega.geometry.num_triangles != bench.MEGA_TRIS:
        raise AssertionError(f"1M courtyard has {mega.geometry.num_triangles} triangles")
    o_m, d_m = bench.random_rays(mega, 2048, seed=7)
    got = kernel(mega, o_m, d_m, algo="mt")
    ref = jax.jit(xla_traverse.raycast)(mega, o_m, d_m)
    cases.append(bench.compare_hits("1M courtyard vs XLA walk", got.hit, got.t,
                                    ref.hit, ref.t))
    for c in cases:
        _print({"gate": c})
    return {"courtyard_build_s": build_s, "mega_build_s": mega_build_s,
            "mega_leaf_size": mega.bvh.leaf_size, "mega_depth": mega.bvh.depth}


def phase_oracle(tt):
    from terra_tpu.testing import mirror

    scene = tt.scenes.cornell_box(accelerator=tt.Accelerator.BVH)
    cam = tt.scenes.cornell_camera()
    opts = tt.RenderOptions(width=16, height=16, samples_per_pixel=8,
                            bounces=2, integrator=tt.Integrator.DIRECT,
                            accelerator=tt.Accelerator.BVH)
    img = np.asarray(tt.render(scene, cam, opts, seed=23).mean())
    ref = mirror.render_mirror(scene, cam, opts, seed=23)
    rel = np.abs(img - ref) / np.maximum(np.abs(ref), 1e-2)
    frac = float((rel > 2e-3).mean())
    mean_err = float(abs(img.mean() - ref.mean()) / max(ref.mean(), 1e-6))
    if frac > 1.2e-2 or mean_err >= 5e-3:
        raise AssertionError(f"oracle mismatch: frac {frac}, mean err {mean_err}")
    return {"frac_rel_gt_2e-3": frac, "mean_rel_err": mean_err}


def _timed_render(tt, scene, cam, opts):
    import jax

    t0 = time.perf_counter()
    film = tt.render(scene, cam, opts, seed=1)
    jax.block_until_ready(film.acc)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    film = tt.render(scene, cam, opts, seed=2)
    jax.block_until_ready(film.acc)
    second = time.perf_counter() - t0
    img = np.asarray(film.mean())
    if not np.isfinite(img).all() or not (img > 0).any():
        raise AssertionError(f"{opts.width}^2 render is not finite and non-zero")
    # radiance is never negative; courtyard films carry negative values
    # (ROADMAP B1), reported until the fix makes this share 0
    return {"first_call_s": first, "second_call_s": second,
            "mean_radiance": float(img.mean()),
            "negative_share": float((img < 0).mean()),
            "known_bug": "B1 (negative film values)" if (img < 0).any() else None}


def phase_main_path(tt):
    from terra_tpu import cli
    from terra_tpu.io.image import load_image

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "cornell.png")
        ckpt = os.path.join(tmp, "cornell.npz")
        rc = cli.main(["render", "--cornell", "-o", png, "--width", "64",
                       "--height", "64", "--spp", "8", "--bounces", "3",
                       "--integrator", "direct", "--opt",
                       "render_accelerator=bvh", "--checkpoint", ckpt,
                       "--passes", "2"])
        if rc != 0 or not os.path.exists(ckpt):
            raise AssertionError(f"CLI render returned {rc}")
        img = load_image(png, srgb=False)
        if img.shape != (64, 64, 3) or not (img > 0).any():
            raise AssertionError(f"CLI PNG is {img.shape}, max {img.max()}")
    scene = tt.scenes.courtyard()
    cam = tt.scenes.courtyard_camera()
    direct = bench.courtyard_render_opts(tt)  # 384^2, 8 spp, DIRECT
    out["courtyard_384_direct"] = _timed_render(tt, scene, cam, direct)
    mis = direct.replace(width=512, height=512, samples_per_pixel=16,
                         integrator=tt.Integrator.DIRECT_MIS,
                         samples_per_lane=16)
    out["courtyard_512_direct_mis"] = _timed_render(tt, scene, cam, mis)
    out["peak_bytes_in_use"] = _peak_bytes()
    return out


def phase_inverse(tt):
    import dataclasses

    import jax
    import jax.numpy as jnp
    import optax
    from terra_tpu import optim
    from terra_tpu.ops import rng as rng_mod

    scene_gt = tt.scenes.cornell_box(accelerator=tt.Accelerator.BVH)
    cam = tt.scenes.cornell_camera()
    opts = tt.RenderOptions(width=64, height=64, samples_per_pixel=8,
                            bounces=2, integrator=tt.Integrator.DIRECT,
                            accelerator=tt.Accelerator.BVH)
    key = jnp.array(rng_mod.key_from_seed(0), jnp.uint32)
    target = jax.jit(lambda: optim.render_mean_image(
        scene_gt, cam, opts, key, jnp.int32(0), 64))()
    attrs0 = scene_gt.materials.attrs.at[0, 0, :].set(jnp.asarray([0.3, 0.5, 0.6]))
    scene0 = dataclasses.replace(
        scene_gt, materials=dataclasses.replace(scene_gt.materials, attrs=attrs0))
    optimizer = optax.adam(5e-2)
    params = optim.extract_params(scene0, ("attrs",))
    state = optim.TrainState(params, optimizer.init(params), jnp.int32(0))
    step = optim.make_train_step(cam, opts, target, optimizer)
    losses = []
    for _ in range(5):
        state, loss = step(state, scene0, key)
        losses.append(float(loss))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"inverse losses do not fall: {losses}")
    # vertex positions: tangents reach the packed tables, which the kernel
    # must not see; optim.recover refits the BVH after each step
    pos0 = scene_gt.geometry.positions + 2.0
    scene_p = dataclasses.replace(
        scene_gt, geometry=dataclasses.replace(scene_gt.geometry, positions=pos0))
    moved, pos_losses = optim.recover(scene_p, cam, opts, target,
                                      fields=("positions",), steps=2,
                                      learning_rate=0.1, seed=0)
    shift = float(np.abs(np.asarray(moved.geometry.positions - pos0)).max())
    if not np.isfinite(pos_losses).all() or not shift > 0:
        raise AssertionError(f"positions steps: losses {pos_losses}, shift {shift}")
    return {"losses": losses, "positions_losses": pos_losses,
            "positions_max_shift": shift}


def phase_card_tests(tt):
    import pytest

    os.environ["TERRA_TEST_PLATFORM"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu_smoke.py")])
    if rc != 0:
        raise AssertionError(f"card-marked tests failed (pytest rc {int(rc)})")
    return {"pytest_rc": int(rc)}


def _image_close(acc, ref, label):
    """Sharded vs one-card film: rtol 1e-5 (fp32 sample sums reordered by
    the mesh), with an absolute floor of 1e-5 of the mean magnitude for
    values near zero. Returns the largest absolute difference."""
    np.testing.assert_allclose(acc, ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).mean()), err_msg=label)
    return float(np.abs(acc - ref).max())


def phase_four_cards(tt):
    """Sharded render on meshes (4,1) and (2,2) and one sharded train step
    on (2,2), each against the same work on one card."""
    import jax

    devs = jax.devices()
    if len(devs) < 4 or devs[0].platform != "gpu":
        raise RuntimeError(f"need 4 GPUs, found {len(devs)} {devs[0].platform}")
    return sharded_checks(tt, devs[:4], tt.scenes.courtyard(),
                          bench.courtyard_render_opts(tt))


def sharded_checks(tt, devs, scene, opts):
    """The four-card comparisons on ``devs``. Tolerances: fp32 sums over
    the sample axis are reordered by the mesh."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import optax
    from terra_tpu import optim
    from terra_tpu.ops import rng as rng_mod
    from terra_tpu.parallel.mesh import make_mesh, render_sharded

    out = {}
    cam = tt.scenes.courtyard_camera()
    one = np.asarray(tt.render(scene, cam, opts, seed=4).acc)
    for shape in ((4, 1), (2, 2)):
        t0 = time.perf_counter()
        film = render_sharded(scene, cam, opts, make_mesh(shape, devs), seed=4)
        acc = np.asarray(film.acc)
        name = f"render_{shape[0]}x{shape[1]}"
        out[f"{name}_s"] = time.perf_counter() - t0
        out[f"{name}_max_abs_diff"] = _image_close(acc, one, f"mesh {shape}")

    scene_gt = tt.scenes.cornell_box(accelerator=tt.Accelerator.BVH)
    ccam = tt.scenes.cornell_camera()
    copts = tt.RenderOptions(width=64, height=64, samples_per_pixel=8,
                             bounces=2, integrator=tt.Integrator.DIRECT,
                             accelerator=tt.Accelerator.BVH)
    key = jnp.array(rng_mod.key_from_seed(0), jnp.uint32)
    target = jax.jit(lambda: optim.render_mean_image(
        scene_gt, ccam, copts, key, jnp.int32(0), 32))()
    attrs0 = scene_gt.materials.attrs.at[0, 0, :].set(jnp.asarray([0.3, 0.5, 0.6]))
    scene0 = dataclasses.replace(
        scene_gt, materials=dataclasses.replace(scene_gt.materials, attrs=attrs0))
    params = optim.extract_params(scene0, ("attrs",))
    loss_fn = optim.make_loss_fn(ccam, copts, target)
    loss1, g1 = jax.jit(jax.value_and_grad(loss_fn))(params, scene0, key, jnp.int32(0))
    mesh = make_mesh((2, 2), devs)
    loss4, g4 = optim.make_grad_fn_sharded(ccam, copts, target, mesh)(
        params, scene0, key, jnp.int32(0))
    np.testing.assert_allclose(float(loss4), float(loss1), rtol=1e-5)
    for k in g1:
        np.testing.assert_allclose(np.asarray(g4[k]), np.asarray(g1[k]), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(np.asarray(g1[k])).max()),
                                   err_msg=f"grad {k}")
    optimizer = optax.adam(1e-2)
    state = optim.TrainState(params, optimizer.init(params), jnp.int32(0))
    step = optim.make_train_step_sharded(ccam, copts, target, optimizer, mesh)
    _, loss_step = step(state, scene0, key)
    np.testing.assert_allclose(float(loss_step), float(loss1), rtol=1e-5)
    out.update(loss_one=float(loss1), loss_sharded=float(loss4),
               loss_step=float(loss_step))
    return out


PHASES = {
    "device": phase_device,
    "gate": phase_gate,
    "oracle": phase_oracle,
    "main_path": phase_main_path,
    "inverse": phase_inverse,
    "card_tests": phase_card_tests,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded phase on 4 GPUs")
    ap.add_argument("--only", default="",
                    help="comma-separated one-card phases to run (debugging)")
    args = ap.parse_args(argv)

    import jax

    import terra_tpu as tt
    from terra_tpu import compile_cache

    compile_cache.enable()
    if args.four_cards:
        names = ["four_cards"]
        phases = {"four_cards": phase_four_cards}
    else:
        names = [p for p in args.only.split(",") if p] or list(PHASES)
        unknown = set(names) - set(PHASES)
        if unknown:
            ap.error(f"unknown phases {sorted(unknown)}")
        if names[0] != "device":
            names.insert(0, "device")
        phases = PHASES
    ok = True
    for name in names:
        t0 = time.perf_counter()
        try:
            info = phases[name](tt)
            passed = True
        except Exception as e:  # report every phase; fail at the end
            traceback.print_exc()
            info = {"error": f"{type(e).__name__}: {e}"[:2000]}
            passed = False
        _print({"phase": name, "ok": passed,
                "seconds": time.perf_counter() - t0, **info})
        ok = ok and passed
        if name == "device" and not passed:
            break
    if not ok:
        return 1
    print(bench.card(), flush=True)
    dev = jax.devices()[0]
    _print({"ok": True, "device": {"platform": dev.platform,
                                   "kind": dev.device_kind,
                                   "count": len(jax.devices())}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
