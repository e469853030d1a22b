"""Compiled-kernel gates that need an NVIDIA GPU.

The regular suite runs on the CPU, where the CUDA traversal kernel cannot
run (it has no interpret mode; its NumPy twin is tested in
tests/test_gpu_traverse.py). These tests check the compiled kernel itself
on the card:

    TERRA_TEST_PLATFORM=gpu python -m pytest -m gpu tests/test_gpu_smoke.py -q

``python chip_smoke.py`` runs them as its last phase. Every test is marked
``gpu``; whether a card is present is decided in the ``gpu`` fixture at
run time, never at import.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import terra_tpu as tt

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (TERRA_TEST_PLATFORM=gpu on a CUDA host)")
    return jax.devices()[0]


def _random_rays(scene, n, seed):
    rng = np.random.default_rng(seed)
    lo = np.asarray(scene.bvh.node_min[0])
    hi = np.asarray(scene.bvh.node_max[0])
    o = jnp.asarray(lo + rng.random((n, 3), np.float32) * (hi - lo))
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return o, jnp.asarray(v / np.linalg.norm(v, axis=1, keepdims=True))


@pytest.mark.parametrize("algo", ["mt", "watertight"])
def test_compiled_kernel_random_rays_match_brute(gpu, algo):
    """Compiled closest hit on uniform-random rays vs brute force (random
    rays are what caught the flat-box bug: camera rays never see walls
    edge-on)."""
    from terra_tpu import intersect
    from terra_tpu.render import bvh_traversal

    scene = tt.scenes.courtyard()
    o, d = _random_rays(scene, 4096, seed=3)
    hit_k = jax.jit(lambda sc, o, d: bvh_traversal("gpu", sc)(
        sc, o, d, algo=algo))(scene, o, d)
    hit_b = jax.jit(lambda sc, o, d: intersect.raycast_brute(
        o, d, *sc.geometry.corners(), algo=algo))(scene, o, d)
    hk, hb = np.asarray(hit_k.hit), np.asarray(hit_b.hit)
    assert (hk != hb).sum() <= 1, f"{int((hk != hb).sum())}/4096 hit mismatches"
    both = hk & hb
    np.testing.assert_allclose(np.asarray(hit_k.t)[both], np.asarray(hit_b.t)[both],
                               rtol=1e-4, atol=1e-4)


def test_compiled_kernel_ranged_and_any_hit(gpu):
    """Ranged and any-hit occlusion on the card agree with the brute
    closest hit compared against t_max."""
    from terra_tpu import intersect
    from terra_tpu.accel import gpu_traverse

    scene = tt.scenes.random_triangles(3000, seed=77, accelerator=tt.Accelerator.BVH)
    o, d = _random_rays(scene, 4096, seed=5)
    t_max = jnp.asarray(np.random.default_rng(6).uniform(0.05, 3.0, 4096)
                        .astype(np.float32))
    ref = intersect.raycast_brute(o, d, *scene.geometry.corners())
    expect = np.asarray(ref.t) < np.asarray(t_max)
    for any_hit in (False, True):
        occ = jax.jit(lambda sc, o, d, tm: gpu_traverse.raycast(
            sc, o, d, t_max=tm, any_hit=any_hit))(scene, o, d, t_max)
        np.testing.assert_array_equal(np.asarray(occ.hit), expect)


def test_library_built_from_tracked_sources(gpu):
    """The kernel library is compiled from the repo's .cu sources into the
    gitignored, hash-keyed build directory."""
    import os

    from terra_tpu.accel import gpu_traverse

    path = gpu_traverse.build_library()
    assert os.path.exists(path)
    assert os.path.basename(os.path.dirname(path)) == "_build"
    assert path == gpu_traverse.library_path()


def test_compiled_bvh_render_matches_oracle(gpu):
    """One small BVH render end to end through the compiled kernel vs the
    NumPy oracle (the golden comparison, on the card)."""
    from terra_tpu.testing import mirror

    scene = tt.scenes.cornell_box(accelerator=tt.Accelerator.BVH)
    cam = tt.scenes.cornell_camera()
    opts = tt.RenderOptions(width=16, height=16, samples_per_pixel=8,
                            bounces=2, integrator=tt.Integrator.DIRECT,
                            accelerator=tt.Accelerator.BVH)
    film = tt.render(scene, cam, opts, seed=23)
    img_jax = np.asarray(film.mean())
    img_np = mirror.render_mirror(scene, cam, opts, seed=23)
    rel = np.abs(img_jax - img_np) / np.maximum(np.abs(img_np), 1e-2)
    assert (rel > 2e-3).mean() <= 1.2e-2
    assert abs(img_jax.mean() - img_np.mean()) / max(img_np.mean(), 1e-6) < 5e-3
