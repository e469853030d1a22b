"""BVH build validity + XLA walk vs brute force (SURVEY.md §4a)."""
import numpy as np
import jax.numpy as jnp
import pytest

import terra_tpu as tt
from terra_tpu import intersect
from terra_tpu.accel import lbvh, traverse


@pytest.fixture(scope="module", params=[47, 333, 4097])
def built(request):
    scene = tt.scenes.random_triangles(request.param, seed=request.param, accelerator=tt.Accelerator.BVH)
    return scene


def test_build_covers_all_triangles(built):
    bvh = built.bvh
    t = built.geometry.num_triangles
    covered = set(np.asarray(bvh.leaf_tri).reshape(-1).tolist())
    assert covered == set(range(t))


def test_build_child_boxes_contained(built):
    bvh = built.bvh
    ni = bvh.num_internal
    bmin = np.asarray(bvh.node_min)
    bmax = np.asarray(bvh.node_max)
    left = np.asarray(bvh.node_left)
    right = np.asarray(bvh.node_right)
    assert (bmin <= bmax + 1e-6).all()
    for ch in (left, right):
        assert (bmin[:ni] <= bmin[ch] + 1e-5).all()
        assert (bmax[:ni] >= bmax[ch] - 1e-5).all()


def test_every_leaf_reachable(built):
    """Walk the tree host-side; every leaf id must be visited exactly once."""
    bvh = built.bvh
    ni = bvh.num_internal
    left = np.asarray(bvh.node_left)
    right = np.asarray(bvh.node_right)
    seen_leaves = []
    seen_internal = set()
    stack = [ni if ni == 0 else 0]
    while stack:
        node = stack.pop()
        if node >= ni and ni > 0 or (ni == 0 and node == 0):
            if ni == 0:
                seen_leaves.append(0)
                continue
            seen_leaves.append(node - ni)
            continue
        assert node not in seen_internal, "cycle in BVH"
        seen_internal.add(node)
        stack.append(int(left[node]))
        stack.append(int(right[node]))
    assert sorted(seen_leaves) == list(range(bvh.num_leaves))


def test_traversal_matches_brute(built):
    scene = built
    rng = np.random.default_rng(9)
    n = 1024
    o = jnp.asarray(rng.uniform(-2, 2, (n, 3)).astype(np.float32))
    d_ = rng.normal(size=(n, 3)).astype(np.float32)
    d = jnp.asarray(d_ / np.linalg.norm(d_, axis=-1, keepdims=True))

    hit_bvh = traverse.raycast(scene, o, d)
    tri_a, tri_b, tri_c = scene.geometry.corners()
    hit_ref = intersect.raycast_brute(o, d, tri_a, tri_b, tri_c)

    h1 = np.asarray(hit_bvh.hit)
    h2 = np.asarray(hit_ref.hit)
    np.testing.assert_array_equal(h1, h2)
    t1 = np.asarray(hit_bvh.t)[h1]
    t2 = np.asarray(hit_ref.t)[h1]
    np.testing.assert_allclose(t1, t2, rtol=1e-4)
    # triangles may differ only on fp-tie duplicates
    same = np.asarray(hit_bvh.tri)[h1] == np.asarray(hit_ref.tri)[h1]
    assert same.mean() > 0.99


def test_refit_tracks_moved_vertices():
    scene = tt.scenes.random_triangles(100, seed=3, accelerator=tt.Accelerator.BVH)
    import dataclasses

    moved_geom = dataclasses.replace(
        scene.geometry, positions=scene.geometry.positions + 10.0
    )
    bvh2 = lbvh.refit(scene.bvh, moved_geom)
    np.testing.assert_allclose(
        np.asarray(bvh2.node_min), np.asarray(scene.bvh.node_min) + 10.0, atol=1e-4
    )
    # traversal against the moved geometry stays correct
    scene2 = dataclasses.replace(scene, geometry=moved_geom, bvh=bvh2)
    rng = np.random.default_rng(5)
    o = jnp.asarray(rng.uniform(8, 12, (256, 3)).astype(np.float32))
    d_ = rng.normal(size=(256, 3)).astype(np.float32)
    d = jnp.asarray(d_ / np.linalg.norm(d_, axis=-1, keepdims=True))
    hit_bvh = traverse.raycast(scene2, o, d)
    tri_a, tri_b, tri_c = scene2.geometry.corners()
    hit_ref = intersect.raycast_brute(o, d, tri_a, tri_b, tri_c)
    np.testing.assert_array_equal(np.asarray(hit_bvh.hit), np.asarray(hit_ref.hit))


def test_render_with_bvh_matches_brute():
    """Full Cornell render through the BVH accelerator == brute force."""
    scene_bvh = tt.scenes.cornell_box(accelerator=tt.Accelerator.BVH)
    scene_brt = tt.scenes.cornell_box(accelerator=tt.Accelerator.BRUTE)
    cam = tt.scenes.cornell_camera()
    opts = tt.RenderOptions(width=16, height=16, samples_per_pixel=4, bounces=2,
                            integrator=tt.Integrator.DIRECT)
    img_bvh = np.asarray(tt.render(scene_bvh, cam, opts.replace(accelerator=tt.Accelerator.BVH), seed=2).mean())
    img_brt = np.asarray(tt.render(scene_brt, cam, opts, seed=2).mean())
    rel = np.abs(img_bvh - img_brt) / np.maximum(np.abs(img_brt), 1e-2)
    assert (rel > 1e-3).mean() < 5e-3


def test_xla_any_hit_occlusion_matches_ranged():
    """any_hit=True occlusion booleans equal the ranged closest-hit booleans
    (the early-out may only change WHICH hit terminates a lane, never
    whether one exists within t_max)."""
    scene = tt.scenes.random_triangles(900, seed=5, accelerator=tt.Accelerator.BVH)
    rng = np.random.default_rng(7)
    n = 2048
    o = jnp.asarray(rng.uniform(-2, 2, (n, 3)).astype(np.float32))
    d_ = rng.normal(size=(n, 3)).astype(np.float32)
    d = jnp.asarray(d_ / np.linalg.norm(d_, axis=-1, keepdims=True))
    tm = jnp.asarray(rng.uniform(0.3, 3.0, (n,)).astype(np.float32))
    occ_a = traverse.raycast(scene, o, d, t_max=tm, any_hit=True)
    occ_c = traverse.raycast(scene, o, d, t_max=tm)
    np.testing.assert_array_equal(np.asarray(occ_a.hit), np.asarray(occ_c.hit))


@pytest.mark.parametrize("impl", ["xla_walk", "gpu_twin"])
def test_flat_box_walls_are_hit(impl, twin_impl):
    """Axis-aligned coplanar geometry collapses its BVH boxes to zero
    extent on one axis; every ray through such a box has tmin == tmax, so
    the slab test must accept equality (regression: whole courtyard walls
    were invisible to the BVH paths — 41/2048 random rays on the 242k
    scene). Checked for the XLA walk and the GPU kernel's twin."""
    import functools

    import terra_tpu.scenes as scenes
    from terra_tpu.accel import gpu_traverse

    # a grid of coplanar triangles in the x=0 plane (one flat wall)
    tris = []
    for i in range(8):
        for j in range(8):
            y0, z0 = i * 0.25, j * 0.25
            a = [0.0, y0, z0]
            b = [0.0, y0 + 0.25, z0]
            c = [0.0, y0, z0 + 0.25]
            d = [0.0, y0 + 0.25, z0 + 0.25]
            tris.append([a, b, c])
            tris.append([d, c, b])
    n = len(tris)
    geom = scenes.make_geometry(tris, np.zeros(n, np.int32), np.zeros(n, np.int32))
    from terra_tpu.scene import MaterialTable, commit
    import jax.numpy as jnp2
    materials = MaterialTable(
        bsdf_type=jnp2.zeros((1,), jnp2.int32),
        attrs=jnp2.full((1, 8, 3), 0.5, jnp2.float32),
        attr_tex=jnp2.full((1, 8), -1, jnp2.int32),
        emissive=jnp2.zeros((1, 3), jnp2.float32),
        emissive_tex=jnp2.full((1,), -1, jnp2.int32),
        ior=jnp2.full((1,), 1.5, jnp2.float32),
    )
    scene = commit(geom, materials, accelerator=tt.Accelerator.BVH)
    rng = np.random.default_rng(3)
    m = 512
    o = np.stack([np.full(m, -1.0), rng.uniform(0.2, 1.8, m), rng.uniform(0.2, 1.8, m)],
                 axis=1).astype(np.float32)
    d = np.stack([np.ones(m), rng.uniform(-0.05, 0.05, m), rng.uniform(-0.05, 0.05, m)],
                 axis=1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = jnp.asarray(o); d = jnp.asarray(d)
    ta, tb_, tc = scene.geometry.corners()
    hit_b = intersect.raycast_brute(o, d, ta, tb_, tc)
    if impl == "gpu_twin":
        fn = functools.partial(gpu_traverse.raycast, impl=twin_impl)
    else:
        fn = traverse.raycast
    hit = fn(scene, o, d)
    np.testing.assert_array_equal(np.asarray(hit.hit), np.asarray(hit_b.hit))
    assert np.asarray(hit_b.hit).mean() > 0.9  # nearly all rays cross the wall
