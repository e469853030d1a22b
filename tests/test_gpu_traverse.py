"""The GPU traversal's CPU-testable parts: the kernel's NumPy twin and the
XLA walk against brute force, the packed tables, the platform dispatch,
the wrapper's ray order, and the stop-gradient seam.

The CUDA kernel itself runs only on a card (tests/test_gpu_smoke.py);
``traverse_twin`` runs its exact algorithm over the same packed tables and
is injected through ``gpu_traverse.raycast(impl=...)`` (the ``twin_impl``
fixture in conftest.py) or in place of ``gpu_traverse.ffi_impl`` (the
``twin_kernel`` fixture).
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import terra_tpu as tt
from terra_tpu import intersect
from terra_tpu.accel import gpu_traverse, traverse as xla_traverse
from terra_tpu.testing import traverse_twin

render_mod = importlib.import_module("terra_tpu.render")


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = jnp.asarray(rng.uniform(-2, 2, (n, 3)).astype(np.float32))
    d_ = rng.normal(size=(n, 3)).astype(np.float32)
    d = jnp.asarray(d_ / np.linalg.norm(d_, axis=-1, keepdims=True))
    t_max = jnp.asarray(rng.uniform(0.05, 3.0, (n,)).astype(np.float32))
    return o, d, t_max


@functools.lru_cache(maxsize=None)
def _case(tris, algo):
    """Scene, rays and the brute-force reference, shared by the cases."""
    scene = tt.scenes.random_triangles(tris, seed=tris, accelerator=tt.Accelerator.BVH)
    o, d, t_max = _rays(1024, seed=tris + 1)
    ref = intersect.raycast_brute(o, d, *scene.geometry.corners(), algo=algo)
    return scene, o, d, t_max, ref


@pytest.mark.parametrize("impl", ["xla_walk", "twin"])
@pytest.mark.parametrize("algo", ["mt", "watertight"])
@pytest.mark.parametrize("mode", ["closest", "ranged", "any_hit"])
@pytest.mark.parametrize("tris", [33, 700, 3000])
def test_traversal_matches_brute(tris, mode, algo, impl, twin_impl):
    """Both traversals, all three query modes and both leaf tests agree
    with the brute-force sweep: closest hit (t, and tri but for fp ties),
    ranged and any-hit occlusion (hit means brute t < t_max)."""
    scene, o, d, t_max, ref = _case(tris, algo)
    if impl == "twin":
        fn = functools.partial(gpu_traverse.raycast, impl=twin_impl)
    else:
        fn = xla_traverse.raycast
    kw = {} if mode == "closest" else {"t_max": t_max, "any_hit": mode == "any_hit"}
    hit = fn(scene, o, d, algo=algo, **kw)
    if mode == "closest":
        np.testing.assert_array_equal(np.asarray(hit.hit), np.asarray(ref.hit))
        both = np.asarray(ref.hit)
        np.testing.assert_allclose(np.asarray(hit.t)[both], np.asarray(ref.t)[both],
                                   rtol=1e-4)
        same = np.asarray(hit.tri)[both] == np.asarray(ref.tri)[both]
        assert same.mean() > 0.99  # fp ties on shared edges may differ
    else:
        expect = np.asarray(ref.t) < np.asarray(t_max)
        np.testing.assert_array_equal(np.asarray(hit.hit), expect)


@pytest.mark.parametrize("tris", [3, 47, 333, 4097])
def test_pack_layout(tris):
    """Packed tables: node words and child boxes mirror the binary tree,
    leaves partition the triangle records without padding, and each
    leaf's records are exactly its triangles."""
    scene = tt.scenes.random_triangles(tris, seed=tris, accelerator=tt.Accelerator.BVH)
    bvh = scene.bvh
    p = gpu_traverse.pack(bvh, *scene.geometry.corners())
    ni = bvh.num_internal
    leaves = np.asarray(p.leaves)
    ids = np.asarray(p.tris)[:, 9].copy().view(np.int32)
    assert leaves[:, 1].sum() == tris
    np.testing.assert_array_equal(leaves[:, 0], np.cumsum(leaves[:, 1]) - leaves[:, 1])
    np.testing.assert_array_equal(np.sort(ids), np.arange(tris))
    leaf_tri = np.asarray(bvh.leaf_tri)
    for j in range(bvh.num_leaves):
        s, c = leaves[j]
        assert set(ids[s:s + c].tolist()) == set(leaf_tri[j].tolist())
    a, b, c3 = (np.asarray(x) for x in scene.geometry.corners())
    rec = np.asarray(p.tris)
    np.testing.assert_array_equal(rec[:, 0:3], a[ids])
    np.testing.assert_array_equal(rec[:, 3:6], b[ids])
    np.testing.assert_array_equal(rec[:, 6:9], c3[ids])
    if ni == 0:
        assert p.root == ~0
        return
    assert p.root == 0
    nodes = np.asarray(p.nodes)
    words = nodes[:, 12:14].copy().view(np.int32)
    left, right = np.asarray(bvh.node_left), np.asarray(bvh.node_right)
    for child, w in ((left, words[:, 0]), (right, words[:, 1])):
        np.testing.assert_array_equal(w, np.where(child < ni, child, ~(child - ni)))
    bmin, bmax = np.asarray(bvh.node_min), np.asarray(bvh.node_max)
    np.testing.assert_array_equal(nodes[:, [0, 2, 8]], bmin[left])
    np.testing.assert_array_equal(nodes[:, [1, 3, 9]], bmax[left])
    np.testing.assert_array_equal(nodes[:, [4, 6, 10]], bmin[right])
    np.testing.assert_array_equal(nodes[:, [5, 7, 11]], bmax[right])


@pytest.mark.parametrize("row,count", [([3, 4, 5, 6], 4), ([3, 4, 4, 4], 2),
                                       ([9, 9, 9, 9], 1), ([2, 7, 1, 1], 3)])
def test_leaf_counts_end_at_padding(row, count):
    """Builders pad a leaf by repeating its last triangle; the count ends
    at the first repeat."""
    counts = gpu_traverse.leaf_counts(jnp.asarray([row], jnp.int32))
    assert int(counts[0]) == count


def test_tri_records_keep_int32_ids_above_2_24():
    """Triangle ids ride as int32 bits, exact far beyond f32's 2^24."""
    ids = jnp.asarray([0, (1 << 24) + 1, (1 << 24) + 3, (1 << 31) - 1], jnp.int32)
    z = jnp.zeros((4, 3), jnp.float32)
    rec = np.asarray(gpu_traverse.tri_records(z, z, z, ids))
    np.testing.assert_array_equal(rec[:, 9].copy().view(np.int32), np.asarray(ids))
    assert float(np.float32((1 << 24) + 1)) != (1 << 24) + 1  # f32 would not


def test_twin_returns_int32_ids_above_2_24(twin_impl):
    """Through the traversal: the id of the hit record comes back exact."""
    scene, o, d, _, ref = _case(700, "mt")
    p = gpu_traverse.pack(scene.bvh, *scene.geometry.corners())
    big = 1 << 24
    ids = jax.lax.bitcast_convert_type(p.tris[:, 9], jnp.int32)
    tris = p.tris.at[:, 9].set(jax.lax.bitcast_convert_type(ids + big, jnp.float32))
    best_t, best_i = twin_impl(p._replace(tris=tris), o, d,
                               jnp.full((o.shape[0],), intersect.T_FAR), False, False)
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(np.asarray(best_i)[hit] - big, np.asarray(ref.tri)[hit])


@pytest.fixture
def twin_kernel(monkeypatch, twin_impl):
    """Renders on this host take the GPU path (``bvh_traversal("gpu")``,
    tables packed inside the trace) with the twin in place of the CUDA
    kernel."""
    gpu_path = render_mod.bvh_traversal
    monkeypatch.setattr(gpu_traverse, "ffi_impl", twin_impl)
    monkeypatch.setattr(render_mod, "bvh_traversal",
                        lambda platform, sc: gpu_path("gpu", sc))
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("platform", ["gpu", "cpu", "rocm", "METAL"])
def test_bvh_traversal_dispatch(platform, monkeypatch, twin_impl):
    """gpu -> the CUDA kernel (tables packed once; the twin stands in for
    it here), cpu -> the XLA walk with its parent-hit leaf table, anything
    else raises naming the platform."""
    scene, o, d, _, ref = _case(700, "mt")
    if platform == "gpu":
        monkeypatch.setattr(gpu_traverse, "ffi_impl", twin_impl)
        fn = render_mod.bvh_traversal(platform, scene)
        hit = fn(scene, o, d, algo="mt", sort_hint=jnp.where(ref.hit, ref.tri, -1))
        np.testing.assert_array_equal(np.asarray(hit.hit), np.asarray(ref.hit))
    elif platform == "cpu":
        fn = render_mod.bvh_traversal(platform, scene)
        assert fn.func is xla_traverse.raycast
        np.testing.assert_array_equal(
            np.asarray(fn.keywords["leaf_of_tri"]),
            np.asarray(xla_traverse.leaf_of_tri_table(scene.bvh)))
    else:
        with pytest.raises(ValueError, match=platform):
            render_mod.bvh_traversal(platform, scene)


@pytest.mark.parametrize("n", [1, 127, 1000, 4097])
def test_wrapper_reordering_is_invisible(n, twin_impl):
    """The wrapper hands the kernel the rays in the order given and returns
    each ray its own result at any batch size: closest and ranged answers
    agree with brute force, and a batch split in two answers as the whole."""
    scene = tt.scenes.random_triangles(900, seed=44, accelerator=tt.Accelerator.BVH)
    o, d, t_max = _rays(n, seed=n)
    ref = intersect.raycast_brute(o, d, *scene.geometry.corners())
    k = max(n // 2, 1)
    for kw in ({}, {"t_max": t_max}):
        whole = gpu_traverse.raycast(scene, o, d, impl=twin_impl, **kw)
        expect = np.asarray(ref.hit) if not kw else np.asarray(ref.t) < np.asarray(t_max)
        np.testing.assert_array_equal(np.asarray(whole.hit), expect)
        if n == 1:
            continue
        halves = [gpu_traverse.raycast(scene, o[s], d[s], impl=twin_impl,
                                       **{key: v[s] for key, v in kw.items()})
                  for s in (slice(0, k), slice(k, n))]
        for field in ("t", "tri", "hit"):
            np.testing.assert_array_equal(
                np.asarray(getattr(whole, field)),
                np.concatenate([np.asarray(getattr(h, field)) for h in halves]))


def test_wrapper_parent_hit_keys(twin_kernel):
    """The wavefront passes the GPU path parent-hit ids (``sort_hint``);
    the kernel takes rays in the order given, so the hint changes nothing."""
    scene, o, d, _, ref = _case(3000, "mt")
    fn = render_mod.bvh_traversal("gpu", scene)
    hint = jnp.where(ref.hit, ref.tri, -1)
    a = fn(scene, o, d, sort_hint=hint)
    b = fn(scene, o, d)
    for x, y in ((a.t, b.t), (a.tri, b.tri), (a.hit, b.hit)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_wrapper_refuses_trees_deeper_than_the_stack(twin_impl):
    scene, o, d, _, _ = _case(33, "mt")
    deep = dataclasses.replace(scene, bvh=dataclasses.replace(
        scene.bvh, depth=gpu_traverse.STACK_SIZE + 1))
    with pytest.raises(ValueError, match="stack"):
        gpu_traverse.raycast(deep, o, d, impl=twin_impl)


def _loss(scene, cam, opts, fields):
    from terra_tpu import optim
    from terra_tpu.ops import rng as rng_mod

    key = jnp.array(rng_mod.key_from_seed(3), jnp.uint32)
    target = jnp.full((opts.height, opts.width, 3), 0.2, jnp.float32)
    loss_fn = optim.make_loss_fn(cam, opts, target)
    params = optim.extract_params(scene, fields)
    return loss_fn, params, key


@pytest.mark.parametrize("field", ["attrs", "positions"])
def test_grad_crosses_the_kernel_seam(field, request):
    """jax.grad through a BVH render on the GPU path (twin in place of the
    kernel): no tangent reaches the kernel, not even through the packed
    tables when vertex positions are optimized, and the gradient equals
    the XLA walk's."""
    scene = tt.scenes.cornell_box(accelerator=tt.Accelerator.BVH)
    cam = tt.scenes.cornell_camera()
    opts = tt.RenderOptions(width=8, height=8, samples_per_pixel=2, bounces=2,
                            integrator=tt.Integrator.DIRECT,
                            accelerator=tt.Accelerator.BVH)
    loss_fn, params, key = _loss(scene, cam, opts, (field,))
    grad = jax.jit(jax.value_and_grad(loss_fn))
    loss_x, g_x = grad(params, scene, key, jnp.int32(0))
    request.getfixturevalue("twin_kernel")
    loss_k, g_k = grad(params, scene, key, jnp.int32(0))
    assert np.isfinite(float(loss_k))
    np.testing.assert_allclose(float(loss_k), float(loss_x), rtol=1e-5)
    g_k, g_x = np.asarray(g_k[field]), np.asarray(g_x[field])
    np.testing.assert_allclose(g_k, g_x, rtol=1e-4, atol=1e-5 * np.abs(g_x).max())
    assert np.abs(g_k).max() > 0


@pytest.mark.parametrize("field", ["attrs", "positions"])
def test_train_step_through_the_kernel_seam(field, twin_kernel):
    """optim.make_train_step traces and runs with the GPU path's
    stop-gradient seam inside the loss."""
    import optax

    from terra_tpu import optim

    scene = tt.scenes.cornell_box(accelerator=tt.Accelerator.BVH)
    cam = tt.scenes.cornell_camera()
    opts = tt.RenderOptions(width=8, height=8, samples_per_pixel=2, bounces=1,
                            integrator=tt.Integrator.DIRECT,
                            accelerator=tt.Accelerator.BVH)
    _, params, key = _loss(scene, cam, opts, (field,))
    optimizer = optax.adam(1e-2)
    step = optim.make_train_step(cam, opts, jnp.zeros((8, 8, 3)), optimizer)
    state = optim.TrainState(params, optimizer.init(params), jnp.int32(0))
    state, loss = step(state, scene, key)
    assert np.isfinite(float(loss)) and int(state.step) == 1
    assert not np.array_equal(np.asarray(state.params[field]), np.asarray(params[field]))


def test_twin_single_leaf_tree():
    """A tree that is one leaf (root word ~0) is walked by the twin."""
    from terra_tpu.accel import lbvh

    scene = tt.scenes.random_triangles(lbvh.DEFAULT_LEAF_SIZE, seed=5,
                                       accelerator=tt.Accelerator.BVH)
    assert scene.bvh.num_internal == 0
    p = gpu_traverse.pack(scene.bvh, *scene.geometry.corners())
    o, d, _ = _rays(256, seed=9)
    t, i = traverse_twin.traverse(p.nodes, p.leaves, p.tris, o, d,
                                  np.full(256, intersect.T_FAR, np.float32), p.root)
    ref = intersect.raycast_brute(o, d, *scene.geometry.corners())
    np.testing.assert_array_equal(t < intersect.T_FAR, np.asarray(ref.hit))
