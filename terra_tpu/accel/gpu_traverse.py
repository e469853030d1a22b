"""Per-ray BVH traversal on NVIDIA Hopper: a CUDA kernel called through
``jax.ffi``.

The kernel (``cuda/bvh_traverse.cu``) walks one ray per thread with an
ordered short stack over the binary SAH tree of :mod:`.lbvh`: near child
first, best-t pruning, node and triangle records read through the
read-only cache. It answers the three queries the wavefront issues:
closest hit, ranged (``t_max`` seeds the best t: NEE shadow rays) and any
hit (stop at the first hit below ``t_max``), with either leaf test
(Moller-Trumbore or Wald 2013 watertight, ``RenderOptions.intersector``).

This module owns what surrounds the kernel, in Python the CPU tests reach:
the packed tables (:func:`pack`) and the stop-gradient seam. ``testing/traverse_twin.py`` is the NumPy twin of the
kernel's exact algorithm over the same tables; tests inject it through
``raycast(..., impl=...)``.

The shared library is compiled with ``nvcc`` from the ``.cu`` sources
next to this file at first use, into ``cuda/_build/`` (gitignored), keyed
by a hash of the sources. A failed build or load raises: there is no
fallback traversal on the GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..intersect import RayHit, T_FAR

__all__ = ["Packed", "pack", "raycast", "build_library", "STACK_SIZE"]

STACK_SIZE = 64  # kStack in bvh_traverse.cu
TARGET = "terra_bvh_traverse"
NVCC_ARCH = "arch=compute_90a,code=sm_90a"

_CUDA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda")
_BUILD_DIR = os.path.join(_CUDA_DIR, "_build")
_lock = threading.Lock()
_registered = False


class Packed(NamedTuple):
    """Device tables the kernel reads (layout in bvh_traverse.cu)."""

    nodes: jax.Array   # (max(ni, 1), 16) f32
    leaves: jax.Array  # (C, 2) i32: first record, record count
    tris: jax.Array    # (T, 12) f32: corners + int32 id bits
    root: int          # 0, or ~0 when the whole tree is one leaf


def _bits_f32(x):
    return jax.lax.bitcast_convert_type(x.astype(jnp.int32), jnp.float32)


def leaf_counts(leaf_tri):
    """Real triangles per padded leaf: builders pad a leaf by repeating its
    last triangle, so the count ends at the first repeat."""
    size = leaf_tri.shape[1]
    if size == 1:
        return jnp.ones((leaf_tri.shape[0],), jnp.int32)
    dup = leaf_tri[:, 1:] == leaf_tri[:, :-1]
    return jnp.where(jnp.any(dup, axis=1), jnp.argmax(dup, axis=1) + 1,
                     size).astype(jnp.int32)


def tri_records(a, b, c, ids):
    """(T, 12) f32 triangle records: corners and the int32 id's bits."""
    zero = jnp.zeros_like(ids, jnp.float32)
    return jnp.stack([a[:, 0], a[:, 1], a[:, 2], b[:, 0],
                      b[:, 1], b[:, 2], c[:, 0], c[:, 1],
                      c[:, 2], _bits_f32(ids), zero, zero], axis=1)


def pack(bvh, tri_a, tri_b, tri_c) -> Packed:
    """Kernel tables from the binary tree (jit-traceable, so refit and
    per-step vertex edits repack for free). Leaves are compacted: record k
    of leaf j is ``tris[leaves[j, 0] + k]`` for k < ``leaves[j, 1]``."""
    ni = bvh.num_internal
    leaf_tri = bvh.leaf_tri
    size = leaf_tri.shape[1]
    t = tri_a.shape[0]
    counts = leaf_counts(leaf_tri)
    starts = jnp.cumsum(counts) - counts
    slot = starts[:, None] + jnp.arange(size, dtype=jnp.int32)[None, :]
    slot = jnp.where(jnp.arange(size)[None, :] < counts[:, None], slot, t)
    ids = jnp.zeros((t,), jnp.int32).at[slot.reshape(-1)].set(
        leaf_tri.reshape(-1), mode="drop")
    tris = tri_records(tri_a[ids], tri_b[ids], tri_c[ids], ids)
    leaves = jnp.stack([starts, counts], axis=1).astype(jnp.int32)
    if ni == 0:
        return Packed(jnp.zeros((1, 16), jnp.float32), leaves, tris, ~0)

    def word(child):
        return jnp.where(child < ni, child, ~(child - ni))

    left, right = bvh.node_left, bvh.node_right
    lmin, lmax = bvh.node_min[left], bvh.node_max[left]
    rmin, rmax = bvh.node_min[right], bvh.node_max[right]
    zero = jnp.zeros((ni,), jnp.float32)
    nodes = jnp.stack([
        lmin[:, 0], lmax[:, 0], lmin[:, 1], lmax[:, 1],
        rmin[:, 0], rmax[:, 0], rmin[:, 1], rmax[:, 1],
        lmin[:, 2], lmax[:, 2], rmin[:, 2], rmax[:, 2],
        _bits_f32(word(left)), _bits_f32(word(right)), zero, zero,
    ], axis=1)
    return Packed(nodes, leaves, tris, 0)


def _sources():
    return sorted(os.path.join(_CUDA_DIR, f) for f in os.listdir(_CUDA_DIR)
                  if f.endswith((".cu", ".h")))


def library_path() -> str:
    """Build output for the current sources (hash-keyed file name)."""
    h = hashlib.sha256(NVCC_ARCH.encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libterra_cuda_{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compile the CUDA sources once (no-op when the hash-keyed library
    exists). Raises with nvcc's output on failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, "-gencode", NVCC_ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-I", jax.ffi.include_dir(), "-o", tmp,
           *[s for s in _sources() if s.endswith(".cu")]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run nvcc ({nvcc}): {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _register():
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(build_library())
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.TerraBvhTraverse), platform="CUDA")
        _registered = True


def ffi_impl(packed: Packed, o, d, t_init, any_hit: bool, watertight: bool):
    """The CUDA kernel: (N,) best t and (N,) int32 triangle id."""
    _register()
    n = o.shape[0]
    call = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((n,), jnp.float32),
         jax.ShapeDtypeStruct((n,), jnp.int32)))
    return call(packed.nodes, packed.leaves, packed.tris, o, d, t_init,
                root=np.int32(packed.root), any_hit=np.int32(any_hit),
                watertight=np.int32(watertight))


def raycast(scene, o, d, algo: str = "mt", t_max=None, any_hit: bool = False,
            packed: Packed | None = None, impl=None) -> RayHit:
    """Closest-hit (or ranged / any-hit with ``t_max``) BVH raycast.

    The kernel takes the rays in the order given: a coherence sort before
    it cost more than it saved on every ray class (PERF.md), since the
    tables sit in L2. ``impl`` defaults to the CUDA kernel (``ffi_impl``).

    The kernel has no differentiation rule: every input, the packed tables
    included (they carry vertex tangents when positions are optimized), is
    stop-gradiented, and differentiable hit attributes are recomputed in
    ``surface.py``.
    """
    bvh = scene.bvh
    if bvh.depth > STACK_SIZE:
        raise ValueError(f"BVH depth {bvh.depth} exceeds the kernel's "
                         f"stack of {STACK_SIZE}")
    if packed is None:
        packed = pack(bvh, *scene.geometry.corners())
    sg = jax.lax.stop_gradient
    packed = packed._replace(nodes=sg(packed.nodes), leaves=sg(packed.leaves),
                             tris=sg(packed.tris))
    o = sg(o).astype(jnp.float32)
    d = sg(d).astype(jnp.float32)
    if t_max is None:
        t_init = jnp.full((o.shape[0],), T_FAR, jnp.float32)
    else:
        t_init = sg(t_max).astype(jnp.float32)
    best_t, best_i = (impl or ffi_impl)(packed, o, d, t_init, bool(any_hit),
                                        algo == "watertight")
    hit = best_t < (T_FAR if t_max is None else t_max)
    return RayHit(
        t=sg(best_t),
        tri=sg(jnp.where(hit, best_i, 0)),
        hit=hit,
    )
