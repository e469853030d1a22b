"""Native host-side kernels (C++ via ctypes) with transparent fallback.

The reference keeps its entire builder/runtime in C (/root/reference/src/);
this package keeps device compute in XLA (and one CUDA kernel) but the
host-side scene build hot paths (LBVH construction, OBJ number crunching) are native C++:

  * compiled lazily with g++ on first use (cached as _terra_native.so next
    to the source),
  * every entry point has a NumPy fallback, so the package works without a
    toolchain (``TERRA_TPU_NO_NATIVE=1`` forces the fallback).
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional

import numpy as np

log = logging.getLogger("terra_tpu")

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "terra_native.cpp")
_LIB = os.path.join(_DIR, "_terra_native.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("TERRA_TPU_NO_NATIVE"):
        return None
    try:
        if (not os.path.exists(_LIB)) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", _LIB, _SRC],
                check=True, capture_output=True, timeout=120,
            )
        lib = ctypes.CDLL(_LIB)
        lib.terra_lbvh_build.restype = ctypes.c_int
        lib.terra_sah_build.restype = ctypes.c_int
        lib.terra_obj_count.restype = ctypes.c_int
        lib.terra_obj_parse.restype = ctypes.c_int
        _lib = lib
    except Exception as e:  # missing g++, sandbox, etc. -> numpy fallback
        log.debug("native kernels unavailable (%s); using NumPy fallback", e)
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def lbvh_build(positions: np.ndarray, tri_vidx: np.ndarray, leaf_size: int):
    """Native LBVH build; returns a dict of arrays matching accel.lbvh.LBVH
    or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    positions = np.ascontiguousarray(positions, np.float32)
    tri_vidx = np.ascontiguousarray(tri_vidx, np.int32)
    t = len(tri_vidx)
    c = (t + leaf_size - 1) // leaf_size
    ni = c - 1
    leaf_tri = np.zeros((c, leaf_size), np.int32)
    left = np.zeros((max(ni, 0),), np.int32)
    right = np.zeros((max(ni, 0),), np.int32)
    box_min = np.zeros((ni + c, 3), np.float32)
    box_max = np.zeros((ni + c, 3), np.float32)
    dfs_next = np.zeros((ni + c,), np.int32)
    dfs_skip = np.zeros((ni + c,), np.int32)
    tri_order = np.zeros((t,), np.int32)
    rc = lib.terra_lbvh_build(
        _ptr(positions, ctypes.c_float), ctypes.c_int64(len(positions)),
        _ptr(tri_vidx, ctypes.c_int32), ctypes.c_int64(t),
        ctypes.c_int(leaf_size),
        _ptr(leaf_tri, ctypes.c_int32),
        _ptr(left, ctypes.c_int32), _ptr(right, ctypes.c_int32),
        _ptr(box_min, ctypes.c_float), _ptr(box_max, ctypes.c_float),
        _ptr(dfs_next, ctypes.c_int32), _ptr(dfs_skip, ctypes.c_int32),
        _ptr(tri_order, ctypes.c_int32),
    )
    if rc != 0:
        return None
    return dict(
        leaf_tri=leaf_tri, left=left, right=right,
        box_min=box_min, box_max=box_max,
        dfs_next=dfs_next, dfs_skip=dfs_skip, tri_order=tri_order,
        num_leaves=c,
    )


def sah_build(positions: np.ndarray, tri_vidx: np.ndarray, leaf_size: int):
    """Native binned-SAH build (16 bins x 3 axes, uniform padded leaves in
    [leaf_size/2, leaf_size]). Returns the accel.lbvh.LBVH array dict (with
    the data-dependent actual leaf count) or None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    positions = np.ascontiguousarray(positions, np.float32)
    tri_vidx = np.ascontiguousarray(tri_vidx, np.int32)
    t = len(tri_vidx)
    c_max = max(2 * ((t + leaf_size - 1) // leaf_size), 1)
    nn_max = 2 * c_max - 1
    leaf_tri = np.zeros((c_max, leaf_size), np.int32)
    left = np.zeros((c_max - 1 or 1,), np.int32)
    right = np.zeros((c_max - 1 or 1,), np.int32)
    box_min = np.zeros((nn_max, 3), np.float32)
    box_max = np.zeros((nn_max, 3), np.float32)
    dfs_next = np.zeros((nn_max,), np.int32)
    dfs_skip = np.zeros((nn_max,), np.int32)
    tri_order = np.zeros((t,), np.int32)
    num_leaves = ctypes.c_int64()
    rc = lib.terra_sah_build(
        _ptr(positions, ctypes.c_float), ctypes.c_int64(len(positions)),
        _ptr(tri_vidx, ctypes.c_int32), ctypes.c_int64(t),
        ctypes.c_int(leaf_size),
        _ptr(leaf_tri, ctypes.c_int32),
        _ptr(left, ctypes.c_int32), _ptr(right, ctypes.c_int32),
        _ptr(box_min, ctypes.c_float), _ptr(box_max, ctypes.c_float),
        _ptr(dfs_next, ctypes.c_int32), _ptr(dfs_skip, ctypes.c_int32),
        _ptr(tri_order, ctypes.c_int32),
        ctypes.byref(num_leaves),
    )
    if rc != 0:
        return None
    c = int(num_leaves.value)
    ni = c - 1
    return dict(
        leaf_tri=leaf_tri[:c], left=left[:max(ni, 0)], right=right[:max(ni, 0)],
        box_min=box_min[:ni + c], box_max=box_max[:ni + c],
        dfs_next=dfs_next[:ni + c], dfs_skip=dfs_skip[:ni + c],
        tri_order=tri_order, num_leaves=c,
    )


def obj_parse(text: bytes):
    """Native OBJ numeric parse. Returns (verts, norms, uvs, face_idx,
    face_line) or None when unavailable. face_idx: (F, 3, 3) int32
    (v, vt, vn per corner, -1 where absent); face_line: source line per
    output triangle (for Python-side usemtl/object association)."""
    lib = _load()
    if lib is None:
        return None
    if isinstance(text, str):
        text = text.encode("utf-8", errors="replace")
    n = len(text)
    buf = ctypes.create_string_buffer(text, n)
    nv = ctypes.c_int64()
    nn = ctypes.c_int64()
    nt = ctypes.c_int64()
    nf = ctypes.c_int64()
    if lib.terra_obj_count(buf, ctypes.c_int64(n), ctypes.byref(nv), ctypes.byref(nn), ctypes.byref(nt), ctypes.byref(nf)) != 0:
        return None
    verts = np.zeros((nv.value, 3), np.float32)
    norms = np.zeros((nn.value, 3), np.float32)
    uvs = np.zeros((nt.value, 2), np.float32)
    face_idx = np.zeros((nf.value, 3, 3), np.int32)
    face_line = np.zeros((nf.value,), np.int32)
    rc = lib.terra_obj_parse(
        buf, ctypes.c_int64(n),
        _ptr(verts, ctypes.c_float), _ptr(norms, ctypes.c_float), _ptr(uvs, ctypes.c_float),
        _ptr(face_idx, ctypes.c_int32), _ptr(face_line, ctypes.c_int32),
    )
    if rc != 0:
        return None
    return verts, norms, uvs, face_idx, face_line
