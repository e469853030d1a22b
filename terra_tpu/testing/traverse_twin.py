"""NumPy twin of the CUDA BVH traversal kernel (accel/cuda/bvh_traverse.cu).

The kernel has no interpret mode, so its algorithm is kept testable here:
the same ordered short stack (near child first, far child pushed with its
entry distance, popped entries skipped once they cannot beat the best t),
the same leaf loop and the same closest / ranged / any-hit rules, over the
same packed tables (``gpu_traverse.pack``). Rays are independent, so the
twin advances every live ray by one node or leaf visit per iteration
(vectorized over rays); each ray makes exactly the kernel's decisions.

No JAX imports: like ``mirror.py`` this is an independent oracle.
"""
from __future__ import annotations

import numpy as np

__all__ = ["traverse", "mt_hit", "watertight_hit", "DONE"]

EPS = np.float32(1e-4)
DONE = np.int32(np.iinfo(np.int32).min)
STACK_SIZE = 64


def _f32(x):
    return np.asarray(x, np.float32)


def mt_hit(o, d, a, b, c):
    """Moller-Trumbore over (k, 3) rays/triangles -> (valid, t)."""
    e1 = b - a
    e2 = c - a
    h = np.stack([d[:, 1] * e2[:, 2] - d[:, 2] * e2[:, 1],
                  d[:, 2] * e2[:, 0] - d[:, 0] * e2[:, 2],
                  d[:, 0] * e2[:, 1] - d[:, 1] * e2[:, 0]], axis=1)
    det = e1[:, 0] * h[:, 0] + e1[:, 1] * h[:, 1] + e1[:, 2] * h[:, 2]
    ok = np.abs(det) > EPS
    inv = np.float32(1.0) / np.where(ok, det, np.float32(1.0))
    s = o - a
    u = inv * (s[:, 0] * h[:, 0] + s[:, 1] * h[:, 1] + s[:, 2] * h[:, 2])
    q = np.stack([s[:, 1] * e1[:, 2] - s[:, 2] * e1[:, 1],
                  s[:, 2] * e1[:, 0] - s[:, 0] * e1[:, 2],
                  s[:, 0] * e1[:, 1] - s[:, 1] * e1[:, 0]], axis=1)
    v = inv * (d[:, 0] * q[:, 0] + d[:, 1] * q[:, 1] + d[:, 2] * q[:, 2])
    t = inv * (e2[:, 0] * q[:, 0] + e2[:, 1] * q[:, 1] + e2[:, 2] * q[:, 2])
    return ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > EPS), t


def _permute(kz, swap, v):
    """(k, 3) -> (px, py, pz) with kz the major axis, kx/ky swapped where
    ``swap`` (the kernel's permute)."""
    pz = np.choose(kz, [v[:, 0], v[:, 1], v[:, 2]])
    a = np.choose(kz, [v[:, 1], v[:, 2], v[:, 0]])
    b = np.choose(kz, [v[:, 2], v[:, 0], v[:, 1]])
    return np.where(swap, b, a), np.where(swap, a, b), pz


def _dop(p1, p2, q1, q2):
    p = p1 * p2
    q = q1 * q2
    r = p - q
    return np.where(np.abs(r) <= np.maximum(np.abs(p), np.abs(q)) * np.float32(4e-7),
                    np.float32(0.0), r)


def watertight_hit(o, d, a, b, c):
    """Wald 2013 watertight test over (k, 3) rays/triangles -> (valid, t)."""
    ad = np.abs(d)
    m0 = (ad[:, 0] >= ad[:, 1]) & (ad[:, 0] >= ad[:, 2])
    m1 = ~m0 & (ad[:, 1] >= ad[:, 2])
    kz = np.where(m0, 0, np.where(m1, 1, 2))
    no_swap = np.zeros(len(d), bool)
    dpx, dpy, dpz = _permute(kz, no_swap, d)
    swap = dpz < 0
    dpx, dpy = np.where(swap, dpy, dpx), np.where(swap, dpx, dpy)
    sz = np.float32(1.0) / np.where(dpz != 0, dpz, np.float32(1.0))
    sx = dpx * sz
    sy = dpy * sz

    def shear(p):
        px, py, pz = _permute(kz, swap, p - o)
        return px - sx * pz, py - sy * pz, pz

    a0, a1, a2 = shear(a)
    b0, b1, b2 = shear(b)
    c0, c1, c2 = shear(c)
    u = _dop(c0, b1, c1, b0)
    v = _dop(a0, c1, a1, c0)
    w = _dop(b0, a1, b1, a0)
    neg = (u < 0) | (v < 0) | (w < 0)
    pos = (u > 0) | (v > 0) | (w > 0)
    det = u + v + w
    t = (u * a2 + v * b2 + w * c2) * sz / np.where(det != 0, det, np.float32(1.0))
    return ~(neg & pos) & (det != 0) & (t > EPS), t


def _slab(o, inv, lo, hi, best_t):
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tmin = np.minimum(t0, t1).max(axis=1)
    tmax = np.maximum(t0, t1).min(axis=1)
    return (tmax >= np.maximum(tmin, 0)) & (tmin < best_t), tmin


def traverse(nodes, leaves, tris, o, d, t_init, root: int,
             any_hit: bool = False, watertight: bool = False):
    """Run the kernel's algorithm. Tables as ``gpu_traverse.Packed``;
    o, d: (N, 3); t_init: (N,). Returns (best_t f32, best_id i32)."""
    nodes = _f32(nodes)
    leaves = np.asarray(leaves, np.int32)
    tris = _f32(tris)
    o = _f32(o)
    d = _f32(d)
    words = nodes[:, 12:14].copy().view(np.int32)
    tri_ids = tris[:, 9].copy().view(np.int32)
    n = o.shape[0]
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        inv = np.where(np.abs(d) > 1e-12, np.float32(1.0) / d, np.float32(1e12))
    best_t = _f32(t_init).copy()
    best_i = np.zeros(n, np.int32)
    cur = np.full(n, root, np.int32)
    sp = np.zeros(n, np.int64)
    stack = np.zeros((n, STACK_SIZE), np.int32)
    stack_t = np.zeros((n, STACK_SIZE), np.float32)
    test = watertight_hit if watertight else mt_hit

    def pop(idx):
        """Pop until an entry can still beat the best t (else DONE)."""
        cur[idx] = DONE
        todo = idx
        while len(todo):
            todo = todo[sp[todo] > 0]
            sp[todo] -= 1
            e = stack[todo, sp[todo]]
            ok = stack_t[todo, sp[todo]] < best_t[todo]
            cur[todo[ok]] = e[ok]
            todo = todo[~ok]

    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        while True:
            inner = np.nonzero(cur >= 0)[0]
            at_leaf = np.nonzero((cur < 0) & (cur != DONE))[0]
            if not len(inner) and not len(at_leaf):
                break
            if len(inner):
                rec = nodes[cur[inner]]
                oi, ii, bt = o[inner], inv[inner], best_t[inner]
                hl, tl = _slab(oi, ii, rec[:, [0, 2, 8]], rec[:, [1, 3, 9]], bt)
                hr, tr = _slab(oi, ii, rec[:, [4, 6, 10]], rec[:, [5, 7, 11]], bt)
                lw, rw = words[cur[inner], 0], words[cur[inner], 1]
                both = hl & hr
                left_first = tl <= tr
                b = inner[both]
                if np.any(sp[b] >= STACK_SIZE):
                    raise OverflowError("traversal stack overflow")
                stack[b, sp[b]] = np.where(left_first, rw, lw)[both]
                stack_t[b, sp[b]] = np.where(left_first, tr, tl)[both]
                sp[b] += 1
                nxt = np.where(both, np.where(left_first, lw, rw),
                               np.where(hl, lw, rw))
                go = hl | hr
                cur[inner[go]] = nxt[go]
                pop(inner[~go])
            if len(at_leaf):
                rng = leaves[~cur[at_leaf]]
                stopped = np.zeros(len(at_leaf), bool)
                for k in range(int(rng[:, 1].max(initial=0))):
                    m = (k < rng[:, 1]) & ~stopped
                    if not m.any():
                        break
                    rays = at_leaf[m]
                    rec = tris[rng[m, 0] + k]
                    ok, t = test(o[rays], d[rays], rec[:, 0:3], rec[:, 3:6],
                                 rec[:, 6:9])
                    take = ok & (t < best_t[rays])
                    best_t[rays[take]] = t[take]
                    best_i[rays[take]] = tri_ids[rng[m, 0] + k][take]
                    if any_hit:
                        stopped[np.nonzero(m)[0][take]] = True
                cur[at_leaf[stopped]] = DONE
                pop(at_leaf[~stopped])
    return best_t, best_i
