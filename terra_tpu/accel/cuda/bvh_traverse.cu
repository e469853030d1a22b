// Per-ray BVH traversal for NVIDIA Hopper, called from JAX through the XLA
// foreign function interface (terra_tpu/accel/gpu_traverse.py).
//
// One thread walks one ray with an ordered short stack (the Aila-Laine
// while-while loop): the inner loop descends internal nodes, visiting the
// nearer hit child first and pushing the farther one with its entry
// distance; the outer loop tests a leaf's triangles and pops. Popped
// entries whose entry distance is no longer below the best hit are
// skipped (best-t pruning). Node and triangle records are read through
// the read-only data cache (__ldg).
//
// Layout (built by gpu_traverse.pack; testing/traverse_twin.py is the
// NumPy twin of this exact algorithm):
//   nodes  (ni, 16) f32: float4 (L.minx, L.maxx, L.miny, L.maxy),
//          float4 (R.minx, R.maxx, R.miny, R.maxy),
//          float4 (L.minz, L.maxz, R.minz, R.maxz),
//          float4 (left word, right word, 0, 0) with the words' int32 bits;
//          a word >= 0 is an internal node, ~leaf_id a leaf.
//   leaves (C, 2) i32: (first record, record count) of each leaf.
//   tris   (T, 12) f32: float4 (ax, ay, az, bx), float4 (by, bz, cx, cy),
//          float4 (cz, triangle id bits, 0, 0); ids are int32.
//
// Query modes: closest hit (t_init = T_FAR), ranged (t_init = t_max seeds
// the best t), any hit (stop at the first hit below t_init).
#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kStack = 64;   // gpu_traverse.STACK_SIZE; depth checked at trace
constexpr int kBlock = 128;
constexpr int kDone = INT32_MIN;  // no ~leaf word takes this value
constexpr float kEps = 1e-4f;     // intersect.py's epsilon

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Moller-Trumbore, the arithmetic of intersect.mt_components.
__device__ __forceinline__ bool mt_hit(const Ray& r, float ax, float ay,
                                       float az, float bx, float by, float bz,
                                       float cx, float cy, float cz, float* t) {
  const float e1x = bx - ax, e1y = by - ay, e1z = bz - az;
  const float e2x = cx - ax, e2y = cy - ay, e2z = cz - az;
  const float hx = r.dy * e2z - r.dz * e2y;
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * hx + e1y * hy + e1z * hz;
  if (!(fabsf(det) > kEps)) return false;
  const float inv = 1.0f / det;
  const float sx = r.ox - ax, sy = r.oy - ay, sz = r.oz - az;
  const float u = inv * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = inv * (r.dx * qx + r.dy * qy + r.dz * qz);
  const float tt = inv * (e2x * qx + e2y * qy + e2z * qz);
  *t = tt;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && tt > kEps;
}

// Per-ray constants of the Wald 2013 watertight test
// (intersect.watertight_components): axis permutation and shear.
struct Shear {
  int kz;       // 0: x is the major axis, 1: y, 2: z
  bool swap;    // swap kx/ky to keep the winding
  float sx, sy, sz;
};

__device__ __forceinline__ void permute(const Shear& s, float vx, float vy,
                                        float vz, float* px, float* py,
                                        float* pz) {
  float a, b, c;
  if (s.kz == 0) {
    a = vy; b = vz; c = vx;
  } else if (s.kz == 1) {
    a = vz; b = vx; c = vy;
  } else {
    a = vx; b = vy; c = vz;
  }
  *px = s.swap ? b : a;
  *py = s.swap ? a : b;
  *pz = c;
}

__device__ __forceinline__ Shear make_shear(const Ray& r) {
  Shear s;
  const float adx = fabsf(r.dx), ady = fabsf(r.dy), adz = fabsf(r.dz);
  const bool m0 = adx >= ady && adx >= adz;
  const bool m1 = !m0 && ady >= adz;
  s.kz = m0 ? 0 : (m1 ? 1 : 2);
  s.swap = false;
  float dpx, dpy, dpz;
  permute(s, r.dx, r.dy, r.dz, &dpx, &dpy, &dpz);
  s.swap = dpz < 0.0f;
  if (s.swap) {
    const float tmp = dpx;
    dpx = dpy;
    dpy = tmp;
  }
  s.sz = 1.0f / (dpz != 0.0f ? dpz : 1.0f);
  s.sx = dpx * s.sz;
  s.sy = dpy * s.sz;
  return s;
}

// p1*p2 - q1*q2 from separately rounded products, snapped to 0 within a
// few ulps of full cancellation (intersect.watertight_components' dop).
__device__ __forceinline__ float dop(float p1, float p2, float q1, float q2) {
  const float p = __fmul_rn(p1, p2);
  const float q = __fmul_rn(q1, q2);
  const float r = __fsub_rn(p, q);
  return fabsf(r) <= fmaxf(fabsf(p), fabsf(q)) * 4e-7f ? 0.0f : r;
}

__device__ __forceinline__ bool watertight_hit(const Ray& r, const Shear& s,
                                               float ax, float ay, float az,
                                               float bx, float by, float bz,
                                               float cx, float cy, float cz,
                                               float* t) {
  float a0, a1, a2, b0, b1, b2, c0, c1, c2;
  permute(s, ax - r.ox, ay - r.oy, az - r.oz, &a0, &a1, &a2);
  permute(s, bx - r.ox, by - r.oy, bz - r.oz, &b0, &b1, &b2);
  permute(s, cx - r.ox, cy - r.oy, cz - r.oz, &c0, &c1, &c2);
  a0 -= s.sx * a2; a1 -= s.sy * a2;
  b0 -= s.sx * b2; b1 -= s.sy * b2;
  c0 -= s.sx * c2; c1 -= s.sy * c2;
  const float u = dop(c0, b1, c1, b0);
  const float v = dop(a0, c1, a1, c0);
  const float w = dop(b0, a1, b1, a0);
  const bool any_neg = u < 0.0f || v < 0.0f || w < 0.0f;
  const bool any_pos = u > 0.0f || v > 0.0f || w > 0.0f;
  const float det = u + v + w;
  const float t_scaled = (u * a2 + v * b2 + w * c2) * s.sz;
  const float tt = t_scaled / (det != 0.0f ? det : 1.0f);
  *t = tt;
  return !(any_neg && any_pos) && det != 0.0f && tt > kEps;
}

// Slab test with >= so that flat boxes (axis-aligned walls) are hit.
__device__ __forceinline__ bool slab(const Ray& r, float lox, float hix,
                                     float loy, float hiy, float loz,
                                     float hiz, float best_t, float* t_entry) {
  const float x0 = (lox - r.ox) * r.ix, x1 = (hix - r.ox) * r.ix;
  const float y0 = (loy - r.oy) * r.iy, y1 = (hiy - r.oy) * r.iy;
  const float z0 = (loz - r.oz) * r.iz, z1 = (hiz - r.oz) * r.iz;
  const float tmin = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1));
  const float tmax = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
  *t_entry = tmin;
  return tmax >= fmaxf(tmin, 0.0f) && tmin < best_t;
}

__device__ __forceinline__ float safe_inv(float v) {
  return fabsf(v) > 1e-12f ? 1.0f / v : 1e12f;
}

template <bool kWatertight, bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
traverse_kernel(const float4* __restrict__ nodes, const int2* __restrict__ leaves,
                const float4* __restrict__ tris, const float* __restrict__ orig,
                const float* __restrict__ dir, const float* __restrict__ t_init,
                float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                int64_t n, int32_t root) {
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  Ray r;
  r.ox = orig[3 * i]; r.oy = orig[3 * i + 1]; r.oz = orig[3 * i + 2];
  r.dx = dir[3 * i]; r.dy = dir[3 * i + 1]; r.dz = dir[3 * i + 2];
  r.ix = safe_inv(r.dx); r.iy = safe_inv(r.dy); r.iz = safe_inv(r.dz);
  Shear sh;
  if (kWatertight) sh = make_shear(r);

  float best_t = t_init[i];
  int32_t best_i = 0;
  int32_t stack[kStack];
  float stack_t[kStack];
  int sp = 0;
  int32_t cur = root;

  for (;;) {
    // inner loop: descend internal nodes until a leaf (or nothing) is next
    while (cur >= 0) {
      const float4* nd = nodes + 4 * (int64_t)cur;
      const float4 n0 = __ldg(nd), n1 = __ldg(nd + 1), n2 = __ldg(nd + 2);
      const float4 n3 = __ldg(nd + 3);
      float tl, tr;
      const bool hl = slab(r, n0.x, n0.y, n0.z, n0.w, n2.x, n2.y, best_t, &tl);
      const bool hr = slab(r, n1.x, n1.y, n1.z, n1.w, n2.z, n2.w, best_t, &tr);
      const int32_t lw = __float_as_int(n3.x), rw = __float_as_int(n3.y);
      if (hl && hr) {
        const bool left_first = tl <= tr;
        stack[sp] = left_first ? rw : lw;
        stack_t[sp] = left_first ? tr : tl;
        ++sp;
        cur = left_first ? lw : rw;
      } else if (hl) {
        cur = lw;
      } else if (hr) {
        cur = rw;
      } else {
        cur = kDone;
        while (sp > 0) {
          --sp;
          if (stack_t[sp] < best_t) { cur = stack[sp]; break; }
        }
        if (cur == kDone) break;
      }
    }
    if (cur == kDone) break;

    // leaf: test its triangles
    const int2 range = __ldg(leaves + ~cur);
    bool stop = false;
    for (int64_t k = range.x; k < (int64_t)range.x + range.y; ++k) {
      const float4* tp = tris + 3 * k;
      const float4 p0 = __ldg(tp), p1 = __ldg(tp + 1), p2 = __ldg(tp + 2);
      float t;
      const bool ok = kWatertight
          ? watertight_hit(r, sh, p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z,
                           p1.w, p2.x, &t)
          : mt_hit(r, p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w, p2.x,
                   &t);
      if (ok && t < best_t) {
        best_t = t;
        best_i = __float_as_int(p2.y);
        if (kAnyHit) { stop = true; break; }
      }
    }
    if (stop) break;
    cur = kDone;
    while (sp > 0) {
      --sp;
      if (stack_t[sp] < best_t) { cur = stack[sp]; break; }
    }
    if (cur == kDone) break;
  }
  t_out[i] = best_t;
  tri_out[i] = best_i;
}

template <bool kWatertight, bool kAnyHit>
void launch(cudaStream_t stream, const float* nodes, const int32_t* leaves,
            const float* tris, const float* orig, const float* dir,
            const float* t_init, float* t_out, int32_t* tri_out, int64_t n,
            int32_t root) {
  const int64_t grid = (n + kBlock - 1) / kBlock;
  traverse_kernel<kWatertight, kAnyHit><<<(unsigned)grid, kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const int2*>(leaves),
      reinterpret_cast<const float4*>(tris), orig, dir, t_init, t_out, tri_out,
      n, root);
}

ffi::Error TraverseImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes,
                        ffi::Buffer<ffi::S32> leaves, ffi::Buffer<ffi::F32> tris,
                        ffi::Buffer<ffi::F32> orig, ffi::Buffer<ffi::F32> dir,
                        ffi::Buffer<ffi::F32> t_init,
                        ffi::ResultBuffer<ffi::F32> t_out,
                        ffi::ResultBuffer<ffi::S32> tri_out, int32_t root,
                        int32_t any_hit, int32_t watertight) {
  const int64_t n = (int64_t)t_init.element_count();
  if ((int64_t)orig.element_count() != 3 * n ||
      (int64_t)dir.element_count() != 3 * n ||
      (int64_t)t_out->element_count() != n ||
      (int64_t)tri_out->element_count() != n) {
    return ffi::Error::InvalidArgument("ray arrays must be (N, 3), (N, 3), (N,)");
  }
  if (nodes.element_count() % 16 != 0 || leaves.element_count() % 2 != 0 ||
      tris.element_count() % 12 != 0) {
    return ffi::Error::InvalidArgument("tables must be (ni, 16), (C, 2), (T, 12)");
  }
  if (n == 0) return ffi::Error::Success();
  using Launch = void (*)(cudaStream_t, const float*, const int32_t*,
                          const float*, const float*, const float*,
                          const float*, float*, int32_t*, int64_t, int32_t);
  const Launch variants[2][2] = {
      {launch<false, false>, launch<false, true>},
      {launch<true, false>, launch<true, true>}};
  variants[watertight != 0][any_hit != 0](
      stream, nodes.typed_data(), leaves.typed_data(), tris.typed_data(),
      orig.typed_data(), dir.typed_data(), t_init.typed_data(),
      t_out->typed_data(), tri_out->typed_data(), n, root);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("terra_bvh_traverse launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(TerraBvhTraverse, TraverseImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // nodes
                                  .Arg<ffi::Buffer<ffi::S32>>()  // leaves
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tris
                                  .Arg<ffi::Buffer<ffi::F32>>()  // origins
                                  .Arg<ffi::Buffer<ffi::F32>>()  // directions
                                  .Arg<ffi::Buffer<ffi::F32>>()  // t_init
                                  .Ret<ffi::Buffer<ffi::F32>>()  // t
                                  .Ret<ffi::Buffer<ffi::S32>>()  // tri id
                                  .Attr<int32_t>("root")
                                  .Attr<int32_t>("any_hit")
                                  .Attr<int32_t>("watertight"));
