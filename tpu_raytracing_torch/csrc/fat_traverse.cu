// K6: fat wide-BVH traversal, one thread per ray, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_raytracing/ops/pallas_traverse.py:_kernel
// (line 71), which walks one 128-ray packet per program over FatWideBVH rows
// (bvh/wide.py:build_wide_fat), with its scalar stack in SMEM and one
// 768-byte row DMA per pop.
//
// What it computes (per ray, rays in the order given), from wide row 0:
//   * a row is 256 int32 words (pad_rows_256): 8 entries of (lo xyz, hi xyz,
//     meta, pad) in words 0..63, then entry e's packed pair (v0..v3 xyz,
//     prim0, prim1, rot0, rot1) in words 64 + 16 e .. 79 + 16 e. meta =
//     child << 5 | count << 2 | type.
//   * slab test of every entry with the safe inverse direction (components
//     below 1e-30 clamped to +-1e-30): back >= front, front <= t and
//     back >= tmin.
//   * a Tri entry the box test accepts: Möller-Trumbore on (v0, v1, v2),
//     then, if count > 0, on (v2, v1, v3); each accepts tt <= t, so on an
//     equal t the later test wins; tri = child << 1 (+1 for the second),
//     prim = prim0 (prim1).
//   * Box entries the box test accepts are sorted by the 19-comparator
//     network of the TPU kernel, by the ray's own entry distance,
//     descending, the higher child id nearer on a tie, and pushed far to
//     near, so the nearest pops first.
//   * a push beyond stack_cap sets *overflow and stops the ray; the TPU
//     kernel drops the push without a word.
//
// What bounds it: each pop is a dependent load of one row, whose address
// comes from the previous pop, so the kernel is latency bound on those
// loads; the 8 slab tests and the triangle tests come second.
//
// How the simple design stands to that: one thread per ray with a private
// stack in local memory. A pop reads the 64 node words as 16-byte vectors
// and a Tri entry's 16 pair words only when this ray's box test accepts it;
// the TPU DMA'd the whole row per pop. Latency is hidden by occupancy and
// the read-only cache; the callers hand in screen tiles and leaf-sorted
// bounce rays, so the threads of a warp tend to read the same rows. No
// shared-memory staging yet.
//
// Bit-exactness: compiled with -fmad=false and without fast math, and every
// expression keeps the order of the plain PyTorch version
// (tpu_raytracing_torch/ops/fat_traverse.py:trace_fat_plain), so the two
// agree bit for bit on hit, t, prim, tri, u and v.

#include <cuda_runtime.h>

namespace {

constexpr int kWide = 8;
constexpr int kRowVec = 256 / 4;  // int4 per row
constexpr int kMaxStack = 160;
constexpr int kThreads = 128;
constexpr float kF32Max = 3.402823466e+38f;
constexpr float kTriEps = 1e-9f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin;
};

// Möller-Trumbore; true if accepted, with (tt, uu, vv).
__device__ __forceinline__ bool moller_trumbore(
    const Ray& r, float t, float a0, float a1, float a2, float b0, float b1, float b2,
    float c0, float c1, float c2, float& tt, float& uu, float& vv) {
  const float e1x = b0 - a0, e1y = b1 - a1, e1z = b2 - a2;
  const float e2x = c0 - a0, e2y = c1 - a1, e2z = c2 - a2;
  const float hx = r.dy * e2z - r.dz * e2y;
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * hx + e1y * hy + e1z * hz;
  const bool degen = (det > -kTriEps) && (det < kTriEps);
  const float f = 1.0f / det;
  const float sx = r.ox - a0, sy = r.oy - a1, sz = r.oz - a2;
  uu = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  vv = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  tt = f * (e2x * qx + e2y * qy + e2z * qz);
  return !degen && (uu >= 0.0f) && (uu <= 1.0f) && (vv >= 0.0f) && (uu + vv <= 1.0f) &&
         (tt >= r.tmin) && (tt <= t);
}

__device__ __forceinline__ float safe_inverse(float d) {
  const float s = fabsf(d) < 1e-30f ? (d < 0.0f ? -1e-30f : 1e-30f) : d;
  return 1.0f / s;
}

// One comparator of the push network: after it, slot a holds the farther
// candidate (the lower child id on a distance tie).
__device__ __forceinline__ void compare_swap(float* cd, int* cc, int a, int b) {
  const bool swap = (cd[a] < cd[b]) || ((cd[a] == cd[b]) && (cc[a] > cc[b]));
  const float da = swap ? cd[b] : cd[a];
  const float db = swap ? cd[a] : cd[b];
  const int ca = swap ? cc[b] : cc[a];
  const int cb = swap ? cc[a] : cc[b];
  cd[a] = da;
  cd[b] = db;
  cc[a] = ca;
  cc[b] = cb;
}

__global__ void __launch_bounds__(kThreads)
fat_traverse_kernel(const int4* __restrict__ rows, const float* __restrict__ origin,
                    const float* __restrict__ dir, const float* __restrict__ tmin,
                    const float* __restrict__ tmax, int* __restrict__ hit_out,
                    float* __restrict__ t_out, int* __restrict__ prim_out,
                    int* __restrict__ tri_out, float* __restrict__ u_out,
                    float* __restrict__ v_out, int* __restrict__ overflow, int num_rays,
                    int stack_cap) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= num_rays) return;
  Ray r;
  r.ox = origin[3 * ray + 0];
  r.oy = origin[3 * ray + 1];
  r.oz = origin[3 * ray + 2];
  r.dx = dir[3 * ray + 0];
  r.dy = dir[3 * ray + 1];
  r.dz = dir[3 * ray + 2];
  r.tmin = tmin[ray];
  const float invx = safe_inverse(r.dx), invy = safe_inverse(r.dy), invz = safe_inverse(r.dz);
  float t = tmax[ray];
  int hit = 0, prim = 0, tri = 0;
  float u = 0.0f, v = 0.0f;

  int stack[kMaxStack];
  int sp = 0;
  stack[sp++] = 0;  // root: wide row 0
  while (sp > 0) {
    const int4* row = rows + static_cast<size_t>(stack[--sp]) * kRowVec;
    float cd[kWide];
    int cc[kWide];
#pragma unroll
    for (int e = 0; e < kWide; ++e) {
      const int4 a = __ldg(row + 2 * e);
      const int4 b = __ldg(row + 2 * e + 1);
      const int meta = b.z;
      const int ntype = meta & 3;
      const int child = meta >> 5;
      const int ccount = (meta >> 2) & 7;
      const float tx0 = (__int_as_float(a.x) - r.ox) * invx;
      const float ty0 = (__int_as_float(a.y) - r.oy) * invy;
      const float tz0 = (__int_as_float(a.z) - r.oz) * invz;
      const float tx1 = (__int_as_float(a.w) - r.ox) * invx;
      const float ty1 = (__int_as_float(b.x) - r.oy) * invy;
      const float tz1 = (__int_as_float(b.y) - r.oz) * invz;
      const float front = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
      const float back = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
      const bool box_hit = (back >= front) && (front <= t) && (back >= r.tmin);
      if (box_hit && ntype == 2) {
        const int4* p = row + 16 + 4 * e;
        const int4 q0 = __ldg(p), q1 = __ldg(p + 1), q2 = __ldg(p + 2), q3 = __ldg(p + 3);
        const float ax = __int_as_float(q0.x), ay = __int_as_float(q0.y), az = __int_as_float(q0.z);
        const float bx = __int_as_float(q0.w), by = __int_as_float(q1.x), bz = __int_as_float(q1.y);
        const float cx = __int_as_float(q1.z), cy = __int_as_float(q1.w), cz = __int_as_float(q2.x);
        const float qx = __int_as_float(q2.y), qy = __int_as_float(q2.z), qz = __int_as_float(q2.w);
        float tt, uu, vv;
        if (moller_trumbore(r, t, ax, ay, az, bx, by, bz, cx, cy, cz, tt, uu, vv)) {
          t = tt;
          hit = 1;
          prim = q3.x;
          tri = child << 1;
          u = uu;
          v = vv;
        }
        if (ccount > 0 && moller_trumbore(r, t, cx, cy, cz, bx, by, bz, qx, qy, qz, tt, uu, vv)) {
          t = tt;
          hit = 1;
          prim = q3.y;
          tri = (child << 1) + 1;
          u = uu;
          v = vv;
        }
      }
      const bool push = box_hit && ntype == 1;
      cd[e] = push ? front : -kF32Max;
      cc[e] = push ? child : -1;
    }
    compare_swap(cd, cc, 0, 1); compare_swap(cd, cc, 2, 3);
    compare_swap(cd, cc, 4, 5); compare_swap(cd, cc, 6, 7);
    compare_swap(cd, cc, 0, 2); compare_swap(cd, cc, 1, 3);
    compare_swap(cd, cc, 4, 6); compare_swap(cd, cc, 5, 7);
    compare_swap(cd, cc, 1, 2); compare_swap(cd, cc, 5, 6);
    compare_swap(cd, cc, 0, 4); compare_swap(cd, cc, 3, 7);
    compare_swap(cd, cc, 1, 5); compare_swap(cd, cc, 2, 6);
    compare_swap(cd, cc, 1, 4); compare_swap(cd, cc, 3, 6);
    compare_swap(cd, cc, 2, 4); compare_swap(cd, cc, 3, 5);
    compare_swap(cd, cc, 3, 4);
#pragma unroll
    for (int e = 0; e < kWide; ++e) {
      if (cc[e] >= 0) {
        if (sp >= stack_cap) {
          atomicOr(overflow, 1);
          goto done;
        }
        stack[sp++] = cc[e];
      }
    }
  }
done:
  hit_out[ray] = hit;
  t_out[ray] = t;
  prim_out[ray] = prim;
  tri_out[ray] = tri;
  u_out[ray] = u;
  v_out[ray] = v;
}

}  // namespace

// Plain C interface, bound with ctypes. Pointers are device pointers;
// ``stream`` is a cudaStream_t. Returns the cudaError_t of the launch.
extern "C" int fat_traverse_launch(const void* rows, const void* origin, const void* dir,
                                   const void* tmin, const void* tmax, void* hit_out,
                                   void* t_out, void* prim_out, void* tri_out, void* u_out,
                                   void* v_out, void* overflow, int num_rays, int stack_cap,
                                   void* stream) {
  if (num_rays <= 0) return 0;
  if (stack_cap <= 0 || stack_cap > kMaxStack) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (num_rays + kThreads - 1) / kThreads;
  fat_traverse_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(rows), static_cast<const float*>(origin),
      static_cast<const float*>(dir), static_cast<const float*>(tmin),
      static_cast<const float*>(tmax), static_cast<int*>(hit_out), static_cast<float*>(t_out),
      static_cast<int*>(prim_out), static_cast<int*>(tri_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), static_cast<int*>(overflow), num_rays, stack_cap);
  return static_cast<int>(cudaGetLastError());
}
