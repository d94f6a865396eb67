// K1: split-BVH traversal, one thread per ray, for Hopper (sm_90a).
//
// Replaces the TPU kernels tpu_raytracing/trace/split_pallas.py:_kernel_v3
// (line 143) and _kernel_v4 (line 541). Both compute one function and differ
// only in how they schedule DMAs and scalar work on the TPU; this kernel
// serves both, in a closest-hit and an any-hit instantiation.
//
// What it computes (per ray, rays in the order given):
//   * depth-first traversal of SplitBVH inner rows from the root (row 0);
//     a row holds kWidth = 8 entries of (lo xyz, hi xyz, meta, pad), meta =
//     child << 5 | type. Type 0 entries are skipped; a box child is an inner
//     row, a tri child the start of a leafw-pair window in the sorted pairs.
//   * slab test: the ray meets the box when back >= front, front <= t_cur
//     and back >= tmin; the child's distance is max(front, 0). All hit
//     children are pushed in slot order except the nearest, which is pushed
//     last so it pops first; the higher entry id wins a distance tie.
//   * leaf: Möller-Trumbore on triangles A = (v0, v1, v2) and B = (v2, v1, v3)
//     of every pair in the window; B beats A, a later slot an earlier one and
//     a later window an earlier one on an exact t tie. The hit id is
//     pair * 2 + second.
//   * any-hit stops at the first accepted hit.
//   * a push beyond stack_cap sets *overflow and stops that ray: nodes are
//     never dropped silently; the host checks the flag once per frame.
//
// What bounds it: each pop is a dependent global load — a 256-byte inner
// row, or a window of leafw 64-byte pair rows — whose address comes from
// the previous pop. The kernel is latency bound on those loads, with the
// slab and Möller-Trumbore arithmetic second.
//
// How the simple design stands to that: one thread per ray with a private
// stack in local memory (the reference CUDA tracer's shape, src/Tracer.cu:
// 308-374) keeps every ray's traversal exact and independent. Latency is
// hidden only by occupancy — many resident warps — and by the read-only
// cache; the callers hand in coherent orders (screen tiles for primary
// rays, a hit-leaf sort for bounce rays) so the threads of a warp tend to
// load the same rows. There is no wgmma, TMA or shared-memory staging yet.
//
// Bit-exactness: compiled with -fmad=false and without fast math, and every
// expression keeps the order of the plain PyTorch version
// (tpu_raytracing_torch/trace/split_trace.py:trace_split_plain), so the two
// agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kWidth = 8;  // entries per inner row: the width the tracer's build emits
constexpr int kMaxStack = 256;
constexpr int kThreads = 128;
constexpr float kF32Max = 3.402823466e+38f;
constexpr float kTriEps = 1e-9f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin;
};

// Möller-Trumbore; returns t if accepted, else kF32Max.
__device__ __forceinline__ float moller_trumbore(
    const Ray& r, float t_cur,
    float a0, float a1, float a2, float b0, float b1, float b2,
    float c0, float c1, float c2) {
  const float e1x = b0 - a0, e1y = b1 - a1, e1z = b2 - a2;
  const float e2x = c0 - a0, e2y = c1 - a1, e2z = c2 - a2;
  const float hx = r.dy * e2z - r.dz * e2y;
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * hx + e1y * hy + e1z * hz;
  const bool degen = (det > -kTriEps) && (det < kTriEps);
  const float f = 1.0f / det;
  const float sx = r.ox - a0, sy = r.oy - a1, sz = r.oz - a2;
  const float uu = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float vv = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  const float tt = f * (e2x * qx + e2y * qy + e2z * qz);
  const bool acc = !degen && (uu >= 0.0f) && (uu <= 1.0f) && (vv >= 0.0f) &&
                   (uu + vv <= 1.0f) && (tt >= r.tmin) && (tt <= t_cur);
  return acc ? tt : kF32Max;
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(kThreads)
split_trace_kernel(const int4* __restrict__ inner, const int4* __restrict__ pairs,
                   const float* __restrict__ origin, const float* __restrict__ dir,
                   const float* __restrict__ tmin, const float* __restrict__ tmax,
                   float* __restrict__ t_out, int* __restrict__ tri_out,
                   int* __restrict__ ipops_out, int* __restrict__ lpops_out,
                   int* __restrict__ overflow, int num_rays, int leafw, int stack_cap) {
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
  const float invx = 1.0f / r.dx, invy = 1.0f / r.dy, invz = 1.0f / r.dz;
  float t_cur = tmax[ray];
  int tri = -1, ipops = 0, lpops = 0;

  int stack[kMaxStack];
  int sp = 0;
  stack[sp++] = 0;  // root: inner row 0
  while (sp > 0) {
    const int tag = stack[--sp];
    if ((tag & 1) == 0) {
      ++ipops;
      const int4* row = inner + static_cast<size_t>(tag >> 1) * (2 * kWidth);
      int ctag[kWidth];
      bool ok[kWidth];
      int nearest = -1;
      float best = 0.0f;
#pragma unroll
      for (int e = 0; e < kWidth; ++e) {
        const int4 a = __ldg(row + 2 * e);
        const int4 b = __ldg(row + 2 * e + 1);
        const int meta = b.z;
        const int ntype = meta & 3;
        const float tx0 = (__int_as_float(a.x) - r.ox) * invx;
        const float ty0 = (__int_as_float(a.y) - r.oy) * invy;
        const float tz0 = (__int_as_float(a.z) - r.oz) * invz;
        const float tx1 = (__int_as_float(a.w) - r.ox) * invx;
        const float ty1 = (__int_as_float(b.x) - r.oy) * invy;
        const float tz1 = (__int_as_float(b.y) - r.oz) * invz;
        const float front = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
        const float back = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
        ok[e] = (ntype != 0) && (back >= front) && (front <= t_cur) && (back >= r.tmin);
        ctag[e] = ((meta >> 5) << 1) | (ntype == 2 ? 1 : 0);
        const float dist = fmaxf(front, 0.0f);
        if (ok[e] && (nearest < 0 || dist <= best)) {
          best = dist;
          nearest = e;
        }
      }
#pragma unroll
      for (int e = 0; e < kWidth; ++e) {
        if (ok[e] && e != nearest) {
          if (sp >= stack_cap) {
            atomicOr(overflow, 1);
            goto done;
          }
          stack[sp++] = ctag[e];
        }
      }
      if (nearest >= 0) {
        if (sp >= stack_cap) {
          atomicOr(overflow, 1);
          goto done;
        }
        int near_tag = ctag[0];
#pragma unroll
        for (int e = 1; e < kWidth; ++e) near_tag = (e == nearest) ? ctag[e] : near_tag;
        stack[sp++] = near_tag;
      }
    } else {
      ++lpops;
      const int start = tag >> 1;
      float tm = kF32Max;
      int wenc = -1;
      for (int j = 0; j < leafw; ++j) {
        const int4* p = pairs + static_cast<size_t>(start + j) * 4;
        const int4 q0 = __ldg(p), q1 = __ldg(p + 1), q2 = __ldg(p + 2);
        const float v0x = __int_as_float(q0.x), v0y = __int_as_float(q0.y), v0z = __int_as_float(q0.z);
        const float v1x = __int_as_float(q0.w), v1y = __int_as_float(q1.x), v1z = __int_as_float(q1.y);
        const float v2x = __int_as_float(q1.z), v2y = __int_as_float(q1.w), v2z = __int_as_float(q2.x);
        const float v3x = __int_as_float(q2.y), v3y = __int_as_float(q2.z), v3z = __int_as_float(q2.w);
        const float ca = moller_trumbore(r, t_cur, v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z);
        const float cb = moller_trumbore(r, t_cur, v2x, v2y, v2z, v1x, v1y, v1z, v3x, v3y, v3z);
        const float c = fminf(ca, cb);
        const int enc = 2 * j + (cb <= ca ? 1 : 0);
        if (c <= tm) {
          tm = c;
          wenc = enc;
        }
      }
      if (tm <= t_cur) {
        tri = start * 2 + wenc;
        if (ANY_HIT) break;
        t_cur = tm;
      }
    }
  }
done:
  t_out[ray] = t_cur;
  tri_out[ray] = tri;
  ipops_out[ray] = ipops;
  lpops_out[ray] = lpops;
}

template <bool ANY_HIT>
void launch(const void* inner, const void* pairs, const void* origin, const void* dir,
            const void* tmin, const void* tmax, void* t_out, void* tri_out, void* ipops,
            void* lpops, void* overflow, int num_rays, int leafw, int stack_cap,
            cudaStream_t stream) {
  const int blocks = (num_rays + kThreads - 1) / kThreads;
  split_trace_kernel<ANY_HIT><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int4*>(inner), static_cast<const int4*>(pairs),
      static_cast<const float*>(origin), static_cast<const float*>(dir),
      static_cast<const float*>(tmin), static_cast<const float*>(tmax),
      static_cast<float*>(t_out), static_cast<int*>(tri_out), static_cast<int*>(ipops),
      static_cast<int*>(lpops), static_cast<int*>(overflow), num_rays, leafw, stack_cap);
}

}  // namespace

// Plain C interface, bound with ctypes. Pointers are device pointers;
// ``stream`` is a cudaStream_t. Returns the cudaError_t of the launch.
extern "C" int split_trace_launch(const void* inner, const void* pairs, const void* origin,
                                  const void* dir, const void* tmin, const void* tmax,
                                  void* t_out, void* tri_out, void* ipops, void* lpops,
                                  void* overflow, int num_rays, int width, int leafw,
                                  int any_hit, int stack_cap, void* stream) {
  if (num_rays <= 0) return 0;
  if (width != kWidth || leafw <= 0 || stack_cap <= 0 || stack_cap > kMaxStack)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    launch<true>(inner, pairs, origin, dir, tmin, tmax, t_out, tri_out, ipops, lpops, overflow,
                 num_rays, leafw, stack_cap, s);
  else
    launch<false>(inner, pairs, origin, dir, tmin, tmax, t_out, tri_out, ipops, lpops, overflow,
                  num_rays, leafw, stack_cap, s);
  return static_cast<int>(cudaGetLastError());
}
