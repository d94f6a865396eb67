// The split tracer's call glue around K1: the operands K1 takes
// (trace/split_trace.py:kernel_operands_plain) and the hit record rebuilt
// from K1's winner (trace/traverse.py:reconstruct_plain), one launch each.
//
// It replaces no TPU kernel: the JAX package does both with XLA operations,
// which XLA fuses: the operand prep before the Pallas call
// (tpu_raytracing/trace/split_pallas.py:1601-1627) and
// tpu_raytracing/trace/wide_fat.py:_reconstruct (called from
// split_pallas.py:1689). Run eagerly in PyTorch the two were about 7 and
// 60 launches a K1 call, most of them elementwise passes over every ray,
// dead ones included: some 1,150 of a split frame's 2,190 launches.
//
// What it computes, per ray i of R:
//   * split_operands_kernel: tmin_out = active ? tmin : F32_MAX and
//     tmax_out = active ? tmax : -F32_MAX (a null active: every ray live);
//     each direction component d with |d| < 1e-30 becomes -1e-30 if d < 0,
//     else +1e-30 (so -0.0 becomes +1e-30; NaN passes through).
//   * split_record_kernel: hit = tri >= 0, and for a closest hit also
//     t < F32_MAX; a hit gathers the winner's 64-byte pair row (pair tri >> 1,
//     triangle (v0, v1, v2), or (v2, v1, v3) when tri is odd) and repeats
//     Moller-Trumbore's barycentrics in the plain version's order:
//     e1 = v1 - a, e2 = c - a, h = d x e2, f = 1 / (e1 . h), s = o - a,
//     u = f * (s . h), v = f * (d . (s x e1)); prim = pair row word 12, or 13
//     for the second triangle. A ray without a hit gets t = tmax, prim 0,
//     tri 0, u = v = +0.0, so its pair row is not read.
// Every value is the plain version's, bit for bit: the same operations in
// the same order, IEEE division, no contraction (-fmad=false), cross and dot
// written out as ops/intersect.py writes them.
//
// What bounds it: bytes. The operands move 41 B a ray (21 in, 20 out), the
// record 36 B a ray in, a 64 B pair row a hit and 21 B out: some 0.04 ms a
// call at the card's HBM bandwidth for 1M rays. The arithmetic is a few
// dozen operations a ray. The design: one thread per ray, 256-thread
// blocks, no shared memory, every per-ray array read at the thread's own
// index so a warp's loads coalesce, and the pair row as four 16-byte loads.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kF32Max = 3.4028234663852886e38f;
constexpr float kTiny = 1e-30f;

__global__ void __launch_bounds__(kThreads)
split_operands_kernel(const float* __restrict__ direction, const float* __restrict__ tmin,
                      const float* __restrict__ tmax, const bool* __restrict__ active,
                      float* __restrict__ direction_out, float* __restrict__ tmin_out,
                      float* __restrict__ tmax_out, int num_rays) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= num_rays) return;
  const bool live = active == nullptr || active[i];
  tmin_out[i] = live ? tmin[i] : kF32Max;
  tmax_out[i] = live ? tmax[i] : -kF32Max;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float d = direction[3 * i + c];
    direction_out[3 * i + c] = fabsf(d) < kTiny ? (d < 0.0f ? -kTiny : kTiny) : d;
  }
}

// a x b, as ops/intersect.py:cross
__device__ __forceinline__ void cross3(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// (a.x*b.x + a.y*b.y) + a.z*b.z, as ops/intersect.py:dot
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

template <bool AnyHit>
__global__ void __launch_bounds__(kThreads)
split_record_kernel(const int4* __restrict__ pair_rows, const float* __restrict__ origin,
                    const float* __restrict__ direction, const float* __restrict__ tmax,
                    const float* __restrict__ t, const int* __restrict__ tri,
                    bool* __restrict__ hit_out, float* __restrict__ t_out,
                    int* __restrict__ prim_out, int* __restrict__ tri_out,
                    float* __restrict__ u_out, float* __restrict__ v_out, int num_rays,
                    int num_pairs) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= num_rays) return;
  const int id = tri[i];
  const float ti = t[i];
  const bool hit = id >= 0 && (AnyHit || ti < kF32Max);
  hit_out[i] = hit;
  if (!hit) {
    t_out[i] = tmax[i];
    prim_out[i] = 0;
    tri_out[i] = 0;
    u_out[i] = 0.0f;
    v_out[i] = 0.0f;
    return;
  }
  const int pair = min(id >> 1, num_pairs - 1);
  const int4* row = pair_rows + 4 * static_cast<int64_t>(pair);
  const int4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2), q3 = __ldg(row + 3);
  const bool second = (id & 1) != 0;
  // the row's words 0-11 are v0, v1, v2, v3 (xyz each) as float bits
  const float v0[3] = {__int_as_float(q0.x), __int_as_float(q0.y), __int_as_float(q0.z)};
  const float v1[3] = {__int_as_float(q0.w), __int_as_float(q1.x), __int_as_float(q1.y)};
  const float v2[3] = {__int_as_float(q1.z), __int_as_float(q1.w), __int_as_float(q2.x)};
  const float v3[3] = {__int_as_float(q2.y), __int_as_float(q2.z), __int_as_float(q2.w)};
  float a[3], c[3], d[3], e1[3], e2[3], s[3], h[3], q[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a[k] = second ? v2[k] : v0[k];
    c[k] = second ? v3[k] : v2[k];
    d[k] = direction[3 * i + k];
    e1[k] = v1[k] - a[k];
    e2[k] = c[k] - a[k];
    s[k] = origin[3 * i + k] - a[k];
  }
  cross3(d, e2, h);
  const float f = 1.0f / dot3(e1, h);
  cross3(s, e1, q);
  t_out[i] = ti;
  prim_out[i] = second ? q3.y : q3.x;
  tri_out[i] = id;
  u_out[i] = f * dot3(s, h);
  v_out[i] = f * dot3(d, q);
}

int blocks_for(int num_rays) { return (num_rays + kThreads - 1) / kThreads; }

}  // namespace

// kernel_operands: direction [R, 3], tmin, tmax [R] float32, active [R] bool
// or null; writes direction_out [R, 3], tmin_out, tmax_out [R]. ``stream`` is
// a cudaStream_t. Returns the cudaError_t of the launch.
extern "C" int split_operands_launch(const void* direction, const void* tmin,
                                     const void* tmax, const void* active,
                                     void* direction_out, void* tmin_out, void* tmax_out,
                                     int num_rays, void* stream) {
  if (num_rays <= 0) return 0;
  split_operands_kernel<<<blocks_for(num_rays), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(direction), static_cast<const float*>(tmin),
      static_cast<const float*>(tmax), static_cast<const bool*>(active),
      static_cast<float*>(direction_out), static_cast<float*>(tmin_out),
      static_cast<float*>(tmax_out), num_rays);
  return static_cast<int>(cudaGetLastError());
}

// reconstruct: pair_rows [num_pairs, 16] int32 (16-byte aligned), origin and
// direction [R, 3], tmax and t [R] float32, tri [R] int32; writes hit [R]
// bool, t_out [R] float32, prim_out and tri_out [R] int32, u_out and v_out
// [R] float32. ``stream`` is a cudaStream_t. Returns the cudaError_t of the
// launch.
extern "C" int split_record_launch(const void* pair_rows, const void* origin,
                                   const void* direction, const void* tmax, const void* t,
                                   const void* tri, void* hit_out, void* t_out,
                                   void* prim_out, void* tri_out, void* u_out, void* v_out,
                                   int num_rays, int num_pairs, int any_hit, void* stream) {
  if (num_rays <= 0) return 0;
  if (num_pairs <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto rows = static_cast<const int4*>(pair_rows);
  if (any_hit)
    split_record_kernel<true><<<blocks_for(num_rays), kThreads, 0, s>>>(
        rows, static_cast<const float*>(origin), static_cast<const float*>(direction),
        static_cast<const float*>(tmax), static_cast<const float*>(t),
        static_cast<const int*>(tri), static_cast<bool*>(hit_out),
        static_cast<float*>(t_out), static_cast<int*>(prim_out), static_cast<int*>(tri_out),
        static_cast<float*>(u_out), static_cast<float*>(v_out), num_rays, num_pairs);
  else
    split_record_kernel<false><<<blocks_for(num_rays), kThreads, 0, s>>>(
        rows, static_cast<const float*>(origin), static_cast<const float*>(direction),
        static_cast<const float*>(tmax), static_cast<const float*>(t),
        static_cast<const int*>(tri), static_cast<bool*>(hit_out),
        static_cast<float*>(t_out), static_cast<int*>(prim_out), static_cast<int*>(tri_out),
        static_cast<float*>(u_out), static_cast<float*>(v_out), num_rays, num_pairs);
  return static_cast<int>(cudaGetLastError());
}
