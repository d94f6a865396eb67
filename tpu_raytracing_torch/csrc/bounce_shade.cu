// The bounce-shade kernel: the path tracer's shading of one bounce
// (trace/pathtrace.py:bounce_shade_plain) in one launch, one thread per ray.
//
// It replaces no TPU kernel: the JAX package shades with XLA operations
// (tpu_raytracing/trace/pathtrace.py:_bounce_stage), which XLA fuses. Run
// eagerly in PyTorch the same shading was a chain of about 130 operations a
// bounce over every ray (the hit context's gathers, the sky, the normal and
// its normalisation, the shadow direction, next-event estimation, the
// cosine sample, the next rays): about a third of a split frame's kernel
// launches and nearly half of its path-tracer device time.
//
// What it computes, per ray i of R (dead rays too, as the plain version):
//   * miss = alive & !hit; radiance += miss ? throughput * sky(direction) : 0
//     with sky = horizon * (1 - s) + zenith * s, s = 0.5 * (dir.y + 1);
//     alive &= hit;
//   * the hit pair's rotation (pair row word 14, or 15 for the pair's second
//     triangle) and the hit primitive's three corner normals rotated by it,
//     interpolated at (bary_u, bary_v); where instance ids are given (a
//     two-level frame, trace/instanced_split.py) and the ray's is not -1,
//     mapped by that instance's 3x3 normal matrix (row c: (m[c][0] n.x +
//     m[c][1] n.y) + m[c][2] n.z); normalised (length clamped to 1e-20),
//     flipped to face the ray; the material's diffuse albedo (the default
//     slot for material id -1);
//   * hit = origin + direction * t; the shadow direction toward the light
//     (length clamped to 1e-30); radiance += (alive & !srec_hit) ?
//     throughput * albedo * max(n . l, 0) * light colour : 0;
//   * SampleNext (every bounce but the last): throughput *= albedo; the next
//     ray from hit + n * 1e-4 in the cosine-weighted direction about n drawn
//     from u_frame[pixel] (Duff et al.'s orthonormal basis), tmin 1e-3,
//     tmax max_t.
// Every value is the plain version's, bit for bit: the same operations in
// the same order, IEEE division and square root, no contraction
// (-fmad=false), and on the card PyTorch's summation order for
// torch.linalg.vector_norm (norm3 below).
//
// What bounds it: bytes. About 150 bytes a ray are read (the ray, the hit
// record, throughput, radiance, alive, pixel, its two uniforms, and three
// gathers: one word of the pair row, the 36-byte normal row and the
// material id) and 60 written, some 0.07 ms a bounce at the card's HBM
// bandwidth for 1M rays. The arithmetic (a square root, a division and a
// sine and cosine a ray) is far below the card's float rate. The design
// keeps the gathers in flight: one thread per ray, 256-thread blocks, no
// shared memory, few registers, every per-ray array read at the thread's
// own index so a warp's loads coalesce; the material table is a few
// entries and stays in L1. A two-level frame adds a 4-byte instance id a ray
// and a 36-byte normal matrix a hit, from a table of a few thousand rows
// that stays in L2.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// 2.0 * math.pi, rounded to float32 as PyTorch rounds a scalar factor
constexpr float kTwoPi = static_cast<float>(2.0 * 3.141592653589793);

struct Args {
  const float* origin;      // [R, 3]
  const float* direction;   // [R, 3]
  const bool* hit;          // [R]
  const float* t;           // [R]
  const int* prim_id;       // [R]
  const int* tri_id;        // [R]
  const float* bary_u;      // [R]
  const float* bary_v;      // [R]
  const bool* srec_hit;     // [R]
  const float* throughput;  // [R, 3]
  const float* radiance;    // [R, 3]
  const bool* alive;        // [R]
  const int64_t* pixel;     // [R]
  const float* u_frame;     // [num_u, 2]
  const float* max_t;       // [1]
  const int* pair_rows;     // [num_pairs, 16]
  const float* normals;     // [num_prims, 3, 3]
  const int* material_ids;  // [num_prims]
  const float* diffuse;     // [num_mats, 3]
  const float* light;       // [3]
  const int* inst;          // [R] or null (one-level)
  const float* normal_maps; // [num_inst, 3, 3] or null
  float* radiance_out;      // [R, 3]
  bool* alive_out;          // [R]
  float* throughput_out;    // [R, 3]   (SampleNext only)
  float* origin_out;        // [R, 3]   (SampleNext only)
  float* direction_out;     // [R, 3]   (SampleNext only)
  float* tmin_out;          // [R]      (SampleNext only)
  float* tmax_out;          // [R]      (SampleNext only)
  // the shading constants, from the caller: trace/pathtrace.py SKY_HORIZON
  // and SKY_ZENITH, trace/shade.py LIGHT_COLOUR_RGB, trace/render.py
  // SHADOW_TMIN
  float horizon[3], zenith[3], light_colour[3], shadow_tmin;
  int num_rays, num_u, num_pairs, num_prims, num_mats, num_inst;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// torch.clamp(x, min=lo) on the card: NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// (a.x*b.x + a.y*b.y) + a.z*b.z, as ops/intersect.py:dot
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// torch.linalg.vector_norm over a row of three float32 on the card:
// PyTorch's reduction gives the row to two lanes, elements 0 and 2 to the
// first and 1 to the second, each square rounded, and adds the second
// lane's sum last.
__device__ __forceinline__ float norm3(const float* v) {
  return sqrtf((v[0] * v[0] + v[2] * v[2]) + v[1] * v[1]);
}

template <bool SampleNext>
__global__ void __launch_bounds__(kThreads) bounce_shade_kernel(const Args a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.num_rays) return;

  float o[3], d[3], thr[3], rad[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = a.origin[3 * i + c];
    d[c] = a.direction[3 * i + c];
    thr[c] = a.throughput[3 * i + c];
    rad[c] = a.radiance[3 * i + c];
  }
  const bool hit = a.hit[i];
  const bool alive_in = a.alive[i];
  const float t = a.t[i];
  const float bu = a.bary_u[i];
  const float bv = a.bary_v[i];

  // sky radiance for the rays that left the scene
  const bool miss = alive_in && !hit;
  const float s = 0.5f * (d[1] + 1.0f);
  const float one_minus_s = 1.0f - s;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float sky = a.horizon[c] * one_minus_s + a.zenith[c] * s;
    rad[c] = rad[c] + (miss ? thr[c] * sky : 0.0f);
  }
  const bool alive = alive_in && hit;

  // the hit context (trace/render.py:_gather_hit_context): the pair's
  // rotation, the rotated corner normals, the material's albedo
  const int tri = a.tri_id[i];
  const int pair = clampi(tri >> 1, 0, a.num_pairs - 1);
  const int rot = a.pair_rows[16 * static_cast<int64_t>(pair) + ((tri & 1) ? 15 : 14)];
  const int prim = clampi(a.prim_id[i], 0, a.num_prims - 1);
  // trace/shade.py:rotate_attributes: rot 1 -> corners (2, 0, 1), rot 2 ->
  // (1, 2, 0), else (0, 1, 2)
  const int k0 = rot == 1 ? 2 : (rot == 2 ? 1 : 0);
  const int k1 = rot == 1 ? 0 : (rot == 2 ? 2 : 1);
  const int k2 = rot == 1 ? 1 : (rot == 2 ? 0 : 2);
  const float* nrow = a.normals + 9 * static_cast<int64_t>(prim);
  const int mat = a.material_ids[prim];
  const int mi = clampi(mat < 0 ? a.num_mats - 1 : mat, 0, a.num_mats - 1);
  float alb[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) alb[c] = a.diffuse[3 * mi + c];

  // trace/shade.py:interpolate, then normalised and facing the ray
  const float w0 = 1.0f - bu - bv;
  float n[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    n[c] = nrow[3 * k0 + c] * w0 + nrow[3 * k1 + c] * bu + nrow[3 * k2 + c] * bv;
  if (a.inst != nullptr) {
    const int k = a.inst[i];
    if (k >= a.num_inst) __trap();  // torch's index check
    if (k >= 0) {
      const float* m = a.normal_maps + 9 * static_cast<int64_t>(k);
      const float o0 = n[0], o1 = n[1], o2 = n[2];
#pragma unroll
      for (int c = 0; c < 3; ++c) n[c] = m[3 * c] * o0 + m[3 * c + 1] * o1 + m[3 * c + 2] * o2;
    }
  }
  const float len = clamp_min(norm3(n), 1e-20f);
#pragma unroll
  for (int c = 0; c < 3; ++c) n[c] = n[c] / len;
  if (dot3(n, d) > 0.0f) {
#pragma unroll
    for (int c = 0; c < 3; ++c) n[c] = -n[c];
  }
  float hp[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) hp[c] = o[c] + d[c] * t;

  // next-event estimation (trace/render.py:_shadow_rays_from's direction)
  float l[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) l[c] = a.light[c] - hp[c];
  const float dist = clamp_min(norm3(l), 1e-30f);
#pragma unroll
  for (int c = 0; c < 3; ++c) l[c] = l[c] / dist;
  const float ndotl = clamp_min(dot3(n, l), 0.0f);
  const bool lit = alive && !a.srec_hit[i];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a.radiance_out[3 * i + c] = rad[c] + (lit ? thr[c] * alb[c] * ndotl * a.light_colour[c] : 0.0f);
  }
  a.alive_out[i] = alive;
  if (!SampleNext) return;

  // trace/pathtrace.py:_cosine_sample at the ray's pixel
  const int64_t px = a.pixel[i];
  if (px < 0 || px >= a.num_u) __trap();  // torch's index check
  const float u0 = a.u_frame[2 * px];
  const float u1 = a.u_frame[2 * px + 1];
  const float r = sqrtf(u0);
  const float phi = kTwoPi * u1;
  const float loc[3] = {r * cosf(phi), r * sinf(phi), sqrtf(clamp_min(1.0f - u0, 0.0f))};
  const float sign = n[2] >= 0.0f ? 1.0f : -1.0f;
  const float inv = (1.0f / (sign + n[2])) * -1.0f;  // -1.0 / x is x.reciprocal() * -1.0
  const float b = n[0] * n[1] * inv;
  const float tb[3] = {1.0f + sign * (n[0] * n[0]) * inv, sign * b, -sign * n[0]};
  const float bt[3] = {b, sign + (n[1] * n[1]) * inv, -n[1]};
  const float tmax = *a.max_t;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a.throughput_out[3 * i + c] = thr[c] * alb[c];
    a.origin_out[3 * i + c] = hp[c] + n[c] * 1e-4f;
    a.direction_out[3 * i + c] = tb[c] * loc[0] + bt[c] * loc[1] + n[c] * loc[2];
  }
  a.tmin_out[i] = a.shadow_tmin;
  a.tmax_out[i] = tmax;
}

}  // namespace

// One bounce's shading. Pointers as in Args, in that order; inst and
// normal_maps are both null (a one-level frame) or both given; the last
// five outputs may be null when sample_next is 0. ``consts`` is a host array
// of Args' ten shading constants, in their order. ``stream`` is a
// cudaStream_t.
// Returns the cudaError_t of the launch.
extern "C" int bounce_shade_launch(
    const void* origin, const void* direction, const void* hit, const void* t,
    const void* prim_id, const void* tri_id, const void* bary_u, const void* bary_v,
    const void* srec_hit, const void* throughput, const void* radiance, const void* alive,
    const void* pixel, const void* u_frame, const void* max_t, const void* pair_rows,
    const void* normals, const void* material_ids, const void* diffuse, const void* light,
    const void* inst, const void* normal_maps, void* radiance_out, void* alive_out,
    void* throughput_out, void* origin_out, void* direction_out, void* tmin_out,
    void* tmax_out, const float* consts, int num_rays, int num_u, int num_pairs,
    int num_prims, int num_mats, int num_inst, int sample_next, void* stream) {
  if (num_rays <= 0) return 0;
  if (consts == nullptr || num_u <= 0 || num_pairs <= 0 || num_prims <= 0 || num_mats <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((inst == nullptr) != (normal_maps == nullptr) || (inst != nullptr && num_inst <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (sample_next && (throughput_out == nullptr || origin_out == nullptr ||
                      direction_out == nullptr || tmin_out == nullptr || tmax_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(origin),
           static_cast<const float*>(direction),
           static_cast<const bool*>(hit),
           static_cast<const float*>(t),
           static_cast<const int*>(prim_id),
           static_cast<const int*>(tri_id),
           static_cast<const float*>(bary_u),
           static_cast<const float*>(bary_v),
           static_cast<const bool*>(srec_hit),
           static_cast<const float*>(throughput),
           static_cast<const float*>(radiance),
           static_cast<const bool*>(alive),
           static_cast<const int64_t*>(pixel),
           static_cast<const float*>(u_frame),
           static_cast<const float*>(max_t),
           static_cast<const int*>(pair_rows),
           static_cast<const float*>(normals),
           static_cast<const int*>(material_ids),
           static_cast<const float*>(diffuse),
           static_cast<const float*>(light),
           static_cast<const int*>(inst),
           static_cast<const float*>(normal_maps),
           static_cast<float*>(radiance_out),
           static_cast<bool*>(alive_out),
           static_cast<float*>(throughput_out),
           static_cast<float*>(origin_out),
           static_cast<float*>(direction_out),
           static_cast<float*>(tmin_out),
           static_cast<float*>(tmax_out),
           {},
           {},
           {},
           0.0f,
           num_rays,
           num_u,
           num_pairs,
           num_prims,
           num_mats,
           num_inst};
  for (int c = 0; c < 3; ++c) {
    a.horizon[c] = consts[c];
    a.zenith[c] = consts[3 + c];
    a.light_colour[c] = consts[6 + c];
  }
  a.shadow_tmin = consts[9];
  const int blocks = (num_rays + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sample_next)
    bounce_shade_kernel<true><<<blocks, kThreads, 0, s>>>(a);
  else
    bounce_shade_kernel<false><<<blocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
