// K1: split-BVH traversal for Hopper (sm_90a), with leaf windows tested by
// the whole warp.
//
// Replaces the TPU kernels tpu_raytracing/trace/split_pallas.py:_kernel_v3
// (line 143) and _kernel_v4 (line 541), and through kernel_v also _kernel_v5
// (line 898) and _kernel (v2, line 1250). They compute one function and
// differ only in how they schedule DMAs and scalar work on the TPU; this
// kernel serves them all, in a closest-hit and an any-hit instantiation.
//
// What it computes (per ray, rays in the order given):
//   * depth-first traversal of SplitBVH inner rows from the ray's start tag:
//     the root (row 0, tag 0) when ``start`` is null, else start[ray], the
//     reference's per-packet ``ptag`` (_kernel_v3's init_slot, line 191)
//     expanded to one tag per ray: an even tag 2 r starts at inner row r, an
//     odd tag 2 s + 1 at the leaf window from pair s;
//     a row holds WIDTH = 8 or 16 entries of (lo xyz, hi xyz, meta, pad),
//     meta = child << 5 | type (the TPU kernels take both widths,
//     split_pallas.py:129; one instantiation per width). Type 0 entries
//     are skipped; a box child is an inner row, a tri child the start of a
//     leafw-pair window in the sorted pairs.
//   * slab test: the ray meets the box when back >= front, front <= t_cur
//     and back >= tmin; the child's distance is max(front, 0). All hit
//     children are pushed in slot order except the nearest, which is pushed
//     last so it pops first; the higher entry id wins a distance tie (the
//     TPU key keeps the id in its low log2(WIDTH) bits, split_pallas.py:247).
//   * leaf: Möller-Trumbore on triangles A = (v0, v1, v2) and B = (v2, v1, v3)
//     of every pair in the window. The window's winner has the smallest t
//     and, on an equal t, the larger enc = 2 * slot + second (all-miss:
//     F32_MAX and enc 2 * leafw - 1); it is taken when t <= t_cur, so a
//     later window wins an exact tie with an earlier one. The hit id is
//     pair * 2 + second.
//   * any-hit stops at the first window whose winner is taken; the winner
//     is still that window's closest triangle.
//   * a push beyond stack_cap sets *overflow and stops that ray: nodes are
//     never dropped silently; the host checks the flag once per frame.
//
// What bounds it: a leaf pop tests 2 * leafw = 128 triangles (~61
// operations each), an inner pop 8 (or 16) boxes (~25 each), so leaf windows carry
// nearly all the arithmetic; every pop is a dependent load (a 256-byte
// inner row, or a 4 KB window of 64-byte pair rows) whose address comes
// from the previous pop. One thread per ray ran a window's 64 pairs in a
// serial loop while the lanes of its warp at inner rows, or done, waited:
// a warp where a few lanes popped a leaf ran all 64 iterations, and each
// lane read its own window 16 bytes at a time.
//
// What the design does about it (the while-while loop of Aila & Laine,
// "Understanding the Efficiency of Ray Traversal on GPUs", HPG 2009): every
// ray keeps its own stack and traversal order, but the warp shares the
// leaf work. Each round,
//   1. every lane pops and tests inner rows on its own until the top of its
//      stack is a leaf tag or its stack is empty;
//   2. __ballot_sync collects the lanes holding a leaf tag and
//      __match_any_sync groups those that popped the same window. For each
//      distinct window, lane l loads pair rows l, l + 32, ... once (a
//      coalesced load, from L2 for the 1M tree); then for each ray of the
//      group the ray is broadcast with __shfl_sync, every lane runs
//      Möller-Trumbore on its slots, and a 5-step __shfl_xor_sync
//      reduction finds the window's winner, which the ray's own lane takes.
// So a window's 128 tests run on 32 lanes instead of one, whatever the
// other lanes are doing. All 32 lanes stay in the loop until the whole warp
// is done (rays past num_rays, finished any-hit rays and overflowed rays
// keep serving the others), and every warp intrinsic runs with the full
// mask on a converged warp.
//
// Why no TMA or shared-memory staging: the micro-probes on the H100
// (tpu_raytracing_torch/benchmarks/, PERF.md) price a window staged by a TMA bulk copy on an mbarrier at ~315 ns a pop
// and ~118 ns with four in flight, slower than plain coalesced loads that
// hit L2 (the 1M tree fits in the 50 MB L2); and a CTA-wide decision costs
// 40-77 ns where a warp vote costs almost nothing. So the design stays
// inside the warp, with no __syncthreads.
//
// Bit-exactness: compiled with -fmad=false and without fast math, and every
// expression keeps the order of the plain PyTorch version
// (tpu_raytracing_torch/trace/split_trace.py:trace_split_plain). Per ray it
// is the same arithmetic on the same values, and the reduction's key order
// is the plain version's, so the two agree bit for bit on every output.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxStack = 256;
constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr int kMaxSlots = 4;  // pair slots per lane: leafw <= 128
constexpr unsigned kFull = 0xffffffffu;
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

// One lane's pair rows of a window: vertices v0..v3 of slots lane + 32 k.
template <int SLOTS>
struct Window {
  float v[SLOTS][12];
};

// Tests window ``w`` (pairs from slot 0) against ray ``r`` with limit
// ``t_cur`` on every lane and returns, on every lane, the window's winner:
// the smallest t and, on an equal t, the larger enc = 2 * slot + second.
// Slots past leafw take no part (t F32_MAX, enc -1).
template <int SLOTS>
__device__ __forceinline__ void window_winner(const Window<SLOTS>& w, const Ray& r, float t_cur,
                                              int lane, int leafw, float& tm, int& wenc) {
  tm = kF32Max;
  wenc = -1;
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int slot = lane + kWarp * k;
    if (slot < leafw) {
      const float* v = w.v[k];
      const float ca = moller_trumbore(r, t_cur, v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7],
                                       v[8]);
      const float cb = moller_trumbore(r, t_cur, v[6], v[7], v[8], v[3], v[4], v[5], v[9], v[10],
                                       v[11]);
      const float c = fminf(ca, cb);
      const int enc = 2 * slot + (cb <= ca ? 1 : 0);
      // a lane's slots rise in enc: a later one wins an equal t
      if (c <= tm) {
        tm = c;
        wenc = enc;
      }
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(kFull, tm, off);
    const int oe = __shfl_xor_sync(kFull, wenc, off);
    if (ot < tm || (ot == tm && oe > wenc)) {
      tm = ot;
      wenc = oe;
    }
  }
}

template <bool ANY_HIT, int SLOTS, int WIDTH>
__global__ void __launch_bounds__(kThreads)
split_trace_kernel(const int4* __restrict__ inner, const int4* __restrict__ pairs,
                   const float* __restrict__ origin, const float* __restrict__ dir,
                   const float* __restrict__ tmin, const float* __restrict__ tmax,
                   float* __restrict__ t_out, int* __restrict__ tri_out,
                   int* __restrict__ ipops_out, int* __restrict__ lpops_out,
                   int* __restrict__ overflow, const int* __restrict__ start_tags, int num_rays,
                   int leafw, int stack_cap) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % kWarp;
  const bool live = ray < num_rays;  // a lane past num_rays only serves the warp
  Ray r{0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, 0.0f};
  float t_cur = 0.0f;
  if (live) {
    r.ox = origin[3 * ray + 0];
    r.oy = origin[3 * ray + 1];
    r.oz = origin[3 * ray + 2];
    r.dx = dir[3 * ray + 0];
    r.dy = dir[3 * ray + 1];
    r.dz = dir[3 * ray + 2];
    r.tmin = tmin[ray];
    t_cur = tmax[ray];
  }
  const float invx = 1.0f / r.dx, invy = 1.0f / r.dy, invz = 1.0f / r.dz;
  int tri = -1, ipops = 0, lpops = 0;

  int stack[kMaxStack];
  int sp = 0;
  // the start tag; a leaf tag tops the stack and goes straight to step 2
  if (live) stack[sp++] = start_tags ? start_tags[ray] : 0;
  while (__any_sync(kFull, sp > 0)) {
    // 1. inner rows, each lane on its own, until a leaf tag tops its stack
    while (sp > 0) {
      const int tag = stack[sp - 1];
      if (tag & 1) break;
      --sp;
      ++ipops;
      const int4* row = inner + static_cast<size_t>(tag >> 1) * (2 * WIDTH);
      int ctag[WIDTH];
      bool ok[WIDTH];
      int nearest = -1, pushes = 0;
      float best = 0.0f;
#pragma unroll
      for (int e = 0; e < WIDTH; ++e) {
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
        pushes += ok[e] ? 1 : 0;
        const float dist = fmaxf(front, 0.0f);
        if (ok[e] && (nearest < 0 || dist <= best)) {
          best = dist;
          nearest = e;
        }
      }
      if (sp + pushes > stack_cap) {  // a push would overflow: stop the ray
        atomicOr(overflow, 1);
        sp = 0;
        break;
      }
#pragma unroll
      for (int e = 0; e < WIDTH; ++e) {
        if (ok[e] && e != nearest) stack[sp++] = ctag[e];
      }
      if (nearest >= 0) {
        int near_tag = ctag[0];
#pragma unroll
        for (int e = 1; e < WIDTH; ++e) near_tag = (e == nearest) ? ctag[e] : near_tag;
        stack[sp++] = near_tag;
      }
    }

    // 2. leaf windows, the whole warp on each
    const bool at_leaf = sp > 0;
    int start = -1;
    if (at_leaf) {
      start = stack[--sp] >> 1;
      ++lpops;
    }
    unsigned pending = __ballot_sync(kFull, at_leaf);
    const unsigned same = __match_any_sync(kFull, start);
    while (pending) {
      const int leader = __ffs(pending) - 1;
      unsigned group = __shfl_sync(kFull, same, leader);
      const int wstart = __shfl_sync(kFull, start, leader);
      pending &= ~group;
      Window<SLOTS> w;
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        const int slot = lane + kWarp * k;
        int4 q0 = make_int4(0, 0, 0, 0), q1 = q0, q2 = q0;
        if (slot < leafw) {
          const int4* p = pairs + static_cast<size_t>(wstart + slot) * 4;
          q0 = __ldg(p);
          q1 = __ldg(p + 1);
          q2 = __ldg(p + 2);
        }
        const int q[12] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w,
                           q2.x, q2.y, q2.z, q2.w};
#pragma unroll
        for (int i = 0; i < 12; ++i) w.v[k][i] = __int_as_float(q[i]);
      }
      while (group) {
        const int src = __ffs(group) - 1;
        group &= group - 1;
        Ray g;
        g.ox = __shfl_sync(kFull, r.ox, src);
        g.oy = __shfl_sync(kFull, r.oy, src);
        g.oz = __shfl_sync(kFull, r.oz, src);
        g.dx = __shfl_sync(kFull, r.dx, src);
        g.dy = __shfl_sync(kFull, r.dy, src);
        g.dz = __shfl_sync(kFull, r.dz, src);
        g.tmin = __shfl_sync(kFull, r.tmin, src);
        const float g_t = __shfl_sync(kFull, t_cur, src);
        float tm;
        int wenc;
        window_winner<SLOTS>(w, g, g_t, lane, leafw, tm, wenc);
        if (lane == src && tm <= t_cur) {
          tri = wstart * 2 + wenc;
          if (ANY_HIT) {
            sp = 0;
          } else {
            t_cur = tm;
          }
        }
      }
    }
  }
  if (live) {
    t_out[ray] = t_cur;
    tri_out[ray] = tri;
    ipops_out[ray] = ipops;
    lpops_out[ray] = lpops;
  }
}

template <bool ANY_HIT, int SLOTS, int WIDTH>
void launch(const void* inner, const void* pairs, const void* origin, const void* dir,
            const void* tmin, const void* tmax, void* t_out, void* tri_out, void* ipops,
            void* lpops, void* overflow, const void* start, int num_rays, int leafw,
            int stack_cap, cudaStream_t stream) {
  const int blocks = (num_rays + kThreads - 1) / kThreads;
  split_trace_kernel<ANY_HIT, SLOTS, WIDTH><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int4*>(inner), static_cast<const int4*>(pairs),
      static_cast<const float*>(origin), static_cast<const float*>(dir),
      static_cast<const float*>(tmin), static_cast<const float*>(tmax),
      static_cast<float*>(t_out), static_cast<int*>(tri_out), static_cast<int*>(ipops),
      static_cast<int*>(lpops), static_cast<int*>(overflow), static_cast<const int*>(start),
      num_rays, leafw, stack_cap);
}

template <bool ANY_HIT, int WIDTH>
void launch_slots(const void* inner, const void* pairs, const void* origin, const void* dir,
                  const void* tmin, const void* tmax, void* t_out, void* tri_out, void* ipops,
                  void* lpops, void* overflow, const void* start, int num_rays, int leafw,
                  int stack_cap, cudaStream_t s) {
  switch ((leafw + kWarp - 1) / kWarp) {
    case 1:
      launch<ANY_HIT, 1, WIDTH>(inner, pairs, origin, dir, tmin, tmax, t_out, tri_out,
                                ipops, lpops, overflow, start, num_rays, leafw,
                                stack_cap, s);
      break;
    case 2:
      launch<ANY_HIT, 2, WIDTH>(inner, pairs, origin, dir, tmin, tmax, t_out, tri_out,
                                ipops, lpops, overflow, start, num_rays, leafw,
                                stack_cap, s);
      break;
    case 3:
      launch<ANY_HIT, 3, WIDTH>(inner, pairs, origin, dir, tmin, tmax, t_out, tri_out,
                                ipops, lpops, overflow, start, num_rays, leafw,
                                stack_cap, s);
      break;
    default:
      launch<ANY_HIT, kMaxSlots, WIDTH>(inner, pairs, origin, dir, tmin, tmax, t_out,
                                        tri_out, ipops, lpops, overflow, start, num_rays,
                                        leafw, stack_cap, s);
  }
}

}  // namespace

// Plain C interface, bound with ctypes. Pointers are device pointers;
// ``start`` ([num_rays] int32 start tags) may be null: every ray starts at
// the root. ``stream`` is a cudaStream_t. Returns the cudaError_t of the
// launch.
extern "C" int split_trace_launch(const void* inner, const void* pairs, const void* origin,
                                  const void* dir, const void* tmin, const void* tmax,
                                  void* t_out, void* tri_out, void* ipops, void* lpops,
                                  void* overflow, const void* start, int num_rays, int width,
                                  int leafw, int any_hit, int stack_cap, void* stream) {
  if (num_rays <= 0) return 0;
  if ((width != 8 && width != 16) || leafw < 1 || leafw > kMaxSlots * kWarp || stack_cap <= 0 ||
      stack_cap > kMaxStack)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit && width == 8)
    launch_slots<true, 8>(inner, pairs, origin, dir, tmin, tmax, t_out, tri_out, ipops, lpops,
                          overflow, start, num_rays, leafw, stack_cap, s);
  else if (any_hit)
    launch_slots<true, 16>(inner, pairs, origin, dir, tmin, tmax, t_out, tri_out, ipops, lpops,
                           overflow, start, num_rays, leafw, stack_cap, s);
  else if (width == 8)
    launch_slots<false, 8>(inner, pairs, origin, dir, tmin, tmax, t_out, tri_out, ipops, lpops,
                           overflow, start, num_rays, leafw, stack_cap, s);
  else
    launch_slots<false, 16>(inner, pairs, origin, dir, tmin, tmax, t_out, tri_out, ipops, lpops,
                            overflow, start, num_rays, leafw, stack_cap, s);
  return static_cast<int>(cudaGetLastError());
}
