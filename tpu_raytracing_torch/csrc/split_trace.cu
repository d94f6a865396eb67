// K1: split-BVH traversal for Hopper (sm_90a), with leaf windows tested by
// the whole warp.
//
// Replaces the TPU kernels tpu_raytracing/trace/split_pallas.py:_kernel_v3
// (line 143) and _kernel_v4 (line 541), and with no selector also _kernel_v5
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
// operations each), an inner pop 8 or 16 boxes (~25 each), so leaf windows
// carry nearly all the arithmetic; every pop is a dependent load (a 256- or
// 512-byte inner row, or a 4 KB window of 64-byte pair rows) whose address
// comes from the previous pop. One thread per ray ran a window's 64 pairs in
// a serial loop while the lanes of its warp at inner rows, or done, waited:
// a warp where a few lanes popped a leaf ran all 64 iterations, and each
// lane read its own window 16 bytes at a time.
//
// What the design does about it (the while-while loop of Aila & Laine,
// "Understanding the Efficiency of Ray Traversal on GPUs", HPG 2009): every
// ray keeps its own stack and traversal order, but the warp shares the
// leaf work. Each round,
//   1. inner rows are popped and tested until the top of every lane's stack
//      is a leaf tag or its stack is empty:
//      * 8-wide rows: every lane on its own, 2 * 8 16-byte loads and 8
//        slab tests in series a pop;
//      * 16-wide rows (inner_rows_half_warp): the lanes with an inner tag on
//        top are served two at a time. Half-warp h takes the h-th of them;
//        the ray comes from its lane by __shfl_sync, lane 16 h + e loads
//        entry e (the half reads the 512-byte row in one coalesced sweep)
//        and runs one slab test; __ballot_sync gives the hit mask, a 4-step
//        __shfl_xor_sync min inside the half the nearest distance, and the
//        highest entry at that distance is the nearest child. The owning
//        lane pushes the hit tags, read from their entry lanes by
//        __shfl_sync, in slot order, nearest last. One lane per ray at 16
//        wide would issue 32 loads a pop, each touching up to 32 rows
//        across the warp, and keep ctag[16] / ok[16] in registers.
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
// The diagnostic (split_trace_profile_launch): a clock64 instantiation of
// the same kernel (PROFILE), writing per ray the warp's cycles in three
// phases: inner rows (step 1), the leaf windows of the ray's own group, and
// the rest of step 2 while the ray waits at its leaf (the scheduling and
// the other groups' windows). Each is taken at a __syncwarp, so a phase
// ends when its slowest lane ends it. It also profiles the per-lane inner
// phase at 16 wide, the design the half-warp one replaced. Its five
// outputs are the kernel's.
//
// Bit-exactness: compiled with -fmad=false and without fast math, and every
// expression keeps the order of the plain PyTorch version
// (tpu_raytracing_torch/trace/split_trace.py:trace_split_plain). Per ray it
// is the same arithmetic on the same values, and the reductions' key order
// is the plain version's, so the two agree bit for bit on every output.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxStack = 256;
constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr int kHalf = kWarp / 2;
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

// Step 1 on 16-wide rows: the lanes whose stack top is an inner tag are
// served two a step (lowest lanes first), half-warp h on the h-th of them,
// lane 16 h + e on entry e of that ray's row. Returns when every lane's
// top is a leaf tag or its stack is empty, as the per-lane loop does.
// ``stack_cap`` and the overflow rule are the per-lane loop's.
__device__ __forceinline__ void inner_rows_half_warp(
    const int4* __restrict__ inner, const Ray& r, float invx, float invy, float invz,
    float t_cur, int lane, int stack_cap, int* stack, int& sp, int& ipops,
    int* __restrict__ overflow) {
  constexpr int kWidth = kHalf;  // one entry a lane of a half-warp
  const int e = lane % kHalf;
  const float inf = __int_as_float(0x7f800000);
  int top = sp > 0 ? stack[sp - 1] : 1;  // 1: no inner tag on top
  while (true) {
    const unsigned want = __ballot_sync(kFull, sp > 0 && (top & 1) == 0);
    if (want == 0) break;
    const int l0 = __ffs(want) - 1;
    const unsigned more = want & (want - 1);
    const int l1 = more ? __ffs(more) - 1 : l0;  // alone, l0's row fills both halves
    const int src = lane < kHalf ? l0 : l1;
    const bool own = lane == l0 || (more != 0 && lane == l1);
    const int base = lane == l0 ? 0 : kHalf;  // the owner's half
    if (own) {
      --sp;
      ++ipops;
    }
    // the served ray, from its own lane
    const int tag = __shfl_sync(kFull, top, src);
    const float ox = __shfl_sync(kFull, r.ox, src);
    const float oy = __shfl_sync(kFull, r.oy, src);
    const float oz = __shfl_sync(kFull, r.oz, src);
    const float ix = __shfl_sync(kFull, invx, src);
    const float iy = __shfl_sync(kFull, invy, src);
    const float iz = __shfl_sync(kFull, invz, src);
    const float tmn = __shfl_sync(kFull, r.tmin, src);
    const float tc = __shfl_sync(kFull, t_cur, src);
    const int4* row = inner + static_cast<size_t>(tag >> 1) * (2 * kWidth);
    const int4 a = __ldg(row + 2 * e);
    const int4 b = __ldg(row + 2 * e + 1);
    const int meta = b.z;
    const int ntype = meta & 3;
    const float tx0 = (__int_as_float(a.x) - ox) * ix;
    const float ty0 = (__int_as_float(a.y) - oy) * iy;
    const float tz0 = (__int_as_float(a.z) - oz) * iz;
    const float tx1 = (__int_as_float(a.w) - ox) * ix;
    const float ty1 = (__int_as_float(b.x) - oy) * iy;
    const float tz1 = (__int_as_float(b.y) - oz) * iz;
    const float front = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
    const float back = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
    const bool ok = (ntype != 0) && (back >= front) && (front <= tc) && (back >= tmn);
    const int ctag = ((meta >> 5) << 1) | (ntype == 2 ? 1 : 0);
    // the nearest hit child: the smallest max(front, 0) of the half (a hit
    // child's is finite), then the highest entry at it, as the per-lane
    // loop's dist <= best over rising e
    const float dist = ok ? fmaxf(front, 0.0f) : inf;
    float best = dist;
#pragma unroll
    for (int off = kHalf / 2; off > 0; off >>= 1)
      best = fminf(best, __shfl_xor_sync(kFull, best, off));
    const unsigned hits = __ballot_sync(kFull, ok);
    const unsigned nearest = __ballot_sync(kFull, ok && dist == best);
    unsigned mine = own ? (hits >> base) & 0xffffu : 0u;
    if (own && sp + __popc(mine) > stack_cap) {  // a push would overflow: stop the ray
      atomicOr(overflow, 1);
      sp = 0;
      mine = 0;
    }
    const int near = mine ? 31 - __clz((nearest >> base) & 0xffffu) : 0;
    unsigned others = mine & ~(1u << near);
    bool near_left = mine != 0;
    // the pushes: slot order, the nearest last; one tag a lane a step
    const int steps = max(__popc(hits & 0xffffu), __popc(hits >> kHalf));
    for (int k = 0; k < steps; ++k) {
      const bool push = others != 0 || near_left;
      int j = near;
      if (others) {
        j = __ffs(others) - 1;
        others &= others - 1;
      } else {
        near_left = false;
      }
      const int v = __shfl_sync(kFull, ctag, base + j);
      if (push) {
        stack[sp++] = v;
        top = v;
      }
    }
    if (own && mine == 0) top = sp > 0 ? stack[sp - 1] : 1;
  }
}

// Adds the cycles since ``mark`` to ``acc`` where ``act``, at a point the
// whole warp reaches, and moves ``mark`` on.
__device__ __forceinline__ void warp_lap(unsigned long long& acc, unsigned long long& mark,
                                         bool act) {
  __syncwarp();
  const unsigned long long now = clock64();
  if (act) acc += now - mark;
  mark = now;
}

// HALF_WARP: step 1 by inner_rows_half_warp (16-wide rows), else per lane.
// PROFILE: the clock64 diagnostic, cycles[0..2][num_rays].
template <bool ANY_HIT, int SLOTS, int WIDTH, bool PROFILE, bool HALF_WARP>
__global__ void __launch_bounds__(kThreads)
split_trace_kernel(const int4* __restrict__ inner, const int4* __restrict__ pairs,
                   const float* __restrict__ origin, const float* __restrict__ dir,
                   const float* __restrict__ tmin, const float* __restrict__ tmax,
                   float* __restrict__ t_out, int* __restrict__ tri_out,
                   int* __restrict__ ipops_out, int* __restrict__ lpops_out,
                   int* __restrict__ overflow, const int* __restrict__ start_tags, int num_rays,
                   int leafw, int stack_cap, unsigned long long* __restrict__ cycles) {
  static_assert(!HALF_WARP || WIDTH == kHalf, "a half-warp tests a 16-wide row");
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
  unsigned long long cyc[3] = {0, 0, 0}, mark = 0;  // PROFILE

  int stack[kMaxStack];
  int sp = 0;
  // the start tag; a leaf tag tops the stack and goes straight to step 2
  if (live) stack[sp++] = start_tags ? start_tags[ray] : 0;
  while (__any_sync(kFull, sp > 0)) {
    bool in_round = false;
    if constexpr (PROFILE) {
      in_round = sp > 0;
      __syncwarp();
      mark = clock64();
    }
    // 1. inner rows until a leaf tag tops every lane's stack
    if constexpr (HALF_WARP) {
      inner_rows_half_warp(inner, r, invx, invy, invz, t_cur, lane, stack_cap, stack, sp, ipops,
                           overflow);
    } else {
      // each lane on its own
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
    }
    if constexpr (PROFILE) {
      asm volatile("" ::"r"(sp));
      warp_lap(cyc[0], mark, in_round);
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
    unsigned long long own = 0;  // PROFILE: this ray's group's cycles
    while (pending) {
      unsigned long long g0 = 0;
      if constexpr (PROFILE) {
        __syncwarp();
        g0 = clock64();
      }
      const int leader = __ffs(pending) - 1;
      unsigned group = __shfl_sync(kFull, same, leader);
      const int wstart = __shfl_sync(kFull, start, leader);
      pending &= ~group;
      const bool member = PROFILE && ((group >> lane) & 1u);
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
      if constexpr (PROFILE) {
        asm volatile("" ::"f"(t_cur), "r"(tri));
        __syncwarp();
        if (member) own += clock64() - g0;
      }
    }
    if constexpr (PROFILE) {
      __syncwarp();
      const unsigned long long now = clock64();
      if (at_leaf) {
        cyc[1] += own;
        cyc[2] += now - mark - own;
      }
    }
  }
  if constexpr (PROFILE) {
    if (live) {
      for (int k = 0; k < 3; ++k) cycles[static_cast<size_t>(k) * num_rays + ray] = cyc[k];
    }
  }
  if (live) {
    t_out[ray] = t_cur;
    tri_out[ray] = tri;
    ipops_out[ray] = ipops;
    lpops_out[ray] = lpops;
  }
}

struct Args {
  const void *inner, *pairs, *origin, *dir, *tmin, *tmax;
  void *t_out, *tri_out, *ipops, *lpops, *overflow;
  const void* start;
  int num_rays, leafw, stack_cap;
  void* cycles;
  cudaStream_t stream;
};

template <bool ANY_HIT, int SLOTS, int WIDTH, bool PROFILE, bool HALF_WARP>
void launch(const Args& a) {
  const int blocks = (a.num_rays + kThreads - 1) / kThreads;
  split_trace_kernel<ANY_HIT, SLOTS, WIDTH, PROFILE, HALF_WARP><<<blocks, kThreads, 0, a.stream>>>(
      static_cast<const int4*>(a.inner), static_cast<const int4*>(a.pairs),
      static_cast<const float*>(a.origin), static_cast<const float*>(a.dir),
      static_cast<const float*>(a.tmin), static_cast<const float*>(a.tmax),
      static_cast<float*>(a.t_out), static_cast<int*>(a.tri_out), static_cast<int*>(a.ipops),
      static_cast<int*>(a.lpops), static_cast<int*>(a.overflow),
      static_cast<const int*>(a.start), a.num_rays, a.leafw, a.stack_cap,
      static_cast<unsigned long long*>(a.cycles));
}

template <bool ANY_HIT, int WIDTH, bool PROFILE, bool HALF_WARP>
void launch_slots(const Args& a) {
  switch ((a.leafw + kWarp - 1) / kWarp) {
    case 1:
      launch<ANY_HIT, 1, WIDTH, PROFILE, HALF_WARP>(a);
      break;
    case 2:
      launch<ANY_HIT, 2, WIDTH, PROFILE, HALF_WARP>(a);
      break;
    case 3:
      launch<ANY_HIT, 3, WIDTH, PROFILE, HALF_WARP>(a);
      break;
    default:
      launch<ANY_HIT, kMaxSlots, WIDTH, PROFILE, HALF_WARP>(a);
  }
}

template <int WIDTH, bool PROFILE, bool HALF_WARP>
void launch_mode(const Args& a, int any_hit) {
  if (any_hit)
    launch_slots<true, WIDTH, PROFILE, HALF_WARP>(a);
  else
    launch_slots<false, WIDTH, PROFILE, HALF_WARP>(a);
}

bool valid(int width, int leafw, int stack_cap) {
  return (width == 8 || width == 16) && leafw >= 1 && leafw <= kMaxSlots * kWarp &&
         stack_cap > 0 && stack_cap <= kMaxStack;
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
  if (!valid(width, leafw, stack_cap)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{inner,    pairs,    origin, dir,      tmin,  tmax,      t_out,
               tri_out,  ipops,    lpops,  overflow, start, num_rays,  leafw,
               stack_cap, nullptr, static_cast<cudaStream_t>(stream)};
  if (width == 8)
    launch_mode<8, false, false>(a, any_hit);
  else
    launch_mode<16, false, true>(a, any_hit);
  return static_cast<int>(cudaGetLastError());
}

// The diagnostic: the same five outputs from K1's clock64 instantiation,
// and each ray's cycles in its three phases in ``cycles`` ([3][num_rays]
// uint64). ``per_lane`` at width 16 profiles the per-lane inner rows the
// half-warp design replaced; 8-wide rows run per lane either way.
extern "C" int split_trace_profile_launch(const void* inner, const void* pairs,
                                          const void* origin, const void* dir, const void* tmin,
                                          const void* tmax, void* t_out, void* tri_out,
                                          void* ipops, void* lpops, void* overflow,
                                          const void* start, int num_rays, int width, int leafw,
                                          int any_hit, int stack_cap, int per_lane, void* cycles,
                                          void* stream) {
  if (num_rays <= 0) return 0;
  if (!valid(width, leafw, stack_cap) || cycles == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{inner,    pairs,    origin, dir,      tmin,  tmax,      t_out,
               tri_out,  ipops,    lpops,  overflow, start, num_rays,  leafw,
               stack_cap, cycles, static_cast<cudaStream_t>(stream)};
  if (width == 8)
    launch_mode<8, true, false>(a, any_hit);
  else if (per_lane)
    launch_mode<16, true, false>(a, any_hit);
  else
    launch_mode<16, true, true>(a, any_hit);
  return static_cast<int>(cudaGetLastError());
}
