// K6: fat wide-BVH traversal for Hopper (sm_90a), with each pop's triangle
// tests taken off the running-t chain and shared by the warp.
//
// Replaces the TPU kernel tpu_raytracing/ops/pallas_traverse.py:_kernel
// (line 71, called at line 263), which walks one 128-ray packet per program
// over FatWideBVH rows (bvh/wide.py:build_wide_fat), with its scalar stack
// in SMEM and one 768-byte row DMA per pop.
//
// What it computes (per ray, rays in the order given), from wide row 0:
//   * a row is 256 int32 words (pad_rows_256): 8 entries of (lo xyz, hi xyz,
//     meta, pad) in words 0..63, then entry e's packed pair (v0..v3 xyz,
//     prim0, prim1, rot0, rot1) in words 64 + 16 e .. 79 + 16 e. meta =
//     child << 5 | count << 2 | type.
//   * slab test of every entry with the safe inverse direction (components
//     below 1e-30 clamped to +-1e-30): back >= front, front <= t and
//     back >= tmin, with t the ray's running closest hit.
//   * a Tri entry the box test accepts: Möller-Trumbore on (v0, v1, v2),
//     then, if count > 0, on (v2, v1, v3); each accepts tt <= t, so on an
//     equal t the later test wins; tri = child << 1 (+1 for the second),
//     prim = prim0 (prim1).
//   * Box entries the box test accepts are sorted by the 19-comparator
//     network of the TPU kernel, by the ray's own entry distance,
//     descending, the higher child id nearer on a tie, and pushed far to
//     near, so the nearest pops first.
//   * a push at a depth of stack_cap sets *overflow and stops the ray; the
//     TPU kernel drops the push without a word.
//   * with COUNT (fat_traverse_count_launch), per ray: box tests, 1 for each
//     non-empty entry of every row the ray pops, and triangle-entry tests, 1
//     for each Tri entry whose box test (with the running t) the ray passes,
//     whether the entry holds one triangle or two. They are what the
//     reference's wide tracer counts per 128-ray packet
//     (tpu_raytracing/trace/wide_fat.py:108,117), counted per ray.
//
// What bounds it. The arithmetic is small: 25 operations a slab test and 61
// a triangle test come to 0.0493 ms of float32 issue on the 1M bounce pass
// (chip_smoke.py phase 9), which the kernel misses by about 32x. A pop is a
// chain of dependent steps: the stack top gives the row, its 64 node words
// come from L1 or L2 as sixteen 16-byte loads a lane, the 8 slab tests
// follow, then the triangles of the accepted Tri entries (a second
// dependent load, the entry's pair words), the pushes and the next pop. A
// bounce ray pops 26.1 rows and runs 0.31 triangle tests a pop. Timed by
// the warp at __syncwarp points, this kernel spends about 30% of its cycles
// on node loads and box tests, 35% on the Tri entries and 35% on sort,
// push and pop, on every pass: no phase dominates, the chain does. The
// kernel it replaced (one thread per ray, each triangle loaded and tested
// when its in-order walk reaches the entry, every child through the local
// stack) can only be timed per lane, 65 / 2 / 33% on the bounce pass, and a
// lane waiting for other lanes' triangles books the wait to its next box
// test, so that split hides the divergence this design removes.
//
// What the design does about it. Per pop, in three phases:
//   1. every lane loads its row's 64 node words as 16-byte vectors and
//      tests all 8 boxes against t_in, the ray's t at the start of the pop;
//   2. the triangles of the entries that pass. Since t only falls, an
//      entry's box test with the running t is box_in(e) && front_e <= t,
//      and a triangle test is its t-free part (edges, determinant, u, v,
//      tt >= tmin) and tt <= t. So every triangle's t-free part runs before
//      the walk, off the running-t chain, spread over the warp: a
//      __shfl_up_sync prefix sum of each lane's count gives every (ray,
//      entry) task a slot in a per-warp shared list; each round, lane l
//      takes task l of the round, receives its ray and row by __shfl_sync,
//      loads the entry's pair words and writes both triangles' tt (NaN
//      where the t-free part rejects, or for a missing second triangle) to
//      a per-warp shared buffer. After __syncwarp each ray walks its 8
//      entries in order on its own lane with the plain version's running
//      t: an entry is taken if box_in(e) && front_e <= t, a triangle if
//      tt <= t. That keeps the tie rule (the later test wins an equal t)
//      and the box re-check bit-equal. A pop with no accepted Tri entry
//      skips the walk: t did not move, so its pushes are its accepted Box
//      entries;
//   3. the pushes: none pops the stack, one becomes the next row directly,
//      more go through the push network, the nearest kept in a register as
//      the next row rather than stored and loaded again. The overflow check
//      is made at the logical depth, sp + pushes > stack_cap.
// u, v and prim of the closest hit are recomputed once at the end, from the
// winner's pair words with the same code, so the shared buffer carries only
// the two tt words of a task. All 32 lanes stay in the warp's loop until
// every ray of the warp is done (finished and overflowed rays and lanes past
// num_rays keep serving), and every warp intrinsic takes the full mask.
//
// What it gains, and where it loses (NVIDIA H100 80GB HBM3, 700 W; PERF.md
// section 6), against the replaced kernel in the same process: 6-11% on
// the 1M bounce pass (1.71-1.75 -> 1.56-1.61 ms) and 4-8% on the bounce
// shadow pass, whose warps diverge; 1-9% lost on the coherent primary
// passes, where there is little divergence to remove and the longer chain
// of a pop with Tri entries is not repaid. Three fixes for those measured
// slower there: 72 registers for 28 warps an SM (it spills), testing in
// order on the owning lane whenever the warp's entries are spread evenly,
// and an L1 prefetch of the accepted entries' pair lines.
//
// The diagnostics (fat_traverse_profile_launch): this kernel's clock64
// instantiation, and the replaced kernel profiled per lane, each writing
// per ray the cycles of the three phases (node loads and box tests; the Tri
// entries with the walk; sort, push and pop) and the triangle tests run;
// their six outputs stay bit-equal.
//
// The counting instantiation (COUNT) is the same kernel plus two int
// registers a lane: the box tests are added in phase 1 by the lane that
// owns the ray, the triangle-entry tests in the walk, where the owning lane
// re-checks each entry with the running t. So a count lands on its own ray
// although the triangle tests of a pop are spread over the warp. The render
// modes' wide tracer takes it (trace/wide_fat.py); the binary frame keeps
// the instantiation without counts.
//
// The any-hit instantiation (fat_traverse_any_kernel, a kernel of its own so
// that the two above keep their code) ends a ray at its first occluder; the
// wide path tracer's shadow passes take it
// (trace/wide_fat.py:make_fat_frame_tracers).
//
// Bit-exactness: compiled with -fmad=false and without fast math, and every
// expression keeps the order of the plain PyTorch version
// (tpu_raytracing_torch/ops/fat_traverse.py:trace_fat_plain), so the kernel
// and both diagnostics agree with it bit for bit on hit, t, prim, tri, u
// and v, the counting instantiation on both counts too, and the any-hit
// instantiation with trace_fat_plain(..., any_hit=True) on all six.

#include <cuda_runtime.h>

namespace {

constexpr int kWide = 8;
constexpr int kRowVec = 256 / 4;  // int4 per row
constexpr int kPairVec = 16;      // int4 of node words before the pairs
constexpr int kMaxStack = 160;
constexpr int kThreads = 128;
// blocks an SM: caps the kernel at 80 registers (24 warps an SM, against 20
// at the 90-96 it takes unbounded)
constexpr int kMinBlocks = 6;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxTasks = kWarp * kWide;  // Tri entries a warp can accept in one pop
constexpr unsigned kFull = 0xffffffffu;
constexpr float kF32Max = 3.402823466e+38f;
constexpr float kTriEps = 1e-9f;
constexpr int kTypeBox = 1;
constexpr int kTypeTri = 2;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin;
};

// No tt <= t takes a NaN.
__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

// Möller-Trumbore's t-free part: true if accepted up to the tt <= t test,
// with (tt, uu, vv).
__device__ __forceinline__ bool moller_trumbore(
    const Ray& r, float a0, float a1, float a2, float b0, float b1, float b2, float c0,
    float c1, float c2, float& tt, float& uu, float& vv) {
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
         (tt >= r.tmin);
}

// A pair's 12 vertex words: v0 = (a), v1 = (b), v2 = (c), v3 = (q).
struct Pair {
  float ax, ay, az, bx, by, bz, cx, cy, cz, qx, qy, qz;
};

__device__ __forceinline__ Pair load_pair(const int4* p) {
  const int4 q0 = __ldg(p), q1 = __ldg(p + 1), q2 = __ldg(p + 2);
  return Pair{__int_as_float(q0.x), __int_as_float(q0.y), __int_as_float(q0.z),
              __int_as_float(q0.w), __int_as_float(q1.x), __int_as_float(q1.y),
              __int_as_float(q1.z), __int_as_float(q1.w), __int_as_float(q2.x),
              __int_as_float(q2.y), __int_as_float(q2.z), __int_as_float(q2.w)};
}

// tt of a pair's first (second = false) or second triangle if its t-free
// part accepts, else NaN, which no tt <= t takes.
__device__ __forceinline__ float triangle_t(const Ray& r, const Pair& p, bool second) {
  float tt, uu, vv;
  const bool acc = second ? moller_trumbore(r, p.cx, p.cy, p.cz, p.bx, p.by, p.bz, p.qx, p.qy,
                                            p.qz, tt, uu, vv)
                          : moller_trumbore(r, p.ax, p.ay, p.az, p.bx, p.by, p.bz, p.cx, p.cy,
                                            p.cz, tt, uu, vv);
  return acc ? tt : quiet_nan();
}

__device__ __forceinline__ float safe_inverse(float d) {
  const float s = fabsf(d) < 1e-30f ? (d < 0.0f ? -1e-30f : 1e-30f) : d;
  return 1.0f / s;
}

// Slab test of one entry: returns front, sets back.
__device__ __forceinline__ float slab(const int4& a, const int4& b, const Ray& r, float invx,
                                      float invy, float invz, float& back) {
  const float tx0 = (__int_as_float(a.x) - r.ox) * invx;
  const float ty0 = (__int_as_float(a.y) - r.oy) * invy;
  const float tz0 = (__int_as_float(a.z) - r.oz) * invz;
  const float tx1 = (__int_as_float(a.w) - r.ox) * invx;
  const float ty1 = (__int_as_float(b.x) - r.oy) * invy;
  const float tz1 = (__int_as_float(b.y) - r.oz) * invz;
  back = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
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

__device__ __forceinline__ void push_network(float* cd, int* cc) {
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
}

__device__ __forceinline__ Ray load_ray(const float* origin, const float* dir,
                                        const float* tmin, int ray) {
  return Ray{origin[3 * ray + 0], origin[3 * ray + 1], origin[3 * ray + 2], dir[3 * ray + 0],
             dir[3 * ray + 1], dir[3 * ray + 2], tmin[ray]};
}

// Adds the cycles since ``mark`` to ``acc`` and moves ``mark`` on.
__device__ __forceinline__ void lap(unsigned long long& acc, unsigned long long& mark) {
  const unsigned long long now = clock64();
  acc += now - mark;
  mark = now;
}

// The same at a point the whole warp reaches: the cycles until its last
// lane gets there, booked to every lane whose ray is in the pop.
__device__ __forceinline__ void warp_lap(unsigned long long& acc, unsigned long long& mark,
                                         bool act) {
  __syncwarp();
  const unsigned long long now = clock64();
  if (act) acc += now - mark;
  mark = now;
}


// K6. PROFILE adds the warp's clock64 cycles in each phase of a pop (taken
// at a __syncwarp, so a phase ends when its slowest lane ends it) to every
// ray in the pop, in cycles[0..2][num_rays], and each ray's triangle tests
// run in cycles[3]; COUNT writes each ray's box tests and triangle-entry
// tests to box_out and tri_tests_out. The six outputs are the same.
template <bool PROFILE, bool COUNT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fat_traverse_kernel(const int4* __restrict__ rows, const float* __restrict__ origin,
                    const float* __restrict__ dir, const float* __restrict__ tmin,
                    const float* __restrict__ tmax, int* __restrict__ hit_out,
                    float* __restrict__ t_out, int* __restrict__ prim_out,
                    int* __restrict__ tri_out, float* __restrict__ u_out,
                    float* __restrict__ v_out, int* __restrict__ overflow,
                    int* __restrict__ box_out, int* __restrict__ tri_tests_out,
                    unsigned long long* __restrict__ cycles, int num_rays, int stack_cap) {
  __shared__ int s_task[kWarps][kMaxTasks];
  __shared__ float s_t0[kWarps][kMaxTasks];
  __shared__ float s_t1[kWarps][kMaxTasks];
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const bool live = ray < num_rays;  // a lane past num_rays only serves the warp
  Ray r{0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, 0.0f};
  float t = 0.0f;
  if (live) {
    r = load_ray(origin, dir, tmin, ray);
    t = tmax[ray];
  }
  const float invx = safe_inverse(r.dx), invy = safe_inverse(r.dy), invz = safe_inverse(r.dz);
  // the closest hit so far: its row, entry << 1 | second, and tri id
  int hit = 0, win_node = 0, win_code = 0, win_tri = 0;
  unsigned long long cyc[3] = {0, 0, 0}, mark = PROFILE ? clock64() : 0;
  int tests = 0;  // triangle tests run for this ray (PROFILE)
  int box_tests = 0, tri_tests = 0;  // COUNT

  int stack[kMaxStack];
  int sp = 0;
  int node = live ? 0 : -1;  // the row being popped; -1 once the ray is done
  while (__any_sync(kFull, node >= 0)) {
    const bool act = node >= 0;
    // 1. node words and box tests against t_in
    const int4* row = rows + static_cast<size_t>(act ? node : 0) * kRowVec;
    float front[kWide];
    int child[kWide];
    unsigned in_tri = 0, in_box = 0, second = 0, nonempty = 0;
    if (act) {
#pragma unroll
      for (int e = 0; e < kWide; ++e) {
        const int4 a = __ldg(row + 2 * e);
        const int4 b = __ldg(row + 2 * e + 1);
        const int meta = b.z;
        const int ntype = meta & 3;
        child[e] = meta >> 5;
        float back;
        front[e] = slab(a, b, r, invx, invy, invz, back);
        const bool in = (back >= front[e]) && (front[e] <= t) && (back >= r.tmin);
        in_tri |= (in && ntype == kTypeTri) ? 1u << e : 0u;
        in_box |= (in && ntype == kTypeBox) ? 1u << e : 0u;
        second |= (((meta >> 2) & 7) > 0) ? 1u << e : 0u;
        nonempty |= ntype != 0 ? 1u << e : 0u;
      }
      if (COUNT) box_tests += __popc(nonempty);
    }
    if (PROFILE) {
      asm volatile("" ::"r"(in_tri), "r"(in_box));
      warp_lap(cyc[0], mark, act);
    }
    // 2. the t-free part of every accepted Tri entry's triangles, spread
    // over the warp: lane l of a round takes task l of the warp's list
    const int n_tri = __popc(in_tri);
    int incl = n_tri;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    const int base = incl - n_tri;  // this lane's first task in the warp's list
    const int total = __shfl_sync(kFull, incl, kWarp - 1);
    if (total > 0) {
      int k = base;
      for (unsigned m = in_tri; m; m &= m - 1) {
        const int e = __ffs(m) - 1;
        s_task[warp][k++] = lane << 4 | e << 1 | static_cast<int>((second >> e) & 1u);
      }
      if (PROFILE) tests += n_tri + __popc(in_tri & second);
      __syncwarp();
      for (int first = 0; first < total; first += kWarp) {
        const int idx = first + lane;
        const bool has = idx < total;
        const int code = has ? s_task[warp][idx] : 0;
        const int owner = code >> 4;
        Ray g;
        g.ox = __shfl_sync(kFull, r.ox, owner);
        g.oy = __shfl_sync(kFull, r.oy, owner);
        g.oz = __shfl_sync(kFull, r.oz, owner);
        g.dx = __shfl_sync(kFull, r.dx, owner);
        g.dy = __shfl_sync(kFull, r.dy, owner);
        g.dz = __shfl_sync(kFull, r.dz, owner);
        g.tmin = __shfl_sync(kFull, r.tmin, owner);
        const int g_node = __shfl_sync(kFull, node, owner);
        if (has) {
          const Pair p = load_pair(rows + static_cast<size_t>(g_node) * kRowVec + kPairVec +
                                   4 * ((code >> 1) & 7));
          s_t0[warp][idx] = triangle_t(g, p, false);
          s_t1[warp][idx] = (code & 1) ? triangle_t(g, p, true) : quiet_nan();
        }
      }
      __syncwarp();
    }
    // the walk, in entry order with the running t
    unsigned push = 0;
    if (act && !in_tri) {
      push = in_box;  // t did not move: every accepted Box entry is pushed
    } else if (act) {
#pragma unroll
      for (int e = 0; e < kWide; ++e) {
        const bool ok = (((in_tri | in_box) >> e) & 1u) && front[e] <= t;
        if (ok && ((in_tri >> e) & 1u)) {
          if (COUNT) ++tri_tests;
          const int k = base + __popc(in_tri & ((1u << e) - 1u));
          const float t0 = s_t0[warp][k];
          const float t1 = s_t1[warp][k];
          if (t0 <= t) {
            t = t0;
            hit = 1;
            win_node = node;
            win_code = e << 1;
            win_tri = child[e] << 1;
          }
          if (t1 <= t) {
            t = t1;
            hit = 1;
            win_node = node;
            win_code = (e << 1) | 1;
            win_tri = (child[e] << 1) + 1;
          }
        }
        push |= (ok && ((in_box >> e) & 1u)) ? 1u << e : 0u;
      }
    }
    if (PROFILE) {
      asm volatile("" ::"f"(t), "r"(push));
      warp_lap(cyc[1], mark, act);
    }
    // 3. push far to near; the nearest is kept as the next row. The n pushes
    // overflow at a logical depth of stack_cap exactly when sp + n > stack_cap.
    if (act) {
      const int n = __popc(push);
      if (sp + n > stack_cap) {
        atomicOr(overflow, 1);
        sp = 0;
        node = -1;
      } else if (n == 0) {
        node = sp > 0 ? stack[--sp] : -1;
      } else if (n == 1) {
        int only = 0;
#pragma unroll
        for (int e = 0; e < kWide; ++e) only = ((push >> e) & 1u) ? child[e] : only;
        node = only;
      } else {
        float cd[kWide];
        int cc[kWide];
#pragma unroll
        for (int e = 0; e < kWide; ++e) {
          const bool p = (push >> e) & 1u;
          cd[e] = p ? front[e] : -kF32Max;
          cc[e] = p ? child[e] : -1;
        }
        push_network(cd, cc);
        int keep = -1;
#pragma unroll
        for (int e = 0; e < kWide; ++e) {
          if (cc[e] >= 0) {
            if (keep >= 0) stack[sp++] = keep;
            keep = cc[e];
          }
        }
        node = keep;
      }
    }
    if (PROFILE) {
      asm volatile("" ::"r"(node));
      warp_lap(cyc[2], mark, act);
    }
  }
  if (!live) return;
  int prim = 0, tri = 0;
  float u = 0.0f, v = 0.0f;
  if (hit) {
    // the winner's barycentrics and prim, from its pair words, as its test
    // computed them
    const int e = win_code >> 1, sec = win_code & 1;
    const int4* p = rows + static_cast<size_t>(win_node) * kRowVec + kPairVec + 4 * e;
    const Pair q = load_pair(p);
    const int4 ids = __ldg(p + 3);
    float tt;
    if (sec)
      moller_trumbore(r, q.cx, q.cy, q.cz, q.bx, q.by, q.bz, q.qx, q.qy, q.qz, tt, u, v);
    else
      moller_trumbore(r, q.ax, q.ay, q.az, q.bx, q.by, q.bz, q.cx, q.cy, q.cz, tt, u, v);
    prim = sec ? ids.y : ids.x;
    tri = win_tri;
  }
  if (PROFILE) {
    for (int k = 0; k < 3; ++k) cycles[static_cast<size_t>(k) * num_rays + ray] = cyc[k];
    cycles[3 * static_cast<size_t>(num_rays) + ray] = tests;
  }
  if (COUNT) {
    box_out[ray] = box_tests;
    tri_tests_out[ray] = tri_tests;
  }
  hit_out[ray] = hit;
  t_out[ray] = t;
  prim_out[ray] = prim;
  tri_out[ray] = tri;
  u_out[ray] = u;
  v_out[ray] = v;
}

// K6's any-hit instantiation (fat_traverse_any_launch), for shadow rays: a
// ray ends at the first pop in which a triangle's t-free test accepts with
// tt <= tmax, and reports hit = 1; its t stays tmax, and prim, tri, u and v
// are 0. Since t never falls, phase 1's box tests against t_in are final:
// the walk goes, a pop's Tri entries are tested as in K6's phase 2 (the
// task lane ORs its ray's bit into a per-warp word when a triangle
// occludes), and a pop with no occluder pushes its accepted Box entries as
// K6's phase 3 does, with K6's stack and overflow check.
// A closest-hit walk with the same tmax finds a hit exactly when this one
// does: it tests the same boxes against a t no larger than tmax, and an
// occluder it would reach lies in a box this walk enters.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fat_traverse_any_kernel(const int4* __restrict__ rows, const float* __restrict__ origin,
                        const float* __restrict__ dir, const float* __restrict__ tmin,
                        const float* __restrict__ tmax, int* __restrict__ hit_out,
                        float* __restrict__ t_out, int* __restrict__ prim_out,
                        int* __restrict__ tri_out, float* __restrict__ u_out,
                        float* __restrict__ v_out, int* __restrict__ overflow, int num_rays,
                        int stack_cap) {
  __shared__ int s_task[kWarps][kMaxTasks];
  __shared__ unsigned s_occluded[kWarps];
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const bool live = ray < num_rays;  // a lane past num_rays only serves the warp
  Ray r{0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, 0.0f};
  float t = 0.0f;
  if (live) {
    r = load_ray(origin, dir, tmin, ray);
    t = tmax[ray];
  }
  const float invx = safe_inverse(r.dx), invy = safe_inverse(r.dy), invz = safe_inverse(r.dz);
  int hit = 0;
  int stack[kMaxStack];
  int sp = 0;
  int node = live ? 0 : -1;  // the row being popped; -1 once the ray is done
  while (__any_sync(kFull, node >= 0)) {
    const bool act = node >= 0;
    // 1. node words and box tests against t = tmax
    const int4* row = rows + static_cast<size_t>(act ? node : 0) * kRowVec;
    float front[kWide];
    int child[kWide];
    unsigned in_tri = 0, in_box = 0, second = 0;
    if (act) {
#pragma unroll
      for (int e = 0; e < kWide; ++e) {
        const int4 a = __ldg(row + 2 * e);
        const int4 b = __ldg(row + 2 * e + 1);
        const int meta = b.z;
        const int ntype = meta & 3;
        child[e] = meta >> 5;
        float back;
        front[e] = slab(a, b, r, invx, invy, invz, back);
        const bool in = (back >= front[e]) && (front[e] <= t) && (back >= r.tmin);
        in_tri |= (in && ntype == kTypeTri) ? 1u << e : 0u;
        in_box |= (in && ntype == kTypeBox) ? 1u << e : 0u;
        second |= (((meta >> 2) & 7) > 0) ? 1u << e : 0u;
      }
    }
    // 2. the accepted Tri entries' triangles, spread over the warp as in K6
    const int n_tri = __popc(in_tri);
    int incl = n_tri;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    const int total = __shfl_sync(kFull, incl, kWarp - 1);
    if (total > 0) {
      int k = incl - n_tri;
      for (unsigned m = in_tri; m; m &= m - 1) {
        const int e = __ffs(m) - 1;
        s_task[warp][k++] = lane << 4 | e << 1 | static_cast<int>((second >> e) & 1u);
      }
      if (lane == 0) s_occluded[warp] = 0u;
      __syncwarp();
      for (int first = 0; first < total; first += kWarp) {
        const int idx = first + lane;
        const bool has = idx < total;
        const int code = has ? s_task[warp][idx] : 0;
        const int owner = code >> 4;
        Ray g;
        g.ox = __shfl_sync(kFull, r.ox, owner);
        g.oy = __shfl_sync(kFull, r.oy, owner);
        g.oz = __shfl_sync(kFull, r.oz, owner);
        g.dx = __shfl_sync(kFull, r.dx, owner);
        g.dy = __shfl_sync(kFull, r.dy, owner);
        g.dz = __shfl_sync(kFull, r.dz, owner);
        g.tmin = __shfl_sync(kFull, r.tmin, owner);
        const float g_t = __shfl_sync(kFull, t, owner);
        const int g_node = __shfl_sync(kFull, node, owner);
        if (has) {
          const Pair p = load_pair(rows + static_cast<size_t>(g_node) * kRowVec + kPairVec +
                                   4 * ((code >> 1) & 7));
          if (triangle_t(g, p, false) <= g_t || ((code & 1) && triangle_t(g, p, true) <= g_t))
            atomicOr(&s_occluded[warp], 1u << owner);
        }
      }
      __syncwarp();
      hit |= static_cast<int>((s_occluded[warp] >> lane) & 1u);
      // every lane reads the word before the next pop's lane 0 clears it
      __syncwarp();
    }
    // 3. an occluded ray is done; otherwise push far to near, as K6
    if (act) {
      const int n = __popc(in_box);
      if (hit) {
        node = -1;
      } else if (sp + n > stack_cap) {
        atomicOr(overflow, 1);
        sp = 0;
        node = -1;
      } else if (n == 0) {
        node = sp > 0 ? stack[--sp] : -1;
      } else if (n == 1) {
        int only = 0;
#pragma unroll
        for (int e = 0; e < kWide; ++e) only = ((in_box >> e) & 1u) ? child[e] : only;
        node = only;
      } else {
        float cd[kWide];
        int cc[kWide];
#pragma unroll
        for (int e = 0; e < kWide; ++e) {
          const bool p = (in_box >> e) & 1u;
          cd[e] = p ? front[e] : -kF32Max;
          cc[e] = p ? child[e] : -1;
        }
        push_network(cd, cc);
        int keep = -1;
#pragma unroll
        for (int e = 0; e < kWide; ++e) {
          if (cc[e] >= 0) {
            if (keep >= 0) stack[sp++] = keep;
            keep = cc[e];
          }
        }
        node = keep;
      }
    }
  }
  if (!live) return;
  hit_out[ray] = hit;
  t_out[ray] = t;
  prim_out[ray] = 0;
  tri_out[ray] = 0;
  u_out[ray] = 0.0f;
  v_out[ray] = 0.0f;
}

// A diagnostic, not K6: the kernel K6 replaced (one thread per ray, entries
// walked in order with the running t, a Tri entry's pair loaded and tested
// once its box passes, every child through the local stack), profiled per
// lane into cycles[0..2][num_rays], with its triangle tests in cycles[3]. A
// lane waiting at a reconvergence point for other lanes' triangles books
// that wait to its own next phase, so its split cannot tell divergence from
// work.
__global__ void __launch_bounds__(kThreads)
fat_traverse_thread_split(const int4* __restrict__ rows, const float* __restrict__ origin,
                          const float* __restrict__ dir, const float* __restrict__ tmin,
                          const float* __restrict__ tmax, int* __restrict__ hit_out,
                          float* __restrict__ t_out, int* __restrict__ prim_out,
                          int* __restrict__ tri_out, float* __restrict__ u_out,
                          float* __restrict__ v_out, int* __restrict__ overflow,
                          unsigned long long* __restrict__ cycles, int num_rays,
                          int stack_cap) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= num_rays) return;
  const Ray r = load_ray(origin, dir, tmin, ray);
  const float invx = safe_inverse(r.dx), invy = safe_inverse(r.dy), invz = safe_inverse(r.dz);
  float t = tmax[ray];
  int hit = 0, prim = 0, tri = 0;
  float u = 0.0f, v = 0.0f;
  unsigned long long cyc[3] = {0, 0, 0}, mark = clock64();
  int tests = 0;

  int stack[kMaxStack];
  int sp = 0;
  stack[sp++] = 0;  // root: wide row 0
  while (sp > 0) {
    const int node = stack[--sp];
    const int4* row = rows + static_cast<size_t>(node) * kRowVec;
    lap(cyc[2], mark);
    float cd[kWide];
    int cc[kWide];
#pragma unroll
    for (int e = 0; e < kWide; ++e) {
      const int4 a = __ldg(row + 2 * e);
      const int4 b = __ldg(row + 2 * e + 1);
      const int meta = b.z;
      const int ntype = meta & 3;
      const int child = meta >> 5;
      float back;
      const float front = slab(a, b, r, invx, invy, invz, back);
      const bool box_hit = (back >= front) && (front <= t) && (back >= r.tmin);
      asm volatile("" ::"r"(static_cast<int>(box_hit)));
      lap(cyc[0], mark);
      if (box_hit && ntype == kTypeTri) {
        tests += 1 + (((meta >> 2) & 7) > 0);
        const int4* p = row + kPairVec + 4 * e;
        const Pair q = load_pair(p);
        const int4 ids = __ldg(p + 3);
        float tt, uu, vv;
        if (moller_trumbore(r, q.ax, q.ay, q.az, q.bx, q.by, q.bz, q.cx, q.cy, q.cz, tt, uu,
                            vv) &&
            tt <= t) {
          t = tt;
          hit = 1;
          prim = ids.x;
          tri = child << 1;
          u = uu;
          v = vv;
        }
        if (((meta >> 2) & 7) > 0 &&
            moller_trumbore(r, q.cx, q.cy, q.cz, q.bx, q.by, q.bz, q.qx, q.qy, q.qz, tt, uu,
                            vv) &&
            tt <= t) {
          t = tt;
          hit = 1;
          prim = ids.y;
          tri = (child << 1) + 1;
          u = uu;
          v = vv;
        }
        asm volatile("" ::"f"(t));
        lap(cyc[1], mark);
      }
      const bool push = box_hit && ntype == kTypeBox;
      cd[e] = push ? front : -kF32Max;
      cc[e] = push ? child : -1;
    }
    push_network(cd, cc);
#pragma unroll
    for (int e = 0; e < kWide; ++e) {
      if (cc[e] >= 0) {
        if (sp >= stack_cap) {
          atomicOr(overflow, 1);
          sp = 0;
          break;
        }
        stack[sp++] = cc[e];
      }
    }
  }
  lap(cyc[2], mark);
  for (int k = 0; k < 3; ++k) cycles[static_cast<size_t>(k) * num_rays + ray] = cyc[k];
  cycles[3 * static_cast<size_t>(num_rays) + ray] = tests;
  hit_out[ray] = hit;
  t_out[ray] = t;
  prim_out[ray] = prim;
  tri_out[ray] = tri;
  u_out[ray] = u;
  v_out[ray] = v;
}

}  // namespace

#define FAT_PARAMS                                                                         \
  const void *rows, const void *origin, const void *dir, const void *tmin, const void *tmax, \
      void *hit_out, void *t_out, void *prim_out, void *tri_out, void *u_out, void *v_out,   \
      void *overflow, int num_rays, int stack_cap
#define FAT_ARGS                                                                           \
  static_cast<const int4*>(rows), static_cast<const float*>(origin),                        \
      static_cast<const float*>(dir), static_cast<const float*>(tmin),                      \
      static_cast<const float*>(tmax), static_cast<int*>(hit_out), static_cast<float*>(t_out), \
      static_cast<int*>(prim_out), static_cast<int*>(tri_out), static_cast<float*>(u_out),  \
      static_cast<float*>(v_out), static_cast<int*>(overflow)

// Plain C interface, bound with ctypes. Pointers are device pointers;
// ``stream`` is a cudaStream_t. Returns the cudaError_t of the launch.
extern "C" int fat_traverse_launch(FAT_PARAMS, void* stream) {
  if (num_rays <= 0) return 0;
  if (stack_cap <= 0 || stack_cap > kMaxStack) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (num_rays + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fat_traverse_kernel<false, false>
      <<<blocks, kThreads, 0, s>>>(FAT_ARGS, nullptr, nullptr, nullptr, num_rays, stack_cap);
  return static_cast<int>(cudaGetLastError());
}

// K6's any-hit instantiation: hit, t = tmax, and prim, tri, u, v = 0.
extern "C" int fat_traverse_any_launch(FAT_PARAMS, void* stream) {
  if (num_rays <= 0) return 0;
  if (stack_cap <= 0 || stack_cap > kMaxStack) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (num_rays + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fat_traverse_any_kernel<<<blocks, kThreads, 0, s>>>(FAT_ARGS, num_rays, stack_cap);
  return static_cast<int>(cudaGetLastError());
}

// K6's counting instantiation: the same outputs, and each ray's box tests
// and triangle-entry tests in ``box_out`` and ``tri_tests_out`` (int32).
extern "C" int fat_traverse_count_launch(FAT_PARAMS, void* box_out, void* tri_tests_out,
                                         void* stream) {
  if (num_rays <= 0) return 0;
  if (stack_cap <= 0 || stack_cap > kMaxStack || box_out == nullptr || tri_tests_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (num_rays + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fat_traverse_kernel<false, true><<<blocks, kThreads, 0, s>>>(
      FAT_ARGS, static_cast<int*>(box_out), static_cast<int*>(tri_tests_out), nullptr, num_rays,
      stack_cap);
  return static_cast<int>(cudaGetLastError());
}

// The diagnostics: K6's profiled form (per_thread 0) or the earlier
// one-thread-per-ray kernel's (per_thread 1), writing their [4][num_rays]
// clock64 split and triangle tests to ``cycles``.
extern "C" int fat_traverse_profile_launch(FAT_PARAMS, int per_thread, void* cycles,
                                           void* stream) {
  if (num_rays <= 0) return 0;
  if (stack_cap <= 0 || stack_cap > kMaxStack || cycles == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (num_rays + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* cyc = static_cast<unsigned long long*>(cycles);
  if (per_thread)
    fat_traverse_thread_split<<<blocks, kThreads, 0, s>>>(FAT_ARGS, cyc, num_rays, stack_cap);
  else
    fat_traverse_kernel<true, false>
        <<<blocks, kThreads, 0, s>>>(FAT_ARGS, nullptr, nullptr, cyc, num_rays, stack_cap);
  return static_cast<int>(cudaGetLastError());
}
