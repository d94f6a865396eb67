// The app's instanced tracers around K1 (trace/instanced_split.py:
// trace_instanced): the candidate sweep over the instances' world boxes,
// the items mapped into object space, each item's K1 result folded into its
// ray, and the closest-hit record. One launch each.
//
// The sweep replaces no TPU kernel: the JAX package sweeps with XLA
// operations (tpu_raytracing/trace/instanced_split.py: candidate_masks and
// peel_candidates), which XLA fuses. Run eagerly in PyTorch the same sweep
// made [R, 256] float32 temporaries, about 20 of them for every 256
// instances, and bitmask words of [R, I / 32] int64, then some 10 launches
// for each candidate slot peeled: at R = 1M rays and 1,000 instances over
// 100 GB of memory traffic and thousands of launches a frame. The other
// three kernels replace the JAX package's item sort glue, winner scatter and
// record reconstruction (instanced_split.py:trace_rays_instanced_split).
//
// What it computes:
//   * inst_sweep_kernel, one thread a ray i of R: with inv = 1 / d (each
//     component with |d| < 1e-30 first set to +-1e-30), for each instance
//     box in ascending order the slab test of candidate_masks: t0 = (lo -
//     o) * inv, t1 = (hi - o) * inv per axis, front = max over the axes (x,
//     then y, then z) of min(t0, t1), back = min of max(t0, t1), an overlap
//     where back >= front, front <= tmax and back >= tmin. A dead ray
//     (active false) tests nothing. Its overlaps, lowest instance first,
//     go to consecutive item slots from first[i]: slot s gets item_ray = i
//     and item_key = 1 + (instance << 3 | octant), octant bit a set where
//     d[a] > 0; slots at or past `capacity` are not written. nov[i] counts
//     every overlap. The ray's resolve state starts here: best = INT64_MAX
//     or occluded = false, box and triangle tests 0. stats[0] gets the
//     call's overlaps, stats[1] its live rays, stats[2] its largest
//     overlap.
//   * inst_items_kernel, one thread a slot j of the key-sorted slots: the
//     slot's ray (ray 0 for an unused slot, key 0) mapped by its
//     instance's inverse transform m (instance 0 for an unused slot): o' =
//     ((m[c][0] o.x + m[c][1] o.y) + m[c][2] o.z) + m[c][3], d' likewise
//     without m[c][3] and then clamped as above; tmin and tmax the ray's,
//     or F32_MAX and -F32_MAX for an unused slot; the slot's ray, or -1.
//   * inst_resolve_kernel, one thread a slot: the slot's K1 pops added to
//     its ray's box tests (inner pops x width) and triangle tests (leaf
//     pops x 2 x leaf width); a closest hit (tri >= 0, t < F32_MAX) takes
//     the 64-bit minimum of (t's bits as an ordered signed word << 32 |
//     instance x tri_range + tri) into best[ray]; an any hit (tri >= 0)
//     sets occluded[ray]. Slot 0 also sets stats[3] = (stats[0] >
//     capacity) and the call's overflow flag: K1's plus `candidate_overflow`
//     where stats[3] is set.
//   * inst_record_kernel, one thread a ray: the winner decoded from best,
//     the world ray mapped by the winner's instance as in the item kernel
//     (the direction not clamped) and the split front's record kernel's
//     Moller-Trumbore barycentrics there; a ray without a winner gets t =
//     tmax, prim 0, tri 0, u = v = +0.0 and instance -1.
// Every value is the plain versions', bit for bit: the same operations in
// the same order, IEEE division, no contraction (-fmad=false); cross and
// dot written out as ops/intersect.py writes them. Only the sweep's slot
// order differs from its plain version's: a block of rays reserves its
// slots with one atomic add, in whatever order the blocks run, and no
// result depends on that order.
//
// What bounds them. The sweep is the arithmetic of R x I slab tests, about
// 25 operations each (1,000 instances and 1M rays: some 25 G operations a
// call, about 1 ms at the card's float32 rate), for 32 bytes read a ray and
// 8 written an overlap. The design: one thread a ray keeps its ray in
// registers while the block stages 256 instance boxes at a time in shared
// memory, read by every thread at the same address (a broadcast); a ray
// keeps its first 32 overlaps in a local array and emits them after one
// atomic add a block reserves the block's slots, and a block with a ray of
// more than 32 overlaps sweeps again to emit them. The other three kernels
// are bytes: one thread a slot or a ray, every per-slot array read at the
// thread's own index; the resolve's atomics go to a ray's few slots.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// instance boxes staged in shared memory at a time
constexpr int kTile = 256;
// overlaps a thread keeps before its block sweeps again to emit them
constexpr int kLocal = 32;
constexpr float kF32Max = 3.4028234663852886e38f;
constexpr float kTiny = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float clamp_dir(float d) {
  return fabsf(d) < kTiny ? (d < 0.0f ? -kTiny : kTiny) : d;
}

struct Ray {
  float o[3], inv[3], tmin, tmax;
};

// candidate_masks' slab test of the ray against staged box k
__device__ __forceinline__ bool overlaps(const float (*box)[kTile], int k, const Ray& r) {
  float t0 = (box[0][k] - r.o[0]) * r.inv[0];
  float t1 = (box[3][k] - r.o[0]) * r.inv[0];
  float front = fminf(t0, t1);
  float back = fmaxf(t0, t1);
  t0 = (box[1][k] - r.o[1]) * r.inv[1];
  t1 = (box[4][k] - r.o[1]) * r.inv[1];
  front = fmaxf(front, fminf(t0, t1));
  back = fminf(back, fmaxf(t0, t1));
  t0 = (box[2][k] - r.o[2]) * r.inv[2];
  t1 = (box[5][k] - r.o[2]) * r.inv[2];
  front = fmaxf(front, fminf(t0, t1));
  back = fminf(back, fmaxf(t0, t1));
  return back >= front && front <= r.tmax && back >= r.tmin;
}

// boxes [base, base + n) into shared memory, lo xyz in rows 0-2, hi in 3-5
__device__ __forceinline__ void stage(float (*box)[kTile], const float* wmin, const float* wmax,
                                      int base, int n) {
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int64_t b = 3 * static_cast<int64_t>(base + k);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      box[c][k] = wmin[b + c];
      box[3 + c][k] = wmax[b + c];
    }
  }
  __syncthreads();
}

struct SweepArgs {
  const float* origin;      // [R, 3]
  const float* direction;   // [R, 3]
  const float* tmin;        // [R]
  const float* tmax;        // [R]
  const bool* active;       // [R] or null (every ray live)
  const float* wmin;        // [I, 3]
  const float* wmax;        // [I, 3]
  int* item_ray;            // [capacity]
  int* item_key;            // [capacity], zeroed by the caller
  int* nov;                 // [R]
  long long* first;         // [R] or null
  long long* best;          // [R] or null (any-hit)
  bool* occluded;           // [R] or null (closest-hit)
  int* box_tests;           // [R]
  int* tri_tests;           // [R]
  unsigned long long* stats;  // [4], zeroed by the caller
  int num_rays, num_inst;
  long long capacity;
};

__global__ void __launch_bounds__(kThreads) inst_sweep_kernel(const SweepArgs a) {
  __shared__ float box[6][kTile];
  __shared__ long long warp_start[kWarps];
  __shared__ int warp_live[kWarps];
  __shared__ int warp_top[kWarps];
  __shared__ long long block_start;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < a.num_rays;
  const bool live = in && (a.active == nullptr || a.active[i]);
  Ray r{};
  int oct = 0;
  if (live) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float d = a.direction[3 * i + c];
      r.o[c] = a.origin[3 * i + c];
      r.inv[c] = 1.0f / clamp_dir(d);
      oct |= (d > 0.0f ? 1 : 0) << c;
    }
    r.tmin = a.tmin[i];
    r.tmax = a.tmax[i];
  }
  if (in) {
    if (a.best != nullptr) a.best[i] = LLONG_MAX;
    if (a.occluded != nullptr) a.occluded[i] = false;
    a.box_tests[i] = 0;
    a.tri_tests[i] = 0;
  }

  // the overlaps: counted, the first kLocal kept
  int count = 0;
  int cand[kLocal];
  if (__syncthreads_or(live)) {
    for (int base = 0; base < a.num_inst; base += kTile) {
      const int n = min(kTile, a.num_inst - base);
      stage(box, a.wmin, a.wmax, base, n);
      if (live) {
        for (int k = 0; k < n; ++k) {
          if (overlaps(box, k, r)) {
            if (count < kLocal) cand[count] = base + k;
            ++count;
          }
        }
      }
    }
  }

  // the block's slots: a scan over the warp, then one atomic add a block
  int incl = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  const unsigned live_bits = __ballot_sync(kFull, live);
  const int top = __reduce_max_sync(kFull, count);
  if (lane == 31) warp_start[warp] = incl;
  if (lane == 0) {
    warp_live[warp] = __popc(live_bits);
    warp_top[warp] = top;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total = 0;
    int lives = 0, most = 0;
    for (int w = 0; w < kWarps; ++w) {
      const long long c = warp_start[w];
      warp_start[w] = total;
      total += c;
      lives += warp_live[w];
      most = max(most, warp_top[w]);
    }
    block_start = total > 0 ? static_cast<long long>(atomicAdd(
                                  &a.stats[0], static_cast<unsigned long long>(total)))
                            : 0;
    if (lives > 0) atomicAdd(&a.stats[1], static_cast<unsigned long long>(lives));
    if (most > 0) atomicMax(&a.stats[2], static_cast<unsigned long long>(most));
  }
  __syncthreads();
  const long long start = block_start + warp_start[warp] + (incl - count);
  if (in) {
    a.nov[i] = count;
    if (a.first != nullptr) a.first[i] = start;
  }
  if (count <= kLocal) {
    for (int j = 0; j < count; ++j) {
      const long long s = start + j;
      if (s < a.capacity) {
        a.item_ray[s] = i;
        a.item_key[s] = 1 + ((cand[j] << 3) | oct);
      }
    }
  }
  // rays with more overlaps than they kept: the block sweeps again
  if (__syncthreads_or(count > kLocal)) {
    long long s = start;
    for (int base = 0; base < a.num_inst; base += kTile) {
      const int n = min(kTile, a.num_inst - base);
      stage(box, a.wmin, a.wmax, base, n);
      if (count > kLocal) {
        for (int k = 0; k < n; ++k) {
          if (overlaps(box, k, r)) {
            if (s < a.capacity) {
              a.item_ray[s] = i;
              a.item_key[s] = 1 + (((base + k) << 3) | oct);
            }
            ++s;
          }
        }
      }
    }
  }
}

// row c of the affine map m (3 x 4, row-major) applied to v, with or
// without its translation, summed as trace/instanced.py:transform_rays sums
__device__ __forceinline__ float map_row(const float* m, int c, const float* v, bool point) {
  const float s = m[4 * c] * v[0] + m[4 * c + 1] * v[1] + m[4 * c + 2] * v[2];
  return point ? s + m[4 * c + 3] : s;
}

__global__ void __launch_bounds__(kThreads)
inst_items_kernel(const int* __restrict__ s_key, const long long* __restrict__ order,
                  const int* __restrict__ item_ray, const float* __restrict__ origin,
                  const float* __restrict__ direction, const float* __restrict__ tmin,
                  const float* __restrict__ tmax, const float* __restrict__ inv,
                  float* __restrict__ origin_out, float* __restrict__ direction_out,
                  float* __restrict__ tmin_out, float* __restrict__ tmax_out,
                  int* __restrict__ s_ray, long long num_slots, int num_inst) {
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= num_slots) return;
  const int key = s_key[j];
  const bool live = key != 0;
  const int ray = live ? item_ray[order[j]] : 0;
  const int inst = live ? (key - 1) >> 3 : 0;
  if (inst >= num_inst) __trap();  // torch's index check
  const float* m = inv + 12 * static_cast<int64_t>(inst);
  float o[3], d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = origin[3 * static_cast<int64_t>(ray) + c];
    d[c] = direction[3 * static_cast<int64_t>(ray) + c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    origin_out[3 * j + c] = map_row(m, c, o, true);
    direction_out[3 * j + c] = clamp_dir(map_row(m, c, d, false));
  }
  tmin_out[j] = live ? tmin[ray] : kF32Max;
  tmax_out[j] = live ? tmax[ray] : -kF32Max;
  s_ray[j] = live ? ray : -1;
}

template <bool AnyHit>
__global__ void __launch_bounds__(kThreads)
inst_resolve_kernel(const int* __restrict__ s_ray, const int* __restrict__ s_key,
                    const float* __restrict__ t, const int* __restrict__ tri,
                    const int* __restrict__ ipops, const int* __restrict__ lpops,
                    const int* __restrict__ k1_overflow, long long* best, bool* occluded,
                    int* box_tests, int* tri_tests, unsigned long long* stats,
                    int* overflow_out, long long num_slots, long long capacity, int width,
                    int tris_per_pop, int tri_range, int candidate_overflow) {
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j == 0) {
    const bool over = stats[0] > static_cast<unsigned long long>(capacity);
    stats[3] = over ? 1ull : 0ull;
    overflow_out[0] = k1_overflow[0] + (over ? candidate_overflow : 0);
  }
  if (j >= num_slots) return;
  const int ray = s_ray[j];
  if (ray < 0) return;
  atomicAdd(&box_tests[ray], ipops[j] * width);
  atomicAdd(&tri_tests[ray], lpops[j] * tris_per_pop);
  const int id = tri[j];
  if (id < 0) return;
  if (AnyHit) {
    occluded[ray] = true;
    return;
  }
  const float ti = t[j];
  if (!(ti < kF32Max)) return;
  const unsigned bits = __float_as_uint(ti);
  const unsigned hi = (bits & 0x80000000u) != 0 ? (bits ^ 0x7fffffffu) : bits;
  const unsigned long long low =
      static_cast<unsigned long long>((s_key[j] - 1) >> 3) * static_cast<unsigned>(tri_range) +
      static_cast<unsigned>(id);
  atomicMin(&best[ray], static_cast<long long>((static_cast<unsigned long long>(hi) << 32) | low));
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

__global__ void __launch_bounds__(kThreads)
inst_record_kernel(const long long* __restrict__ best, const int4* __restrict__ pair_rows,
                   const float* __restrict__ inv, const float* __restrict__ origin,
                   const float* __restrict__ direction, const float* __restrict__ tmax,
                   bool* __restrict__ hit_out, float* __restrict__ t_out,
                   int* __restrict__ prim_out, int* __restrict__ tri_out,
                   float* __restrict__ u_out, float* __restrict__ v_out,
                   int* __restrict__ inst_out, int num_rays, int num_pairs, int num_inst,
                   int tri_range) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= num_rays) return;
  const long long key = best[i];
  if (key == LLONG_MAX) {
    hit_out[i] = false;
    t_out[i] = tmax[i];
    prim_out[i] = 0;
    tri_out[i] = 0;
    u_out[i] = 0.0f;
    v_out[i] = 0.0f;
    inst_out[i] = -1;
    return;
  }
  const unsigned long long k = static_cast<unsigned long long>(key);
  const unsigned hi = static_cast<unsigned>(k >> 32);
  const float ti = __uint_as_float((hi & 0x80000000u) != 0 ? (hi ^ 0x7fffffffu) : hi);
  const unsigned low = static_cast<unsigned>(k & 0xffffffffull);
  const int inst = static_cast<int>(low / static_cast<unsigned>(tri_range));
  const int id = static_cast<int>(low % static_cast<unsigned>(tri_range));
  if (inst >= num_inst) __trap();  // torch's index check
  const float* m = inv + 12 * static_cast<int64_t>(inst);
  float wo[3], wd[3], o[3], d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    wo[c] = origin[3 * i + c];
    wd[c] = direction[3 * i + c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = map_row(m, c, wo, true);
    d[c] = map_row(m, c, wd, false);
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
  float a[3], c[3], e1[3], e2[3], s[3], h[3], q[3];
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    a[x] = second ? v2[x] : v0[x];
    c[x] = second ? v3[x] : v2[x];
    e1[x] = v1[x] - a[x];
    e2[x] = c[x] - a[x];
    s[x] = o[x] - a[x];
  }
  cross3(d, e2, h);
  const float f = 1.0f / dot3(e1, h);
  cross3(s, e1, q);
  hit_out[i] = true;
  t_out[i] = ti;
  prim_out[i] = second ? q3.y : q3.x;
  tri_out[i] = id;
  u_out[i] = f * dot3(s, h);
  v_out[i] = f * dot3(d, q);
  inst_out[i] = inst;
}

int blocks_for(long long num) { return static_cast<int>((num + kThreads - 1) / kThreads); }

}  // namespace

// The sweep: pointers as in SweepArgs, in that order (active, first, best
// and occluded may be null; best or occluded given); item_key and stats
// zeroed by the caller. ``stream`` is a cudaStream_t. Returns the
// cudaError_t of the launch.
extern "C" int inst_sweep_launch(const void* origin, const void* direction, const void* tmin,
                                 const void* tmax, const void* active, const void* wmin,
                                 const void* wmax, void* item_ray, void* item_key, void* nov,
                                 void* first, void* best, void* occluded, void* box_tests,
                                 void* tri_tests, void* stats, int num_rays, int num_inst,
                                 long long capacity, void* stream) {
  if (num_rays <= 0) return 0;
  if (num_inst < 0 || capacity <= 0 || (best == nullptr) == (occluded == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const SweepArgs a{static_cast<const float*>(origin),
                    static_cast<const float*>(direction),
                    static_cast<const float*>(tmin),
                    static_cast<const float*>(tmax),
                    static_cast<const bool*>(active),
                    static_cast<const float*>(wmin),
                    static_cast<const float*>(wmax),
                    static_cast<int*>(item_ray),
                    static_cast<int*>(item_key),
                    static_cast<int*>(nov),
                    static_cast<long long*>(first),
                    static_cast<long long*>(best),
                    static_cast<bool*>(occluded),
                    static_cast<int*>(box_tests),
                    static_cast<int*>(tri_tests),
                    static_cast<unsigned long long*>(stats),
                    num_rays,
                    num_inst,
                    capacity};
  inst_sweep_kernel<<<blocks_for(num_rays), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The items: s_key [C] int32 and order [C] int64 (the stable sort of the
// sweep's item_key), item_ray [C] int32, the rays' origin and direction
// [R, 3] and tmin, tmax [R] float32, inv [num_inst, 3, 4] float32; writes
// K1's origin and direction [C, 3], tmin and tmax [C] float32 and s_ray [C]
// int32. ``stream`` is a cudaStream_t. Returns the cudaError_t of the
// launch.
extern "C" int inst_items_launch(const void* s_key, const void* order, const void* item_ray,
                                 const void* origin, const void* direction, const void* tmin,
                                 const void* tmax, const void* inv, void* origin_out,
                                 void* direction_out, void* tmin_out, void* tmax_out,
                                 void* s_ray, long long num_slots, int num_inst, void* stream) {
  if (num_slots <= 0) return 0;
  if (num_inst <= 0) return static_cast<int>(cudaErrorInvalidValue);
  inst_items_kernel<<<blocks_for(num_slots), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(s_key), static_cast<const long long*>(order),
      static_cast<const int*>(item_ray), static_cast<const float*>(origin),
      static_cast<const float*>(direction), static_cast<const float*>(tmin),
      static_cast<const float*>(tmax), static_cast<const float*>(inv),
      static_cast<float*>(origin_out), static_cast<float*>(direction_out),
      static_cast<float*>(tmin_out), static_cast<float*>(tmax_out), static_cast<int*>(s_ray),
      num_slots, num_inst);
  return static_cast<int>(cudaGetLastError());
}

// The resolve: s_ray, s_key [C] int32, K1's t [C] float32, tri, inner and
// leaf pops [C] int32 and overflow [1] int32; the sweep's best [R] int64
// (closest-hit) or occluded [R] bool (any-hit; the other null), box and
// triangle tests [R] int32 and stats [4] int64, updated in place; writes
// overflow_out [1] int32. ``stream`` is a cudaStream_t. Returns the
// cudaError_t of the launch.
extern "C" int inst_resolve_launch(const void* s_ray, const void* s_key, const void* t,
                                   const void* tri, const void* ipops, const void* lpops,
                                   const void* k1_overflow, void* best, void* occluded,
                                   void* box_tests, void* tri_tests, void* stats,
                                   void* overflow_out, long long num_slots, long long capacity,
                                   int width, int tris_per_pop, int tri_range, int any_hit,
                                   int candidate_overflow, void* stream) {
  if (num_slots <= 0) return 0;
  if (tri_range <= 0 || (any_hit ? occluded == nullptr : best == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    inst_resolve_kernel<true><<<blocks_for(num_slots), kThreads, 0, s>>>(
        static_cast<const int*>(s_ray), static_cast<const int*>(s_key),
        static_cast<const float*>(t), static_cast<const int*>(tri),
        static_cast<const int*>(ipops), static_cast<const int*>(lpops),
        static_cast<const int*>(k1_overflow), nullptr, static_cast<bool*>(occluded),
        static_cast<int*>(box_tests), static_cast<int*>(tri_tests),
        static_cast<unsigned long long*>(stats), static_cast<int*>(overflow_out), num_slots,
        capacity, width, tris_per_pop, tri_range, candidate_overflow);
  else
    inst_resolve_kernel<false><<<blocks_for(num_slots), kThreads, 0, s>>>(
        static_cast<const int*>(s_ray), static_cast<const int*>(s_key),
        static_cast<const float*>(t), static_cast<const int*>(tri),
        static_cast<const int*>(ipops), static_cast<const int*>(lpops),
        static_cast<const int*>(k1_overflow), static_cast<long long*>(best), nullptr,
        static_cast<int*>(box_tests), static_cast<int*>(tri_tests),
        static_cast<unsigned long long*>(stats), static_cast<int*>(overflow_out), num_slots,
        capacity, width, tris_per_pop, tri_range, candidate_overflow);
  return static_cast<int>(cudaGetLastError());
}

// The closest-hit record: best [R] int64, pair_rows [num_pairs, 16] int32
// (16-byte aligned), inv [num_inst, 3, 4], the rays' origin and direction
// [R, 3] and tmax [R] float32; writes hit [R] bool, t [R] float32, prim and
// tri [R] int32, u and v [R] float32, inst [R] int32. ``stream`` is a
// cudaStream_t. Returns the cudaError_t of the launch.
extern "C" int inst_record_launch(const void* best, const void* pair_rows, const void* inv,
                                  const void* origin, const void* direction, const void* tmax,
                                  void* hit_out, void* t_out, void* prim_out, void* tri_out,
                                  void* u_out, void* v_out, void* inst_out, int num_rays,
                                  int num_pairs, int num_inst, int tri_range, void* stream) {
  if (num_rays <= 0) return 0;
  if (num_pairs <= 0 || num_inst <= 0 || tri_range <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  inst_record_kernel<<<blocks_for(num_rays), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(best), static_cast<const int4*>(pair_rows),
      static_cast<const float*>(inv), static_cast<const float*>(origin),
      static_cast<const float*>(direction), static_cast<const float*>(tmax),
      static_cast<bool*>(hit_out), static_cast<float*>(t_out), static_cast<int*>(prim_out),
      static_cast<int*>(tri_out), static_cast<float*>(u_out), static_cast<float*>(v_out),
      static_cast<int*>(inst_out), num_rays, num_pairs, num_inst, tri_range);
  return static_cast<int>(cudaGetLastError());
}
