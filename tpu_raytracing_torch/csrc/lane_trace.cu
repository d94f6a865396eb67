// K5: per-ray treelet traversal with resumable state, for Hopper (sm_90a),
// with leaf windows tested by the whole warp.
//
// Replaces the TPU kernel tpu_raytracing/trace/lane_pallas.py:_lane_kernel
// (line 107), in a closest-hit and an any-hit instantiation.
//
// Layouts (thread i is ray i = p * 128 + lane; every ray and state row read
// or written is coalesced across a warp):
//   columns   [T, ecap, wh] f32  treelet columns, each column's wh words
//             contiguous (TreeletBVH.columns: the reference's tables
//             [T, wh, ecap] transposed once at build time; wh % 4 == 0, so
//             every column starts 16-byte aligned)
//   rays8     [num_p, 8, 128] f32  o.xyz, d.xyz, tmin, tmax
//   state     [num_p, 5 + stack, 128] i32  0 cur entry, 1 tbest bits,
//             2 tribest, 3 depth, 4 depth watermark, 5.. stack (top first)
//   out       [num_p, 8, 128] f32  0 t, 1 tri bits, 2 box tests, 3 tri
//             tests, 4 iterations, 5 treelet switches, 6 watermark,
//             7 wanted tid + 1 (0 = finished)
//   state_out as state, at the end of the launch.
//
// What it computes per ray, resuming from its state, one element a step:
//   * an entry word is tid << 9 | col << 2 | typ (typ 1 inner column,
//     2 window column); a portal meta (type 3) is pushed as its child
//     treelet's root entry, child << 9 | 1.
//   * window column: Möller-Trumbore on triangles (v0, v1, v2) and
//     (v2, v1, v3) of its lw pairs, f = 1 / (|det| < 1e-9 ? 1e-9 : det);
//     the hit is accepted in [tmin, tbest]; the window's winner has the
//     smallest t and, on an equal t, the larger index 2 * p + second (an
//     all-miss window names 2 * lw - 1 at F32_MAX); it is taken when its t
//     <= tbest; tri = gstart * 2 + index.
//   * inner column: the 8-entry slab test with inv = 1 / safe(d) (|d| <
//     1e-30 -> -1e-30 if d < 0 else +1e-30), tn clamped to tmin and tf to
//     tbest; hits ranked nearest first (the higher entry id on a tie); the
//     nearest becomes cur, the rest are pushed so rank 1 is on top.
//   * the stack holds at most `stack` entries; a push beyond drops the
//     deepest entry. The depth counter is not clamped above; the watermark
//     is its maximum, and a ray ends flagged wanting its root when the
//     watermark passed stack - 8 (it may have dropped entries).
//   * any-hit: the first accepted hit ends the ray (cur NONE, empty stack,
//     depth 0).
//   * budgets are per ray: with budget > 0 a ray stops after that many
//     iterations of its own; with no_switch it stops when its entry's
//     treelet differs from the one it started the launch in. A stopped ray
//     exports its state, and row 7 holds its entry's tid + 1.
//
// What bounds it: each step is a dependent load whose address comes from
// the previous step — an inner column (56 words, 8 slab tests) or a window
// column (12 * lw + 1 words, 2 * lw triangle tests) — so the kernel is
// bound by the latency of those loads and by the triangle tests, which
// carry most of the arithmetic. The 1M tree's columns (~298 MB) do not fit
// in the 50 MB L2, so a visit's bytes come from device memory.
//
// What the design does about it:
//   * Column-contiguous tables. In the reference's layout the words of one
//     column lie ecap * 4 = 512 bytes apart, one 32-byte sector each (56
//     sectors for an inner visit, 193 for a 16-pair window). Here a column
//     is contiguous: an inner visit is 14 16-byte loads issued together (7
//     sectors), a window 49 (25 sectors).
//   * Warp-cooperative leaf windows (the while-while loop of Aila & Laine,
//     "Understanding the Efficiency of Ray Traversal on GPUs", HPG 2009, as
//     K1 does them, csrc/split_trace.cu). Every ray keeps its own stack and
//     visits inner columns on its own lane until its entry is a window
//     column, it is finished or it is stopped. Then __ballot_sync collects
//     the lanes at a window and __match_any_sync groups those at the same
//     one. For each distinct window the warp loads the column once,
//     coalesced, into a per-warp shared-memory buffer; lane l takes
//     triangle j = l (+ 32 k): pair p = j % lw, second = j / lw, whose word
//     w is row w * lw + p, so 16 lanes read 64 contiguous bytes a row. Each
//     ray of the group is broadcast with __shfl_sync, every lane tests its
//     triangles, and a 5-step __shfl_xor_sync reduction picks the winner
//     (the smaller t, on an equal t the larger index; lanes past 2 * lw
//     give F32_MAX with index -1), which the ray's own lane takes. So a
//     window's 2 * lw tests run on up to 32 lanes instead of one.
//   * All 32 lanes stay in the loop until the whole warp is done: finished
//     rays, rays stopped by their budget or no_switch and lanes past
//     num_rays keep serving the others, and every warp intrinsic runs with
//     the full mask on a converged warp.
//   * Not done: inner columns tested by several lanes of a ray, and the
//     resident treelet staged in shared memory per block.
//
// Bit-exactness: compiled with -fmad=false and without fast math; every
// expression keeps the order of the plain PyTorch version
// (tpu_raytracing_torch/trace/lane_trace.py:trace_lane_plain), and each
// ray takes the same steps in the same order, so the two agree bit for bit
// on every out row and state row.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr int kMaxStack = 128;
constexpr int kMaxLeafWidth = 128;  // 2 * 128 triangles on 8 slots a lane
constexpr int kMaxIters = 1 << 20;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kF32Max = 3.402823466e+38f;
constexpr float kTriEps = 1e-9f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin;
};

__device__ __forceinline__ float safe_dir(float d) {
  return fabsf(d) < 1e-30f ? (d < 0.0f ? -1e-30f : 1e-30f) : d;
}

// Möller-Trumbore; returns t and sets ok.
__device__ __forceinline__ float moller_trumbore(
    const Ray& r, float a0, float a1, float a2, float b0, float b1, float b2,
    float c0, float c1, float c2, bool& ok) {
  const float e1x = b0 - a0, e1y = b1 - a1, e1z = b2 - a2;
  const float e2x = c0 - a0, e2y = c1 - a1, e2z = c2 - a2;
  const float hx = r.dy * e2z - r.dz * e2y;
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * hx + e1y * hy + e1z * hz;
  const float f = 1.0f / (fabsf(det) < kTriEps ? kTriEps : det);
  const float sx = r.ox - a0, sy = r.oy - a1, sz = r.oz - a2;
  const float u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  const float t = f * (e2x * qx + e2y * qy + e2z * qz);
  ok = (fabsf(det) >= kTriEps) && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) && (u + v <= 1.0f);
  return t;
}

// (t, index) ordering of a window's candidates: the smaller t wins, on an
// equal t the larger index (the plain version's sequential <=).
__device__ __forceinline__ void take_better(float t, int idx, float& tm, int& im) {
  if (t < tm || (t == tm && idx > im)) {
    tm = t;
    im = idx;
  }
}

// One lane's triangles of a window: j = lane + 32 k, pair j % lw, second
// j / lw; vertices a, b, c in test order and index 2 * pair + second (-1
// past 2 * lw).
template <int SLOTS>
struct Tris {
  float v[SLOTS][9];
  int idx[SLOTS];
};

// The per-ray machine: a ray's traversal state and its counters. Its stack
// (bottom first, n entries) is an array of the kernel's own, so that the
// scalars stay in registers.
struct Lane {
  Ray r;
  float ix, iy, iz;
  int cur, tribest, depth, wmark, n;
  float tbest;
  int box, tri, iters, switches, start_tid, res;

  // May the ray take another step in this launch?
  __device__ __forceinline__ bool runnable(int limit, int no_switch) const {
    return cur != 0 && iters < limit && !(no_switch && (cur >> 9) != start_tid);
  }

  // The step's bookkeeping before its visit.
  __device__ __forceinline__ void count_step() {
    const int etid = cur >> 9;
    if (etid != res) {
      ++switches;
      res = etid;
    }
    ++iters;
  }

  // Push the k1 hits of pv (the nearest becomes cur) or pop; any-hit ends
  // the ray at its first hit.
  template <bool ANY_HIT>
  __device__ __forceinline__ void advance(int k1, const int (&pv)[8], int (&stk)[kMaxStack],
                                          int stack_cap) {
    const bool found = ANY_HIT && tribest >= 0;
    if (found) k1 = 0;
    if (k1 > 0) {
      for (int q = k1 - 1; q >= 1; --q) {
        if (n == stack_cap) {  // drop the deepest entry
          for (int i = 1; i < n; ++i) stk[i - 1] = stk[i];
          --n;
        }
        stk[n++] = pv[q];
      }
      cur = pv[0];
      depth = max(depth + (k1 - 1), 0);
    } else {
      cur = n > 0 ? stk[n - 1] : 0;
      n = max(n - 1, 0);
      depth = max(depth - 1, 0);
    }
    if (found) {
      cur = 0;
      n = 0;
      depth = 0;
    }
    wmark = max(wmark, depth);
  }

  // One step at a non-window entry: the inner column's slab tests (a
  // column of another type only pops).
  template <bool ANY_HIT>
  __device__ __forceinline__ void inner_step(const float* __restrict__ columns, int wh, int ecap,
                                             int (&stk)[kMaxStack], int stack_cap) {
    count_step();
    const int etid = cur >> 9;
    int k1 = 0;
    int pv[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) pv[q] = 0;
    if ((cur & 3) == 1) {
      const int col = (cur >> 2) & 127;
      const int4* cp = reinterpret_cast<const int4*>(
          columns + (static_cast<size_t>(etid) * ecap + col) * wh);
      int w[56];
#pragma unroll
      for (int k = 0; k < 14; ++k) {
        const int4 q = __ldg(cp + k);
        w[4 * k] = q.x;
        w[4 * k + 1] = q.y;
        w[4 * k + 2] = q.z;
        w[4 * k + 3] = q.w;
      }
      bool hit[8];
      float key[8];
      int ev[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float lox = __int_as_float(w[0 * 8 + e]);
        const float loy = __int_as_float(w[1 * 8 + e]);
        const float loz = __int_as_float(w[2 * 8 + e]);
        const float hix = __int_as_float(w[3 * 8 + e]);
        const float hiy = __int_as_float(w[4 * 8 + e]);
        const float hiz = __int_as_float(w[5 * 8 + e]);
        const int m = w[48 + e];
        const float t0x = (lox - r.ox) * ix, t0y = (loy - r.oy) * iy, t0z = (loz - r.oz) * iz;
        const float t1x = (hix - r.ox) * ix, t1y = (hiy - r.oy) * iy, t1z = (hiz - r.oz) * iz;
        float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
        float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
        tn = fmaxf(tn, r.tmin);
        tf = fminf(tf, tbest);
        const int mtyp = m & 7;
        hit[e] = (tf >= tn) && (mtyp != 0);
        key[e] = hit[e] ? tn : kF32Max;
        const int child = m >> 5;
        ev[e] = mtyp == 3 ? ((child << 9) | 1) : ((etid << 9) | (child << 2) | (mtyp == 2 ? 2 : 1));
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (!hit[e]) continue;
        int rank = 0;
#pragma unroll
        for (int e2 = 0; e2 < 8; ++e2)
          rank += (hit[e2] && (key[e2] < key[e] || (key[e2] == key[e] && e2 > e))) ? 1 : 0;
        pv[rank] = ev[e];
        ++k1;
      }
      box += 8;
    }
    advance<ANY_HIT>(k1, pv, stk, stack_cap);
  }
};

// Loads the window column at entry ``wcur`` into the warp's buffer (every
// lane of the warp calls it) and returns this lane's triangles and the
// window's gstart.
template <int SLOTS>
__device__ __forceinline__ int load_window(const float* __restrict__ columns, int wh, int ecap,
                                           int lw, int nvec, int wcur, int4* wbuf, int lane,
                                           Tris<SLOTS>& tr) {
  const int4* wp = reinterpret_cast<const int4*>(
      columns + (static_cast<size_t>(wcur >> 9) * ecap + ((wcur >> 2) & 127)) * wh);
  __syncwarp();  // the previous window's reads are done
  for (int k = lane; k < nvec; k += kWarp) wbuf[k] = __ldg(wp + k);
  __syncwarp();
  const float* wf = reinterpret_cast<const float*>(wbuf);
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int j = lane + kWarp * s;
    tr.idx[s] = -1;
    if (j < 2 * lw) {
      const int p = j % lw, second = j / lw;
      // A = (v0, v1, v2), B = (v2, v1, v3); vertex k is words 3k..3k+2
      const int a = second ? 6 : 0, c = second ? 9 : 6;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        tr.v[s][i] = wf[(a + i) * lw + p];
        tr.v[s][3 + i] = wf[(3 + i) * lw + p];
        tr.v[s][6 + i] = wf[(c + i) * lw + p];
      }
      tr.idx[s] = 2 * p + second;
    }
  }
  return reinterpret_cast<const int*>(wbuf)[12 * lw];
}

// The window's winner for ray ``g`` with limit ``tb1``, on every lane.
template <int SLOTS>
__device__ __forceinline__ void window_winner(const Tris<SLOTS>& tr, const Ray& g, float tb1,
                                              float& tm, int& im) {
  tm = kF32Max;
  im = -1;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    if (tr.idx[s] >= 0) {
      const float* v = tr.v[s];
      bool ok;
      const float t = moller_trumbore(g, v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], ok);
      take_better((ok && t >= g.tmin && t <= tb1) ? t : kF32Max, tr.idx[s], tm, im);
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(kFull, tm, off);
    const int oi = __shfl_xor_sync(kFull, im, off);
    take_better(ot, oi, tm, im);
  }
}

template <bool ANY_HIT, int SLOTS>
__global__ void __launch_bounds__(kThreads)
lane_trace_kernel(const float* __restrict__ columns, int wh, int ecap, int lw, int nvec,
                  const float* __restrict__ rays8, const int* __restrict__ state_in,
                  float* __restrict__ out, int* __restrict__ state_out, int num_rays,
                  int root_tid, int stack_cap, int limit, int no_switch) {
  extern __shared__ int4 wbufs[];
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % kWarp;
  int4* wbuf = wbufs + (threadIdx.x / kWarp) * nvec;
  const bool valid = ray < num_rays;  // a lane past num_rays only serves the warp
  const int pkt = ray >> 7, pl = ray & 127;
  const int srows = 5 + stack_cap;

  Lane s;
  int stk[kMaxStack];
  s.r = Ray{0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, 0.0f};
  s.cur = 0;
  s.tbest = 0.0f;
  s.tribest = -1;
  s.depth = s.wmark = s.n = 0;
  if (valid) {
    const float* rp = rays8 + static_cast<size_t>(pkt) * 8 * 128 + pl;
    s.r.ox = rp[0 * 128];
    s.r.oy = rp[1 * 128];
    s.r.oz = rp[2 * 128];
    s.r.dx = rp[3 * 128];
    s.r.dy = rp[4 * 128];
    s.r.dz = rp[5 * 128];
    s.r.tmin = rp[6 * 128];
    const int* sp = state_in + static_cast<size_t>(pkt) * srows * 128 + pl;
    s.cur = sp[0 * 128];
    s.tbest = __int_as_float(sp[1 * 128]);
    s.tribest = sp[2 * 128];
    s.depth = sp[3 * 128];
    s.wmark = sp[4 * 128];
    // The state's stack is top first and top-contiguous; keep it bottom first.
    while (s.n < stack_cap && sp[(5 + s.n) * 128] != 0) ++s.n;
    for (int i = 0; i < s.n; ++i) stk[s.n - 1 - i] = sp[(5 + i) * 128];
  }
  s.ix = 1.0f / safe_dir(s.r.dx);
  s.iy = 1.0f / safe_dir(s.r.dy);
  s.iz = 1.0f / safe_dir(s.r.dz);
  s.box = s.tri = s.iters = s.switches = 0;
  s.start_tid = s.cur >> 9;
  s.res = s.start_tid;

  while (true) {
    // 1. inner columns, each lane on its own, until its entry is a window
    //    column or it may not step again
    while (s.runnable(limit, no_switch) && (s.cur & 3) != 2)
      s.inner_step<ANY_HIT>(columns, wh, ecap, stk, stack_cap);

    // 2. window columns, the whole warp on each
    const bool at_win = s.runnable(limit, no_switch);
    unsigned pending = __ballot_sync(kFull, at_win);
    if (pending == 0) break;  // warp-uniform: no lane may step again
    if (at_win) s.count_step();
    const unsigned same = __match_any_sync(kFull, at_win ? s.cur : 0);
    while (pending) {
      const int leader = __ffs(pending) - 1;
      unsigned group = __shfl_sync(kFull, same, leader);
      const int wcur = __shfl_sync(kFull, s.cur, leader);
      pending &= ~group;
      Tris<SLOTS> tr;
      const int gstart = load_window<SLOTS>(columns, wh, ecap, lw, nvec, wcur, wbuf, lane, tr);
      while (group) {
        const int src = __ffs(group) - 1;
        group &= group - 1;
        Ray g;
        g.ox = __shfl_sync(kFull, s.r.ox, src);
        g.oy = __shfl_sync(kFull, s.r.oy, src);
        g.oz = __shfl_sync(kFull, s.r.oz, src);
        g.dx = __shfl_sync(kFull, s.r.dx, src);
        g.dy = __shfl_sync(kFull, s.r.dy, src);
        g.dz = __shfl_sync(kFull, s.r.dz, src);
        g.tmin = __shfl_sync(kFull, s.r.tmin, src);
        const float tb1 = __shfl_sync(kFull, s.tbest, src);
        float wmin;
        int widx;
        window_winner<SLOTS>(tr, g, tb1, wmin, widx);
        if (lane == src && wmin <= s.tbest) {
          s.tbest = wmin;
          s.tribest = gstart * 2 + widx;
        }
      }
    }
    if (at_win) {
      s.tri += 2 * lw;
      const int none[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      s.advance<ANY_HIT>(0, none, stk, stack_cap);
    }
  }
  if (!valid) return;

  const int top = s.n > 0 ? stk[s.n - 1] : 0;
  const bool live = (s.cur != 0) || (top != 0);
  const bool ovf = s.wmark > stack_cap - 8;
  const int live_e = (s.cur & 3) != 0 ? s.cur : top;
  const int wtid = live ? (live_e >> 9) : root_tid;
  const int want = (live || ovf) ? wtid + 1 : 0;

  float* op = out + static_cast<size_t>(pkt) * 8 * 128 + pl;
  op[0 * 128] = s.tbest;
  op[1 * 128] = __int_as_float(s.tribest);
  op[2 * 128] = static_cast<float>(s.box);
  op[3 * 128] = static_cast<float>(s.tri);
  op[4 * 128] = static_cast<float>(s.iters);
  op[5 * 128] = static_cast<float>(s.switches);
  op[6 * 128] = static_cast<float>(s.wmark);
  op[7 * 128] = static_cast<float>(want);

  int* so = state_out + static_cast<size_t>(pkt) * srows * 128 + pl;
  so[0 * 128] = s.cur;
  so[1 * 128] = __float_as_int(s.tbest);
  so[2 * 128] = s.tribest;
  so[3 * 128] = s.depth;
  so[4 * 128] = s.wmark;
  for (int i = 0; i < stack_cap; ++i) so[(5 + i) * 128] = i < s.n ? stk[s.n - 1 - i] : 0;
}

template <bool ANY_HIT, int SLOTS>
void launch(const float* columns, int wh, int ecap, int lw, int nvec, const float* rays8,
            const int* state_in, float* out, int* state_out, int num_packets, int root_tid,
            int stack_cap, int limit, int no_switch, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(kThreads / kWarp) * nvec * sizeof(int4);
  lane_trace_kernel<ANY_HIT, SLOTS><<<num_packets, kThreads, smem, s>>>(
      columns, wh, ecap, lw, nvec, rays8, state_in, out, state_out, num_packets * 128, root_tid,
      stack_cap, limit, no_switch);
}

template <bool ANY_HIT>
void launch_slots(const float* columns, int wh, int ecap, int lw, int nvec, const float* rays8,
                  const int* state_in, float* out, int* state_out, int num_packets,
                  int root_tid, int stack_cap, int limit, int no_switch, cudaStream_t s) {
  const int tris = 2 * lw;
  if (tris <= kWarp)
    launch<ANY_HIT, 1>(columns, wh, ecap, lw, nvec, rays8, state_in, out, state_out, num_packets,
                       root_tid, stack_cap, limit, no_switch, s);
  else if (tris <= 2 * kWarp)
    launch<ANY_HIT, 2>(columns, wh, ecap, lw, nvec, rays8, state_in, out, state_out, num_packets,
                       root_tid, stack_cap, limit, no_switch, s);
  else if (tris <= 4 * kWarp)
    launch<ANY_HIT, 4>(columns, wh, ecap, lw, nvec, rays8, state_in, out, state_out, num_packets,
                       root_tid, stack_cap, limit, no_switch, s);
  else
    launch<ANY_HIT, 8>(columns, wh, ecap, lw, nvec, rays8, state_in, out, state_out, num_packets,
                       root_tid, stack_cap, limit, no_switch, s);
}

}  // namespace

// Plain C interface, bound with ctypes. Pointers are device pointers;
// ``stream`` is a cudaStream_t. Returns the cudaError_t of the launch.
extern "C" int lane_trace_launch(const void* columns, int num_tables, int wh, int ecap, int lw,
                                 const void* rays8, const void* state_in, void* out,
                                 void* state_out, int num_packets, int root_tid, int stack_cap,
                                 int budget, int no_switch, int any_hit, void* stream) {
  if (num_packets <= 0) return 0;
  if (num_tables <= 0 || ecap <= 0 || ecap > 128 || lw <= 0 || lw > kMaxLeafWidth || wh < 56 ||
      wh < 12 * lw + 1 || wh % 4 != 0 || reinterpret_cast<uintptr_t>(columns) % 16 != 0 ||
      stack_cap <= 0 || stack_cap > kMaxStack || root_tid < 0 || root_tid >= num_tables)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = (12 * lw + 1 + 3) / 4;  // the window's 16-byte words, within wh
  const int limit = budget > 0 ? budget : kMaxIters;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(columns);
  const float* r = static_cast<const float*>(rays8);
  const int* si = static_cast<const int*>(state_in);
  float* o = static_cast<float*>(out);
  int* so = static_cast<int*>(state_out);
  if (any_hit)
    launch_slots<true>(c, wh, ecap, lw, nvec, r, si, o, so, num_packets, root_tid, stack_cap,
                       limit, no_switch, s);
  else
    launch_slots<false>(c, wh, ecap, lw, nvec, r, si, o, so, num_packets, root_tid, stack_cap,
                        limit, no_switch, s);
  return static_cast<int>(cudaGetLastError());
}
