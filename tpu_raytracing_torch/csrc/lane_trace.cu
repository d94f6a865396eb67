// K5: per-ray treelet traversal with resumable state, one thread per ray,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_raytracing/trace/lane_pallas.py:_lane_kernel
// (line 107), in a closest-hit and an any-hit instantiation.
//
// Layouts (the reference's; thread i is ray i = p * 128 + lane, and every
// row read or written is coalesced across a warp):
//   tables    [T, wh, ecap] f32  treelet column tables (bvh/treelet.py)
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
//     the hit is accepted in [tmin, tbest]; on equal t the later slot and
//     the second triangle win; tri = gstart * 2 + p * 2 + second.
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
// What bounds it: each step is a chain of dependent global loads — up to
// 56 words of an inner column or 12 * lw + 1 of a window column, each
// word ecap * 4 bytes from the next — whose address comes from the
// previous step. It is latency bound on those loads.
//
// How the simple design stands to that: one thread per ray with a private
// stack in local memory, tables read through the read-only cache from
// device memory. Latency is hidden by occupancy alone, and the strided
// column reads waste most of each 32-byte sector. The TPU kernel kept one
// treelet table resident in VMEM per 128-lane packet; staging the resident
// treelet in shared memory per block is the next step.
//
// Bit-exactness: compiled with -fmad=false and without fast math, with every
// expression in the order of the plain PyTorch version
// (tpu_raytracing_torch/trace/lane_trace.py:trace_lane_plain), so the two
// agree bit for bit on every out row and state row.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxStack = 128;
constexpr int kMaxIters = 1 << 20;
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

template <bool ANY_HIT>
__global__ void __launch_bounds__(kThreads)
lane_trace_kernel(const float* __restrict__ tables, int wh, int ecap, int lw,
                  const float* __restrict__ rays8, const int* __restrict__ state_in,
                  float* __restrict__ out, int* __restrict__ state_out, int num_rays,
                  int root_tid, int stack_cap, int limit, int no_switch) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= num_rays) return;
  const int pkt = ray >> 7, lane = ray & 127;
  const int srows = 5 + stack_cap;
  const float* rp = rays8 + static_cast<size_t>(pkt) * 8 * 128 + lane;
  Ray r;
  r.ox = rp[0 * 128];
  r.oy = rp[1 * 128];
  r.oz = rp[2 * 128];
  r.dx = rp[3 * 128];
  r.dy = rp[4 * 128];
  r.dz = rp[5 * 128];
  r.tmin = rp[6 * 128];
  const float ix = 1.0f / safe_dir(r.dx), iy = 1.0f / safe_dir(r.dy), iz = 1.0f / safe_dir(r.dz);

  const int* sp = state_in + static_cast<size_t>(pkt) * srows * 128 + lane;
  int cur = sp[0 * 128];
  float tbest = __int_as_float(sp[1 * 128]);
  int tribest = sp[2 * 128];
  int depth = sp[3 * 128];
  int wmark = sp[4 * 128];
  // The state's stack is top first and top-contiguous; keep it bottom first.
  int stk[kMaxStack];
  int n = 0;
  while (n < stack_cap && sp[(5 + n) * 128] != 0) ++n;
  for (int i = 0; i < n; ++i) stk[n - 1 - i] = sp[(5 + i) * 128];

  int box = 0, tri = 0, iters = 0, switches = 0;
  const int start_tid = cur >> 9;
  int res = start_tid;
  const size_t tstride = static_cast<size_t>(wh) * ecap;

  while (cur != 0 && iters < limit) {
    const int etid = cur >> 9;
    if (no_switch && etid != start_tid) break;
    if (etid != res) {
      ++switches;
      res = etid;
    }
    ++iters;
    const int typ = cur & 3;
    const int col = (cur >> 2) & 127;
    const float* cp = tables + static_cast<size_t>(etid) * tstride + col;
    int k1 = 0;
    int pv[8];

    if (typ == 2) {
      const int gstart = __float_as_int(__ldg(cp + static_cast<size_t>(12 * lw) * ecap));
      const float tb1 = tbest;
      float wmin = kF32Max;
      int widx = -1;
      for (int p = 0; p < lw; ++p) {
        float v[12];
#pragma unroll
        for (int w = 0; w < 12; ++w) v[w] = __ldg(cp + static_cast<size_t>(w * lw + p) * ecap);
        bool oka, okb;
        const float ta = moller_trumbore(r, v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], oka);
        const float tb = moller_trumbore(r, v[6], v[7], v[8], v[3], v[4], v[5], v[9], v[10], v[11], okb);
        const float tva = (oka && ta >= r.tmin && ta <= tb1) ? ta : kF32Max;
        const float tvb = (okb && tb >= r.tmin && tb <= tb1) ? tb : kF32Max;
        // the last (p * 2 + second) at the minimum wins
        if (tva <= wmin) {
          wmin = tva;
          widx = 2 * p;
        }
        if (tvb <= wmin) {
          wmin = tvb;
          widx = 2 * p + 1;
        }
      }
      if (wmin <= tb1) {
        tbest = wmin;
        tribest = gstart * 2 + widx;
      }
      tri += 2 * lw;
    } else if (typ == 1) {
      bool hit[8];
      float key[8];
      int ev[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float lox = __ldg(cp + static_cast<size_t>(0 * 8 + e) * ecap);
        const float loy = __ldg(cp + static_cast<size_t>(1 * 8 + e) * ecap);
        const float loz = __ldg(cp + static_cast<size_t>(2 * 8 + e) * ecap);
        const float hix = __ldg(cp + static_cast<size_t>(3 * 8 + e) * ecap);
        const float hiy = __ldg(cp + static_cast<size_t>(4 * 8 + e) * ecap);
        const float hiz = __ldg(cp + static_cast<size_t>(5 * 8 + e) * ecap);
        const int m = __float_as_int(__ldg(cp + static_cast<size_t>(48 + e) * ecap));
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
      for (int q = 0; q < 8; ++q) pv[q] = 0;
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

    // stack update: push the hits (the nearest becomes cur) or pop
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

  const int top = n > 0 ? stk[n - 1] : 0;
  const bool live = (cur != 0) || (top != 0);
  const bool ovf = wmark > stack_cap - 8;
  const int live_e = (cur & 3) != 0 ? cur : top;
  const int wtid = live ? (live_e >> 9) : root_tid;
  const int want = (live || ovf) ? wtid + 1 : 0;

  float* op = out + static_cast<size_t>(pkt) * 8 * 128 + lane;
  op[0 * 128] = tbest;
  op[1 * 128] = __int_as_float(tribest);
  op[2 * 128] = static_cast<float>(box);
  op[3 * 128] = static_cast<float>(tri);
  op[4 * 128] = static_cast<float>(iters);
  op[5 * 128] = static_cast<float>(switches);
  op[6 * 128] = static_cast<float>(wmark);
  op[7 * 128] = static_cast<float>(want);

  int* so = state_out + static_cast<size_t>(pkt) * srows * 128 + lane;
  so[0 * 128] = cur;
  so[1 * 128] = __float_as_int(tbest);
  so[2 * 128] = tribest;
  so[3 * 128] = depth;
  so[4 * 128] = wmark;
  for (int i = 0; i < stack_cap; ++i) so[(5 + i) * 128] = i < n ? stk[n - 1 - i] : 0;
}

}  // namespace

// Plain C interface, bound with ctypes. Pointers are device pointers;
// ``stream`` is a cudaStream_t. Returns the cudaError_t of the launch.
extern "C" int lane_trace_launch(const void* tables, int num_tables, int wh, int ecap, int lw,
                                 const void* rays8, const void* state_in, void* out,
                                 void* state_out, int num_packets, int root_tid, int stack_cap,
                                 int budget, int no_switch, int any_hit, void* stream) {
  if (num_packets <= 0) return 0;
  if (num_tables <= 0 || ecap <= 0 || ecap > 128 || lw <= 0 || wh < 56 || wh < 12 * lw + 1 ||
      stack_cap <= 0 || stack_cap > kMaxStack || root_tid < 0 || root_tid >= num_tables)
    return static_cast<int>(cudaErrorInvalidValue);
  const int num_rays = num_packets * 128;
  const int limit = budget > 0 ? budget : kMaxIters;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(tables);
  const float* r = static_cast<const float*>(rays8);
  const int* si = static_cast<const int*>(state_in);
  if (any_hit)
    lane_trace_kernel<true><<<num_packets, kThreads, 0, s>>>(
        t, wh, ecap, lw, r, si, static_cast<float*>(out), static_cast<int*>(state_out), num_rays,
        root_tid, stack_cap, limit, no_switch);
  else
    lane_trace_kernel<false><<<num_packets, kThreads, 0, s>>>(
        t, wh, ecap, lw, r, si, static_cast<float*>(out), static_cast<int*>(state_out), num_rays,
        root_tid, stack_cap, limit, no_switch);
  return static_cast<int>(cudaGetLastError());
}
