// The per-lane machine probes, for Hopper (sm_90a): one CTA of 128
// threads, thread l standing for lane l of the TPU's (8, 128) tiles.
//
// Replaces the TPU kernels of benchmarks/probe_lane_machine.py (E1 :56,
// E1b :76, E1c :98, E2 :123, E3 :154 and its correctness kernel :175, E4
// :197, E5 :215; pallas_calls :63 :84 :111 :138 :168 :182 :202 :261),
// benchmarks/probe_lane_machine2.py (make :34, pallas_call :85;
// wide_gather_check :98, pallas_call :107) and
// benchmarks/probe_lane_machine3.py (make :72, pallas_call :120). Each
// variant is one template instantiation of lane_probe_kernel; the Python
// wrappers and plain PyTorch versions are the modules of the same names in
// tpu_raytracing_torch/benchmarks/.
//
// How the TPU's pieces map:
//   * The (rows, table_lanes) table sits in shared memory (dynamic: 48 KB at
//     96 x 128 float32, 192 KB at 96 x 512, above the 48 KB static limit).
//   * take_along_axis(tab, idx, axis=1) -> thread l reads column ptr[l] of
//     every row: tab_s[s * lanes + ptr[l]]. The table is row-major, so a
//     warp's 32 reads of one row fall in bank ptr % 32: lanes whose pointers
//     differ but agree mod 32 conflict and serialise. Those bank conflicts
//     are part of what the gather probes measure on this card.
//   * take_along_axis(..., axis=0) -> thread l reads its own column at row
//     idx[s, l] (bank l % 32: conflict-free).
//   * pltpu.roll + jnp.where on the (32, 128) stack -> each thread's 32-entry
//     column in registers, rotated by k & 7 through the reference's three
//     static rolls (by 4, 2, 1) and selects.
//   * E2's one-hot bf16 product with float32 accumulation -> computed in the
//     kernel's own body, a per-thread loop of 128 bf16 x one-hot products
//     per output word (12,288 per thread per iteration); no library call.
//     All but one product per sum are exact zeros, so the sum is exact.
//   * The VMEM out_ref that every chain feeds back through, and the stack
//     scratch, are shared-memory buffers read and written through volatile
//     pointers each iteration, as the reference reads and writes its refs;
//     thread l owns column l. E5, full/nofetch/full2x and V2-V4 keep their
//     slab, rank and stack work only in the stack scratch on the TPU; here
//     the final stack is an extra output, so that work reaches a result and
//     is not deleted. Where the reference computes rows that reach nothing
//     (E5's rank, rows 8-95 of V1's gather), the kernel does not compute
//     them, as a compiler would not.
//   * V3 interleaves 2 independent packets in one thread's loop; V4 runs
//     chunks of 8 iterations inside an any-alive loop whose condition is a
//     CTA-wide sum (warp __reduce_add_sync, then shared memory), the
//     counterpart of the TPU's scalar cond. Its sum of values in [0, 127]
//     is never negative, so the loop runs ITERS / 8 chunks, as the
//     reference's does.
//   * A gather index outside its table is clamped to it (the reference's
//     indices are in range by construction; the plain versions clamp too).
//
// Float arithmetic is IEEE and unfused (-fmad=false) in the reference's
// order; % on floats is jnp.remainder (fmodf, exact), float32 -> int32 is
// XLA's (cvt.rzi: truncating, saturating, NaN -> 0), int32 adds wrap.
//
// What bounds it: nothing of the card's throughput. Every probe is one
// dependent chain on one SM, through shared memory; that latency is what
// the probes measure, so the measured time over the bound (bytes or float32
// operations at the card's peak) is very large by design.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 96;
constexpr int kS = 32;
constexpr int kWarps = kLanes / 32;

// The order of tpu_raytracing_torch/benchmarks/_lane.py:KINDS.
enum Kind { E1, E1B, E1C, E2, E3, E3_ONCE, E4, E5, FULL, FETCH, FETCH2, NOFETCH, FULL2X, WIDE,
            V0, V1, V2, V3, V4 };

struct Args {
  const void* tab;
  const int* idx;
  float* out;
  float* extra;
  int iters;
  int tl;  // table lanes
};

__device__ __forceinline__ int add32(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int clampi(int x, int hi) { return min(max(x, 0), hi - 1); }

// jnp.remainder(x, 127.0)
__device__ __forceinline__ float rem127(float x) {
  float r = fmodf(x, 127.0f);
  if (r != 0.0f && r < 0.0f) r += 127.0f;
  return r;
}

__device__ __forceinline__ float bf16_to_f32(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

// The reference's variable shift of a (32, 128) stack by k in [0, 8): three
// static rolls along the sublanes (rolled[s] = st[s - bit]) and selects.
__device__ __forceinline__ void roll_select(float (&v)[kS], int k) {
#pragma unroll
  for (int b = 2; b >= 0; --b) {
    const int bit = 1 << b;
    const bool take = (k & bit) != 0;
    float t[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) t[s] = take ? v[(s - bit + kS) % kS] : v[s];
#pragma unroll
    for (int s = 0; s < kS; ++s) v[s] = t[s];
  }
}

struct Slab {
  int nvalid;
  int rank0;
};

// The mock slab test of E5 / body_work on box = g[0:48] as (6, 8): the
// entries' hit count and the rank of entry 0's key among the 8.
__device__ __forceinline__ Slab slab(const float (&g)[48]) {
  float key[8];
  int nvalid = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float t0 = (g[e] - 0.3f) * g[24 + e];
    const float t1 = (g[8 + e] - 0.2f) * g[32 + e];
    const float t2 = (g[16 + e] - 0.1f) * g[40 + e];
    const float front = fmaxf(fmaxf(fminf(t0, t1), fminf(t1, t2)), fminf(t0, t2));
    const float back = fminf(fminf(fmaxf(t0, t1), fmaxf(t1, t2)), fmaxf(t0, t2));
    const bool hit = back >= front;
    key[e] = hit ? front : 3e38f;
    nvalid += hit ? 1 : 0;
  }
  int rank0 = 0;
#pragma unroll
  for (int f = 0; f < 8; ++f) rank0 += key[f] < key[0] ? 1 : 0;
  return {nvalid, rank0};
}

// The stack push: the column shifted by k, then (st + add) + 1 on rows < k.
__device__ __forceinline__ void stack_push(volatile float* col, int k, float add) {
  float v[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) v[s] = col[s * kLanes];
  roll_select(v, k);
#pragma unroll
  for (int s = 0; s < kS; ++s) col[s * kLanes] = s < k ? (v[s] + add) + 1.0f : v[s];
}

__device__ __forceinline__ int cta_sum(int v, int* red, int& buf) {
  v = static_cast<int>(__reduce_add_sync(0xffffffffu, static_cast<unsigned>(v)));
  int* slot = red + buf * kWarps;
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = slot[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = add32(m, slot[w]);
  buf ^= 1;
  return m;
}

__device__ __forceinline__ void load_words(uint32_t* dst, const uint32_t* src, int words) {
  for (int j = threadIdx.x; j < words; j += kLanes) dst[j] = src[j];
}

// One iteration of probe 3's packet step on packet p: gather, optional
// body work, and the pointer tile's update.
template <int K>
__device__ __forceinline__ void v_step(const float* tab_s, volatile int* st8, volatile float* st_col,
                                       int l) {
  int p8[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) p8[r] = st8[r * kLanes + l];
  const int ptr = p8[0] & 127;
  float g[48];
  constexpr int kG = K == V1 ? 8 : 48;
#pragma unroll
  for (int s = 0; s < kG; ++s) g[s] = tab_s[s * kLanes + ptr];
  if constexpr (K != V1) {
    const Slab sl = slab(g);
    stack_push(st_col, min(sl.nvalid, 7), static_cast<float>(sl.rank0));
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) st8[r * kLanes + l] = add32(add32(p8[r], __float2int_rz(g[r])), 1) & 127;
}

template <int K>
__global__ void __launch_bounds__(kLanes) lane_probe_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red_s[2 * kWarps];
  const int l = threadIdx.x;
  const int tl = a.tl;
  const float* tab = static_cast<const float*>(a.tab);

  if constexpr (K == E1 || K == E1B || K == E4 || K == WIDE) {
    // one-shot gathers straight to the output
    constexpr int kR = K == E1 ? 8 : (K == E4 ? kS : kRows);
    float* tab_s = reinterpret_cast<float*>(smem);
    load_words(reinterpret_cast<uint32_t*>(tab_s), static_cast<const uint32_t*>(a.tab), kR * tl);
    __syncthreads();
    const int p = clampi(a.idx[l], tl);
#pragma unroll 8
    for (int s = 0; s < kR; ++s) {
      float v;
      if constexpr (K == E1) v = tab_s[s * tl + clampi(a.idx[s * kLanes + l], tl)];
      else if constexpr (K == E4) v = tab_s[clampi(a.idx[s * kLanes + l], kS) * kLanes + l];
      else v = tab_s[s * tl + p];
      a.out[s * kLanes + l] = v;
    }
  } else if constexpr (K == E3 || K == E3_ONCE) {
    float v[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) v[s] = tab[s * kLanes + l];
    const int k0 = a.idx[l];
    if constexpr (K == E3_ONCE) {
      roll_select(v, k0 & 7);
    } else {
      volatile float* out_s = reinterpret_cast<float*>(smem);
#pragma unroll
      for (int s = 0; s < kS; ++s) out_s[s * kLanes + l] = v[s];
      for (int it = 0; it < a.iters; ++it) {
#pragma unroll
        for (int s = 0; s < kS; ++s) v[s] = out_s[s * kLanes + l];
        roll_select(v, add32(k0, it) & 7);
#pragma unroll
        for (int s = 0; s < kS; ++s) out_s[s * kLanes + l] = v[s] + 1.0f;
      }
#pragma unroll
      for (int s = 0; s < kS; ++s) v[s] = out_s[s * kLanes + l];
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) a.out[s * kLanes + l] = v[s];
  } else if constexpr (K == E2) {
    const unsigned short* tab_b = reinterpret_cast<const unsigned short*>(smem);
    volatile float* out_s = reinterpret_cast<float*>(smem + kRows * kLanes * 2);
    load_words(reinterpret_cast<uint32_t*>(smem), static_cast<const uint32_t*>(a.tab),
               kRows * kLanes / 2);
    for (int s = 0; s < kRows; ++s) out_s[s * kLanes + l] = static_cast<float>(a.idx[s * kLanes + l]);
    __syncthreads();
    for (int it = 0; it < a.iters; ++it) {
      const int ptr = __float2int_rz(out_s[l]) & 127;
      for (int s = 0; s < kRows; ++s) {
        float acc = 0.0f;
#pragma unroll 16
        for (int k = 0; k < kLanes; ++k)
          acc = acc + bf16_to_f32(tab_b[s * kLanes + k]) * (k == ptr ? 1.0f : 0.0f);
        out_s[s * kLanes + l] = rem127(acc + 1.0f);
      }
    }
    for (int s = 0; s < kRows; ++s) a.out[s * kLanes + l] = out_s[s * kLanes + l];
  } else if constexpr (K == E1C || K == V0 || K == E5 || K == FULL || K == FETCH ||
                       K == FETCH2 || K == NOFETCH || K == FULL2X) {
    // the E5 / probe-2 skeleton: state fed back through out_s
    float* tab_s = reinterpret_cast<float*>(smem);
    volatile float* out_s = tab_s + kRows * tl;
    volatile float* st_col = out_s + kRows * kLanes + l;
    load_words(reinterpret_cast<uint32_t*>(tab_s), static_cast<const uint32_t*>(a.tab),
               kRows * tl);
    for (int s = 0; s < kRows; ++s) out_s[s * kLanes + l] = static_cast<float>(a.idx[s * kLanes + l]);
    constexpr bool kStack = K == E5 || K == FULL || K == NOFETCH || K == FULL2X;
    if constexpr (kStack) {
#pragma unroll
      for (int s = 0; s < kS; ++s) st_col[s * kLanes] = 0.0f;
    }
    __syncthreads();
    for (int it = 0; it < a.iters; ++it) {
      const int ptr = __float2int_rz(out_s[l]) & (tl - 1);
      const float nofetch_scale = 1.0f + static_cast<float>(ptr) * 0.0f;
      float g[48];
#pragma unroll
      for (int s = 0; s < kRows; ++s) {
        float v;
        if constexpr (K == NOFETCH) {
          v = tab_s[s * tl + l] * nofetch_scale;
        } else {
          v = tab_s[s * tl + ptr];
          if constexpr (K == FETCH2) {
            const float v2 = tab_s[s * tl + (ptr ^ 1)];
            v = (v + v2 * 0.0f) + v2;
          }
        }
        if (s < 48) g[s] = v;
        if constexpr (K == E1C || K == V0 || K == E5) out_s[s * kLanes + l] = rem127(v + 1.0f);
        else out_s[s * kLanes + l] = v + 1.0f;
      }
      if constexpr (K == E5) {
        stack_push(st_col, min(slab(g).nvalid, 7), 0.0f);
      } else if constexpr (K == FULL || K == NOFETCH || K == FULL2X) {
        const Slab sl = slab(g);
#pragma unroll
        for (int r = 0; r < (K == FULL2X ? 2 : 1); ++r)
          stack_push(st_col, min(sl.nvalid + r, 7), static_cast<float>(sl.rank0));
      }
    }
    for (int s = 0; s < kRows; ++s) a.out[s * kLanes + l] = out_s[s * kLanes + l];
    if constexpr (kStack) {
      for (int s = 0; s < kS; ++s) a.extra[s * kLanes + l] = st_col[s * kLanes];
    }
  } else if constexpr (K == V1 || K == V2 || K == V3 || K == V4) {
    constexpr int kPk = K == V3 ? 2 : 1;
    float* tab_s = reinterpret_cast<float*>(smem);
    volatile int* st8 = reinterpret_cast<int*>(tab_s + kRows * kLanes);
    volatile float* st_s = reinterpret_cast<float*>(smem) + kRows * kLanes + kPk * 8 * kLanes;
    load_words(reinterpret_cast<uint32_t*>(tab_s), static_cast<const uint32_t*>(a.tab),
               kRows * kLanes);
#pragma unroll
    for (int p = 0; p < kPk; ++p) {
#pragma unroll
      for (int r = 0; r < 8; ++r) st8[(p * 8 + r) * kLanes + l] = add32(a.idx[r * kLanes + l], p);
#pragma unroll
      for (int s = 0; s < kS; ++s) st_s[(p * kS + s) * kLanes + l] = 0.0f;
    }
    __syncthreads();
    if constexpr (K == V4) {
      int buf = 0;
      bool alive = true;
      for (int c = 0; c < a.iters / 8 && alive; ++c) {
        for (int j = 0; j < 8; ++j) v_step<K>(tab_s, st8, st_s + l, l);
        int colsum = 0;
#pragma unroll
        for (int r = 0; r < 8; ++r) colsum = add32(colsum, st8[r * kLanes + l]);
        alive = cta_sum(colsum, red_s, buf) >= 0;
      }
    } else {
      for (int it = 0; it < a.iters; ++it) {
#pragma unroll
        for (int p = 0; p < kPk; ++p)
          v_step<K>(tab_s, st8 + p * 8 * kLanes, st_s + p * kS * kLanes + l, l);
      }
    }
    for (int r = 0; r < kRows; ++r)
      a.out[r * kLanes + l] = r < 8 * kPk ? static_cast<float>(st8[r * kLanes + l]) : 0.0f;
    if constexpr (K != V1) {
      for (int s = 0; s < kPk * kS; ++s) a.extra[s * kLanes + l] = st_s[s * kLanes + l];
    }
  }
}

size_t smem_bytes(int kind, int tl) {
  const size_t tab = static_cast<size_t>(kRows) * tl * 4;
  const size_t tile = static_cast<size_t>(kRows) * kLanes * 4;
  const size_t stack = static_cast<size_t>(kS) * kLanes * 4;
  switch (kind) {
    case E1: return 8 * kLanes * 4;
    case E1B: case WIDE: return tab;
    case E1C: case V0: case FETCH: case FETCH2: return tab + tile;
    case E2: return kRows * kLanes * 2 + tile;
    case E3: case E4: return stack;
    case E3_ONCE: return 0;
    case E5: case FULL: case NOFETCH: case FULL2X: return tab + tile + stack;
    case V1: case V2: case V4: return tile + 8 * kLanes * 4 + stack;
    case V3: return tile + 2 * (8 * kLanes * 4 + stack);
    default: return 0;
  }
}

template <int K>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lane_probe_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  lane_probe_kernel<K><<<1, kLanes, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes. tab: the probe's table or stack
// (float32, bf16 for E2), idx: its int32 indices, initial state or shifts,
// out [rows, 128] float32, extra: the final stack [npk * 32, 128] float32
// for the variants that keep one (else unused), iters: loop length,
// table_lanes: the table's width (a power of two, 128..512; 128 where the
// table is not a gather table). Pointers are device pointers, stream a
// cudaStream_t. Returns the cudaError_t of the launch.
extern "C" int lane_probe_launch(int kind, const void* tab, const void* idx, void* out,
                                 void* extra, int iters, int table_lanes, void* stream_ptr) {
  if (iters < 0 || table_lanes < kLanes || table_lanes > 512 ||
      (table_lanes & (table_lanes - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{tab, static_cast<const int*>(idx), static_cast<float*>(out),
               static_cast<float*>(extra), iters, table_lanes};
  const size_t smem = smem_bytes(kind, table_lanes);
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  switch (kind) {
    case E1: return launch<E1>(a, smem, st);
    case E1B: return launch<E1B>(a, smem, st);
    case E1C: return launch<E1C>(a, smem, st);
    case E2: return launch<E2>(a, smem, st);
    case E3: return launch<E3>(a, smem, st);
    case E3_ONCE: return launch<E3_ONCE>(a, smem, st);
    case E4: return launch<E4>(a, smem, st);
    case E5: return launch<E5>(a, smem, st);
    case FULL: return launch<FULL>(a, smem, st);
    case FETCH: return launch<FETCH>(a, smem, st);
    case FETCH2: return launch<FETCH2>(a, smem, st);
    case NOFETCH: return launch<NOFETCH>(a, smem, st);
    case FULL2X: return launch<FULL2X>(a, smem, st);
    case WIDE: return launch<WIDE>(a, smem, st);
    case V0: return launch<V0>(a, smem, st);
    case V1: return launch<V1>(a, smem, st);
    case V2: return launch<V2>(a, smem, st);
    case V3: return launch<V3>(a, smem, st);
    case V4: return launch<V4>(a, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
