// The scalar-loop micro-probes, for Hopper (sm_90a): one CTA, 128 threads.
//
// Replaces the TPU kernels of benchmarks/micro_pallas.py (k_loop :67,
// k_dma1 :75, k_dma2 :88, k_comp :109, k_pipe :130; pallas_call :37) and
// benchmarks/micro_control.py (mk_red :73, mk_when :89, k_push :105,
// k_read :125, k_combo :135; pallas_call :43; k_batch :188, pallas_call
// :229). Each is one template instantiation of micro_probe_kernel; the
// Python wrappers are tpu_raytracing_torch/benchmarks/micro_pallas.py and
// micro_control.py, whose plain PyTorch versions compute the same outputs.
//
// What the probes compute: an N-iteration loop whose output is an int32
// sum, s += row[idx_of(i, seed)][6] (or idx_of itself, or a stack
// pointer), with one component of a traversal pop added per variant. The
// TPU runs them as one core's sequential loop, so the counterpart is ONE
// CTA. Its 128 threads, four warps, stand for the TPU's 128 lanes; the
// scalar state (i, s, idx, sp) is uniform across the CTA, every thread
// computes it, and thread 0 writes the output.
//
// How the TPU's pieces map:
//   * SMEM/VMEM scratch -> shared memory, read through volatile pointers so
//     every read and write the reference makes is made here too.
//   * make_async_copy(...).start() / .wait() on a DMA semaphore -> a 1-D
//     TMA bulk copy (cp.async.bulk) global -> shared memory that completes
//     on an mbarrier. Chosen over cp.async because it is the same contract:
//     one thread issues the whole row copy (the DMA engine moves it, no
//     thread spends registers or instructions on its words) and every
//     thread waits on the barrier's phase, as the reference waits on its
//     semaphore. It is an asynchronous copy the compiler can neither hoist
//     nor merge with a load. A row buffer is reused only after a
//     __syncthreads, since the CTA's threads read it at different times;
//     that barrier is part of what a pop costs on the card.
//   * pipe4 / combo / batch4 keep 4 copies in flight, round-robin, one
//     mbarrier per slot, as the reference keeps 4 semaphores.
//   * jnp.min / jnp.sum of an (8,1) or (32,1) vector -> element t on thread
//     t, the identity elsewhere; __reduce_min_sync / __reduce_add_sync in
//     each warp, then the four warp results through shared memory (one
//     __syncthreads per reduction, buffers alternating).
//   * pl.when -> a uniform branch.
//   * Scalar SMEM that the loop writes (when's scr, the push stack and its
//     pointer spp) -> one copy per warp in shared memory, each warp's 32
//     lanes reading and writing the same words with the same values, so no
//     barrier orders one warp's write against another's read. The push
//     loop's dynamic writes are dynamic shared-memory writes, the dump slot
//     at 300 as in the reference; an index outside [0, 300] (the first
//     iteration's pointer is the scratch fill, INT32_MIN in interpret mode)
//     is clamped, as dynamic_update_slice clamps. The stack is never read,
//     so its contents reach no output.
//   * comp's acc (8,128) -> column t on thread t; it is written to an extra
//     output so its 54 vector operations per element reach a result and
//     are not deleted.
//   * Scratch the reference reads before writing (vec, meta_s, scr, spp,
//     acc) starts from inputs the wrapper passes (interpret mode's NaN /
//     INT32_MIN fill, or any other).
//
// Integer semantics follow JAX: int32 arithmetic wraps (computed in
// unsigned here, where signed overflow is undefined), % is a floor modulo,
// >> is arithmetic, float32 -> int32 truncates and saturates with NaN -> 0
// (cvt.rzi.s32.f32, __float2int_rz). Float arithmetic is IEEE and unfused
// (-fmad=false), in the reference's order.
//
// What bounds it: nothing of the card's throughput. Every probe is one
// latency chain on one SM: each copy's issue and wait, each barrier, each
// shared-memory access. That is what the probes measure, so the measured
// time over the bound (bytes or float32 operations at the card's peak) is
// very large by design.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kW = 65536;
constexpr int kRow = 128;  // int32 words per row
constexpr unsigned kRowBytes = kRow * 4;
constexpr int kStack = 301;
constexpr int kDump = 300;
constexpr int kSpp = 16;

// The order of tpu_raytracing_torch/benchmarks/_micro.py:KINDS.
enum Kind { LOOP, DMA1, DMA2, COMP, PIPE4, RED1, RED2, WHEN4, WHEN12, PUSH8, READ8, COMBO, BATCH4 };

__device__ __forceinline__ int add32(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int idx_of(int i, int seed) {
  const unsigned x = (static_cast<unsigned>(i) * 7919u + static_cast<unsigned>(seed)) * 1103515245u;
  return static_cast<int>((x & 0x7FFFFFFFu) % kW);
}

__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// ((meta >> 5) << 1) | (meta & 1), the left shift wrapping as in int32
__device__ __forceinline__ int tag_of(int meta) {
  return static_cast<int>((static_cast<unsigned>(meta >> 5) << 1) | static_cast<unsigned>(meta & 1));
}

__device__ __forceinline__ unsigned smem_addr(const volatile void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(const_cast<const void*>(p)));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(1u) : "memory");
}

// make_async_copy(...).start(): one thread arms the barrier with the byte
// count and issues the bulk copy, which completes the count on arrival.
__device__ __forceinline__ void copy_start(volatile void* dst, const void* src, unsigned bytes,
                                           uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// .wait(): every thread spins on the barrier's phase.
__device__ __forceinline__ void copy_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// CTA-wide reductions of one int per thread: warp reduction, then the four
// warp results through red (two alternating buffers of kWarps words), so one
// __syncthreads per call suffices.
__device__ __forceinline__ int cta_min(int v, int* red, int& buf) {
  v = __reduce_min_sync(0xffffffffu, v);
  int* slot = red + buf * kWarps;
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = slot[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = min(m, slot[w]);
  buf ^= 1;
  return m;
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

// The interior_pop push tail: 8 candidate tags from a row's meta words,
// pushed where bit e of vmask is set and e != emin. Returns the new sp.
__device__ __forceinline__ int push8(volatile int* stack, const volatile int* meta_row, int sp,
                                     int vmask, int emin) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int tag = tag_of(meta_row[e * 8 + 6]);
    const bool ok = (((vmask >> e) & 1) == 1) && (e != emin);
    const int at = ok ? sp : kDump;
    stack[min(max(at, 0), kDump)] = tag;
    sp = add32(sp, ok ? 1 : 0);
  }
  return sp;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
micro_probe_kernel(const int* __restrict__ rows, const int* __restrict__ seed_p, int n,
                   const float* __restrict__ vec, const int* __restrict__ meta,
                   const int* __restrict__ spp, int* __restrict__ out, float* __restrict__ acc) {
  __shared__ __align__(128) int row_s[4][kRow];
  __shared__ __align__(128) int vrow_s[8][kRow];
  __shared__ float acc_s[8][kRow];
  __shared__ __align__(8) uint64_t bar_s[5];
  __shared__ float vec_s[32];
  __shared__ int meta_s[kRow];
  __shared__ int spp_s[kWarps][kSpp];
  __shared__ int stack_s[kWarps][kStack];
  __shared__ int red_s[2 * kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seed = seed_p[0];
  if (tid < 32) vec_s[tid] = vec[tid];
  meta_s[tid] = meta[tid];
  if (lane < kSpp) spp_s[warp][lane] = spp[lane];
  if (K == COMP) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_s[e][tid] = acc[e * kRow + tid];
  }
  if (tid == 0) {
#pragma unroll
    for (int b = 0; b < 5; ++b) bar_init(&bar_s[b]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const volatile float* vec_v = vec_s;
  const volatile int* meta_v = meta_s;
  volatile int* sppw = spp_s[warp];
  volatile int* stackw = stack_s[warp];
  volatile int(*rows_v)[kRow] = row_s;
  int s = 0;
  int rbuf = 0;
  unsigned phase = 0;  // bit b: parity to wait for on bar_s[b]

  if constexpr (K == LOOP) {
    for (int i = 0; i < n; ++i) s = add32(s, idx_of(i, seed));
  } else if constexpr (K == DMA1 || K == DMA2 || K == COMP) {
    for (int i = 0; i < n; ++i) {
      const int idx = idx_of(i, seed);
      if (tid == 0) {
        copy_start(row_s[0], rows + static_cast<size_t>(idx) * kRow, kRowBytes, &bar_s[0]);
        if (K == DMA2)
          copy_start(vrow_s, rows + static_cast<size_t>(min(idx, kW - 8)) * kRow, 8 * kRowBytes,
                     &bar_s[4]);
      }
      copy_wait(&bar_s[0], phase & 1);
      if (K == DMA2) copy_wait(&bar_s[4], phase & 1);
      phase ^= 1;
      if constexpr (K == COMP) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float x = acc_s[e][tid];
#pragma unroll
          for (int r = 0; r < 6; ++r) {
            x = fmaxf(x * 1.0001f + 0.5f, x);
            x = fminf(x * 0.9999f - 0.5f, x);
          }
#pragma unroll
          for (int r = 0; r < 6; ++r) x = x + fminf(x, 0.25f * x);
          acc_s[e][tid] = x;
        }
      }
      s = add32(s, rows_v[0][6]);
      __syncthreads();  // every thread has read row_s before the next copy
    }
  } else if constexpr (K == PIPE4) {
    if (tid == 0)
      for (int c = 0; c < 4; ++c)
        copy_start(row_s[c], rows + static_cast<size_t>(idx_of(c, seed)) * kRow, kRowBytes,
                   &bar_s[c]);
    for (int i = 0; i < n; ++i) {
      const int c = i & 3;
      copy_wait(&bar_s[c], (phase >> c) & 1);
      phase ^= 1u << c;
      s = add32(s, rows_v[c][6]);
      __syncthreads();
      if (tid == 0)
        copy_start(row_s[c], rows + static_cast<size_t>(idx_of(i + 4, seed)) * kRow, kRowBytes,
                   &bar_s[c]);
    }
    for (int c = 0; c < 4; ++c) copy_wait(&bar_s[c], (phase >> c) & 1);
  } else if constexpr (K == RED1 || K == RED2) {
    constexpr int kRed = K == RED1 ? 1 : 2;
    for (int i = 0; i < n; ++i) {
      const float m = static_cast<float>(i % 7 + 1);
      const int x = tid < 8 ? __float2int_rz(vec_v[tid] * m) : 0;
#pragma unroll
      for (int r = 0; r < kRed; ++r) s = add32(s, cta_min(tid < 8 ? add32(x, r) : INT_MAX, red_s, rbuf));
    }
  } else if constexpr (K == WHEN4 || K == WHEN12) {
    constexpr int kWhen = K == WHEN4 ? 4 : 12;
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int w = 0; w < kWhen; ++w)
        if ((i + w) % 3 != 0) sppw[w] = add32(sppw[w], i);
      s = add32(s, sppw[0]);
    }
  } else if constexpr (K == PUSH8) {
    for (int i = 0; i < n; ++i) {
      const int sp = push8(stackw, meta_v, sppw[0], i & 0xFF, i % 8);
      sppw[0] = floor_mod(sp, 200);
      s = add32(s, sp);
    }
  } else if constexpr (K == READ8) {
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int e = 0; e < 8; ++e) s = add32(s, meta_v[e * 8 + 6]);
    }
  } else if constexpr (K == COMBO) {
    if (tid == 0)
      for (int c = 0; c < 4; ++c)
        copy_start(row_s[c], rows + static_cast<size_t>(idx_of(c, seed)) * kRow, kRowBytes,
                   &bar_s[c]);
    for (int i = 0; i < n; ++i) {
      const int c = i & 3;
      copy_wait(&bar_s[c], (phase >> c) & 1);
      phase ^= 1u << c;
      const float m = static_cast<float>(i % 7 + 1);
      const int x = tid < 8 ? __float2int_rz(vec_v[tid] * m) : 0;
      const int kmin = cta_min(tid < 8 ? x : INT_MAX, red_s, rbuf);
      const int vmask = cta_sum(tid < 8 ? (x & 1) : 0, red_s, rbuf);
      if (i % 3 != 0) sppw[1] = add32(sppw[1], 1);
      const int sp = push8(stackw, rows_v[c], sppw[0], vmask, floor_mod(kmin, 8));
      sppw[0] = floor_mod(sp, 200);
      if (i % 5 != 0) sppw[2] = add32(sppw[2], 1);
      __syncthreads();  // every thread has read row_s[c] before it is refilled
      if (tid == 0)
        copy_start(row_s[c], rows + static_cast<size_t>(idx_of(i + 4, seed)) * kRow, kRowBytes,
                   &bar_s[c]);
      if (i % 7 != 0) sppw[3] = add32(sppw[3], 1);
      s = add32(s, sp);
    }
    for (int c = 0; c < 4; ++c) copy_wait(&bar_s[c], (phase >> c) & 1);
  } else if constexpr (K == BATCH4) {
    if (tid == 0)
      for (int c = 0; c < 4; ++c)
        copy_start(row_s[c], rows + static_cast<size_t>(idx_of(c, seed)) * kRow, kRowBytes,
                   &bar_s[c]);
    for (int i = 0; i < n / 4; ++i) {
      const float m = static_cast<float>(i % 7 + 1);
      const int x = tid < 32 ? add32(__float2int_rz(vec_v[tid] * m), tid) : INT_MAX;
      const int packed = cta_min(x, red_s, rbuf);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        copy_wait(&bar_s[c], (phase >> c) & 1);
        phase ^= 1u << c;
        const int sp = push8(stackw, rows_v[c], sppw[0], (packed >> (c * 8)) & 0xFF,
                             floor_mod(packed, 8));
        sppw[0] = floor_mod(sp, 200);
        __syncthreads();
        if (tid == 0)
          copy_start(row_s[c], rows + static_cast<size_t>(idx_of(i * 4 + c + 4, seed)) * kRow,
                     kRowBytes, &bar_s[c]);
      }
      s = add32(s, sppw[0]);
    }
    for (int c = 0; c < 4; ++c) copy_wait(&bar_s[c], (phase >> c) & 1);
  }

  if (tid == 0) out[0] = s;
  if (K == COMP) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e * kRow + tid] = acc_s[e][tid];
  }
}

template <int K>
int launch(const void* rows, const void* seed, int n, const void* vec, const void* meta,
           const void* spp, void* out, void* acc, cudaStream_t stream) {
  micro_probe_kernel<K><<<1, kThreads, 0, stream>>>(
      static_cast<const int*>(rows), static_cast<const int*>(seed), n,
      static_cast<const float*>(vec), static_cast<const int*>(meta), static_cast<const int*>(spp),
      static_cast<int*>(out), static_cast<float*>(acc));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes. rows [65536, 128] i32, seed [1] i32,
// vec [32] f32, meta [128] i32, spp [16] i32 (the scratch fills), out [1]
// i32, acc [8, 128] f32 (in: comp's fill, out: its final acc; unused by the
// other kinds). Pointers are device pointers, stream a cudaStream_t.
// Returns the cudaError_t of the launch.
extern "C" int micro_probe_launch(int kind, const void* rows, const void* seed, int n,
                                  const void* vec, const void* meta, const void* spp, void* out,
                                  void* acc, void* stream_ptr) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  switch (kind) {
    case LOOP: return launch<LOOP>(rows, seed, n, vec, meta, spp, out, acc, st);
    case DMA1: return launch<DMA1>(rows, seed, n, vec, meta, spp, out, acc, st);
    case DMA2: return launch<DMA2>(rows, seed, n, vec, meta, spp, out, acc, st);
    case COMP: return launch<COMP>(rows, seed, n, vec, meta, spp, out, acc, st);
    case PIPE4: return launch<PIPE4>(rows, seed, n, vec, meta, spp, out, acc, st);
    case RED1: return launch<RED1>(rows, seed, n, vec, meta, spp, out, acc, st);
    case RED2: return launch<RED2>(rows, seed, n, vec, meta, spp, out, acc, st);
    case WHEN4: return launch<WHEN4>(rows, seed, n, vec, meta, spp, out, acc, st);
    case WHEN12: return launch<WHEN12>(rows, seed, n, vec, meta, spp, out, acc, st);
    case PUSH8: return launch<PUSH8>(rows, seed, n, vec, meta, spp, out, acc, st);
    case READ8: return launch<READ8>(rows, seed, n, vec, meta, spp, out, acc, st);
    case COMBO: return launch<COMBO>(rows, seed, n, vec, meta, spp, out, acc, st);
    case BATCH4: return launch<BATCH4>(rows, seed, n, vec, meta, spp, out, acc, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
