// The 8-wide fat collapse: bvh/wide.py:build_wide_fat, with K6's stack-depth
// check (ops/fat_traverse.py:check_stack_depth), in two launches and a scan.
//
// It replaces no TPU kernel: the JAX package collapses with XLA operations
// (tpu_raytracing/bvh/wide.py:build_wide_fat), which XLA fuses. Run eagerly
// in PyTorch the same collapse was some 250 operations over every binary
// slot (pointer-doubling depth passes, the frontier of every slot, a
// [slots, 8, 16] gather of pair rows, a where and a cat) and five host reads,
// about 19 ms of a 1M-triangle Karras frame for work that moves some 1.5 GB.
//
// What it computes, for a BVH of n slots (bvh/types.py) and P pair rows:
//   * depth_anchor_kernel, one thread per slot: the slot's depth, the number
//     of parent links to a slot that is its own parent (root slots have
//     depth 0), walked up to `cap` links; the slot is an anchor when it is a
//     Box slot, depth >= base and (depth - base) % 3 == 0, base 2 for a root
//     pair and 3 for any other root group; info[1] = the largest depth
//     (capped), info[2] = root_count. The walk stops at `cap`, where K6's
//     stack check fails whatever the tree: the caller then finds the exact
//     depth by pointer doubling for the error it raises.
//   * the caller's inclusive scan of the anchor flags in slot order: anchor
//     s owns wide row incl[s] (1 + its rank), as build_wide numbers them.
//   * emit_kernel, one thread per (slot, entry), eight per slot: for an
//     anchor, entry q of its 3-level frontier (q's bits pick the child at
//     each level, a leaf stops early and leaves holes, as _frontier does);
//     slot 0's eight threads also walk the root group's greedy expansion
//     (_expand_group, base levels) and write entry q of row 0; row s + 1 is
//     zeroed where it lies past the live rows (num_wide = 1 + anchors, in
//     info[0]). Each entry writes its 8 node words (min and max bits, meta,
//     pad; an empty entry the inverted F32_MAX box) and its 16 pair words
//     (the pair row of a Tri entry, else zeros).
// Every output word equals build_wide_fat's: the same integer operations,
// float bits copied, meta truncated to 32 bits as PyTorch's cast does.
//
// What bounds it: bytes. The 1.43 GiB output at 1M triangles ([n + 1, 192]
// int32, mostly the zero tail) is written once, about 0.45 ms at the card's
// HBM bandwidth; reads are some 50 B a slot and the live rows' pair rows.
// The depth walks are dependent loads of the 4 B parent array, which stays
// in the 50 MB L2 at 2M slots. The design writes every row once with 16-byte
// stores, eight neighbouring threads on one row, and keeps every temporary
// to one int32 a slot.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWide = 8;
constexpr int kNodeWords = 8 * kWide;
constexpr int kPairWords = 16;
constexpr int kRowWords = kNodeWords + kWide * kPairWords;
constexpr int kChildNone = 0;
constexpr int kChildBox = 1;
constexpr int kChildTri = 2;
constexpr int kF32MaxBits = 0x7f7fffff;
constexpr int kNegF32MaxBits = static_cast<int>(0xff7fffffu);

struct Tree {
  const int* node_min;  // [n, 3] float32 bits
  const int* node_max;
  const int* child;
  const int* count;
  const int* type;
  const int* flag;  // anchor flags
  const int* incl;  // their inclusive scan
  int64_t n;
};

__device__ __forceinline__ int64_t clamp_slot(int64_t x, int64_t n) {
  return x < 0 ? 0 : (x > n - 1 ? n - 1 : x);
}

// one level of _frontier for entry x: side k of a Box entry's child pair;
// any other entry stays on the left and leaves a hole on the right
__device__ __forceinline__ int64_t expand(const Tree& t, int64_t x, int k) {
  const int64_t s = clamp_slot(x, t.n);
  if (x >= 0 && t.type[s] == kChildBox) return static_cast<int64_t>(t.child[s]) + k;
  return k ? -1 : x;
}

// _pack_entries and build_wide_fat's pair words for binary slot x (-1 empty),
// written as entry e of `row`
__device__ __forceinline__ void write_entry(const Tree& t, int64_t x, const int4* pairs,
                                            int64_t num_pairs, int* row, int e) {
  const int64_t s = clamp_slot(x, t.n);
  const bool valid = x >= 0;
  const int ty = valid ? t.type[s] : kChildNone;
  const int64_t child = ty == kChildBox ? (t.flag[s] ? static_cast<int64_t>(t.incl[s]) : -1)
                                        : static_cast<int64_t>(t.child[s]);
  const int64_t cnt = t.count[s];
  const int64_t meta64 = ((child < 0 ? 0 : child) << 5) |
                         ((cnt < 0 ? 0 : (cnt > 7 ? 7 : cnt)) << 2) |
                         (ty < 0 ? 0 : (ty > 3 ? 3 : ty));
  const int meta = static_cast<int>(static_cast<uint32_t>(meta64 & 0xFFFFFFFFll));
  const int* mn = t.node_min + 3 * s;
  const int* mx = t.node_max + 3 * s;
  int4* node = reinterpret_cast<int4*>(row + 8 * e);
  node[0] = valid ? make_int4(mn[0], mn[1], mn[2], mx[0])
                  : make_int4(kF32MaxBits, kF32MaxBits, kF32MaxBits, kNegF32MaxBits);
  node[1] = valid ? make_int4(mx[1], mx[2], meta, 0)
                  : make_int4(kNegF32MaxBits, kNegF32MaxBits, meta, 0);
  int4* pw = reinterpret_cast<int4*>(row + kNodeWords + kPairWords * e);
  if ((meta & 3) == kChildTri) {
    int64_t pc = static_cast<int64_t>(meta >> 5);
    pc = pc < 0 ? 0 : (pc > num_pairs - 1 ? num_pairs - 1 : pc);
    const int4* src = pairs + 4 * pc;
#pragma unroll
    for (int k = 0; k < 4; ++k) pw[k] = src[k];
  } else {
    const int4 z = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int k = 0; k < 4; ++k) pw[k] = z;
  }
}

__global__ void __launch_bounds__(kThreads)
depth_anchor_kernel(const int* __restrict__ parent, const int* __restrict__ type,
                    const int* __restrict__ root_count, int* __restrict__ flag,
                    unsigned long long* __restrict__ info, int64_t n, int cap) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int rc = *root_count;
  int depth = 0;
  if (i < n) {
    int64_t cur = i;
    int64_t p = parent[i];
    while (p != cur && depth < cap) {
      ++depth;
      cur = p;
      p = parent[p];
    }
    const int base = rc == 2 ? 2 : 3;
    flag[i] = type[i] == kChildBox && depth >= base && (depth - base) % 3 == 0;
  }
  for (int off = 16; off > 0; off >>= 1)
    depth = max(depth, __shfl_xor_sync(0xffffffffu, depth, off));
  __shared__ int warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = depth;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
    atomicMax(&info[1], static_cast<unsigned long long>(m));
    if (blockIdx.x == 0) info[2] = static_cast<unsigned long long>(static_cast<int64_t>(rc));
  }
}

__global__ void __launch_bounds__(kThreads)
emit_kernel(Tree t, const int* __restrict__ root, const int* __restrict__ root_count,
            const int4* __restrict__ pairs, int64_t num_pairs, int* __restrict__ rows,
            unsigned long long* __restrict__ info) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t s = g >> 3;
  const int e = static_cast<int>(g & 7);
  if (s >= t.n) return;
  const int64_t num_wide = 1 + static_cast<int64_t>(t.incl[t.n - 1]);
  if (t.flag[s]) {
    const int64_t x = expand(t, expand(t, expand(t, s, e >> 2), (e >> 1) & 1), e & 1);
    write_entry(t, x, pairs, num_pairs, rows + static_cast<int64_t>(t.incl[s]) * kRowWords, e);
  }
  if (s + 1 >= num_wide) {
    // the row's eight threads store 128 contiguous bytes a step
    int4* r = reinterpret_cast<int4*>(rows + (s + 1) * kRowWords);
    const int4 z = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int k = 0; k < kRowWords / 4 / kWide; ++k) r[kWide * k + e] = z;
  }
  if (s == 0) {
    // row 0: the root group expanded base times, greedily from the left,
    // within the 8-entry budget (_expand_group)
    const int rc = *root_count;
    const int64_t r0 = *root;
    int64_t ent[kWide];
#pragma unroll
    for (int k = 0; k < kWide; ++k) ent[k] = k < rc ? r0 + k : -1;
    const int levels = rc == 2 ? 2 : 3;
    for (int level = 0; level < levels; ++level) {
      int valid_count = 0;
#pragma unroll
      for (int k = 0; k < kWide; ++k) valid_count += ent[k] >= 0;
      int64_t next[kWide];
#pragma unroll
      for (int k = 0; k < kWide; ++k) next[k] = -1;
      int order = 0;
      int start = 0;
      for (int k = 0; k < kWide; ++k) {
        const bool valid = ent[k] >= 0;
        const int64_t sk = clamp_slot(ent[k], t.n);
        const bool box = valid && t.type[sk] == kChildBox;
        order += box;
        const bool can = box && valid_count + order <= kWide;
        const int64_t c = t.child[sk];
        if (valid && start < kWide) next[start] = can ? c : ent[k];
        if (can && start + 1 < kWide) next[start + 1] = c + 1;
        start += can ? 2 : (valid ? 1 : 0);
      }
#pragma unroll
      for (int k = 0; k < kWide; ++k) ent[k] = next[k];
    }
    write_entry(t, ent[e], pairs, num_pairs, rows, e);
    if (e == 0) info[0] = static_cast<unsigned long long>(num_wide);
  }
}

}  // namespace

// Pass 1 over the n >= 1 slots of a BVH: int32 parent and type [n], root_count
// (one int32 on the device); writes the anchor flags [n] int32 and, into info
// ([3] int64 zeroed by the caller), the largest depth (capped at cap) and
// root_count. Returns the cudaError_t of the launch.
extern "C" int wide_collapse_depth_launch(const void* parent, const void* type,
                                          const void* root_count, void* flag, void* info,
                                          int64_t n, int cap, void* stream) {
  if (n < 1 || cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  depth_anchor_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(parent), static_cast<const int*>(type),
      static_cast<const int*>(root_count), static_cast<int*>(flag),
      static_cast<unsigned long long*>(info), n, cap);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: node_min and node_max [n, 3] float32, child, count and type [n]
// int32, the flags and their inclusive scan incl [n] int32, root and
// root_count (int32 on the device), pair_rows [num_pairs, 16] int32 (16-byte
// aligned); writes every row of rows [n + 1, 192] int32 (16-byte aligned)
// and info[0] = the live row count. Returns the cudaError_t of the launch.
extern "C" int wide_collapse_emit_launch(const void* node_min, const void* node_max,
                                         const void* child, const void* count,
                                         const void* type, const void* flag, const void* incl,
                                         const void* root, const void* root_count,
                                         const void* pair_rows, int64_t num_pairs, void* rows,
                                         void* info, int64_t n, void* stream) {
  if (n < 1 || num_pairs < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Tree t{static_cast<const int*>(node_min), static_cast<const int*>(node_max),
               static_cast<const int*>(child),    static_cast<const int*>(count),
               static_cast<const int*>(type),     static_cast<const int*>(flag),
               static_cast<const int*>(incl),     n};
  const int64_t threads = n * kWide;
  const unsigned int blocks = static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  emit_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const int*>(root), static_cast<const int*>(root_count),
      static_cast<const int4*>(pair_rows), num_pairs, static_cast<int*>(rows),
      static_cast<unsigned long long*>(info));
  return static_cast<int>(cudaGetLastError());
}
