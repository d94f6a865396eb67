// The Karras hierarchy kernel: bvh/lbvh.py:generate_hierarchy in one launch,
// one thread per internal node.
//
// It replaces no TPU kernel: the JAX package builds the hierarchy with XLA
// operations (tpu_raytracing/bvh/lbvh.py:generate_hierarchy), three 34-step
// fori_loops that XLA fuses. Run eagerly in PyTorch the same loops are some
// 13,000 operations over every internal node, each a launch of a few
// microseconds of device work, so a 1M-triangle rebuild spent ~170 ms of
// host time issuing them. Here each thread runs the reference's
// DetermineRange and FindSplit (src/BottomUpBuilder.cu:42-96) in registers,
// as the reference's GenerateHierarchy kernel does (:167-215).
//
// What it computes, for internal node i of n - 1 (n the padded code count;
// nodes i >= count - 1 are padding, written as the plain version writes
// them):
//   * cpl(i, j): the common-prefix length of codes i and j with the index
//     tie-break, -1 when j is outside [0, count);
//   * d, the direction; lmax by doubling and the range length by binary
//     search, 34 steps each; first and last (node 0 covers [0, count - 1]);
//   * the split by binary search, 34 steps;
//   * slot pair (2i, 2i + 1): child, type, count and the covered sorted-leaf
//     ranges [first, split] and [split + 1, last]; parent links of the box
//     children's two slots (the caller fills parent with each slot's own
//     index first).
// Every value equals the plain version's: the same integer operations, with
// PyTorch's wrap of a negative gather index.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChildNone = 0;
constexpr int kChildBox = 1;
constexpr int kChildTri = 2;
constexpr int kSteps = 34;

__device__ __forceinline__ int64_t clz32(int64_t x) {
  return __clz(static_cast<unsigned int>(x & 0xFFFFFFFFll));
}

// codes[i] as PyTorch gathers it: a negative index counts from the end
__device__ __forceinline__ int64_t code_at(const int64_t* codes, int64_t i, int64_t n) {
  return codes[i < 0 ? i + n : i];
}

__device__ __forceinline__ int64_t cpl(const int64_t* codes, int64_t i, int64_t j,
                                       int64_t count, int64_t n) {
  if (j < 0 || j >= count) return -1;
  const int64_t j_safe = j < 0 ? 0 : (j > n - 1 ? n - 1 : j);
  const int64_t xor_codes = code_at(codes, i, n) ^ codes[j_safe];
  const int64_t xor_idx = (i ^ j_safe) & 0xFFFFFFFFll;
  return xor_codes == 0 ? 32 + clz32(xor_idx) : clz32(xor_codes);
}

__global__ void __launch_bounds__(kThreads)
lbvh_hierarchy_kernel(const int64_t* __restrict__ codes, const int64_t* __restrict__ count_ptr,
                      int* __restrict__ child, int* __restrict__ type,
                      int* __restrict__ count_field, int64_t* __restrict__ range_lo,
                      int64_t* __restrict__ range_hi, int* __restrict__ parent, int64_t n) {
  const int64_t ii = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (ii >= n - 1) return;
  const int64_t count = *count_ptr;
  const int64_t num_slots = 2 * (n - 1);
  const bool valid = ii < count - 1;

  // DetermineRange (src/BottomUpBuilder.cu:42-68)
  const int64_t d = cpl(codes, ii, ii + 1, count, n) - cpl(codes, ii, ii - 1, count, n) >= 0
                        ? 1 : -1;
  const int64_t cpl_min = cpl(codes, ii, ii - d, count, n);
  int64_t lmax = 2;
  for (int s = 0; s < kSteps; ++s) {
    if (!(cpl(codes, ii, ii + lmax * d, count, n) > cpl_min)) break;
    lmax *= 2;
  }
  int64_t length = 0;
  for (int k = 0; k < kSteps; ++k) {
    const int64_t t = lmax >> (k + 1);
    if (t > 0 && cpl(codes, ii, ii + (length + t) * d, count, n) > cpl_min) length += t;
  }
  const int64_t j = ii + length * d;
  const int64_t first = ii == 0 ? 0 : min(ii, j);
  const int64_t last = ii == 0 ? count - 1 : max(ii, j);

  // FindSplit (src/BottomUpBuilder.cu:70-96)
  const int64_t common_prefix = cpl(codes, first, last, count, n);
  int64_t split = first;
  int64_t step = last - first;
  for (int s = 0; s < kSteps; ++s) {
    step = (step + 1) >> 1;
    const int64_t new_split = split + step;
    if (new_split < last && cpl(codes, first, new_split, count, n) > common_prefix)
      split = new_split;
    if (step <= 1) break;
  }

  // child/type/parent writes (src/BottomUpBuilder.cu:186-214)
  const bool leaf_a = split == first;
  const bool leaf_b = split + 1 == last;
  const int64_t child_a = leaf_a ? split : split * 2;
  const int64_t child_b = leaf_b ? split + 1 : (split + 1) * 2;
  const int type_a = !valid ? kChildNone : (leaf_a ? kChildTri : kChildBox);
  const int type_b = !valid ? kChildNone : (leaf_b ? kChildTri : kChildBox);
  const int64_t a = 2 * ii;
  child[a] = valid ? static_cast<int>(child_a) : 0;
  child[a + 1] = valid ? static_cast<int>(child_b) : 0;
  type[a] = type_a;
  type[a + 1] = type_b;
  count_field[a] = type_a == kChildBox ? 2 : (type_a == kChildTri ? 1 : 0);
  count_field[a + 1] = type_b == kChildBox ? 2 : (type_b == kChildTri ? 1 : 0);
  range_lo[a] = first;
  range_lo[a + 1] = split + 1;
  range_hi[a] = split;
  range_hi[a + 1] = last;
  if (valid && !leaf_a) {
    for (int off = 0; off < 2; ++off)
      if (child_a + off >= 0 && child_a + off < num_slots)
        parent[child_a + off] = static_cast<int>(a);
  }
  if (valid && !leaf_b) {
    for (int off = 0; off < 2; ++off)
      if (child_b + off >= 0 && child_b + off < num_slots)
        parent[child_b + off] = static_cast<int>(a + 1);
  }
}

}  // namespace

// The hierarchy of n >= 2 sorted codes (int64 holding uint32 keys), count
// the live leaf count (one int64 on the device). Outputs: child, type and
// count [2 (n - 1)] int32, range_lo and range_hi [2 (n - 1)] int64, parent
// [2 (n - 1)] int32, filled by the caller with each slot's own index.
// ``stream`` is a cudaStream_t. Returns the cudaError_t of the launch.
extern "C" int lbvh_hierarchy_launch(const void* codes, const void* count, void* child,
                                     void* type, void* count_field, void* range_lo,
                                     void* range_hi, void* parent, int64_t n, void* stream) {
  if (n < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nodes = n - 1;
  const unsigned int blocks = static_cast<unsigned int>((nodes + kThreads - 1) / kThreads);
  lbvh_hierarchy_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(codes), static_cast<const int64_t*>(count),
      static_cast<int*>(child), static_cast<int*>(type), static_cast<int*>(count_field),
      static_cast<int64_t*>(range_lo), static_cast<int64_t*>(range_hi),
      static_cast<int*>(parent), n);
  return static_cast<int>(cudaGetLastError());
}
