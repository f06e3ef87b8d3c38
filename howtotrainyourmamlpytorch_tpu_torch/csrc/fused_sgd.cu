// B1: the fused LSLR inner-SGD update for Hopper (sm_90a), one launch over
// the whole parameter tree: out_i = p_i - lr_i * g_i for every leaf i.
//
// Replaces: howtotrainyourmamlpytorch_tpu/ops/pallas_update.py:125
// (_fwd_kernel, launched by _fused_sgd_fwd_impl through pl.pallas_call at
// :159). The TPU kernel takes the tree packed into [rows, 128] tiles for
// VMEM and a per-row lr column gathered by XLA. This kernel takes the
// leaves where they lie, through the leaf table in its launch parameters
// (csrc/tree_chunks.cuh), and reads each leaf's lr itself: no pack, pad,
// concat, gather or slice runs around it.
//
// Numerics: accumulate in f32 and round once to the operand dtype on
// store. __fmul_rn / __fsub_rn forbid FMA contraction and
// __floats2bfloat162_rn / __float2bfloat16_rn round to nearest even, so the
// result equals the plain PyTorch twin
// (ops/fused_update.py::fused_sgd_tree_reference: a mul kernel, a sub
// kernel, a cast) bit for bit, in f32 and in bf16.
//
// What bounds it: bytes. Per element it reads p and g and writes out (12
// bytes in f32, 6 in bf16) for two flops: 1/6 flop per byte against the ~20
// where the H100's f32 arithmetic would bind. At the main path's tree (the
// VGG-64 tree of configs/default.yaml, 18 leaves, 113,236 elements per
// task, 8 tasks: 905,888 elements) that is 10.87 MB, 3.245 us at 3.35 TB/s
// in f32 and 1.62 us in bf16. At that size a launch is one short wave, and
// what costs time is latency: the launch itself (an empty kernel, timed as
// chip_smoke.py times this one, takes ~4.7 us on the H100), DRAM latency,
// and the chain of dependent reads a block makes before its first data
// load. So every byte is requested at the start by fat blocks (four
// 16-byte loads per operand in flight per thread), a block finds its leaf
// with two dependent reads of the table, and the stores leave as 16-byte
// vectors (csrc/tree_chunks.cuh). PERF.md has the times, beside the
// previous design's (which read one packed buffer and so found its data
// with one read). At the ResNet-12 tree (86 leaves x 8 tasks, 34,872,480
// elements: 418.5 MB in f32, 0.1249 ms at 3.35 TB/s) the launch is bound by
// bytes: each of the 264 blocks walks ~33 chunks of 16 KB per operand. It
// takes the 256-leaf table (csrc/tree_chunks.cuh), in the launch parameter
// space past 4 KB that CUDA 12.1 and later give sm_70 and newer.
//
// Interface: plain C, bound with ctypes. The function takes kRecordWords
// uint64 words per leaf and the stream as void*, builds the leaf table (and
// with it the split into chunks), and returns the cudaError_t of the
// launch.

#include "tree_chunks.cuh"

namespace {

struct SgdForward {
  static constexpr bool kReduce = false;
  static __device__ __forceinline__ float out(float lr, float p, float g) {
    return __fsub_rn(p, __fmul_rn(lr, g));
  }
};

template <typename T, int N>
__global__ void __launch_bounds__(tree::kThreads) fused_sgd_kernel(const __grid_constant__ tree::Table<N> tab) {
  tree::walk<SgdForward, T>(tab, nullptr);
}

template <int N>
int forward(const uint64_t* records, int n_leaves, int dtype_code, cudaStream_t s) {
  tree::Table<N> tab{};
  const int grid = tree::fill_table(records, n_leaves, dtype_code == 0 ? 4 : 2, &tab);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) {
    fused_sgd_kernel<float, N><<<grid, tree::kThreads, 0, s>>>(tab);
  } else {
    fused_sgd_kernel<__nv_bfloat16, N><<<grid, tree::kThreads, 0, s>>>(tab);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// records: n_leaves x {p, g, out, lr, numel}; p, g, out contiguous, in
// dtype_code's type (0 = float32, 1 = bfloat16); lr a float32 scalar on the
// card. At most tree::kLargeLeaves leaves.
extern "C" int fused_sgd_forward(const uint64_t* records, int n_leaves, int dtype_code, void* stream) {
  if (dtype_code != 0 && dtype_code != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tree::small_table(n_leaves) ? forward<tree::kSmallLeaves>(records, n_leaves, dtype_code, s)
                                     : forward<tree::kLargeLeaves>(records, n_leaves, dtype_code, s);
}
