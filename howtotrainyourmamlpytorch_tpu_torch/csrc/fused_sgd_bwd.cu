// B2: the backward of the fused LSLR inner-SGD update for Hopper (sm_90a),
// one launch over the whole parameter tree.
//
// Forward (csrc/fused_sgd.cu): out_i = p_i - lr_i * g_i. Its vector-Jacobian
// product for cotangents ct_i of out_i:
//   dp_i  = ct_i                          (returned by the caller as it is)
//   dg_i  = -lr_i * ct_i                  (operand dtype)
//   dlr_i = -sum over leaf i of ct_i * g_i, all its elements and tasks (f32)
// This file computes dg and dlr in one launch.
//
// Replaces: howtotrainyourmamlpytorch_tpu/ops/pallas_update.py:134
// (_bwd_kernel, launched by _fused_sgd_bwd, the jax.custom_vjp backward,
// through pl.pallas_call at :177). The TPU kernel sums each 128-lane row of
// the packed tree, and XLA segment-sums the rows back to the per-tensor
// lrs. Here the kernel takes the leaves where they lie (csrc/tree_chunks.cuh)
// and sums each leaf's lr gradient itself.
//
// Numerics:
//   - dg: one f32 product __fmul_rn(-lr, ct) (negation is exact), then one
//     round-to-nearest-even to bf16 for bf16 operands: the plain twin
//     (ops/fused_update.py::fused_sgd_tree_bwd_reference) bit for bit.
//   - dlr: a fixed tree, so the same inputs give the same bits on every
//     run, with no float atomics. Each thread's part of a chunk is a chain of
//     at most 4 V + 1 fmaf (four vectors of V = 4 elements in f32, 8 in bf16,
//     and a rest element), then 5 shuffle levels in its warp and 3 over the
//     block's 8 warps give the chunk's partial, which the block writes to
//     scratch. The block that finishes last (an acquire-release atomic
//     ticket, which wraps to 0 by itself for the next launch) adds each
//     leaf's partials: lane j of a warp takes chunks j, j + 32, ... in
//     order, then 5 shuffle levels. The longest chain of roundings a product
//     passes is so (4 V + 1) + 5 + 3 + ceil(chunks / 32) + 5
//     (ops/fused_update.py::dlr_rounding_chain); against an exact sum the
//     error is at most (that + 1) * 2^-24 * sum |ct * g|, the bound
//     chip_smoke.py and the card tests hold it to. The ticket is one per
//     device: launches of this kernel on one device must not overlap (the
//     port launches them on the current stream).
//
// What bounds it: bytes. Per element it reads ct and g and writes dg (12
// bytes in f32, 6 in bf16) for three flops, plus 8 bytes per leaf (lr in,
// dlr out) and 4 bytes per 16 KB chunk of scratch. At the main path's tree
// (905,888 elements at 8 tasks, 18 leaves) that is 10.87 MB, 3.245 us at
// 3.35 TB/s in f32 and 1.62 us in bf16. The design is B1's walk, with the
// block sums, the ticket and the last block's leaf sums added; those cost
// ~2.5 us on the H100 over B1 (PERF.md), mostly the serial tail: the last
// block can only start once every other block's partials are visible, and
// then reads them. (Taking the ticket before the block's last stores, so
// that its release waits on the partial alone, ran no faster.) At the
// ResNet-12 tree (86 leaves x 8 tasks, 34.9 M elements, 0.1249 ms of bytes
// in f32) the walk is bound by bytes and the tail is a small part; the
// last block sums 64 leaves per pass (tree::leaf_sums), so 86 leaves take
// two passes.
//
// Interface: plain C, bound with ctypes, as B1's, with the scratch of one
// float per chunk (partial) and the dlr output ([n_leaves] float32) added,
// and fused_sgd_chunks, which tells the wrapper how many chunks a launch
// over its leaves makes.

#include "tree_chunks.cuh"

namespace {

struct SgdBackward {
  static constexpr bool kReduce = true;
  static __device__ __forceinline__ float out(float lr, float ct, float /*g*/) { return __fmul_rn(-lr, ct); }
};

__device__ unsigned g_ticket = 0;

template <typename T, int N>
__global__ void __launch_bounds__(tree::kThreads)
    fused_sgd_bwd_kernel(const __grid_constant__ tree::Table<N> tab, float* __restrict__ partial,
                         float* __restrict__ dlr) {
  tree::walk<SgdBackward, T>(tab, partial);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    // release: this block's partials are visible before its ticket; acquire:
    // the last block sees every block's; the ticket wraps to 0 by itself
    unsigned before;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;\n"
                 : "=r"(before)
                 : "l"(&g_ticket), "r"(gridDim.x - 1)
                 : "memory");
    last = before == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  tree::leaf_sums(tab, partial, dlr);
}

template <int N>
int backward(const uint64_t* records, int n_leaves, float* partial, int n_partial, float* dlr, int dtype_code,
             cudaStream_t s) {
  tree::Table<N> tab{};
  const int grid = tree::fill_table(records, n_leaves, dtype_code == 0 ? 4 : 2, &tab);
  if (grid == 0 || tab.n_chunks > n_partial) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) {
    fused_sgd_bwd_kernel<float, N><<<grid, tree::kThreads, 0, s>>>(tab, partial, dlr);
  } else {
    fused_sgd_bwd_kernel<__nv_bfloat16, N><<<grid, tree::kThreads, 0, s>>>(tab, partial, dlr);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int chunks(const uint64_t* records, int n_leaves, int dtype_code, int32_t* first_chunk) {
  tree::Table<N> tab{};
  if (tree::fill_table(records, n_leaves, dtype_code == 0 ? 4 : 2, &tab) == 0) return -1;
  if (first_chunk != nullptr) {
    for (int i = 0; i <= n_leaves; ++i) first_chunk[i] = tab.first_chunk[i];
  }
  return tab.n_chunks;
}

}  // namespace

// records: n_leaves x {ct, g, dg, lr, numel}; ct, g, dg contiguous, in
// dtype_code's type (0 = float32, 1 = bfloat16); lr a float32 scalar on the
// card; partial: [n_partial] float32 scratch, at least the chunk count
// (fused_sgd_chunks); dlr: [n_leaves] float32 out. At most tree::kLargeLeaves
// leaves.
extern "C" int fused_sgd_backward(const uint64_t* records, int n_leaves, void* partial, int n_partial,
                                  void* dlr, int dtype_code, void* stream) {
  if (dtype_code != 0 && dtype_code != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* out = static_cast<float*>(dlr);
  return tree::small_table(n_leaves)
             ? backward<tree::kSmallLeaves>(records, n_leaves, part, n_partial, out, dtype_code, s)
             : backward<tree::kLargeLeaves>(records, n_leaves, part, n_partial, out, dtype_code, s);
}

// The split a launch over these records makes: writes where each leaf's
// chunks start to first_chunk[0 .. n_leaves] (first_chunk[n_leaves] is the
// count; first_chunk may be null) and returns the chunk count, or -1 when
// the records are out of range. The wrapper sizes partial with it.
extern "C" int fused_sgd_chunks(const uint64_t* records, int n_leaves, int dtype_code, int32_t* first_chunk) {
  if (dtype_code != 0 && dtype_code != 1) return -1;
  return tree::small_table(n_leaves) ? chunks<tree::kSmallLeaves>(records, n_leaves, dtype_code, first_chunk)
                                     : chunks<tree::kLargeLeaves>(records, n_leaves, dtype_code, first_chunk);
}
