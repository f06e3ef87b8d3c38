// Backward of the fused LSLR inner-SGD update for Hopper (sm_90a).
//
// Forward (csrc/fused_sgd.cu): out = p - lr_row * g. Its vector-Jacobian
// product for a cotangent ct of out:
//   dp      = ct                      (returned by the caller as it is)
//   dg      = -lr_row * ct            (operand dtype)
//   dlr_row = -sum over the row's 128 lanes of ct * g   (float32)
// This file computes dg and dlr_row in one launch.
//
// Replaces: howtotrainyourmamlpytorch_tpu/ops/pallas_update.py::_bwd_kernel
// (launched by _fused_sgd_bwd, the jax.custom_vjp backward, through
// pl.pallas_call). Same packed layout as the forward: the whole parameter
// tree, for every task of the meta-batch, in one [rows, 128] buffer, one f32
// lr per 128-lane row. The caller segment-sums dlr_row back to the
// per-tensor lrs (autograd's transpose of the lr gather).
//
// Numerics:
//   - dg: one f32 product __fmul_rn(-lr, ct) (negation is exact), then one
//     round-to-nearest-even to bf16 for bf16 operands. That equals the plain
//     twin (ops/fused_update.py::fused_sgd_bwd_reference:
//     (-lr_rows[:, None] * ct.float()).to(dtype)) bit for bit.
//   - dlr_row: a 128-term f32 sum, accumulated in registers (fmaf per lane,
//     then a butterfly of shuffles). Its order differs from the twin's, so
//     the two agree within the summation bound 2 * 128 * 2^-24 * sum|ct*g|
//     per row, not bit for bit.
//
// What bounds it: memory. Per element it reads ct and g and writes dg (12
// bytes in f32, 6 in bf16) for three flops (one product for dg, one
// multiply-add for dlr), plus 8 bytes per row (lr in, dlr out). That is 1/4
// flop per byte or less, far below the ~20 flops per byte (67 TFLOP/s f32
// over 3.35 TB/s) where the H100's arithmetic would bind. The design moves
// those bytes in 16-byte coalesced accesses and reduces in registers:
//   - f32: a 128-lane row is 512 bytes, exactly one warp of float4 loads,
//     so one warp owns one row; the lane sum is 5 __shfl_xor_sync steps, no
//     shared memory and no atomics. bf16: a row is 256 bytes, half a warp of
//     16-byte loads, so a warp owns two rows and reduces within each half
//     (4 steps).
//   - a grid-stride loop over rows (warp-uniform trip count, so every
//     shuffle has all 32 lanes), grid sized to a few blocks per SM; one
//     launch covers any task count. No TPU tiling, no row padding.
//
// Interface: plain C, bound with ctypes. Pointers and the stream are passed
// as void*; the function returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
fused_sgd_bwd_f32_kernel(const float4* __restrict__ ct, const float4* __restrict__ g,
                         const float* __restrict__ lr_rows, float4* __restrict__ dg,
                         float* __restrict__ dlr_rows, int64_t n_rows) {
  constexpr int kVecPerRow = kLane / 4;  // 32: one warp per row
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       row < n_rows; row += n_warps) {
    const float neg_lr = -__ldg(lr_rows + row);
    const int64_t i = row * kVecPerRow + lane;
    const float4 c = ct[i];
    const float4 gv = g[i];
    float4 d;
    d.x = __fmul_rn(neg_lr, c.x);
    d.y = __fmul_rn(neg_lr, c.y);
    d.z = __fmul_rn(neg_lr, c.z);
    d.w = __fmul_rn(neg_lr, c.w);
    dg[i] = d;
    float acc = fmaf(c.x, gv.x, fmaf(c.y, gv.y, fmaf(c.z, gv.z, c.w * gv.w)));
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      acc += __shfl_xor_sync(kFull, acc, offset);
    }
    if (lane == 0) dlr_rows[row] = -acc;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_sgd_bwd_bf16_kernel(const uint4* __restrict__ ct, const uint4* __restrict__ g,
                          const float* __restrict__ lr_rows, uint4* __restrict__ dg,
                          float* __restrict__ dlr_rows, int64_t n_rows) {
  constexpr int kVecPerRow = kLane / 8;  // 16: half a warp per row
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int vec = lane & 15;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
  // each warp takes a pair of rows; the trip count is the same for all 32
  // lanes, so the shuffles below always run with the full mask
  for (int64_t pair = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       2 * pair < n_rows; pair += n_warps) {
    const int64_t row = 2 * pair + half;
    const bool valid = row < n_rows;
    float acc = 0.0f;
    if (valid) {
      const float neg_lr = -__ldg(lr_rows + row);
      const int64_t i = row * kVecPerRow + vec;
      const uint4 cv = ct[i];
      const uint4 gv = g[i];
      const __nv_bfloat162* cp = reinterpret_cast<const __nv_bfloat162*>(&cv);
      const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
      uint4 dv;
      __nv_bfloat162* dp = reinterpret_cast<__nv_bfloat162*>(&dv);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 cf = __bfloat1622float2(cp[k]);
        const float2 gf = __bfloat1622float2(gp[k]);
        dp[k] = __floats2bfloat162_rn(__fmul_rn(neg_lr, cf.x), __fmul_rn(neg_lr, cf.y));
        acc = fmaf(cf.x, gf.x, acc);
        acc = fmaf(cf.y, gf.y, acc);
      }
      dg[i] = dv;
    }
#pragma unroll
    for (int offset = 8; offset > 0; offset >>= 1) {
      acc += __shfl_xor_sync(kFull, acc, offset);  // stays within each half
    }
    if (valid && vec == 0) dlr_rows[row] = -acc;
  }
}

int grid_for(int64_t n_warp_tasks) {
  int device = 0;
  int sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const int64_t needed = (n_warp_tasks + kWarps - 1) / kWarps;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  return static_cast<int>(needed < cap ? (needed > 0 ? needed : 1) : cap);
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. ct, g, dg: [n_rows, 128]
// contiguous, 16-byte aligned, in that dtype; lr_rows, dlr_rows: [n_rows]
// float32. Returns a cudaError_t.
extern "C" int fused_sgd_backward(const void* ct, const void* g, const void* lr_rows,
                                  void* dg, void* dlr_rows, int64_t n_rows,
                                  int dtype_code, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) {
    fused_sgd_bwd_f32_kernel<<<grid_for(n_rows), kThreads, 0, s>>>(
        static_cast<const float4*>(ct), static_cast<const float4*>(g),
        static_cast<const float*>(lr_rows), static_cast<float4*>(dg),
        static_cast<float*>(dlr_rows), n_rows);
  } else if (dtype_code == 1) {
    fused_sgd_bwd_bf16_kernel<<<grid_for((n_rows + 1) / 2), kThreads, 0, s>>>(
        static_cast<const uint4*>(ct), static_cast<const uint4*>(g),
        static_cast<const float*>(lr_rows), static_cast<uint4*>(dg),
        static_cast<float*>(dlr_rows), n_rows);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
