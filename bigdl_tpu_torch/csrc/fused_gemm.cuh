// Shared helpers of the fused ResNet kernels' cores for Hopper
// (fused_gemm_sm90.cuh: bf16; fused_gemm_tf32_sm90.cuh: float32 in 3xTF32):
// the operands' conversions and rounding in the plain versions' order, and
// the fixed-order second pass that adds the kernels' per-block partial sums
// (BatchNorm statistics, da / db, the weight gradient's splits) with no
// atomics, so that reruns agree bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bigdl_fg {

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// v rounded to T's precision, kept as float32 (the JAX kernels' astype(x.dtype))
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

// max(v, 0) that keeps NaN, as jnp.maximum does
__device__ __forceinline__ float relu_f(float v) { return v < 0.f ? 0.f : v; }

// x * a + b in float32 with each operation rounded (no FMA contraction), the
// order the JAX kernels and the plain PyTorch versions evaluate it in
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// out[c] = sum_{i < n} part[i * cols + c], in a fixed order: 32 columns per
// block, 32 row groups (rows g, g + 32, ...) summed in turn, then the 32
// group sums in order.
template <typename OutT>
__global__ void __launch_bounds__(1024)
    sum_rows_kernel(const float* __restrict__ part, int n, int cols, OutT* __restrict__ out) {
  __shared__ float s[32][33];
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + tx;
  float acc = 0.f;
  if (c < cols)
    for (int i = ty; i < n; i += 32) acc += part[(size_t)i * cols + c];
  s[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && c < cols) {
    float tot = 0.f;
#pragma unroll
    for (int y = 0; y < 32; ++y) tot += s[y][tx];
    out[c] = from_f<OutT>(tot);
  }
}

template <typename OutT>
__host__ cudaError_t sum_rows(const float* part, int n, int cols, OutT* out, cudaStream_t s) {
  sum_rows_kernel<OutT><<<(cols + 31) / 32, 1024, 0, s>>>(part, n, cols, out);
  return cudaGetLastError();
}

}  // namespace bigdl_fg
