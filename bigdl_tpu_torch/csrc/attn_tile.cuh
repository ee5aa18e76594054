// Shared core of the CUDA-core attention kernel paged_attention.cu
// (paged_attention_sm90.cu uses parts of it): one 256-thread
// block owns R = 256 / TPR query rows, TPR lanes per row, and streams
// 64-key K/V tiles through shared memory with a float32 online softmax (m,
// l, acc) kept in registers.
//
// Lane `sub` of a row computes the logits of keys sub, sub + TPR, ... and owns
// the output columns sub, sub + TPR, ... (interleaved so that neighbouring
// lanes touch neighbouring shared-memory banks). Row statistics are reduced
// with warp shuffles across the TPR lanes of the row, which lie in one warp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace bigdl {

constexpr int kThreads = 256;
constexpr int kBK = 64;  // keys per shared-memory tile

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

// Shared-memory layout, all float32: Q rows and K rows padded to D + 1 so
// lanes reading different rows at the same column hit different banks.
template <int D, int R>
struct TileSmem {
  static constexpr int kQStride = D + 1;
  static constexpr int kKStride = D + 1;
  static constexpr int kPStride = kBK + 1;
  static constexpr size_t kFloats =
      size_t(R) * kQStride + size_t(kBK) * kKStride + size_t(kBK) * D + size_t(R) * kPStride;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <int D, int TPR>
struct RowState {
  float m;
  float l;
  float acc[D / TPR];

  __device__ __forceinline__ void init() {
    m = -INFINITY;
    l = 0.f;
#pragma unroll
    for (int j = 0; j < D / TPR; ++j) acc[j] = 0.f;
  }
};

template <int TPR>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One key tile for one query row. Key c of the tile is visible to the row
// iff c <= lim (lim < 0: the whole tile is masked). Every thread of the
// block must call this (the shuffles span the full warp).
template <int D, int TPR>
__device__ __forceinline__ void tile_update(const float* __restrict__ q_row,
                                            const float* __restrict__ ks,
                                            const float* __restrict__ vs,
                                            float* __restrict__ p_row, int sub, int lim,
                                            float scale, RowState<D, TPR>& st) {
  constexpr int NC = kBK / TPR;
  constexpr int KS = D + 1;
  float s[NC];
  float tmax = -INFINITY;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = sub + i * TPR;
    float dot = 0.f;
    if (c <= lim) {
      const float* kr = ks + c * KS;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(q_row[d], kr[d], dot);
      s[i] = dot * scale;
    } else {
      s[i] = -INFINITY;
    }
    tmax = fmaxf(tmax, s[i]);
  }
  tmax = row_max<TPR>(tmax);
  const float m_new = fmaxf(st.m, tmax);
  float alpha = 1.f;
  float psum = 0.f;
  if (m_new != -INFINITY) {  // at least one visible key so far
    alpha = expf(st.m - m_new);  // st.m == -inf gives 0
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      s[i] = expf(s[i] - m_new);  // masked keys give exactly 0
      psum += s[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < NC; ++i) s[i] = 0.f;
  }
  psum = row_sum<TPR>(psum);
  st.l = st.l * alpha + psum;
  st.m = m_new;
#pragma unroll
  for (int i = 0; i < NC; ++i) p_row[sub + i * TPR] = s[i];
  __syncwarp();
#pragma unroll
  for (int j = 0; j < D / TPR; ++j) st.acc[j] *= alpha;
  const int cend = lim + 1 < kBK ? lim + 1 : kBK;
  for (int c = 0; c < cend; ++c) {
    const float p = p_row[c];
    const float* vr = vs + c * D;
#pragma unroll
    for (int j = 0; j < D / TPR; ++j) st.acc[j] = fmaf(p, vr[sub + j * TPR], st.acc[j]);
  }
  __syncwarp();
}

// Copy `nrows` rows of D elements (row stride D in global memory) into a
// float tile of stride `stride`, zero-filling rows nrows..R-1.
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, int stride,
                                          const T* __restrict__ src, int nrows) {
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    dst[r * stride + d] = r < nrows ? to_f<T>(src[size_t(r) * D + d]) : 0.f;
  }
}

template <typename T, int D, int TPR>
__device__ __forceinline__ void store_row(T* __restrict__ out_row, int sub,
                                          const RowState<D, TPR>& st) {
  const float inv = st.l > 0.f ? 1.f / st.l : 0.f;  // fully masked rows give 0
#pragma unroll
  for (int j = 0; j < D / TPR; ++j) out_row[sub + j * TPR] = from_f<T>(st.acc[j] * inv);
}

}  // namespace bigdl
