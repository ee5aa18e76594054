// Shared core of the fused ResNet kernels on the CUDA cores: a tiled
// float32-FMA product. It serves fused_conv.cu (K4) for float32 calls
// outside the 3xTF32 rule and bf16 shapes outside the tensor-core rule. The
// tensor-core routes are fused_gemm_sm90.cuh (bf16: K3, K4, K5; K3 / K5 also
// at any K and N through its ragged policy) and fused_gemm_tf32_sm90.cuh
// (float32 in 3xTF32: K3, K4, K5; K3 / K5 likewise), which reuse this
// header's operand rounding helpers and second pass.
//
//   C[r][c] = sum_k A(r, k) * B(c, k)      r < rows, c < cols, k in a range
//
// whose operands are not arrays but element functors `f(i, k)`, so that a
// kernel folds its elementwise prologue (the previous BatchNorm's affine
// and ReLU, the 3x3 conv's tap gather) into the load of its operand tiles,
// and whose epilogue functor `epi(r, c, v, s1, s2)` sees each finished
// float32 sum once (writes the output, and hands back up to two values
// whose per-column sums over the block's rows the core writes as partials:
// BatchNorm statistics).
//
// One 256-thread block owns a 128 x BN tile of C (BN = 64 or 128); thread
// (ty, tx) = (tid / 16, tid % 16) keeps rows ty + 16 i and columns
// tx + 16 j of it in registers (8 x BN/16 float32 sums). Each 16-deep slice
// of the contraction is loaded once into shared memory as float32 (rows
// padded by one float, so the transposed stores of either operand and the
// broadcast reads of the product hit distinct banks) and feeds 16 x 8 x
// BN/16 FMAs per thread. Elements outside [0, rows) x [0, cols) or past the
// contraction range load as 0, which masks ragged edges without padding
// copies. blockIdx.z selects a contiguous slice of the contraction (K4
// runs one). Every cross-block sum goes through a second pass
// (sum_rows_kernel) in a fixed order: there are no atomics, so reruns agree
// bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bigdl_fg {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // rows of C per block (the Python wrappers size partials by it)
constexpr int kBK = 16;   // contraction depth of one shared-memory stage

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

// ---------------------------------------------------------------------------
// Operand functors
// ---------------------------------------------------------------------------

// The implicit im2col of a 3x3 conv (pad 1, stride 1 or 2) over an NHWC
// input with the BatchNorm prologue: row m is output pixel (b, oh, ow),
// column kk = tap * C + c with tap = 3 dy + dx (the HWIO weight's row
// order). A tap in the zero padding gives 0, after the prologue.
template <typename T>
struct Im2col {
  const T* x;
  const float* a;
  const float* b;
  int H, W, C, H2, W2, stride;
  __device__ __forceinline__ float operator()(int m, int kk) const {
    const int tap = kk / C;
    const int c = kk - tap * C;
    const int dy = tap / 3;
    const int dx = tap - 3 * dy;
    const int hw = H2 * W2;
    const int bi = m / hw;
    const int rem = m - bi * hw;
    const int oh = rem / W2;
    const int ow = rem - oh * W2;
    const int ih = oh * stride + dy - 1;
    const int iw = ow * stride + dx - 1;
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) return 0.f;
    const float v = to_f<T>(x[(((size_t)bi * H + ih) * W + iw) * C + c]);
    return relu_f(round_to<T>(affine(v, a[c], b[c])));
  }
};

// B(c, k) = w[k * ld + c]: a row-major (K, N) weight as N rows of K
template <typename T>
struct ColsOf {
  const T* w;
  int ld;
  __device__ __forceinline__ float operator()(int c, int k) const {
    return to_f<T>(w[(size_t)k * ld + c]);
  }
};

// ---------------------------------------------------------------------------
// Epilogue functors: (r, c, v) -> writes; s1, s2 are the values to sum over r
// ---------------------------------------------------------------------------

// z in T; with stats, s1 = z and s2 = z^2 from the float32 sum
template <typename T>
struct StoreZ {
  T* z;
  int ld;
  int stats;
  __device__ __forceinline__ void operator()(int r, int c, float v, float& s1, float& s2) const {
    z[(size_t)r * ld + c] = from_f<T>(v);
    if (stats) {
      s1 = v;
      s2 = __fmul_rn(v, v);
    }
  }
};

// ---------------------------------------------------------------------------
// The product
// ---------------------------------------------------------------------------

template <int BN>
struct Tiles {
  float a[kBK][kBM + 1];
  float b[kBK][BN + 1];
};

// the column-sum scratch of the epilogue reuses the operand tiles
template <int BN>
union Smem {
  Tiles<BN> t;
  float red[2][16][BN];
};

// dst[k][i] = f(i0 + i, k0 + k) for i < ROWS, k < kBK, and 0 where
// i0 + i >= ilim or k0 + k >= klim. KCONTIG: the operand is contiguous
// along the contraction, so consecutive threads walk k; otherwise along i.
template <int ROWS, bool KCONTIG, class F>
__device__ __forceinline__ void load_tile(float (*dst)[ROWS + 1], const F& f, int i0, int k0,
                                          int ilim, int klim) {
  constexpr int kPer = ROWS * kBK / kThreads;
#pragma unroll
  for (int l = 0; l < kPer; ++l) {
    const int e = threadIdx.x + l * kThreads;
    const int i = KCONTIG ? e / kBK : e % ROWS;
    const int k = KCONTIG ? e % kBK : e / ROWS;
    const int gi = i0 + i;
    const int gk = k0 + k;
    dst[k][i] = (gi < ilim && gk < klim) ? f(gi, gk) : 0.f;
  }
}

// Grid (ceil(rows / 128), ceil(cols / BN), splits); split z covers the
// contraction [z * kchunk, min(kdim, (z + 1) * kchunk)). With SUMS and
// part1 != nullptr, the block writes the sums over its rows of the
// epilogue's s1 / s2 to part1 / part2[blockIdx.x * cols + c].
template <int BN, bool KA, bool KB, bool SUMS, class FA, class FB, class Epi>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(FA fa, FB fb, Epi epi, int rows, int cols, int kdim, int kchunk, float* part1,
                float* part2) {
  constexpr int TM = kBM / 16;
  constexpr int TN = BN / 16;
  __shared__ Smem<BN> sm;
  Tiles<BN>& t = sm.t;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(kdim, kbeg + kchunk);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    load_tile<kBM, KA>(t.a, fa, row0, k0, rows, kend);
    load_tile<BN, KB>(t.b, fb, col0, k0, cols, kend);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = t.a[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = t.b[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float c1[TN], c2[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) c1[j] = c2[j] = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= cols) continue;
      float s1 = 0.f, s2 = 0.f;
      epi(r, c, acc[i][j], s1, s2);
      c1[j] += s1;
      c2[j] += s2;
    }
  }
  if (SUMS && part1 != nullptr) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      sm.red[0][ty][tx + 16 * j] = c1[j];
      sm.red[1][ty][tx + 16 * j] = c2[j];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < BN; c += kThreads) {
      if (col0 + c >= cols) continue;
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int y = 0; y < 16; ++y) {
        s += sm.red[0][y][c];
        q += sm.red[1][y][c];
      }
      part1[(size_t)blockIdx.x * cols + col0 + c] = s;
      part2[(size_t)blockIdx.x * cols + col0 + c] = q;
    }
  }
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

// BN = 64 for outputs of at most 64 columns, else 128
template <bool KA, bool KB, bool SUMS, class FA, class FB, class Epi>
__host__ cudaError_t gemm(FA fa, FB fb, Epi epi, int rows, int cols, int kdim, int kchunk,
                          int splits, float* part1, float* part2, cudaStream_t s) {
  dim3 grid((rows + kBM - 1) / kBM, 1, splits);
  if (cols <= 64) {
    grid.y = (cols + 63) / 64;
    gemm_kernel<64, KA, KB, SUMS><<<grid, kThreads, 0, s>>>(fa, fb, epi, rows, cols, kdim,
                                                             kchunk, part1, part2);
  } else {
    grid.y = (cols + 127) / 128;
    gemm_kernel<128, KA, KB, SUMS><<<grid, kThreads, 0, s>>>(fa, fb, epi, rows, cols, kdim,
                                                              kchunk, part1, part2);
  }
  return cudaGetLastError();
}

}  // namespace bigdl_fg
