// Int8 GEMM for Hopper: C[g] (M x N, int32) = A[g] (M x K, int8) . B[g] (N x K, int8)^T,
// batched over a group index g (grouped and depthwise convolutions run as G groups).
//
// Replaces no Pallas kernel. The JAX package computes its int8 x int8 -> int32 contractions in
// XLA (bigdl_tpu/quantization/quantize.py:89 `lax.dot_general(..., preferred_element_type=
// int32)`, and `lax.conv_general_dilated` over int8 at :136 and :190), and no PyTorch op
// computes them on a CUDA device: torch.matmul and F.conv2d refuse int8 and int32 tensors, and
// torch._int_mm (cuBLASLt) takes only M > 16 with K and N multiples of 8 (Inception's first
// convolution has K = 147, a depthwise 3x3 K = 9). It is the contraction of the port's
// QuantizedLinear, QuantizedSpatialConvolution and QuantizedSpatialSeparableConvolution
// (bigdl_tpu_torch/kernels/int8_matmul.py, which forms A from an int8 im2col for the
// convolutions).
//
// What bounds it on an H100: 2 * M * N * K operations at 1,979 dense int8 TOP/s against the
// bytes of A and B read once and of C (int32, four bytes an element) written once at 3.35 TB/s.
// The convolutions of a quantized image model are bound by the bytes: their int32 output alone
// is four times the int8 input (Inception's first convolution at B32/224: 7.6 GOP, 162 MB).
//
// Design (a first, plain kernel; wgmma over TMA tiles is later work): tensor cores through
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, a 128 x 128 (or, for N <= 16, 256 x 16)
// output tile a block of 8 warps, 32-deep int8 slices of A and B staged through two shared
// buffers with the next slice's global loads issued before the current slice's products. Rows
// are 48 bytes apart in shared memory, so each fragment load of a warp touches 32 distinct
// banks. Ragged M, N and K are zero-filled by the loaders (rows past M or N and columns past K
// read as 0); operands whose rows start on 16-byte boundaries load 16 bytes a thread, the
// others (K = 147, K = 9) a byte a thread, a warp reading 32 consecutive bytes of a row.
// Sums are exact in int32 while K * 128 * 128 < 2^31 (the wrapper checks K).
//
// Grid: (ceil(M / BM), ceil(N / BN), G); 256 threads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace bigdl {
namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;   // int8 depth of one m16n8k32 product
constexpr int kLds = 48;  // bytes between rows of a shared tile (32 + 16: no bank conflicts)

union Chunk {
  uint4 v;
  int8_t c[16];
};

// One thread's share of a ROWS x 32 slice of a row-major int8 operand, held in registers
// between the global load and the shared store.
template <int ROWS, bool VEC>
struct Slice;

// 16 bytes a thread: chunk c of the slice is row c / 2, bytes (c % 2) * 16 .. + 15.
template <int ROWS>
struct Slice<ROWS, true> {
  static constexpr int kChunks = ROWS * 2;
  static constexpr int kIters = (kChunks + kThreads - 1) / kThreads;
  uint4 v[kIters];

  __device__ __forceinline__ void load(const int8_t* __restrict__ src, long long ld, int rows,
                                       int K, int k0, int tid) {
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int c = tid + i * kThreads;
      Chunk ch;
      ch.v = make_uint4(0u, 0u, 0u, 0u);
      const int r = c >> 1;
      const int kk = k0 + (c & 1) * 16;
      if (c < kChunks && r < rows && kk < K) {
        const int8_t* p = src + r * ld + kk;
        if (kk + 16 <= K) {
          ch.v = __ldg(reinterpret_cast<const uint4*>(p));
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) ch.c[j] = kk + j < K ? p[j] : int8_t(0);
        }
      }
      v[i] = ch.v;
    }
  }

  __device__ __forceinline__ void store(int8_t* dst, int tid) const {
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int c = tid + i * kThreads;
      if (c < kChunks) *reinterpret_cast<uint4*>(dst + (c >> 1) * kLds + (c & 1) * 16) = v[i];
    }
  }
};

// A byte a thread: element e of the slice is row e / 32, byte e % 32.
template <int ROWS>
struct Slice<ROWS, false> {
  static constexpr int kIters = ROWS * kBK / kThreads;
  static_assert(ROWS * kBK % kThreads == 0, "slice rows must be a multiple of 8");
  int8_t b[kIters];

  __device__ __forceinline__ void load(const int8_t* __restrict__ src, long long ld, int rows,
                                       int K, int k0, int tid) {
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int e = tid + i * kThreads;
      const int r = e >> 5;
      const int kk = k0 + (e & 31);
      b[i] = (r < rows && kk < K) ? src[r * ld + kk] : int8_t(0);
    }
  }

  __device__ __forceinline__ void store(int8_t* dst, int tid) const {
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int e = tid + i * kThreads;
      dst[(e >> 5) * kLds + (e & 31)] = b[i];
    }
  }
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BM, int BN, int WARPS_M, int WARPS_N, bool VEC>
__global__ void __launch_bounds__(kThreads)
    int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                     int32_t* __restrict__ C, int M, int N, int K, long long lda, long long ldb,
                     long long ldc, long long sa, long long sb, long long sc) {
  static_assert(WARPS_M * WARPS_N * 32 == kThreads, "8 warps a block");
  constexpr int WM = BM / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int MT = WM / 16;
  constexpr int NT = WN / 8;
  __shared__ __align__(16) int8_t As[2][BM * kLds];
  __shared__ __align__(16) int8_t Bs[2][BN * kLds];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long g = blockIdx.z;
  const int8_t* a = A + g * sa + m0 * lda;
  const int8_t* b = B + g * sb + n0 * ldb;
  const int rows_a = M - m0;
  const int rows_b = N - n0;

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0;

  Slice<BM, VEC> sa_;
  Slice<BN, VEC> sb_;
  const int nk = (K + kBK - 1) / kBK;
  sa_.load(a, lda, rows_a, K, 0, tid);
  sb_.load(b, ldb, rows_b, K, 0, tid);
  sa_.store(As[0], tid);
  sb_.store(Bs[0], tid);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      sa_.load(a, lda, rows_a, K, (kt + 1) * kBK, tid);
      sb_.load(b, ldb, rows_b, K, (kt + 1) * kBK, tid);
    }
    uint32_t af[MT][4];
    uint32_t bf[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int8_t* p = As[cur] + (wm * WM + mt * 16 + gid) * kLds + tig * 4;
      af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
      af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLds);
      af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLds + 16);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int8_t* q = Bs[cur] + (wn * WN + nt * 8 + gid) * kLds + tig * 4;
      bf[nt][0] = *reinterpret_cast<const uint32_t*>(q);
      bf[nt][1] = *reinterpret_cast<const uint32_t*>(q + 16);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    if (more) {
      sa_.store(As[cur ^ 1], tid);
      sb_.store(Bs[cur ^ 1], tid);
    }
    __syncthreads();
  }

  int32_t* c = C + g * sc;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + wn * WN + nt * 8 + tig * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * WM + mt * 16 + gid + half * 8;
        if (row >= M) continue;
        int32_t* out = c + row * ldc + col;
        if (col < N) out[0] = acc[mt][nt][half * 2];
        if (col + 1 < N) out[1] = acc[mt][nt][half * 2 + 1];
      }
    }
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N>
int launch(const int8_t* A, const int8_t* B, int32_t* C, int G, int M, int N, int K,
           long long lda, long long ldb, long long ldc, long long sa, long long sb,
           long long sc, bool vec, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, G);
  if (vec)
    int8_gemm_kernel<BM, BN, WARPS_M, WARPS_N, true>
        <<<grid, kThreads, 0, stream>>>(A, B, C, M, N, K, lda, ldb, ldc, sa, sb, sc);
  else
    int8_gemm_kernel<BM, BN, WARPS_M, WARPS_N, false>
        <<<grid, kThreads, 0, stream>>>(A, B, C, M, N, K, lda, ldb, ldc, sa, sb, sc);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace
}  // namespace bigdl

// A (G, M, K) and B (G, N, K) int8 with row strides lda / ldb and group strides sa / sb (in
// elements); C (G, M, N) int32 with row stride ldc and group stride sc. Returns the launch's
// cudaError_t.
extern "C" int bigdl_int8_gemm(const void* A, const void* B, void* C, int G, int M, int N, int K,
                               long long lda, long long ldb, long long ldc, long long sa,
                               long long sb, long long sc, void* stream) {
  if (G <= 0 || M <= 0 || N <= 0) return cudaSuccess;
  const int8_t* a = static_cast<const int8_t*>(A);
  const int8_t* b = static_cast<const int8_t*>(B);
  int32_t* c = static_cast<int32_t*>(C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = bigdl::aligned16(a) && bigdl::aligned16(b) && lda % 16 == 0 &&
                   ldb % 16 == 0 && (G == 1 || (sa % 16 == 0 && sb % 16 == 0));
  if (N <= 16)
    return bigdl::launch<256, 16, 8, 1>(a, b, c, G, M, N, K, lda, ldb, ldc, sa, sb, sc, vec, s);
  return bigdl::launch<128, 128, 2, 4>(a, b, c, G, M, N, K, lda, ldb, ldc, sa, sb, sc, vec, s);
}
