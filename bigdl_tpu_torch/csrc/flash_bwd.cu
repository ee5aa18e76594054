// Flash attention backward (K1-bwd) for Hopper, float32 with head dims past
// 64 (bf16 inputs take the tensor-core kernels of flash_bwd_sm90.cu, float32
// ones with D up to 64 the 3xTF32 kernels of flash_bwd_tf32_sm90.cu).
//
// Replaces the Pallas kernels bigdl_tpu/kernels/flash_attention.py
// `_flash_bwd`: `_bwd_kv_kernel` (dK and dV over query tiles) and
// `_bwd_q_kernel` (dQ over key tiles). Given q, k, v, the forward's output o
// and log-sum-exp lse (B, H, Tq) in float32, the output gradient dO and
// delta = rowsum(dO * O) (B, H, Tq) in float32, both kernels recompute
//   p  = exp(q k^T * scale - lse), 0 where col >= Tkv, where causal and
//        col > row, where row >= Tq, and on rows whose lse is -inf;
//   dp = dO v^T;  ds = p * (dp - delta) * scale
// tile by tile and accumulate dV = p^T dO and dK = ds^T q (first kernel)
// and dQ = ds k (second kernel) in float32 registers, written once in
// float32. There are no atomics, so the gradients are deterministic.
//
// What bounds it on an H100: at the training shape (T = 1024, D = 64) the
// backward does 10 * D operations per (row, visible key) pair against
// 8 * 2 * D bytes per row it reads or writes, several hundred operations
// per byte, so it is bound by arithmetic. It does its five products per tile
// with float32 FMAs on the CUDA cores (67 TF/s peak, and shared-memory reads
// feed it at about half of that): float32 callers need float32 products,
// which the TF32 tensor cores would not give. What the
// design does: each 64-key (or 64-query) tile is staged once in shared
// memory as float32 and reused against every tile of the other side; each
// thread keeps a 4x4 register tile of the 64x64 score block and a 4x(D/16)
// tile of its gradient rows, so each shared-memory read feeds two to four
// FMAs; the loops stop at the causal diagonal (no tile above it is read);
// the ragged edges are masked in the kernel instead of padding copies.
//
// Grids: (ceil(Tkv / 64), H, B) for dK/dV and (ceil(Tq / 64), H, B) for dQ;
// 256 threads, thread (ty, tx) = (tid / 16, tid % 16) owning rows ty + 16 i
// and columns tx + 16 j of each tile.
#include "attn_tile.cuh"

namespace bigdl {

constexpr int kBT = kBK;        // 64 query rows or keys per tile
constexpr int kPS = kBT + 1;    // row stride of the 64x64 score tiles

// acc[i][j] = sum_d a[(ty + 16 i) * (D + 1) + d] * b[(tx + 16 j) * (D + 1) + d]
template <int D>
__device__ __forceinline__ void tile_abt(float (&acc)[4][4], const float* __restrict__ a,
                                         const float* __restrict__ b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r s[r * kPS + ty + 16 i] * x[r * (D + 1) + tx + 16 j]
// (a transposed score tile times a row tile: dV += p^T dO, dK += ds^T q)
template <int D>
__device__ __forceinline__ void tile_atb(float (&acc)[4][D / 16], const float* __restrict__ s,
                                         const float* __restrict__ x, int ty, int tx) {
#pragma unroll 4
  for (int r = 0; r < kBT; ++r) {
    float sv[4], xv[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) sv[i] = s[r * kPS + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) xv[j] = x[r * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c s[(ty + 16 i) * kPS + c] * x[c * (D + 1) + tx + 16 j]
// (a score tile times a row tile: dQ += ds k)
template <int D>
__device__ __forceinline__ void tile_ab(float (&acc)[4][D / 16], const float* __restrict__ s,
                                        const float* __restrict__ x, int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < kBT; ++c) {
    float sv[4], xv[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) sv[i] = s[(ty + 16 * i) * kPS + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) xv[j] = x[c * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
  }
}

// p and ds of one (64-query, 64-key) tile pair, in registers: rows
// q0 + ty + 16 i, keys k0 + tx + 16 j. All operand tiles are in shared memory.
template <int D>
__device__ __forceinline__ void probs_and_dscores(float (&p)[4][4], float (&ds)[4][4],
                                                  const float* qs, const float* dos,
                                                  const float* ks, const float* vs,
                                                  const float* lse_s, const float* delta_s,
                                                  int q0, int k0, int Tq, int Tkv, int causal,
                                                  float scale, int ty, int tx) {
  tile_abt<D>(p, qs, ks, ty, tx);    // s  = q k^T (unscaled)
  tile_abt<D>(ds, dos, vs, ty, tx);  // dp = dO v^T
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    const float lse = lse_s[r];
    const float delta = delta_s[r];
    const bool row_ok = row < Tq && lse != -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      const bool keep = row_ok && col < Tkv && (!causal || col <= row);
      const float pv = keep ? expf(p[i][j] * scale - lse) : 0.f;
      p[i][j] = pv;
      ds[i][j] = pv * (ds[i][j] - delta) * scale;
    }
  }
}

__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s, const float* lse,
                                               const float* delta, size_t row0, int nrows) {
  if (threadIdx.x < kBT) {
    const int r = threadIdx.x;
    lse_s[r] = r < nrows ? lse[row0 + r] : 0.f;
    delta_s[r] = r < nrows ? delta[row0 + r] : 0.f;
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_tile(T* __restrict__ out, const float (&acc)[4][D / 16],
                                           int nrows, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < nrows) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j) out[size_t(r) * D + tx + 16 * j] = from_f<T>(acc[i][j]);
    }
  }
}

template <int D>
struct BwdSmem {
  static constexpr int kRow = kBT * (D + 1);  // one 64-row operand tile
  static constexpr size_t kDkdvBytes = (4 * size_t(kRow) + 2 * kBT * kPS + 2 * kBT) * sizeof(float);
  static constexpr size_t kDqBytes = (4 * size_t(kRow) + kBT * kPS + 2 * kBT) * sizeof(float);
};

// One block per (64-key tile, head, batch row): dK and dV of those keys.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tkv, int causal,
                          float scale) {
  constexpr int S = D + 1;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BwdSmem<D>::kRow;
  float* qs = vs + BwdSmem<D>::kRow;
  float* dos = qs + BwdSmem<D>::kRow;
  float* ps = dos + BwdSmem<D>::kRow;
  float* dss = ps + kBT * kPS;
  float* lse_s = dss + kBT * kPS;
  float* delta_s = lse_s + kBT;

  const int k0 = blockIdx.x * kBT;
  const size_t bh = size_t(blockIdx.z) * gridDim.y + blockIdx.y;
  const int nk = min(kBT, Tkv - k0);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  load_rows<T, D, kBT>(ks, S, k + (bh * Tkv + k0) * D, nk);
  load_rows<T, D, kBT>(vs, S, v + (bh * Tkv + k0) * D, nk);

  float dk_acc[4][D / 16];
  float dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: query rows below k0 see none of these keys
  for (int q0 = causal ? k0 : 0; q0 < Tq; q0 += kBT) {
    const int nq = min(kBT, Tq - q0);
    __syncthreads();  // the previous query tile is fully consumed
    load_rows<T, D, kBT>(qs, S, q + (bh * Tq + q0) * D, nq);
    load_rows<T, D, kBT>(dos, S, dout + (bh * Tq + q0) * D, nq);
    load_row_stats(lse_s, delta_s, lse, delta, bh * Tq + q0, nq);
    __syncthreads();
    float p[4][4], ds[4][4];
    probs_and_dscores<D>(p, ds, qs, dos, ks, vs, lse_s, delta_s, q0, k0, Tq, Tkv, causal, scale,
                         ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ps[(ty + 16 * i) * kPS + tx + 16 * j] = p[i][j];
        dss[(ty + 16 * i) * kPS + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    tile_atb<D>(dv_acc, ps, dos, ty, tx);
    tile_atb<D>(dk_acc, dss, qs, ty, tx);
  }
  store_tile<T, D>(dk + (bh * Tkv + k0) * D, dk_acc, nk, ty, tx);
  store_tile<T, D>(dv + (bh * Tkv + k0) * D, dv_acc, nk, ty, tx);
}

// One block per (64-query tile, head, batch row): dQ of those rows.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int Tq, int Tkv, int causal, float scale) {
  constexpr int S = D + 1;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BwdSmem<D>::kRow;
  float* ks = dos + BwdSmem<D>::kRow;
  float* vs = ks + BwdSmem<D>::kRow;
  float* dss = vs + BwdSmem<D>::kRow;
  float* lse_s = dss + kBT * kPS;
  float* delta_s = lse_s + kBT;

  const int q0 = blockIdx.x * kBT;
  const size_t bh = size_t(blockIdx.z) * gridDim.y + blockIdx.y;
  const int nq = min(kBT, Tq - q0);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  load_rows<T, D, kBT>(qs, S, q + (bh * Tq + q0) * D, nq);
  load_rows<T, D, kBT>(dos, S, dout + (bh * Tq + q0) * D, nq);
  load_row_stats(lse_s, delta_s, lse, delta, bh * Tq + q0, nq);

  float dq_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dq_acc[i][j] = 0.f;

  // causal: keys past this tile's last row are seen by none of its rows
  const int kend = causal ? min(Tkv, q0 + nq) : Tkv;
  for (int k0 = 0; k0 < kend; k0 += kBT) {
    const int nk = min(kBT, Tkv - k0);
    __syncthreads();  // the previous key tile is fully consumed (and Q loaded)
    load_rows<T, D, kBT>(ks, S, k + (bh * Tkv + k0) * D, nk);
    load_rows<T, D, kBT>(vs, S, v + (bh * Tkv + k0) * D, nk);
    __syncthreads();
    float p[4][4], ds[4][4];
    probs_and_dscores<D>(p, ds, qs, dos, ks, vs, lse_s, delta_s, q0, k0, Tq, Tkv, causal, scale,
                         ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dss[(ty + 16 * i) * kPS + tx + 16 * j] = ds[i][j];
    __syncthreads();
    tile_ab<D>(dq_acc, dss, ks, ty, tx);
  }
  store_tile<T, D>(dq + (bh * Tq + q0) * D, dq_acc, nq, ty, tx);
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dq, void* dk, void* dv, int B,
                       int H, int Tq, int Tkv, int causal, float scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  auto kv_kern = flash_bwd_dkdv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(BwdSmem<D>::kDkdvBytes));
  if (err != cudaSuccess) return err;
  dim3 kv_grid((Tkv + kBT - 1) / kBT, H, B);
  kv_kern<<<kv_grid, kThreads, BwdSmem<D>::kDkdvBytes, stream>>>(
      qp, kp, vp, dop, lp, dp, static_cast<T*>(dk), static_cast<T*>(dv), Tq, Tkv, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto q_kern = flash_bwd_dq_kernel<T, D>;
  err = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(BwdSmem<D>::kDqBytes));
  if (err != cudaSuccess) return err;
  dim3 q_grid((Tq + kBT - 1) / kBT, H, B);
  q_kern<<<q_grid, kThreads, BwdSmem<D>::kDqBytes, stream>>>(
      qp, kp, vp, dop, lp, dp, static_cast<T*>(dq), Tq, Tkv, causal, scale);
  return cudaGetLastError();
}

}  // namespace bigdl

// Launches the dK/dV kernel, then the dQ kernel, on `stream`; float32 tensors,
// D a multiple of 16 up to 192 (four float32 64-row tiles of D + 1 columns
// fill the block's shared memory there; the wrapper pads any other D to the
// next one). Returns a cudaError_t (0 = both launched).
extern "C" int bigdl_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, void* dk, void* dv,
                               int B, int H, int Tq, int Tkv, int D, int causal, float scale,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return bigdl::launch_bwd<float, 16>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tkv, causal, scale, s);
    case 32: return bigdl::launch_bwd<float, 32>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tkv, causal, scale, s);
    case 48: return bigdl::launch_bwd<float, 48>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tkv, causal, scale, s);
    case 64: return bigdl::launch_bwd<float, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tkv, causal, scale, s);
    case 80: return bigdl::launch_bwd<float, 80>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tkv, causal, scale, s);
    case 96: return bigdl::launch_bwd<float, 96>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tkv, causal, scale, s);
    case 112: return bigdl::launch_bwd<float, 112>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tkv, causal, scale, s);
    case 128: return bigdl::launch_bwd<float, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tkv, causal, scale, s);
    case 144: return bigdl::launch_bwd<float, 144>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tkv, causal, scale, s);
    case 160: return bigdl::launch_bwd<float, 160>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tkv, causal, scale, s);
    case 176: return bigdl::launch_bwd<float, 176>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tkv, causal, scale, s);
    case 192: return bigdl::launch_bwd<float, 192>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tkv, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
