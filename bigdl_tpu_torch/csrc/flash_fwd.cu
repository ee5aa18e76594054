// Flash attention forward (K1-fwd) for Hopper, float32 (bf16 inputs take the
// tensor-core kernel of flash_fwd_sm90.cu).
//
// Replaces the Pallas kernel bigdl_tpu/kernels/flash_attention.py `_flash_fwd`
// (body `_fwd_kernel`): online-softmax attention over q, k, v of shape
// (B, H, T, D), causal or rectangular-causal (query row r sits at global
// position q_offset + r and sees keys <= q_offset + r), over the first
// kv_len keys only. Returns o (B, H, Tq, D) in the input type and the per-row
// log-sum-exp lse (B, H, Tq) in float32; rows that see no key give o = 0 and
// lse = -inf.
//
// What bounds it on an H100: at serving shapes (D = 64, T of a few hundred)
// the work is about 2 * T / (bytes per element) operations per byte read, far
// under the ~295 operations per byte where bf16 tensor cores stop being the
// limit, so the kernel should be bound by memory and launch latency. It does
// its two products with float32 FMAs on the CUDA cores (float32 callers need
// float32 products, which the TF32 tensor cores would not give), so at long T
// it is bound by those operations instead. What the design does: K/V are read once per 64-row query
// tile, scores never leave shared memory, the key loop stops at the causal /
// kv_len bound (no key tile above the diagonal or past kv_len is read), and
// the ragged edges are masked in the kernel instead of padding copies.
//
// Grid: (ceil(Tq / 64), H, B); 256 threads, 4 lanes per query row.
#include "attn_tile.cuh"

namespace bigdl {

constexpr int kFlashTPR = 4;
constexpr int kFlashRows = kThreads / kFlashTPR;  // 64 query rows per block

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                     int Tq, int Tkv, int causal, int q_offset, int kv_len, float scale) {
  using Smem = TileSmem<D, kFlashRows>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kFlashRows * Smem::kQStride;
  float* vs = ks + kBK * Smem::kKStride;
  float* ps = vs + kBK * D;

  const int q0 = blockIdx.x * kFlashRows;
  const size_t bh = size_t(blockIdx.z) * gridDim.y + blockIdx.y;
  const int nrows = min(kFlashRows, Tq - q0);
  const T* qb = q + (bh * Tq + q0) * D;
  const T* kb = k + bh * Tkv * D;
  const T* vb = v + bh * Tkv * D;

  load_rows<T, D, kFlashRows>(qs, Smem::kQStride, qb, nrows);

  const int r = threadIdx.x / kFlashTPR;
  const int sub = threadIdx.x % kFlashTPR;
  RowState<D, kFlashTPR> st;
  st.init();

  int kend = kv_len;
  if (causal) kend = min(kend, q_offset + q0 + nrows);
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed (and Q loaded)
    const int nk = min(kBK, kv_len - k0);
    load_rows<T, D, kBK>(ks, Smem::kKStride, kb + size_t(k0) * D, nk);
    load_rows<T, D, kBK>(vs, D, vb + size_t(k0) * D, nk);
    __syncthreads();
    int lim = -1;
    if (r < nrows) {
      lim = kv_len - 1 - k0;
      if (causal) lim = min(lim, q_offset + q0 + r - k0);
    }
    tile_update<D, kFlashTPR>(qs + r * Smem::kQStride, ks, vs, ps + r * Smem::kPStride, sub,
                              lim, scale, st);
  }
  if (r < nrows) {
    store_row<T, D, kFlashTPR>(o + (bh * Tq + q0 + r) * D, sub, st);
    if (sub == 0) lse[bh * Tq + q0 + r] = st.l > 0.f ? st.m + logf(st.l) : -INFINITY;
  }
}

template <typename T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o, void* lse,
                         int B, int H, int Tq, int Tkv, int causal, int q_offset, int kv_len,
                         float scale, cudaStream_t stream) {
  constexpr size_t smem = TileSmem<D, kFlashRows>::kBytes;
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kFlashRows - 1) / kFlashRows, H, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(o),
                                         static_cast<float*>(lse), Tq, Tkv, causal, q_offset,
                                         kv_len, scale);
  return cudaGetLastError();
}

}  // namespace bigdl

// float32 q, k, v, o, lse; D a multiple of 16 up to 256 (the wrapper pads
// any other D to the next one). Returns a cudaError_t (0 = launched).
extern "C" int bigdl_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int B, int H, int Tq, int Tkv, int D, int causal, int q_offset,
                               int kv_len, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return bigdl::launch_flash<float, 16>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 32: return bigdl::launch_flash<float, 32>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 48: return bigdl::launch_flash<float, 48>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 64: return bigdl::launch_flash<float, 64>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 80: return bigdl::launch_flash<float, 80>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 96: return bigdl::launch_flash<float, 96>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 112: return bigdl::launch_flash<float, 112>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 128: return bigdl::launch_flash<float, 128>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 144: return bigdl::launch_flash<float, 144>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 160: return bigdl::launch_flash<float, 160>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 176: return bigdl::launch_flash<float, 176>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 192: return bigdl::launch_flash<float, 192>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 208: return bigdl::launch_flash<float, 208>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 224: return bigdl::launch_flash<float, 224>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 240: return bigdl::launch_flash<float, 240>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 256: return bigdl::launch_flash<float, 256>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
