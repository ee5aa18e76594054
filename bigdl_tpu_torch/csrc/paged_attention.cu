// Paged attention (K2) for Hopper, float32 and bfloat16 pages: the unsplit
// kernel. Every call on the card takes the split-K kernel of
// paged_attention_sm90.cu; this one keeps its entry point, routed by no rule
// (chip_smoke.py times it beside the split-K kernel).
//
// Replaces the Pallas kernel bigdl_tpu/kernels/paged_attention.py
// `paged_decode_attention` (body `_kernel`): attention straight out of the
// paged KV pool through per-row block tables and positions, with no gathered
// (B, kvH, T, D) view. q arrives as (B, kvH, G * S, D), the kv-major fold of
// (B, nH, S, D) with nH = kvH * G; row g * S + s of kv head h is query head
// h * G + g at position positions[b] + s and sees keys <= positions[b] + s.
// Pages are (num_blocks, kvH, block_size, D); tables (B, max_blocks) int32
// with block 0 the null block; positions (B,) int32.
//
// What bounds it on an H100: decode (S = 1) does 4 * D operations per K/V
// row of 2 * D * sizeof(page) bytes, about one operation per byte in float32,
// so it is bound by memory: the bytes of the ceil((pos + S) / block_size)
// pages each row needs. What the design does: one block per (batch row, kv
// head, tile of query rows) reads the row's positions and table itself,
// visits exactly the logical blocks 0 .. pos + S - 1 (pages past the end are
// never read), gathers each needed page row straight into shared memory and
// runs the float32 online softmax there. The G query heads of a kv head share
// one pass over its pages (grouped-query attention never expands K/V). Small
// tiles (decode, G * S <= 8) take a warp per query row, larger ones 4 lanes
// per row and 64 rows per block.
//
// Grid: (ceil(G * S / R), kvH, B); 256 threads.
#include "attn_tile.cuh"

namespace bigdl {

template <typename T, int D, int TPR>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                           const T* __restrict__ v_pages, const int* __restrict__ tables,
                           const int* __restrict__ positions, T* __restrict__ o, int kvH,
                           int rows, int S, int bs, int max_blocks, float scale) {
  constexpr int R = kThreads / TPR;
  using Smem = TileSmem<D, R>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + R * Smem::kQStride;
  float* vs = ks + kBK * Smem::kKStride;
  float* ps = vs + kBK * D;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int r0 = blockIdx.x * R;
  const int nrows = min(R, rows - r0);
  const int pos = positions[b];
  const int* tbl = tables + size_t(b) * max_blocks;
  const int n_valid = min(pos + S, max_blocks * bs);  // logical positions 0 .. n_valid - 1
  const size_t head = size_t(b) * kvH + h;

  load_rows<T, D, R>(qs, Smem::kQStride, q + (head * rows + r0) * D, nrows);

  const int r = threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;
  RowState<D, TPR> st;
  st.init();

  for (int k0 = 0; k0 < n_valid; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed (and Q loaded)
    for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
      const int i = e / D;
      const int d = e - i * D;
      const int t = k0 + i;
      float kv = 0.f, vv = 0.f;
      if (t < n_valid) {
        const size_t page = size_t(tbl[t / bs]);
        const size_t src = ((page * kvH + h) * bs + (t % bs)) * D + d;
        kv = to_f<T>(k_pages[src]);
        vv = to_f<T>(v_pages[src]);
      }
      ks[i * Smem::kKStride + d] = kv;
      vs[i * D + d] = vv;
    }
    __syncthreads();
    int lim = -1;
    if (r < nrows) lim = min(pos + (r0 + r) % S, n_valid - 1) - k0;
    tile_update<D, TPR>(qs + r * Smem::kQStride, ks, vs, ps + r * Smem::kPStride, sub, lim,
                        scale, st);
  }
  if (r < nrows) store_row<T, D, TPR>(o + (head * rows + r0 + r) * D, sub, st);
}

template <typename T, int D, int TPR>
cudaError_t launch_paged(const void* q, const void* kp, const void* vp, const int* tables,
                         const int* positions, void* o, int B, int kvH, int rows, int S, int bs,
                         int max_blocks, float scale, cudaStream_t stream) {
  constexpr int R = kThreads / TPR;
  constexpr size_t smem = TileSmem<D, R>::kBytes;
  auto kern = paged_attention_kernel<T, D, TPR>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((rows + R - 1) / R, kvH, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(kp),
                                         static_cast<const T*>(vp), tables, positions,
                                         static_cast<T*>(o), kvH, rows, S, bs, max_blocks, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_tpr(const void* q, const void* kp, const void* vp, const int* tables,
                         const int* positions, void* o, int B, int kvH, int rows, int S, int bs,
                         int max_blocks, float scale, cudaStream_t s) {
  // a warp per query row for the decode shapes, 4 lanes per row otherwise
  if (rows <= kThreads / 32 && D % 32 == 0)
    return launch_paged<T, D, 32>(q, kp, vp, tables, positions, o, B, kvH, rows, S, bs,
                                  max_blocks, scale, s);
  return launch_paged<T, D, 4>(q, kp, vp, tables, positions, o, B, kvH, rows, S, bs, max_blocks,
                               scale, s);
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* kp, const void* vp, const int* tables,
                       const int* positions, void* o, int B, int kvH, int rows, int S, int bs,
                       int max_blocks, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return dispatch_tpr<T, 16>(q, kp, vp, tables, positions, o, B, kvH, rows, S, bs, max_blocks, scale, s);
    case 32: return dispatch_tpr<T, 32>(q, kp, vp, tables, positions, o, B, kvH, rows, S, bs, max_blocks, scale, s);
    case 48: return dispatch_tpr<T, 48>(q, kp, vp, tables, positions, o, B, kvH, rows, S, bs, max_blocks, scale, s);
    case 64: return dispatch_tpr<T, 64>(q, kp, vp, tables, positions, o, B, kvH, rows, S, bs, max_blocks, scale, s);
    case 80: return dispatch_tpr<T, 80>(q, kp, vp, tables, positions, o, B, kvH, rows, S, bs, max_blocks, scale, s);
    case 96: return dispatch_tpr<T, 96>(q, kp, vp, tables, positions, o, B, kvH, rows, S, bs, max_blocks, scale, s);
    case 112: return dispatch_tpr<T, 112>(q, kp, vp, tables, positions, o, B, kvH, rows, S, bs, max_blocks, scale, s);
    case 128: return dispatch_tpr<T, 128>(q, kp, vp, tables, positions, o, B, kvH, rows, S, bs, max_blocks, scale, s);
    case 144: return dispatch_tpr<T, 144>(q, kp, vp, tables, positions, o, B, kvH, rows, S, bs, max_blocks, scale, s);
    case 160: return dispatch_tpr<T, 160>(q, kp, vp, tables, positions, o, B, kvH, rows, S, bs, max_blocks, scale, s);
    case 176: return dispatch_tpr<T, 176>(q, kp, vp, tables, positions, o, B, kvH, rows, S, bs, max_blocks, scale, s);
    case 192: return dispatch_tpr<T, 192>(q, kp, vp, tables, positions, o, B, kvH, rows, S, bs, max_blocks, scale, s);
    case 208: return dispatch_tpr<T, 208>(q, kp, vp, tables, positions, o, B, kvH, rows, S, bs, max_blocks, scale, s);
    case 224: return dispatch_tpr<T, 224>(q, kp, vp, tables, positions, o, B, kvH, rows, S, bs, max_blocks, scale, s);
    case 240: return dispatch_tpr<T, 240>(q, kp, vp, tables, positions, o, B, kvH, rows, S, bs, max_blocks, scale, s);
    case 256: return dispatch_tpr<T, 256>(q, kp, vp, tables, positions, o, B, kvH, rows, S, bs, max_blocks, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bigdl

// dtype: 0 = float32, 1 = bfloat16 (q, pages and output share it). rows = G * S;
// D a multiple of 16 up to 256 (the wrapper pads any other D to the next one).
// Returns a cudaError_t (0 = launched).
extern "C" int bigdl_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                     const void* tables, const void* positions, void* o,
                                     int dtype, int B, int kvH, int rows, int S, int D, int bs,
                                     int max_blocks, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(tables);
  const int* pos = static_cast<const int*>(positions);
  if (dtype == 0)
    return bigdl::dispatch_d<float>(D, q, k_pages, v_pages, tbl, pos, o, B, kvH, rows, S, bs,
                                    max_blocks, scale, s);
  if (dtype == 1)
    return bigdl::dispatch_d<__nv_bfloat16>(D, q, k_pages, v_pages, tbl, pos, o, B, kvH, rows, S,
                                            bs, max_blocks, scale, s);
  return cudaErrorInvalidValue;
}
