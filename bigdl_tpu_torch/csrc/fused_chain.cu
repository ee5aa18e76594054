// Cross-layer fused residual junction + next 1x1 conv + batch statistics (K5)
// for Hopper on the CUDA cores: the route of float32 shapes whose K or N is
// not a multiple of 4 (f32) and of bfloat16 shapes whose K or N is not a
// multiple of 8 (bf16_ragged). Every other shape - every ResNet-50
// junction - takes a tensor-core route: fused_chain_sm90.cu (bf16) or
// fused_chain_tf32_sm90.cu (float32, 3xTF32).
//
// Replaces the Pallas kernels of bigdl_tpu/kernels/fused_chain.py: `_cfwd`
// (forward) and `_cbwd` (the dz/dr/da/db kernel and the dw kernel). Over a
// contiguous NHWC junction seen as (M = B*H*W, K) rows:
//
// Forward:  h = relu(z * a + b + r)  (float32, rounded to z's type; written
//                                      once: it is the next block's residual)
//           zo = h @ w;  s1 = sum_m zo, s2 = sum_m zo^2  (float32)
// Backward: dzo_eff = dzo + ds1 + 2 zo ds2 (rounded to z's type)
//           g = [z * a + b + r > 0] (dh + dzo_eff @ w^T)
//           dz = g a, dr = g, da = sum_m g z, db = sum_m g;  dw = h^T @ dzo_eff
//
// What bounds it on an H100: the junction is the widest activation of a
// stage (K = 4 N), and the product does 2 K N operations per pixel against
// 3 K + N elements moved, below the bf16 balance point of ~295 operations
// per byte in stages 0-1, so a kernel at its best is bound by memory there.
// This version multiplies with float32 FMAs on the CUDA cores through the
// core it shares with K3's CUDA-core route (fused_gemm.cuh) and is bound by
// those. What the
// design does: the epilogue of block n runs in the loads of block n+1's
// first product, so the junction output is written once (by the blocks of
// column tile 0) and never read back for the product; the backward rebuilds
// h and the ReLU mask from z and r rather than reading h; the column sums
// and the split-K weight gradient are summed in second passes (no atomics).
#include "fused_gemm.cuh"

namespace bigdl_fg {

// The dz/dr epilogue: g = [u > 0] (dh + v), dz = g a, dr = g; sums g z, g.
template <typename T>
struct ChainDxEpi {
  const T* z;
  const T* r;
  const T* dh;
  const float* a;
  const float* b;
  T* dz;
  T* dr;
  int ld;
  __device__ __forceinline__ void operator()(int m, int k, float v, float& s1, float& s2) const {
    const size_t i = (size_t)m * ld + k;
    const float zf = to_f<T>(z[i]);
    const float u = __fadd_rn(affine(zf, a[k], b[k]), to_f<T>(r[i]));
    const float g = u > 0.f ? v + to_f<T>(dh[i]) : 0.f;
    dz[i] = from_f<T>(g * a[k]);
    dr[i] = from_f<T>(g);
    s1 = g * zf;
    s2 = g;
  }
};

}  // namespace bigdl_fg

using namespace bigdl_fg;

namespace {

template <typename T>
cudaError_t fwd(const void* z, const void* r, const float* a, const float* b, const void* w,
                void* h, void* zo, float* part1, float* part2, float* s1, float* s2, int M,
                int K, int N, int stats, cudaStream_t s) {
  Resid<T> fa{static_cast<const T*>(z), static_cast<const T*>(r), a, b, static_cast<T*>(h), K};
  ColsOf<T> fb{static_cast<const T*>(w), N};
  StoreZ<T> epi{static_cast<T*>(zo), N, stats};
  cudaError_t e = gemm<true, false, true>(fa, fb, epi, M, N, K, K, 1, stats ? part1 : nullptr,
                                          part2, s);
  if (e != cudaSuccess || !stats) return e;
  const int nm = (M + kBM - 1) / kBM;
  if ((e = sum_rows<float>(part1, nm, N, s1, s)) != cudaSuccess) return e;
  return sum_rows<float>(part2, nm, N, s2, s);
}

template <typename T>
cudaError_t bwd(const void* z, const void* r, const float* a, const float* b, const void* w,
                const void* dh, const void* dzo, const void* zo, const float* ds1,
                const float* ds2, void* dz, void* dr, void* dw, float* ws, float* part1,
                float* part2, float* da, float* db, int M, int K, int N, int stats, int splits,
                int rows_per_split, cudaStream_t s) {
  const T* zt = static_cast<const T*>(z);
  const T* rt = static_cast<const T*>(r);
  DzEff<T> dze{static_cast<const T*>(dzo), static_cast<const T*>(zo), ds1, ds2, N, stats};
  // dz, dr (M, K) from dzo_eff (M, N) . w (K, N)^T; da, db per block
  ChainDxEpi<T> epi{zt, rt, static_cast<const T*>(dh), a, b, static_cast<T*>(dz),
                    static_cast<T*>(dr), K};
  cudaError_t e = gemm<true, true, true>(dze, RowsOf<T>{static_cast<const T*>(w), N}, epi, M, K,
                                         N, N, 1, part1, part2, s);
  if (e != cudaSuccess) return e;
  const int nm = (M + kBM - 1) / kBM;
  if ((e = sum_rows<float>(part1, nm, K, da, s)) != cudaSuccess) return e;
  if ((e = sum_rows<float>(part2, nm, K, db, s)) != cudaSuccess) return e;
  // dw (K, N) = h^T (K, M) . dzo_eff (M, N), h rebuilt from z and r
  Swap<Resid<T>> fa{Resid<T>{zt, rt, a, b, nullptr, K}};
  Swap<DzEff<T>> fb{dze};
  e = gemm<false, false, false>(fa, fb, StoreSplit{ws, K, N}, K, N, M, rows_per_split, splits,
                                nullptr, nullptr, s);
  if (e != cudaSuccess) return e;
  return sum_rows<T>(ws, splits, K * N, static_cast<T*>(dw), s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (z, r, w, h, zo share it; a, b, s1, s2 float32)
extern "C" int bigdl_fused_chain_fwd(const void* z, const void* r, const float* a,
                                     const float* b, const void* w, void* h, void* zo,
                                     float* part1, float* part2, float* s1, float* s2,
                                     int dtype, int M, int K, int N, int stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd<float>(z, r, a, b, w, h, zo, part1, part2, s1, s2, M, K, N, stats, s);
  return fwd<__nv_bfloat16>(z, r, a, b, w, h, zo, part1, part2, s1, s2, M, K, N, stats, s);
}

// z, r, w, dh, dzo, zo, dz, dr, dw in dtype; a, b, ds1, ds2, da, db float32;
// ws holds splits x K x N float32 partials of dw; part1/part2 ceil(M/128) x K.
extern "C" int bigdl_fused_chain_bwd(const void* z, const void* r, const float* a,
                                     const float* b, const void* w, const void* dh,
                                     const void* dzo, const void* zo, const float* ds1,
                                     const float* ds2, void* dz, void* dr, void* dw, float* ws,
                                     float* part1, float* part2, float* da, float* db,
                                     int dtype, int M, int K, int N, int stats, int splits,
                                     int rows_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd<float>(z, r, a, b, w, dh, dzo, zo, ds1, ds2, dz, dr, dw, ws, part1, part2, da,
                      db, M, K, N, stats, splits, rows_per_split, s);
  return bwd<__nv_bfloat16>(z, r, a, b, w, dh, dzo, zo, ds1, ds2, dz, dr, dw, ws, part1, part2,
                            da, db, M, K, N, stats, splits, rows_per_split, s);
}
