// Fused BatchNorm-apply + ReLU + matmul + batch statistics (K3, and K3-nhwc
// through a view) for Hopper on the CUDA cores: the route of float32 shapes
// whose K or N is not a multiple of 4 (route f32) and of bfloat16 shapes
// whose K or N is not a multiple of 8 (bf16_ragged). Every other shape -
// every ResNet-50 call - takes a tensor-core route: fused_matmul_sm90.cu
// (bf16) or fused_matmul_tf32_sm90.cu (float32, 3xTF32).
//
// Replaces the Pallas kernels of bigdl_tpu/kernels/fused_matmul.py:
// `_fwd` / `_fwd4` (forward) and `_bwd` / `_bwd4` (the dx + da/db kernel and
// the dw kernel). A contiguous NHWC activation already is a (B*H*W, K)
// matrix, so one flat kernel serves both entry points and the TPU's relayout
// problem (the reason for the NHWC kernels) does not arise.
//
// Forward:  x_hat = act(x * a + b)   (float32, rounded to x's type)
//           z = x_hat @ w            (float32 sums, written in x's type)
//           s1 = sum_m z, s2 = sum_m z^2   (float32, rows >= M excluded)
// Backward: dz_eff = dz + ds1 + 2 z ds2 (rounded to x's type)
//           dxn = [x * a + b > 0] (dz_eff @ w^T);  dx = dxn * a
//           da = sum_m dxn x, db = sum_m dxn;  dw = x_hat^T @ dz_eff
// (the ReLU mask and a/b only with the prologue; dz_eff = dz without stats).
//
// What bounds it on an H100: a 1x1 conv of ResNet-50 does 2 K N operations
// per pixel against (K + N) elements read and written, so stage 0 (K, N of
// 64-256) sits below the card's ~295 operations per byte in bf16 and is
// bound by memory, while stages 2-3 (K, N up to 2048) are bound by the
// product. These kernels multiply with float32 FMAs on the CUDA cores
// (fused_gemm.cuh), so they are bound by those (67 TF/s peak) at every
// stage. What the design
// does: the prologue, the stats-gradient injection and the ReLU mask run in
// the tile loads and the epilogue, so x_hat and dz_eff never reach device
// memory; the column sums go to per-block partials summed in a second pass
// (deterministic); dw splits its M-long contraction over enough blocks to
// fill the card and sums the splits in a second pass.
#include "fused_gemm.cuh"

namespace bigdl_fg {

// The dx epilogue: the ReLU mask from the recomputed x * a + b, dx = dxn * a,
// and the column sums da = sum dxn x, db = sum dxn (with the prologue).
template <typename T>
struct DxEpi {
  const T* x;
  const float* a;
  const float* b;
  T* dx;
  int ld, prologue, relu;
  __device__ __forceinline__ void operator()(int r, int c, float v, float& s1, float& s2) const {
    const size_t i = (size_t)r * ld + c;
    const float xv = to_f<T>(x[i]);
    const float xn = prologue ? affine(xv, a[c], b[c]) : xv;
    const float dxn = (relu && !(xn > 0.f)) ? 0.f : v;
    dx[i] = from_f<T>(prologue ? dxn * a[c] : dxn);
    if (prologue) {
      s1 = dxn * xv;
      s2 = dxn;
    }
  }
};

}  // namespace bigdl_fg

using namespace bigdl_fg;

namespace {

template <typename T>
cudaError_t fwd(const void* x, const void* w, const float* a, const float* b, void* z,
                float* part1, float* part2, float* s1, float* s2, int M, int K, int N,
                int prologue, int relu, int stats, cudaStream_t s) {
  XHat<T> fa{static_cast<const T*>(x), a, b, K, prologue, relu};
  ColsOf<T> fb{static_cast<const T*>(w), N};
  StoreZ<T> epi{static_cast<T*>(z), N, stats};
  cudaError_t e = gemm<true, false, true>(fa, fb, epi, M, N, K, K, 1, stats ? part1 : nullptr,
                                          part2, s);
  if (e != cudaSuccess || !stats) return e;
  const int nm = (M + kBM - 1) / kBM;
  e = sum_rows<float>(part1, nm, N, s1, s);
  if (e != cudaSuccess) return e;
  return sum_rows<float>(part2, nm, N, s2, s);
}

template <typename T>
cudaError_t bwd(const void* x, const void* w, const float* a, const float* b, const void* dz,
                const void* z, const float* ds1, const float* ds2, void* dx, void* dw,
                float* ws, float* part1, float* part2, float* da, float* db, int M, int K, int N,
                int prologue, int relu, int stats, int splits, int rows_per_split,
                cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  DzEff<T> dze{static_cast<const T*>(dz), static_cast<const T*>(z), ds1, ds2, N, stats};
  // dx (M, K) = dz_eff (M, N) . w (K, N)^T, with the ReLU mask, a, da, db
  DxEpi<T> epi{xt, a, b, static_cast<T*>(dx), K, prologue, relu};
  cudaError_t e = gemm<true, true, true>(dze, RowsOf<T>{static_cast<const T*>(w), N}, epi, M, K,
                                         N, N, 1, prologue ? part1 : nullptr, part2, s);
  if (e != cudaSuccess) return e;
  if (prologue) {
    const int nm = (M + kBM - 1) / kBM;
    if ((e = sum_rows<float>(part1, nm, K, da, s)) != cudaSuccess) return e;
    if ((e = sum_rows<float>(part2, nm, K, db, s)) != cudaSuccess) return e;
  }
  // dw (K, N) = x_hat^T (K, M) . dz_eff (M, N), split over M, then summed
  Swap<XHat<T>> fa{XHat<T>{xt, a, b, K, prologue, relu}};
  Swap<DzEff<T>> fb{dze};
  e = gemm<false, false, false>(fa, fb, StoreSplit{ws, K, N}, K, N, M, rows_per_split, splits,
                                nullptr, nullptr, s);
  if (e != cudaSuccess) return e;
  return sum_rows<T>(ws, splits, K * N, static_cast<T*>(dw), s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, w, z share it; a, b, s1, s2 are float32)
extern "C" int bigdl_fused_matmul_fwd(const void* x, const void* w, const float* a,
                                      const float* b, void* z, float* part1, float* part2,
                                      float* s1, float* s2, int dtype, int M, int K, int N,
                                      int prologue, int relu, int stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd<float>(x, w, a, b, z, part1, part2, s1, s2, M, K, N, prologue, relu, stats, s);
  return fwd<__nv_bfloat16>(x, w, a, b, z, part1, part2, s1, s2, M, K, N, prologue, relu,
                            stats, s);
}

// x, w, dz, z, dx, dw in dtype; a, b, ds1, ds2, da, db float32; ws holds
// splits x K x N float32 partials of dw; part1/part2 ceil(M / 128) x K.
extern "C" int bigdl_fused_matmul_bwd(const void* x, const void* w, const float* a,
                                      const float* b, const void* dz, const void* z,
                                      const float* ds1, const float* ds2, void* dx, void* dw,
                                      float* ws, float* part1, float* part2, float* da,
                                      float* db, int dtype, int M, int K, int N, int prologue,
                                      int relu, int stats, int splits, int rows_per_split,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd<float>(x, w, a, b, dz, z, ds1, ds2, dx, dw, ws, part1, part2, da, db, M, K, N,
                      prologue, relu, stats, splits, rows_per_split, s);
  return bwd<__nv_bfloat16>(x, w, a, b, dz, z, ds1, ds2, dx, dw, ws, part1, part2, da, db, M,
                            K, N, prologue, relu, stats, splits, rows_per_split, s);
}
