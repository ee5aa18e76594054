// Fused BatchNorm-apply + ReLU + matmul + batch statistics (K3, and K3-nhwc
// through a view) for Hopper, float32, on the tensor cores in 3xTF32.
//
// Replaces, for float32 inputs whose K and N are multiples of 4, the Pallas
// kernels of bigdl_tpu/kernels/fused_matmul.py: `_fwd` / `_fwd4` (forward)
// and `_bwd` / `_bwd4` (the dx + da/db kernel and the dw kernel). It
// computes what fused_matmul.cu computes (that file's note gives the
// formulas; it stays the route of the other float32 shapes), with the same
// C entry arguments and one more, the scratch of the split weight.
//
// What bounds it on an H100: a 1x1 conv of ResNet-50 does 2 K N operations
// per pixel against (K + N) float32 elements read and written. 3xTF32 runs
// three tf32 products for each (495 TF/s dense, so 165 TF/s of float32
// work), which puts the balance point near 50 operations per byte: stage 0
// (K, N of 64-256, 16-26 operations per byte) is bound by memory (3.35
// TB/s), the wide stage-3 products by the tensor cores. The CUDA-core route
// is capped by 67 TF/s of float32 FMA at every stage. What the design does
// (fused_gemm_tf32_sm90.cuh): each call first splits the weight into tf32
// hi and lo halves laid out K-major (w^T for the forward, w itself for dx:
// tf32 wgmma takes no transpose), which TMA then streams into a swizzled
// ring; x and dz / z rows come by 16-byte cp.async two chunks ahead, and
// x_hat and dz_eff are made in float32 in the consumers' registers, split,
// and fed as wgmma's register A operand, so neither reaches device memory;
// z and dx leave through a swizzled float32 staging tile and TMA stores;
// the statistics and da/db are reduced to one partial per 64 rows and
// summed in a fixed order (no atomics). dw is a split contraction over the
// pixels: x_hat^T from registers, dz_eff written transposed (hi and lo) in
// shared memory, two float32 partials a split.
#include "fused_gemm_tf32_sm90.cuh"

namespace bigdl_fg {
namespace sm90 {
namespace tf32 {
namespace {

cudaError_t fwd(const void* x, const void* w, const float* a, const float* b, void* z,
                float* part1, float* part2, float* s1, float* s2, int M, int K, int N,
                int prologue, int relu, int stats, float* wsplit, cudaStream_t s) {
  // B of z = x_hat w: w^T (N, K), hi and lo
  float* whi = wsplit;
  float* wlo = wsplit + (size_t)K * N;
  cudaError_t e = split_w(w, whi, wlo, K, N, true, s);
  if (e != cudaSuccess) return e;
  XHatF<> aop{};
  aop.x = static_cast<const float*>(x);
  aop.a = prologue ? a : nullptr;
  aop.b = prologue ? b : nullptr;
  aop.rows = M;
  aop.ld = K;
  aop.relu = relu;
  e = gemm(whi, wlo, z, aop, StoreZ2{}, M, N, K, stats ? part1 : nullptr, part2, s);
  if (e != cudaSuccess || !stats) return e;
  const int nm = (M + kPartRows - 1) / kPartRows;
  if ((e = sum_rows<float>(part1, nm, N, s1, s)) != cudaSuccess) return e;
  return sum_rows<float>(part2, nm, N, s2, s);
}

cudaError_t bwd(const void* x, const void* w, const float* a, const float* b, const void* dz,
                const void* z, const float* ds1, const float* ds2, void* dx, void* dw, float* ws,
                float* part1, float* part2, float* da, float* db, int M, int K, int N,
                int prologue, int relu, int stats, int splits, int rows_per_split,
                float* wsplit, cudaStream_t s) {
  // dx (M, K) = dz_eff (M, N) . w (K, N)^T, with the ReLU mask, a, da, db;
  // its B is w^T, K-major as w is stored
  float* whi = wsplit;
  float* wlo = wsplit + (size_t)K * N;
  cudaError_t e = split_w(w, whi, wlo, K, N, false, s);
  if (e != cudaSuccess) return e;
  DzEffF<> aop{};
  aop.dz = static_cast<const float*>(dz);
  aop.z = static_cast<const float*>(z);
  aop.ds1 = ds1;
  aop.ds2 = ds2;
  aop.rows = M;
  aop.ld = N;
  aop.stats = stats;
  DxEpi2<float> epi{static_cast<const float*>(x), a, b, K, prologue, relu};
  e = gemm(whi, wlo, dx, aop, epi, M, K, N, prologue ? part1 : nullptr, part2, s);
  if (e != cudaSuccess) return e;
  if (prologue) {
    const int nm = (M + kPartRows - 1) / kPartRows;
    if ((e = sum_rows<float>(part1, nm, K, da, s)) != cudaSuccess) return e;
    if ((e = sum_rows<float>(part2, nm, K, db, s)) != cudaSuccess) return e;
  }
  // dw (K, N) = x_hat^T (K, M) . dz_eff (M, N), split over M, then summed
  e = gemm_dw(x, dz, z, a, b, ds1, ds2, ws, M, K, N, prologue, relu, stats, splits,
              rows_per_split, s);
  if (e != cudaSuccess) return e;
  return sum_rows<float>(ws, 2 * splits, K * N, static_cast<float*>(dw), s);
}

}  // namespace
}  // namespace tf32
}  // namespace sm90
}  // namespace bigdl_fg

// The arguments of fused_matmul.cu's entry points, then wsplit: 2 x K x N
// float32 of scratch for the split weight. dtype must be 0 (float32), K and
// N multiples of 4, and x, w (and dz, z) 16-byte aligned; part1/part2 hold
// ceil(M / 64) x N float32 partial sums.
extern "C" int bigdl_fused_matmul_tf32_sm90_fwd(const void* x, const void* w, const float* a,
                                                const float* b, void* z, float* part1,
                                                float* part2, float* s1, float* s2, int dtype,
                                                int M, int K, int N, int prologue, int relu,
                                                int stats, void* stream, float* wsplit) {
  if (dtype != 0 || K % 4 != 0 || N % 4 != 0) return cudaErrorInvalidValue;
  return bigdl_fg::sm90::tf32::fwd(x, w, a, b, z, part1, part2, s1, s2, M, K, N, prologue,
                                   relu, stats, wsplit, static_cast<cudaStream_t>(stream));
}

// ws holds 2 x splits x K x N float32 partials of dw (rows_per_split a
// multiple of 64); part1/part2 ceil(M / 64) x K.
extern "C" int bigdl_fused_matmul_tf32_sm90_bwd(const void* x, const void* w, const float* a,
                                                const float* b, const void* dz, const void* z,
                                                const float* ds1, const float* ds2, void* dx,
                                                void* dw, float* ws, float* part1, float* part2,
                                                float* da, float* db, int dtype, int M, int K,
                                                int N, int prologue, int relu, int stats,
                                                int splits, int rows_per_split, void* stream,
                                                float* wsplit) {
  if (dtype != 0 || K % 4 != 0 || N % 4 != 0 || rows_per_split % 64 != 0)
    return cudaErrorInvalidValue;
  return bigdl_fg::sm90::tf32::bwd(x, w, a, b, dz, z, ds1, ds2, dx, dw, ws, part1, part2, da, db,
                                   M, K, N, prologue, relu, stats, splits, rows_per_split,
                                   wsplit, static_cast<cudaStream_t>(stream));
}
