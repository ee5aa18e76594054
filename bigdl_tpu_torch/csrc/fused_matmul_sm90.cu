// Fused BatchNorm-apply + ReLU + matmul + batch statistics (K3, and K3-nhwc
// through a view) for Hopper, bfloat16, on the tensor cores.
//
// Replaces, for bf16 inputs whose K and N are multiples of 8, the Pallas
// kernels of bigdl_tpu/kernels/fused_matmul.py: `_fwd` / `_fwd4` (forward)
// and `_bwd` / `_bwd4` (the dx + da/db kernel and the dw kernel). It
// computes what fused_matmul.cu computes (that file's note gives the
// formulas; it stays the route of bf16 shapes outside that rule and of
// float32 shapes outside the 3xTF32 rule), with the same C entry points and
// arguments.
//
// What bounds it on an H100: a 1x1 conv of ResNet-50 does 2 K N operations
// per pixel against (K + N) bf16 elements read and written. At stage 0 (K
// and N of 64-256) that is 40-100 operations per byte, far below the card's
// ~295, so those calls are bound by memory (3.35 TB/s); stages 2-3 (K, N up
// to 2048) by the tensor cores (989 TF/s). What the design does
// (fused_gemm_sm90.cuh): bf16 wgmma with float32 accumulators in
// registers, 128 x 256 tiles where N allows; the weight through TMA into a
// swizzled ring kept full by a producer warp; x and dz / z rows copied
// with 16-byte cp.async two chunks ahead, x_hat and dz_eff made in the
// consumers' registers (with the parameters of the chunk's columns staged
// beside its tile), so neither reaches device memory and z is read once;
// persistent blocks with column tiles of the same rows adjacent, so x is
// read from device memory about once; z and dx leave through a swizzled
// staging tile and TMA stores; the statistics and da/db reduced in
// registers, shuffles and shared memory to one partial per 64 rows and
// summed in a fixed order (no atomics). dw is a split contraction over the
// pixels whose two operands are transformed in shared memory, 64 rows of
// dw a block, two float32 partials a split.
#include "fused_gemm_sm90.cuh"

namespace bigdl_fg {
namespace sm90 {
namespace {

cudaError_t fwd(const void* x, const void* w, const float* a, const float* b, void* z,
                float* part1, float* part2, float* s1, float* s2, int M, int K, int N,
                int prologue, int relu, int stats, cudaStream_t s) {
  XHatA<1> aop{};
  aop.x = static_cast<const bf16*>(x);
  aop.a = prologue ? a : nullptr;
  aop.b = prologue ? b : nullptr;
  aop.rows = M;
  aop.C = K;
  aop.relu = relu;
  cudaError_t e =
      gemm_rs<256, 1>(w, z, aop, StoreZ2{}, M, N, K, stats ? part1 : nullptr, part2, s);
  if (e != cudaSuccess || !stats) return e;
  const int nm = (M + kPartRows - 1) / kPartRows;
  if ((e = sum_rows<float>(part1, nm, N, s1, s)) != cudaSuccess) return e;
  return sum_rows<float>(part2, nm, N, s2, s);
}

cudaError_t bwd(const void* x, const void* w, const float* a, const float* b, const void* dz,
                const void* z, const float* ds1, const float* ds2, void* dx, void* dw, float* ws,
                float* part1, float* part2, float* da, float* db, int M, int K, int N,
                int prologue, int relu, int stats, int splits, int rows_per_split,
                cudaStream_t s) {
  // dx (M, K) = dz_eff (M, N) . w (K, N)^T, with the ReLU mask, a, da, db
  DzEffA aop{};
  aop.dz = static_cast<const bf16*>(dz);
  aop.z = static_cast<const bf16*>(z);
  aop.ds1 = ds1;
  aop.ds2 = ds2;
  aop.rows = M;
  aop.ld = N;
  aop.stats = stats;
  DxEpi2<bf16> epi{static_cast<const bf16*>(x), a, b, K, prologue, relu};
  cudaError_t e =
      gemm_rs<128, 0>(w, dx, aop, epi, M, K, N, prologue ? part1 : nullptr, part2, s);
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
  return sum_rows<bf16>(ws, 2 * splits, K * N, static_cast<bf16*>(dw), s);
}

}  // namespace
}  // namespace sm90
}  // namespace bigdl_fg

// The arguments of fused_matmul.cu's entry points; dtype must be 1
// (bfloat16), K and N multiples of 8, and x, w (and dz, z) 16-byte aligned.
extern "C" int bigdl_fused_matmul_sm90_fwd(const void* x, const void* w, const float* a,
                                           const float* b, void* z, float* part1, float* part2,
                                           float* s1, float* s2, int dtype, int M, int K, int N,
                                           int prologue, int relu, int stats, void* stream) {
  if (dtype != 1 || K % 8 != 0 || N % 8 != 0) return cudaErrorInvalidValue;
  return bigdl_fg::sm90::fwd(x, w, a, b, z, part1, part2, s1, s2, M, K, N, prologue, relu,
                             stats, static_cast<cudaStream_t>(stream));
}

// ws holds 2 x splits x K x N float32 partials of dw (rows_per_split a
// multiple of 128); part1/part2 ceil(M / 128) x K.
extern "C" int bigdl_fused_matmul_sm90_bwd(const void* x, const void* w, const float* a,
                                           const float* b, const void* dz, const void* z,
                                           const float* ds1, const float* ds2, void* dx,
                                           void* dw, float* ws, float* part1, float* part2,
                                           float* da, float* db, int dtype, int M, int K, int N,
                                           int prologue, int relu, int stats, int splits,
                                           int rows_per_split, void* stream) {
  if (dtype != 1 || K % 8 != 0 || N % 8 != 0 || rows_per_split % 128 != 0)
    return cudaErrorInvalidValue;
  return bigdl_fg::sm90::bwd(x, w, a, b, dz, z, ds1, ds2, dx, dw, ws, part1, part2, da, db, M,
                             K, N, prologue, relu, stats, splits, rows_per_split,
                             static_cast<cudaStream_t>(stream));
}
