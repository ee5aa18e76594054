// Fused BatchNorm-apply + ReLU + matmul + batch statistics (K3, and K3-nhwc
// through a view) for Hopper: the ragged routes, the shapes outside the
// aligned tensor-core rules of fused_matmul_sm90.cu (bf16, K and N
// multiples of 8) and fused_matmul_tf32_sm90.cu (float32, K and N multiples
// of 4). Both dtypes run those files' kernels with the cores' ragged load /
// store policy (RG = true), at any K and N:
// - float32 (route f32): 3xTF32 wgmma on fused_gemm_tf32_sm90.cuh;
// - bfloat16 (route bf16_ragged): bf16 wgmma on fused_gemm_sm90.cuh.
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
// What bounds it on an H100: a 1x1 conv does 2 K N operations per pixel
// against (K + N) elements read and written: below the balance point of
// 3xTF32 (~50 operations per byte) or bf16 (~295) at widths up to a few
// hundred, so these calls are bound by memory (3.35 TB/s), as on the
// aligned routes. A row of K = 63 float32 values is 252 bytes and of 63
// bf16 values 126 (every other row at an odd element address), which rules
// out the aligned routes' 16-byte copies and TMA for the activations. What
// the design does: the aligned routes' kernels with the ragged policy (the
// cores' notes) - x, dz and z come by 4-byte copies into the same swizzled
// ring (bf16 rows of odd length by 2-byte loads), a warp reading a row's
// neighbouring elements; x_hat and dz_eff are made in registers, so neither
// reaches device memory; the weight is prepared once a call (float32: its
// tf32 hi / lo halves with the contraction zero-padded to a whole stage;
// bf16: a copy with rows zero-padded to 8) and streams by TMA - weight-sized
// scratch, the only copy; z and dx leave by coalesced predicated stores
// from the staging tile; the statistics and da/db are reduced to one
// partial per 64 rows, dw to two partials a split, and summed in a fixed
// order (no atomics: reruns agree bit for bit).
#include "fused_gemm_tf32_sm90.cuh"

namespace bigdl_fg {
namespace sm90 {
namespace {

// bfloat16 at any K and N: fused_matmul_sm90.cu's kernels with RG. Both
// products read w (K, N) from its copy with rows of pad8(N): the forward
// through the transposed descriptor, dx as the K-major B of w^T.
cudaError_t fwd_bf16(const void* x, const void* w, const float* a, const float* b, void* z,
                     float* part1, float* part2, float* s1, float* s2, int M, int K, int N,
                     int prologue, int relu, int stats, void* wpad, cudaStream_t s) {
  cudaError_t e = pad_cols(w, wpad, K, N, s);
  if (e != cudaSuccess) return e;
  XHatA<1, true> aop{};
  aop.x = static_cast<const bf16*>(x);
  aop.a = prologue ? a : nullptr;
  aop.b = prologue ? b : nullptr;
  aop.rows = M;
  aop.C = K;
  aop.relu = relu;
  e = gemm_rs<128, 1, true>(wpad, z, aop, StoreZ2{}, M, N, K, stats ? part1 : nullptr, part2,
                            s);
  if (e != cudaSuccess || !stats) return e;
  const int nm = (M + kPartRows - 1) / kPartRows;
  if ((e = sum_rows<float>(part1, nm, N, s1, s)) != cudaSuccess) return e;
  return sum_rows<float>(part2, nm, N, s2, s);
}

cudaError_t bwd_bf16(const void* x, const void* w, const float* a, const float* b,
                     const void* dz, const void* z, const float* ds1, const float* ds2, void* dx,
                     void* dw, float* ws, float* part1, float* part2, float* da, float* db, int M,
                     int K, int N, int prologue, int relu, int stats, int splits,
                     int rows_per_split, void* wpad, cudaStream_t s) {
  // dx (M, K) = dz_eff (M, N) . w (K, N)^T, with the ReLU mask, a, da, db
  cudaError_t e = pad_cols(w, wpad, K, N, s);
  if (e != cudaSuccess) return e;
  DzEffA<true> aop{};
  aop.dz = static_cast<const bf16*>(dz);
  aop.z = static_cast<const bf16*>(z);
  aop.ds1 = ds1;
  aop.ds2 = ds2;
  aop.rows = M;
  aop.ld = N;
  aop.stats = stats;
  DxEpi2<bf16, true> epi{static_cast<const bf16*>(x), a, b, K, prologue, relu};
  e = gemm_rs<128, 0, true>(wpad, dx, aop, epi, M, K, N, prologue ? part1 : nullptr, part2, s);
  if (e != cudaSuccess) return e;
  if (prologue) {
    const int nm = (M + kPartRows - 1) / kPartRows;
    if ((e = sum_rows<float>(part1, nm, K, da, s)) != cudaSuccess) return e;
    if ((e = sum_rows<float>(part2, nm, K, db, s)) != cudaSuccess) return e;
  }
  // dw (K, N) = x_hat^T (K, M) . dz_eff (M, N), split over M, then summed
  e = gemm_dw<false, true>(x, dz, z, a, b, ds1, ds2, ws, M, K, N, prologue, relu, stats, splits,
                           rows_per_split, s);
  if (e != cudaSuccess) return e;
  return sum_rows<bf16>(ws, 2 * splits, K * N, static_cast<bf16*>(dw), s);
}

}  // namespace

namespace tf32 {
namespace {

// float32 at any K and N: fused_matmul_tf32_sm90.cu's kernels with RG
cudaError_t fwd_f32(const void* x, const void* w, const float* a, const float* b, void* z,
                    float* part1, float* part2, float* s1, float* s2, int M, int K, int N,
                    int prologue, int relu, int stats, float* wsplit, cudaStream_t s) {
  // B of z = x_hat w: w^T (N, kpad(K)), hi and lo
  float* whi = wsplit;
  float* wlo = wsplit + (size_t)N * kpad(K);
  cudaError_t e = split_w(w, whi, wlo, K, N, true, s, true);
  if (e != cudaSuccess) return e;
  XHatF<true> aop{};
  aop.x = static_cast<const float*>(x);
  aop.a = prologue ? a : nullptr;
  aop.b = prologue ? b : nullptr;
  aop.rows = M;
  aop.ld = K;
  aop.relu = relu;
  e = gemm<true>(whi, wlo, z, aop, StoreZ2{}, M, N, K, stats ? part1 : nullptr, part2, s);
  if (e != cudaSuccess || !stats) return e;
  const int nm = (M + kPartRows - 1) / kPartRows;
  if ((e = sum_rows<float>(part1, nm, N, s1, s)) != cudaSuccess) return e;
  return sum_rows<float>(part2, nm, N, s2, s);
}

cudaError_t bwd_f32(const void* x, const void* w, const float* a, const float* b,
                    const void* dz, const void* z, const float* ds1, const float* ds2, void* dx,
                    void* dw, float* ws, float* part1, float* part2, float* da, float* db, int M,
                    int K, int N, int prologue, int relu, int stats, int splits,
                    int rows_per_split, float* wsplit, cudaStream_t s) {
  // dx (M, K) = dz_eff (M, N) . w (K, N)^T: its B is w (K, kpad(N))
  float* whi = wsplit;
  float* wlo = wsplit + (size_t)K * kpad(N);
  cudaError_t e = split_w(w, whi, wlo, K, N, false, s, true);
  if (e != cudaSuccess) return e;
  DzEffF<true> aop{};
  aop.dz = static_cast<const float*>(dz);
  aop.z = static_cast<const float*>(z);
  aop.ds1 = ds1;
  aop.ds2 = ds2;
  aop.rows = M;
  aop.ld = N;
  aop.stats = stats;
  DxEpi2<float, true> epi{static_cast<const float*>(x), a, b, K, prologue, relu};
  e = gemm<true>(whi, wlo, dx, aop, epi, M, K, N, prologue ? part1 : nullptr, part2, s);
  if (e != cudaSuccess) return e;
  if (prologue) {
    const int nm = (M + kPartRows - 1) / kPartRows;
    if ((e = sum_rows<float>(part1, nm, K, da, s)) != cudaSuccess) return e;
    if ((e = sum_rows<float>(part2, nm, K, db, s)) != cudaSuccess) return e;
  }
  // dw (K, N) = x_hat^T (K, M) . dz_eff (M, N), split over M, then summed
  e = gemm_dw<false, true>(x, dz, z, a, b, ds1, ds2, ws, M, K, N, prologue, relu, stats,
                           splits, rows_per_split, s);
  if (e != cudaSuccess) return e;
  return sum_rows<float>(ws, 2 * splits, K * N, static_cast<float*>(dw), s);
}

}  // namespace
}  // namespace tf32
}  // namespace sm90
}  // namespace bigdl_fg

using namespace bigdl_fg;

// dtype: 0 float32, 1 bfloat16 (x, w, z share it; a, b, s1, s2 are
// float32); part1/part2 hold ceil(M / 64) x N float32 partial sums; wsplit
// the weight's scratch: float32 2 x N x kpad(K) float32 (its split halves,
// kpad: K rounded up to 32), bf16 K x pad8(N) bf16 (its padded copy).
extern "C" int bigdl_fused_matmul_fwd(const void* x, const void* w, const float* a,
                                      const float* b, void* z, float* part1, float* part2,
                                      float* s1, float* s2, int dtype, int M, int K, int N,
                                      int prologue, int relu, int stats, void* stream,
                                      float* wsplit) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return sm90::tf32::fwd_f32(x, w, a, b, z, part1, part2, s1, s2, M, K, N, prologue, relu,
                               stats, wsplit, s);
  return sm90::fwd_bf16(x, w, a, b, z, part1, part2, s1, s2, M, K, N, prologue, relu, stats,
                        wsplit, s);
}

// x, w, dz, z, dx, dw in dtype; a, b, ds1, ds2, da, db float32; ws holds 2 x
// splits x K x N float32 partials of dw (rows_per_split a multiple of 64
// for float32, 128 for bf16); part1/part2 ceil(M / 64) x K; wsplit float32
// 2 x K x kpad(N) float32, bf16 K x pad8(N) bf16.
extern "C" int bigdl_fused_matmul_bwd(const void* x, const void* w, const float* a,
                                      const float* b, const void* dz, const void* z,
                                      const float* ds1, const float* ds2, void* dx, void* dw,
                                      float* ws, float* part1, float* part2, float* da,
                                      float* db, int dtype, int M, int K, int N, int prologue,
                                      int relu, int stats, int splits, int rows_per_split,
                                      void* stream, float* wsplit) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_per_split % (dtype == 0 ? 64 : 128) != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return sm90::tf32::bwd_f32(x, w, a, b, dz, z, ds1, ds2, dx, dw, ws, part1, part2, da, db, M,
                               K, N, prologue, relu, stats, splits, rows_per_split, wsplit, s);
  return sm90::bwd_bf16(x, w, a, b, dz, z, ds1, ds2, dx, dw, ws, part1, part2, da, db, M, K, N,
                        prologue, relu, stats, splits, rows_per_split, wsplit, s);
}
