// Cross-layer fused residual junction + next 1x1 conv + batch statistics (K5)
// for Hopper: the ragged routes, the shapes outside the aligned tensor-core
// rules of fused_chain_sm90.cu (bf16, K and N multiples of 8) and
// fused_chain_tf32_sm90.cu (float32, K and N multiples of 4). Both dtypes
// run those files' kernels with the cores' ragged load / store policy (RG =
// true), at any K and N:
// - float32 (route f32): 3xTF32 wgmma on fused_gemm_tf32_sm90.cuh;
// - bfloat16 (route bf16_ragged): bf16 wgmma on fused_gemm_sm90.cuh.
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
// stage; the forward does 2 K N operations per pixel against 3 K + N
// elements moved (z and r read, h and zo written), the backward twice the
// operations against 5 K + 2 N, so both are bound by memory at ResNet-like
// widths in either dtype, as on the aligned routes. What the design does:
// the aligned routes' kernels with the ragged policy (the cores' notes): z
// and r come by 4-byte copies into the swizzled ring (bf16 rows of odd
// length by 2-byte loads); h = relu(z a + b + r) is made in registers as
// the A operand and stored once (column tile 0) from the converted tile by
// coalesced predicated stores, never read back; the weight is prepared once
// a call (float32: split hi / lo halves, the contraction zero-padded to a
// whole stage; bf16: rows zero-padded to 8) and streams by TMA; zo, dz and
// dr leave from the staging tile by predicated stores; the backward
// rebuilds h and the ReLU mask from z and r; the column sums, da / db and
// the split-K weight gradient are summed in fixed-order second passes (no
// atomics: reruns agree bit for bit).
#include "fused_gemm_tf32_sm90.cuh"

namespace bigdl_fg {
namespace sm90 {
namespace {

// bfloat16 at any K and N: fused_chain_sm90.cu's kernels with RG, w (K, N)
// read from its copy with rows of pad8(N) by both products
cudaError_t fwd_bf16(const void* z, const void* r, const float* a, const float* b, const void* w,
                     void* h, void* zo, float* part1, float* part2, float* s1, float* s2, int M,
                     int K, int N, int stats, void* wpad, cudaStream_t s) {
  cudaError_t e = pad_cols(w, wpad, K, N, s);
  if (e != cudaSuccess) return e;
  ResidA<true> aop{};
  aop.z = static_cast<const bf16*>(z);
  aop.r = static_cast<const bf16*>(r);
  aop.a = a;
  aop.b = b;
  aop.rows = M;
  aop.ld = K;
  e = gemm_rs<128, 1, true>(wpad, zo, aop, StoreZ2{}, M, N, K, stats ? part1 : nullptr, part2,
                            s, h);
  if (e != cudaSuccess || !stats) return e;
  const int nm = (M + kPartRows - 1) / kPartRows;
  if ((e = sum_rows<float>(part1, nm, N, s1, s)) != cudaSuccess) return e;
  return sum_rows<float>(part2, nm, N, s2, s);
}

cudaError_t bwd_bf16(const void* z, const void* r, const float* a, const float* b, const void* w,
                     const void* dh, const void* dzo, const void* zo, const float* ds1,
                     const float* ds2, void* dz, void* dr, void* dw, float* ws, float* part1,
                     float* part2, float* da, float* db, int M, int K, int N, int stats,
                     int splits, int rows_per_split, void* wpad, cudaStream_t s) {
  // dz, dr (M, K) from dzo_eff (M, N) . w (K, N)^T, with the ReLU mask, a,
  // da, db
  cudaError_t e = pad_cols(w, wpad, K, N, s);
  if (e != cudaSuccess) return e;
  DzEffA<true> aop{};
  aop.dz = static_cast<const bf16*>(dzo);
  aop.z = static_cast<const bf16*>(zo);
  aop.ds1 = ds1;
  aop.ds2 = ds2;
  aop.rows = M;
  aop.ld = N;
  aop.stats = stats;
  ChainDxEpi2<bf16, true> epi{static_cast<const bf16*>(z), static_cast<const bf16*>(r),
                              static_cast<const bf16*>(dh), a, b, K};
  e = gemm_rs<128, 0, true>(wpad, dz, aop, epi, M, K, N, part1, part2, s, dr);
  if (e != cudaSuccess) return e;
  const int nm = (M + kPartRows - 1) / kPartRows;
  if ((e = sum_rows<float>(part1, nm, K, da, s)) != cudaSuccess) return e;
  if ((e = sum_rows<float>(part2, nm, K, db, s)) != cudaSuccess) return e;
  // dw (K, N) = h^T (K, M) . dzo_eff (M, N), h rebuilt from z and r, split
  // over M, then summed
  e = gemm_dw<true, true>(z, dzo, zo, a, b, ds1, ds2, ws, M, K, N, 1, 1, stats, splits,
                          rows_per_split, s, r);
  if (e != cudaSuccess) return e;
  return sum_rows<bf16>(ws, 2 * splits, K * N, static_cast<bf16*>(dw), s);
}

}  // namespace

namespace tf32 {
namespace {

// float32 at any K and N: fused_chain_tf32_sm90.cu's kernels with RG
cudaError_t fwd_f32(const void* z, const void* r, const float* a, const float* b, const void* w,
                    void* h, void* zo, float* part1, float* part2, float* s1, float* s2, int M,
                    int K, int N, int stats, float* wsplit, cudaStream_t s) {
  // B of zo = h w: w^T (N, kpad(K)), hi and lo
  float* whi = wsplit;
  float* wlo = wsplit + (size_t)N * kpad(K);
  cudaError_t e = split_w(w, whi, wlo, K, N, true, s, true);
  if (e != cudaSuccess) return e;
  ResidF<true> aop{};
  aop.z = static_cast<const float*>(z);
  aop.r = static_cast<const float*>(r);
  aop.a = a;
  aop.b = b;
  aop.rows = M;
  aop.ld = K;
  e = gemm<true>(whi, wlo, zo, aop, StoreZ2{}, M, N, K, stats ? part1 : nullptr, part2, s, h);
  if (e != cudaSuccess || !stats) return e;
  const int nm = (M + kPartRows - 1) / kPartRows;
  if ((e = sum_rows<float>(part1, nm, N, s1, s)) != cudaSuccess) return e;
  return sum_rows<float>(part2, nm, N, s2, s);
}

cudaError_t bwd_f32(const void* z, const void* r, const float* a, const float* b, const void* w,
                    const void* dh, const void* dzo, const void* zo, const float* ds1,
                    const float* ds2, void* dz, void* dr, void* dw, float* ws, float* part1,
                    float* part2, float* da, float* db, int M, int K, int N, int stats,
                    int splits, int rows_per_split, float* wsplit, cudaStream_t s) {
  // dz, dr (M, K) from dzo_eff (M, N) . w (K, N)^T: its B is w (K, kpad(N))
  float* whi = wsplit;
  float* wlo = wsplit + (size_t)K * kpad(N);
  cudaError_t e = split_w(w, whi, wlo, K, N, false, s, true);
  if (e != cudaSuccess) return e;
  DzEffF<true> aop{};
  aop.dz = static_cast<const float*>(dzo);
  aop.z = static_cast<const float*>(zo);
  aop.ds1 = ds1;
  aop.ds2 = ds2;
  aop.rows = M;
  aop.ld = N;
  aop.stats = stats;
  ChainDxEpi2<float, true> epi{static_cast<const float*>(z), static_cast<const float*>(r),
                               static_cast<const float*>(dh), a, b, K};
  e = gemm<true>(whi, wlo, dz, aop, epi, M, K, N, part1, part2, s, dr);
  if (e != cudaSuccess) return e;
  const int nm = (M + kPartRows - 1) / kPartRows;
  if ((e = sum_rows<float>(part1, nm, K, da, s)) != cudaSuccess) return e;
  if ((e = sum_rows<float>(part2, nm, K, db, s)) != cudaSuccess) return e;
  // dw (K, N) = h^T (K, M) . dzo_eff (M, N), h rebuilt from z and r, split
  // over M, then summed
  e = gemm_dw<true, true>(z, dzo, zo, a, b, ds1, ds2, ws, M, K, N, 1, 1, stats, splits,
                          rows_per_split, s, r);
  if (e != cudaSuccess) return e;
  return sum_rows<float>(ws, 2 * splits, K * N, static_cast<float*>(dw), s);
}

}  // namespace
}  // namespace tf32
}  // namespace sm90
}  // namespace bigdl_fg

using namespace bigdl_fg;

// dtype: 0 float32, 1 bfloat16 (z, r, w, h, zo share it; a, b, s1, s2
// float32); part1/part2 hold ceil(M / 64) x N float32 partial sums; wsplit
// the weight's scratch: float32 2 x N x kpad(K) float32 (its split halves,
// kpad: K rounded up to 32), bf16 K x pad8(N) bf16 (its padded copy).
extern "C" int bigdl_fused_chain_fwd(const void* z, const void* r, const float* a,
                                     const float* b, const void* w, void* h, void* zo,
                                     float* part1, float* part2, float* s1, float* s2,
                                     int dtype, int M, int K, int N, int stats, void* stream,
                                     float* wsplit) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return sm90::tf32::fwd_f32(z, r, a, b, w, h, zo, part1, part2, s1, s2, M, K, N, stats,
                               wsplit, s);
  return sm90::fwd_bf16(z, r, a, b, w, h, zo, part1, part2, s1, s2, M, K, N, stats, wsplit, s);
}

// z, r, w, dh, dzo, zo, dz, dr, dw in dtype; a, b, ds1, ds2, da, db float32;
// ws holds 2 x splits x K x N float32 partials of dw (rows_per_split a
// multiple of 64 for float32, 128 for bf16); part1/part2 ceil(M / 64) x K;
// wsplit float32 2 x K x kpad(N) float32, bf16 K x pad8(N) bf16.
extern "C" int bigdl_fused_chain_bwd(const void* z, const void* r, const float* a,
                                     const float* b, const void* w, const void* dh,
                                     const void* dzo, const void* zo, const float* ds1,
                                     const float* ds2, void* dz, void* dr, void* dw, float* ws,
                                     float* part1, float* part2, float* da, float* db,
                                     int dtype, int M, int K, int N, int stats, int splits,
                                     int rows_per_split, void* stream, float* wsplit) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_per_split % (dtype == 0 ? 64 : 128) != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return sm90::tf32::bwd_f32(z, r, a, b, w, dh, dzo, zo, ds1, ds2, dz, dr, dw, ws, part1,
                               part2, da, db, M, K, N, stats, splits, rows_per_split, wsplit, s);
  return sm90::bwd_bf16(z, r, a, b, w, dh, dzo, zo, ds1, ds2, dz, dr, dw, ws, part1, part2, da,
                        db, M, K, N, stats, splits, rows_per_split, wsplit, s);
}
