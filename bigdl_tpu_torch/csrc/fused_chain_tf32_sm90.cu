// Cross-layer fused residual junction + next 1x1 conv + batch statistics
// (K5) for Hopper, float32, on the tensor cores in 3xTF32.
//
// Replaces, for float32 inputs whose K and N are multiples of 4, the Pallas
// kernels of bigdl_tpu/kernels/fused_chain.py: `_cfwd` (forward) and `_cbwd`
// (the dz/dr/da/db kernel and the dw kernel). It computes what
// fused_chain.cu computes (that file's note gives the formulas; it stays the
// route of the other float32 shapes), with the same C entry arguments and
// one more, the scratch of the split weight.
//
// What bounds it on an H100: the junction is the widest activation of a
// stage (K = 4 N). The forward does 2 K N operations per pixel against 3 K +
// N float32 elements moved (z and r read, h and zo written): 10-80
// operations per byte at ResNet-50's widths, about the 3xTF32 balance point
// (~50) at most, so it is bound by memory (3.35 TB/s) at stages 0-2; the
// backward moves 5 K + 2 N elements per pixel for twice the operations and
// is bound by memory too. What the design does (fused_gemm_tf32_sm90.cuh):
// the weight split once a call into tf32 hi and lo halves, K-major, and
// streamed by TMA; z and r copied raw by 16-byte cp.async two chunks ahead
// with the chunk's a and b beside them; h = relu(z a + b + r) made in
// float32 in the consumers' registers, split into hi and lo as wgmma's A
// operand, and written over the raw z tile it came from, from where the
// tiles of column tile 0 store it by TMA: h is written once and never read
// back; zo and its statistics leave through the staging tile. The
// backward's dx is K3's: dzo_eff made in registers, the weight K-major as
// stored, and an epilogue that rebuilds the ReLU mask from z and r and
// writes dz, then dr through the same staging tile, with da / db reduced to
// one partial per 64 rows. dw = h^T dzo_eff is the split contraction over
// the pixels with z, r, dzo and zo staged by TMA, h^T made in registers and
// dzo_eff written transposed in shared memory. No atomics: reruns agree bit
// for bit.
#include "fused_gemm_tf32_sm90.cuh"

namespace bigdl_fg {
namespace sm90 {
namespace tf32 {
namespace {

cudaError_t fwd(const void* z, const void* r, const float* a, const float* b, const void* w,
                void* h, void* zo, float* part1, float* part2, float* s1, float* s2, int M,
                int K, int N, int stats, float* wsplit, cudaStream_t s) {
  // B of zo = h w: w^T (N, K), hi and lo
  float* whi = wsplit;
  float* wlo = wsplit + (size_t)K * N;
  cudaError_t e = split_w(w, whi, wlo, K, N, true, s);
  if (e != cudaSuccess) return e;
  ResidF<> aop{};
  aop.z = static_cast<const float*>(z);
  aop.r = static_cast<const float*>(r);
  aop.a = a;
  aop.b = b;
  aop.rows = M;
  aop.ld = K;
  e = gemm(whi, wlo, zo, aop, StoreZ2{}, M, N, K, stats ? part1 : nullptr, part2, s, h);
  if (e != cudaSuccess || !stats) return e;
  const int nm = (M + kPartRows - 1) / kPartRows;
  if ((e = sum_rows<float>(part1, nm, N, s1, s)) != cudaSuccess) return e;
  return sum_rows<float>(part2, nm, N, s2, s);
}

cudaError_t bwd(const void* z, const void* r, const float* a, const float* b, const void* w,
                const void* dh, const void* dzo, const void* zo, const float* ds1,
                const float* ds2, void* dz, void* dr, void* dw, float* ws, float* part1,
                float* part2, float* da, float* db, int M, int K, int N, int stats, int splits,
                int rows_per_split, float* wsplit, cudaStream_t s) {
  // dz, dr (M, K) from dzo_eff (M, N) . w (K, N)^T, with the ReLU mask, a,
  // da, db; the B of dx is w^T, K-major as w is stored
  float* whi = wsplit;
  float* wlo = wsplit + (size_t)K * N;
  cudaError_t e = split_w(w, whi, wlo, K, N, false, s);
  if (e != cudaSuccess) return e;
  DzEffF<> aop{};
  aop.dz = static_cast<const float*>(dzo);
  aop.z = static_cast<const float*>(zo);
  aop.ds1 = ds1;
  aop.ds2 = ds2;
  aop.rows = M;
  aop.ld = N;
  aop.stats = stats;
  ChainDxEpi2<float> epi{static_cast<const float*>(z), static_cast<const float*>(r),
                         static_cast<const float*>(dh), a, b, K};
  e = gemm(whi, wlo, dz, aop, epi, M, K, N, part1, part2, s, dr);
  if (e != cudaSuccess) return e;
  const int nm = (M + kPartRows - 1) / kPartRows;
  if ((e = sum_rows<float>(part1, nm, K, da, s)) != cudaSuccess) return e;
  if ((e = sum_rows<float>(part2, nm, K, db, s)) != cudaSuccess) return e;
  // dw (K, N) = h^T (K, M) . dzo_eff (M, N), h rebuilt from z and r, split
  // over M, then summed
  e = gemm_dw<true>(z, dzo, zo, a, b, ds1, ds2, ws, M, K, N, 1, 1, stats, splits,
                    rows_per_split, s, r);
  if (e != cudaSuccess) return e;
  return sum_rows<float>(ws, 2 * splits, K * N, static_cast<float*>(dw), s);
}

}  // namespace
}  // namespace tf32
}  // namespace sm90
}  // namespace bigdl_fg

// The arguments of fused_chain.cu's entry points, then wsplit: 2 x K x N
// float32 of scratch for the split weight. dtype must be 0 (float32), K and
// N multiples of 4, and z, r, w 16-byte aligned; part1/part2 hold
// ceil(M / 64) x N float32 partial sums.
extern "C" int bigdl_fused_chain_tf32_sm90_fwd(const void* z, const void* r, const float* a,
                                               const float* b, const void* w, void* h, void* zo,
                                               float* part1, float* part2, float* s1, float* s2,
                                               int dtype, int M, int K, int N, int stats,
                                               void* stream, float* wsplit) {
  if (dtype != 0 || K % 4 != 0 || N % 4 != 0) return cudaErrorInvalidValue;
  return bigdl_fg::sm90::tf32::fwd(z, r, a, b, w, h, zo, part1, part2, s1, s2, M, K, N, stats,
                                   wsplit, static_cast<cudaStream_t>(stream));
}

// ws holds 2 x splits x K x N float32 partials of dw (rows_per_split a
// multiple of 64); part1/part2 ceil(M / 64) x K.
extern "C" int bigdl_fused_chain_tf32_sm90_bwd(const void* z, const void* r, const float* a,
                                               const float* b, const void* w, const void* dh,
                                               const void* dzo, const void* zo, const float* ds1,
                                               const float* ds2, void* dz, void* dr, void* dw,
                                               float* ws, float* part1, float* part2, float* da,
                                               float* db, int dtype, int M, int K, int N,
                                               int stats, int splits, int rows_per_split,
                                               void* stream, float* wsplit) {
  if (dtype != 0 || K % 4 != 0 || N % 4 != 0 || rows_per_split % 64 != 0)
    return cudaErrorInvalidValue;
  return bigdl_fg::sm90::tf32::bwd(z, r, a, b, w, dh, dzo, zo, ds1, ds2, dz, dr, dw, ws, part1,
                                   part2, da, db, M, K, N, stats, splits, rows_per_split, wsplit,
                                   static_cast<cudaStream_t>(stream));
}
