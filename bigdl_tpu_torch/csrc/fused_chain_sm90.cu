// Cross-layer fused residual junction + next 1x1 conv + batch statistics
// (K5) for Hopper, bfloat16, on the tensor cores.
//
// Replaces, for bf16 inputs whose K and N are multiples of 8, the Pallas
// kernels of bigdl_tpu/kernels/fused_chain.py: `_cfwd` (forward) and `_cbwd`
// (the dz/dr/da/db kernel and the dw kernel). It computes what
// fused_chain.cu computes (that file's note gives the formulas; it stays the
// route of bf16 shapes outside that rule and of float32 shapes outside the
// 3xTF32 rule), with the same C entry points and arguments.
//
// What bounds it on an H100: the junction is the widest activation of a
// stage (K = 4 N). The forward does 2 K N operations per pixel against 3 K
// + N bf16 elements moved (z and r read, h and zo written): 40-170
// operations per byte at ResNet-50's widths, under the card's ~295, so it
// is bound by memory (3.35 TB/s) at every stage; the backward moves 5 K + 2
// N elements per pixel for twice the operations and is bound by memory too.
// What the design does (fused_gemm_sm90.cuh): bf16 wgmma with float32
// accumulators in registers; the weight through TMA into a swizzled ring;
// z and r copied raw by 16-byte cp.async two chunks ahead with the chunk's
// a and b beside them, h = relu(z a + b + r) made in the consumers'
// registers as wgmma's A operand (ResidA) and written once, by the tiles of
// column tile 0, from the converted fragments through stmatrix and a TMA
// store, never read back; zo and its statistics leave through the staging
// tile. The backward's dx is K3's: dzo_eff made in registers (DzEffA), the
// weight K-major, and an epilogue (ChainDxEpi2) that rebuilds the ReLU mask
// from z and r and writes dz, then dr through the same staging tile, with
// da / db reduced to one partial per 64 rows. dw = h^T dzo_eff is the split
// contraction over the pixels with z, r, dzo and zo staged by TMA and both
// operands rewritten in place in shared memory. No atomics: reruns agree
// bit for bit.
#include "fused_gemm_sm90.cuh"

namespace bigdl_fg {
namespace sm90 {
namespace {

cudaError_t fwd(const void* z, const void* r, const float* a, const float* b, const void* w,
                void* h, void* zo, float* part1, float* part2, float* s1, float* s2, int M,
                int K, int N, int stats, cudaStream_t s) {
  ResidA<> aop{};
  aop.z = static_cast<const bf16*>(z);
  aop.r = static_cast<const bf16*>(r);
  aop.a = a;
  aop.b = b;
  aop.rows = M;
  aop.ld = K;
  cudaError_t e =
      gemm_rs<128, 1>(w, zo, aop, StoreZ2{}, M, N, K, stats ? part1 : nullptr, part2, s, h);
  if (e != cudaSuccess || !stats) return e;
  const int nm = (M + kPartRows - 1) / kPartRows;
  if ((e = sum_rows<float>(part1, nm, N, s1, s)) != cudaSuccess) return e;
  return sum_rows<float>(part2, nm, N, s2, s);
}

cudaError_t bwd(const void* z, const void* r, const float* a, const float* b, const void* w,
                const void* dh, const void* dzo, const void* zo, const float* ds1,
                const float* ds2, void* dz, void* dr, void* dw, float* ws, float* part1,
                float* part2, float* da, float* db, int M, int K, int N, int stats, int splits,
                int rows_per_split, cudaStream_t s) {
  // dz, dr (M, K) from dzo_eff (M, N) . w (K, N)^T, with the ReLU mask, a,
  // da, db
  DzEffA<> aop{};
  aop.dz = static_cast<const bf16*>(dzo);
  aop.z = static_cast<const bf16*>(zo);
  aop.ds1 = ds1;
  aop.ds2 = ds2;
  aop.rows = M;
  aop.ld = N;
  aop.stats = stats;
  ChainDxEpi2<bf16> epi{static_cast<const bf16*>(z), static_cast<const bf16*>(r),
                  static_cast<const bf16*>(dh), a, b, K};
  cudaError_t e = gemm_rs<128, 0>(w, dz, aop, epi, M, K, N, part1, part2, s, dr);
  if (e != cudaSuccess) return e;
  const int nm = (M + kPartRows - 1) / kPartRows;
  if ((e = sum_rows<float>(part1, nm, K, da, s)) != cudaSuccess) return e;
  if ((e = sum_rows<float>(part2, nm, K, db, s)) != cudaSuccess) return e;
  // dw (K, N) = h^T (K, M) . dzo_eff (M, N), h rebuilt from z and r, split
  // over M, then summed
  e = gemm_dw<true>(z, dzo, zo, a, b, ds1, ds2, ws, M, K, N, 1, 1, stats, splits,
                    rows_per_split, s, r);
  if (e != cudaSuccess) return e;
  return sum_rows<bf16>(ws, 2 * splits, K * N, static_cast<bf16*>(dw), s);
}

}  // namespace
}  // namespace sm90
}  // namespace bigdl_fg

// The arguments of fused_chain.cu's entry points; dtype must be 1
// (bfloat16), K and N multiples of 8, and z, r, w, h, zo 16-byte aligned;
// part1/part2 hold ceil(M / 64) x N float32 partial sums.
extern "C" int bigdl_fused_chain_sm90_fwd(const void* z, const void* r, const float* a,
                                          const float* b, const void* w, void* h, void* zo,
                                          float* part1, float* part2, float* s1, float* s2,
                                          int dtype, int M, int K, int N, int stats,
                                          void* stream) {
  if (dtype != 1 || K % 8 != 0 || N % 8 != 0) return cudaErrorInvalidValue;
  return bigdl_fg::sm90::fwd(z, r, a, b, w, h, zo, part1, part2, s1, s2, M, K, N, stats,
                             static_cast<cudaStream_t>(stream));
}

// ws holds 2 x splits x K x N float32 partials of dw (rows_per_split a
// multiple of 128); part1/part2 ceil(M / 64) x K.
extern "C" int bigdl_fused_chain_sm90_bwd(const void* z, const void* r, const float* a,
                                          const float* b, const void* w, const void* dh,
                                          const void* dzo, const void* zo, const float* ds1,
                                          const float* ds2, void* dz, void* dr, void* dw,
                                          float* ws, float* part1, float* part2, float* da,
                                          float* db, int dtype, int M, int K, int N, int stats,
                                          int splits, int rows_per_split, void* stream) {
  if (dtype != 1 || K % 8 != 0 || N % 8 != 0 || rows_per_split % 128 != 0)
    return cudaErrorInvalidValue;
  return bigdl_fg::sm90::bwd(z, r, a, b, w, dh, dzo, zo, ds1, ds2, dz, dr, dw, ws, part1, part2,
                             da, db, M, K, N, stats, splits, rows_per_split,
                             static_cast<cudaStream_t>(stream));
}
