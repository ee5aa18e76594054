// Fused BatchNorm-apply + ReLU + 3x3 conv (pad 1, stride 1 or 2) + batch
// statistics (K4) for Hopper, bfloat16, on the tensor cores, forward only.
//
// Replaces, for bf16 inputs whose C and N are multiples of 8, the Pallas
// kernel of bigdl_tpu/kernels/fused_conv.py `_cvfwd` (its backward,
// `_cv_bwd`, is plain XLA there and plain PyTorch here). It computes what
// fused_conv.cu computes (that file's note gives the formulas; it stays
// the float32 route and the route of bf16 shapes outside that rule), with
// the same C entry point and arguments: an implicit GEMM over NHWC x (B, H,
// W, C) and HWIO w (3, 3, C, N) whose rows are output pixels and whose
// contraction runs over the 9 C (tap, channel) pairs in the weight's row
// order.
//
// What bounds it on an H100: ResNet-50's 3x3 convs do 18 C N operations per
// output pixel against about (C / stride^2 + N) elements moved, so the
// bytes alone would allow 0.06-0.08 ms a call at B256 and the tensor cores
// bound them only a little less (989 TF/s). What the design does
// (fused_gemm_sm90.cuh, the K3 forward's kernel with a 3x3 gather, 128 x
// 64 or 128 x 128 tiles): the weight through TMA into a swizzled ring; each
// consumer thread works out the image position of its copy rows once a
// tile (which of the 9 taps fall inside the image), then copies for every
// 64-deep chunk of the contraction (one tap, 64 channels) the shifted input
// pixels with 16-byte cp.async two chunks ahead (the 9 reads of a pixel
// come from L2, not from device memory); it reads its A fragments back with
// ldmatrix, applies the BatchNorm prologue and ReLU in registers and feeds
// wgmma's register A operand while the previous chunk's product runs. A tap
// in the zero padding gives 0 after the prologue, not relu(b): it is masked
// by index. Stride 2 is the same gather with other indices. The statistics
// come from the float32 accumulators, one partial per 64 rows, summed in a
// fixed order.
#include "fused_gemm_sm90.cuh"

namespace bigdl_fg {
namespace sm90 {
namespace {

cudaError_t conv_fwd(const void* x, const void* w, const float* a, const float* b, void* z,
                     float* part1, float* part2, float* s1, float* s2, int B, int H, int W, int C,
                     int N, int stride, int stats, cudaStream_t s) {
  const int H2 = (H + stride - 1) / stride;
  const int W2 = (W + stride - 1) / stride;
  const int M = B * H2 * W2;
  XHatA<9> aop{};
  aop.x = static_cast<const bf16*>(x);
  aop.a = a;
  aop.b = b;
  aop.rows = M;
  aop.C = C;
  aop.H = H;
  aop.W = W;
  aop.H2 = H2;
  aop.W2 = W2;
  aop.stride = stride;
  aop.relu = 1;
  cudaError_t e =
      gemm_rs<128, 1>(w, z, aop, StoreZ2{}, M, N, 9 * C, stats ? part1 : nullptr, part2, s);
  if (e != cudaSuccess || !stats) return e;
  const int nm = (M + kPartRows - 1) / kPartRows;
  if ((e = sum_rows<float>(part1, nm, N, s1, s)) != cudaSuccess) return e;
  return sum_rows<float>(part2, nm, N, s2, s);
}

}  // namespace
}  // namespace sm90
}  // namespace bigdl_fg

// The arguments of fused_conv.cu's entry point; dtype must be 1 (bfloat16),
// C and N multiples of 8, x and w 16-byte aligned; part1/part2 hold
// ceil(B * H2 * W2 / 128) x N float32 partial sums.
extern "C" int bigdl_fused_conv_sm90_fwd(const void* x, const void* w, const float* a,
                                         const float* b, void* z, float* part1, float* part2,
                                         float* s1, float* s2, int dtype, int B, int H, int W,
                                         int C, int N, int stride, int stats, void* stream) {
  if (dtype != 1 || C % 8 != 0 || N % 8 != 0 || (stride != 1 && stride != 2))
    return cudaErrorInvalidValue;
  return bigdl_fg::sm90::conv_fwd(x, w, a, b, z, part1, part2, s1, s2, B, H, W, C, N, stride,
                                  stats, static_cast<cudaStream_t>(stream));
}
