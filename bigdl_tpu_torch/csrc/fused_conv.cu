// Fused BatchNorm-apply + ReLU + 3x3 conv (pad 1, stride 1 or 2) + batch
// statistics (K4) for Hopper on the CUDA cores, forward only: the float32
// route, and the route of bfloat16 shapes whose C or N is not a multiple of
// 8 (the bf16 tensor-core route is fused_conv_sm90.cu).
//
// Replaces the Pallas kernel of bigdl_tpu/kernels/fused_conv.py `_cvfwd`
// (its backward, `_cv_bwd`, is plain XLA there and plain PyTorch here):
//
//   x_hat = relu(x * a + b)     (float32, rounded to x's type; the zero
//                                padding comes after it, so a padded tap
//                                contributes 0 and not relu(b))
//   z = conv3x3(x_hat, w)       (float32 sums, written in x's type)
//   s1 = sum z, s2 = sum z^2 per output channel (float32)
//
// over NHWC x (B, H, W, C) and HWIO w (3, 3, C, N), as an implicit GEMM:
// rows are output pixels (B * H2 * W2), the contraction runs over 9 C taps
// in the weight's (dy, dx, c) order, gathered from x as the tiles load.
//
// What bounds it on an H100: ResNet-50's 3x3 convs do 18 C N operations per
// output pixel against about (C / stride^2 + N) elements moved, far above
// the bf16 balance point, so the product bounds them. This kernel
// multiplies with float32 FMAs on the CUDA cores (fused_gemm.cuh) and is
// bound by those; the gather also recomputes each input pixel's prologue
// for each of the 9 taps that read it. What the design does: x_hat and the
// im2col matrix never reach device memory (the TPU kernel builds the
// (rows, 9 C) stack in VMEM), and BN2's statistics come from the float32
// sums in the epilogue, summed across blocks in a second pass.
#include "fused_gemm.cuh"

using namespace bigdl_fg;

namespace {

template <typename T>
cudaError_t fwd(const void* x, const void* w, const float* a, const float* b, void* z,
                float* part1, float* part2, float* s1, float* s2, int B, int H, int W, int C,
                int N, int stride, int stats, cudaStream_t s) {
  const int H2 = (H + stride - 1) / stride;
  const int W2 = (W + stride - 1) / stride;
  const int M = B * H2 * W2;
  Im2col<T> fa{static_cast<const T*>(x), a, b, H, W, C, H2, W2, stride};
  ColsOf<T> fb{static_cast<const T*>(w), N};
  StoreZ<T> epi{static_cast<T*>(z), N, stats};
  cudaError_t e = gemm<true, false, true>(fa, fb, epi, M, N, 9 * C, 9 * C, 1,
                                          stats ? part1 : nullptr, part2, s);
  if (e != cudaSuccess || !stats) return e;
  const int nm = (M + kBM - 1) / kBM;
  if ((e = sum_rows<float>(part1, nm, N, s1, s)) != cudaSuccess) return e;
  return sum_rows<float>(part2, nm, N, s2, s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, w, z share it; a, b, s1, s2 are float32);
// part1/part2 hold ceil(B * H2 * W2 / 128) x N float32 partial sums.
extern "C" int bigdl_fused_conv_fwd(const void* x, const void* w, const float* a,
                                    const float* b, void* z, float* part1, float* part2,
                                    float* s1, float* s2, int dtype, int B, int H, int W, int C,
                                    int N, int stride, int stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd<float>(x, w, a, b, z, part1, part2, s1, s2, B, H, W, C, N, stride, stats, s);
  return fwd<__nv_bfloat16>(x, w, a, b, z, part1, part2, s1, s2, B, H, W, C, N, stride, stats,
                            s);
}
