// Fused BatchNorm-apply + ReLU + 3x3 conv (pad 1, stride 1 or 2) + batch
// statistics (K4) for Hopper, float32, on the tensor cores in 3xTF32,
// forward only.
//
// Replaces, for float32 inputs whose C is a multiple of 32 and N a multiple
// of 4, the Pallas kernel of bigdl_tpu/kernels/fused_conv.py `_cvfwd` (its
// backward, `_cv_bwd`, is plain XLA there and plain PyTorch here). It
// computes what fused_conv.cu computes (that file's note gives the
// formulas; it stays the route of the other float32 shapes), with the same
// C entry arguments and one more, the scratch of the split weight: an
// implicit GEMM over NHWC x (B, H, W, C) and HWIO w (3, 3, C, N) whose rows
// are output pixels and whose contraction runs over the 9 C (tap, channel)
// pairs in the weight's row order.
//
// What bounds it on an H100: ResNet-50's 3x3 convs do 18 C N operations per
// output pixel against about (C / stride^2 + N) float32 elements moved;
// 3xTF32 runs three tf32 products for each (495 TF/s dense, so 165 TF/s of
// float32 work, a balance point near 50 operations per byte), and every
// ResNet-50 shape is far above it: the tensor cores bound it. The CUDA-core
// route is capped by 67 TF/s of float32 FMA. What the design does
// (fused_gemm_tf32_sm90.cuh's rs_kernel, the K3 forward's kernel, with a
// 3x3 gather as its A operand): the weight is split once a call into tf32
// hi and lo halves of w^T (N x 9 C, K-major: tf32 wgmma takes no
// transpose) by split_w_kernel, which TMA streams into a swizzled ring;
// each 32-deep chunk of the contraction is one tap and 32 channels (C % 32
// == 0), whose shifted input pixels each consumer thread copies with
// 16-byte cp.async two chunks ahead (it works out once a tile which of the
// 9 taps of its copy rows lie inside the image; the 9 reads of a pixel
// come from L2, not device memory); the consumers apply the BatchNorm
// prologue and ReLU in float32 in the plain version's rounding order to
// their fragment values, split them and feed wgmma's register A operand
// while the previous chunk's products run. A tap in the zero padding gives
// 0 after the prologue, not relu(b): the copying thread leaves a flag per
// row beside the chunk's parameters, and the conversion masks by it. Stride
// 2 is the same gather with other indices. Each chunk's products are
// promoted into the float32 sum; z leaves through a staging tile and TMA
// stores; the statistics come from the float32 accumulators, one partial
// per 64 rows, summed in a fixed order (no atomics: reruns agree bit for
// bit).
#include "fused_gemm_tf32_sm90.cuh"

namespace bigdl_fg {
namespace sm90 {
namespace tf32 {
namespace {

// x_hat = relu(x * a + b) of NHWC x seen through a 3x3 conv (pad 1, stride
// 1 or 2): row m is output pixel (b, oh, ow), column kk = tap * C + c. A
// chunk (32 columns) is one tap. The slot's parameter area holds the
// chunk's a and b (32 floats each) and, at prm + 256, one flag per row of
// the warpgroup's 64: 1 when the tap of that row lies inside the image.
struct XHatConvF {
  static constexpr int kTiles = 1;
  static constexpr bool kStoreA = false;
  const float* x;
  const float* a;
  const float* b;
  int rows, C, H, W, H2, W2, stride;
  // the first copy row, and for each copy row the element offset of its
  // tap-0 pixel and bit t set when tap t lies inside the image (0 past the
  // end)
  struct State {
    int ir0;
    int ibase[4];
    uint32_t itm[4];
  };

  __device__ __forceinline__ void geometry(int r, int& base, uint32_t& tm) const {
    base = 0;
    tm = 0;
    if (r >= rows) return;
    const int hw = H2 * W2;
    const int bi = r / hw;
    const int rem = r - bi * hw;
    const int oh = rem / W2;
    const int ow = rem - oh * W2;
    const int ih = oh * stride - 1;
    const int iw = ow * stride - 1;
    base = ((bi * H + ih) * W + iw) * C;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int y = ih + t / 3, xx = iw + t % 3;
      if (y >= 0 && y < H && xx >= 0 && xx < W) tm |= 1u << t;
    }
  }
  __device__ __forceinline__ void issue_rows(State& st, int r0) const {
    st.ir0 = r0;
#pragma unroll
    for (int i = 0; i < 4; ++i) geometry(r0 + 16 * i, st.ibase[i], st.itm[i]);
  }
  __device__ __forceinline__ void issue(const State& st, uint8_t* raw, uint8_t* prm,
                                        int k0) const {
    const int lt = threadIdx.x % 128;
    const int u = lt & 7;
    const int tap = k0 / C;
    const int c = k0 - tap * C + 4 * u;
    const int off = ((tap / 3) * W + tap % 3) * C + c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = (st.itm[i] >> tap) & 1u;
      const int e = st.ibase[i] + off;
      cp_async16(raw + swz((lt >> 3) + 16 * i, u), ok ? x + e : x, ok);
      if (u == 0) reinterpret_cast<float*>(prm + 256)[(lt >> 3) + 16 * i] = ok ? 1.f : 0.f;
    }
    if (lt < 8) {
      unit_params4(prm + 16 * u, a, c, true, 1.f);
      unit_params4(prm + 128 + 16 * u, b, c, true, 0.f);
    }
  }
  __device__ __forceinline__ void convert(const State&, uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4], uint8_t* raw,
                                          const uint8_t* prm) const {
    const float in0 = lds_f(prm + 256 + 4 * frag_row(0));
    const float in1 = lds_f(prm + 256 + 4 * frag_row(1));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = frag_col(kk, e);
        const float v = relu_f(affine(lds_f(raw + swz4(frag_row(e), c)), lds_f(prm + 4 * c),
                                      lds_f(prm + 128 + 4 * c)));
        split((e & 1 ? in1 : in0) != 0.f ? v : 0.f, hi[kk][e], lo[kk][e]);
      }
  }
};

cudaError_t conv_fwd(const void* x, const void* w, const float* a, const float* b, void* z,
                     float* part1, float* part2, float* s1, float* s2, int B, int H, int W, int C,
                     int N, int stride, int stats, float* wsplit, cudaStream_t s) {
  const int H2 = (H + stride - 1) / stride;
  const int W2 = (W + stride - 1) / stride;
  const int M = B * H2 * W2;
  // B of z = x_hat w: w^T (N, 9 C), hi and lo
  float* whi = wsplit;
  float* wlo = wsplit + (size_t)9 * C * N;
  cudaError_t e = split_w(w, whi, wlo, 9 * C, N, true, s);
  if (e != cudaSuccess) return e;
  XHatConvF aop{};
  aop.x = static_cast<const float*>(x);
  aop.a = a;
  aop.b = b;
  aop.rows = M;
  aop.C = C;
  aop.H = H;
  aop.W = W;
  aop.H2 = H2;
  aop.W2 = W2;
  aop.stride = stride;
  e = gemm(whi, wlo, z, aop, StoreZ2{}, M, N, 9 * C, stats ? part1 : nullptr, part2, s);
  if (e != cudaSuccess || !stats) return e;
  const int nm = (M + kPartRows - 1) / kPartRows;
  if ((e = sum_rows<float>(part1, nm, N, s1, s)) != cudaSuccess) return e;
  return sum_rows<float>(part2, nm, N, s2, s);
}

}  // namespace
}  // namespace tf32
}  // namespace sm90
}  // namespace bigdl_fg

// The arguments of fused_conv.cu's entry point, then wsplit: 2 x 9 C x N
// float32 of scratch for the split weight. dtype must be 0 (float32), C a
// multiple of 32, N of 4, x and w 16-byte aligned; part1/part2 hold
// ceil(B * H2 * W2 / 64) x N float32 partial sums.
extern "C" int bigdl_fused_conv_tf32_sm90_fwd(const void* x, const void* w, const float* a,
                                              const float* b, void* z, float* part1,
                                              float* part2, float* s1, float* s2, int dtype,
                                              int B, int H, int W, int C, int N, int stride,
                                              int stats, void* stream, float* wsplit) {
  if (dtype != 0 || C % 32 != 0 || N % 4 != 0 || (stride != 1 && stride != 2))
    return cudaErrorInvalidValue;
  return bigdl_fg::sm90::tf32::conv_fwd(x, w, a, b, z, part1, part2, s1, s2, B, H, W, C, N,
                                        stride, stats, wsplit,
                                        static_cast<cudaStream_t>(stream));
}
