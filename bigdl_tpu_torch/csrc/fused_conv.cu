// Fused BatchNorm-apply + ReLU + 3x3 conv (pad 1, stride 1 or 2) + batch
// statistics (K4) for Hopper: the ragged routes, the shapes outside the
// aligned tensor-core rules of fused_conv_sm90.cu (bf16, C and N multiples
// of 8) and fused_conv_tf32_sm90.cu (float32, C a multiple of 32 and N of
// 4). Both dtypes run those files' kernels with the cores' ragged load /
// store policy (RG = true) and a ragged 3x3 gather, at any C and N:
// - float32 (route f32): 3xTF32 wgmma on fused_gemm_tf32_sm90.cuh;
// - bfloat16 (route bf16_ragged): bf16 wgmma on fused_gemm_sm90.cuh.
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
// rows are output pixels (B * H2 * W2), the contraction runs over the 9
// taps, tap-major, each tap's C channels padded with zeros to Cp (float32:
// C rounded up to 32, so that a 32-deep chunk is one tap; bf16: up to 8, so
// that an 8-channel unit is in one tap).
//
// What bounds it on an H100: a 3x3 conv does 18 C N operations per output
// pixel against about (C / stride^2 + N) elements moved, far above the
// balance point of 3xTF32 (~50 operations per byte) or bf16 (~295) at
// ResNet widths, so the tensor cores bound it, as on the aligned routes;
// the per-tap padding adds Cp / C of them (1.28x at C = 50, 2x at C = 16 in
// float32). What the design does: the aligned routes' kernels, rings,
// prologues, 3xTF32 split, promote and column sums (the cores' notes), with
// - the weight prepared once a call into weight-sized scratch, tap-major
//   with the padded channels' rows zero (float32: the tf32 hi and lo halves
//   of w^T, N rows of 9 Cp; bf16: a copy (9 Cp, N rounded up to 8)), which
//   TMA streams; no activation is copied or padded;
// - the gather: each consumer thread works out the image position of its
//   copy rows once a tile (which of the 9 taps lie inside the image) and
//   copies, for every chunk, the shifted input pixels' channels: 16 bytes a
//   thread where C * size is a 16-byte multiple (the aligned routes'
//   copies), else a small piece a lane - float32: two channels by 8-byte
//   cp.async where C is even, else one by 4-byte; bf16: a pair by 4-byte
//   cp.async where C is even, else by 2-byte loads - a warp reading a
//   row's neighbouring channels, the rows' positions passed between lanes
//   by shuffles; channels past C read 0, as do their prologue parameters, so
//   they give 0 after the prologue; a tap in the zero padding is masked to
//   0 after the prologue, as on the aligned routes;
// - z leaves by the ragged policy's predicated stores; the statistics come
//   from the float32 accumulators, one partial per 64 rows, summed in a
//   fixed order (no atomics: reruns agree bit for bit).
#include "fused_gemm_tf32_sm90.cuh"

namespace bigdl_fg {
namespace sm90 {
namespace {

// the padded channels of a tap: C rounded up to q
inline int pad_to(int c, int q) { return (c + q - 1) / q * q; }

// 8 bytes, zero-filled when !ok
__device__ __forceinline__ void cp_async8(uint8_t* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 8 : 0)
               : "memory");
}

// The row r's tap-0 pixel (element offset, 0 past the end) and its in-image
// taps (bit t), as the aligned routes' geometry computes them
__device__ __forceinline__ void conv_geometry(int r, int rows, int C, int H, int W, int H2,
                                              int W2, int stride, int& base, uint32_t& tm) {
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

// -- bfloat16: XHatA<9>'s conversion over a ragged gather ---------------------------

// x_hat of the 3x3 gather over taps of Cp = pad8(C) channels. With C a
// multiple of 8 (Cp = C) and a 16-byte aligned x, XHatA<9>'s own copies;
// otherwise thread lt copies the pair of columns k0 + 2 (lt % 32) (+ 1) of
// rows lt / 32 + 4 i, i < 16, whose tap-0 pixel and in-image taps lane l of
// the warp keeps for row lt / 32 + 4 (l % 16) (ibase[0], itm[0]). A unit's
// tap goes beside the parameters as XHatA<9>'s does, so its conversion
// (the prologue, then the mask of taps in the padding) is the same.
struct XHatConvA : XHatA<9> {
  int Cp;

  __device__ __forceinline__ bool wide() const {
    return !(C & 7) && !(reinterpret_cast<uintptr_t>(x) & 15);
  }
  __device__ __forceinline__ void issue_rows(State& st, int r0) const {
    if (wide()) return XHatA<9>::issue_rows(st, r0);
    st.ir0 = r0;
    const int lt = threadIdx.x % 128;
    conv_geometry(r0 - (lt >> 3) + (lt >> 5) + 4 * (lt & 15), rows, C, H, W, H2, W2, stride,
                  st.ibase[0], st.itm[0]);
  }
  __device__ __forceinline__ void issue(const State& st, uint8_t* raw, uint8_t* prm,
                                        int k0) const {
    if (wide()) return XHatA<9>::issue(st, raw, prm, k0);
    const int lt = threadIdx.x % 128;
    const int w = lt & 31;
    const int kc = k0 + 2 * w;  // this lane's pair
    const int tap = kc / Cp;
    const int c = kc - tap * Cp;
    const bool in = tap < 9 && c < C;
    const bool two = c + 1 < C;
    const int off = ((tap / 3) * W + tap % 3) * C + c;
    const int wo = 4 * (w & 3);
    if (!(C & 1) && !(reinterpret_cast<uintptr_t>(x) & 3)) {  // every pair 4-byte aligned
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int base = __shfl_sync(0xffffffffu, st.ibase[0], i);
        const uint32_t tm = __shfl_sync(0xffffffffu, st.itm[0], i);
        const bool ok = in && ((tm >> tap) & 1u);
        cp_async4(raw + swz((lt >> 5) + 4 * i, w >> 2) + wo, ok ? x + base + off : x, ok);
      }
    } else {  // odd C: every other row at an odd element address
      uint32_t v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int base = __shfl_sync(0xffffffffu, st.ibase[0], i);
        const uint32_t tm = __shfl_sync(0xffffffffu, st.itm[0], i);
        const bool ok = in && ((tm >> tap) & 1u);
        const unsigned short* q = reinterpret_cast<const unsigned short*>(x + base + off);
        v[i] = (ok ? uint32_t(__ldg(q)) : 0u) | ((ok && two ? uint32_t(__ldg(q + 1)) : 0u) << 16);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i)
        *reinterpret_cast<uint32_t*>(raw + swz((lt >> 5) + 4 * i, w >> 2) + wo) = v[i];
    }
    if (lt < 8) {  // unit lt's parameters (zeros from C on) and tap (31 past the taps)
      const int ku = k0 + 8 * lt;
      const int tu = ku / Cp;
      const int cu = ku - tu * Cp;
      const int ld = tu < 9 ? C : 0;
      unit_params_r(prm + 32 * lt, a, cu, ld, 1.f);
      unit_params_r(prm + 256 + 32 * lt, b, cu, ld, 0.f);
      reinterpret_cast<int*>(prm + 512)[lt] = tu < 9 ? tu : 31;
    }
  }
};

// out (9 Cp, np) bf16 = w (9 C, N) with each tap's rows c >= C and the
// columns n >= N zero
__global__ void __launch_bounds__(256)
    pad_taps_kernel(const bf16* __restrict__ w, bf16* __restrict__ out, int C, int Cp, int N,
                    int np) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= (size_t)9 * Cp * np) return;
  const int k = int(i / np), n = int(i % np);
  const int t = k / Cp, c = k - t * Cp;
  out[i] = c < C && n < N ? w[(size_t)(t * C + c) * N + n] : __float2bfloat16(0.f);
}

cudaError_t fwd_bf16(const void* x, const void* w, const float* a, const float* b, void* z,
                     float* part1, float* part2, float* s1, float* s2, int B, int H, int W, int C,
                     int N, int stride, int stats, void* wpad, cudaStream_t s) {
  const int H2 = (H + stride - 1) / stride;
  const int W2 = (W + stride - 1) / stride;
  const int M = B * H2 * W2;
  const int Cp = pad_to(C, 8);
  const size_t n = (size_t)9 * Cp * pad8(N);
  pad_taps_kernel<<<unsigned((n + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16*>(w), static_cast<bf16*>(wpad), C, Cp, N, pad8(N));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  XHatConvA aop{};
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
  aop.Cp = Cp;
  e = gemm_rs<128, 1, true>(wpad, z, aop, StoreZ2{}, M, N, 9 * Cp, stats ? part1 : nullptr,
                            part2, s);
  if (e != cudaSuccess || !stats) return e;
  const int nm = (M + kPartRows - 1) / kPartRows;
  if ((e = sum_rows<float>(part1, nm, N, s1, s)) != cudaSuccess) return e;
  return sum_rows<float>(part2, nm, N, s2, s);
}

}  // namespace

namespace tf32 {
namespace {

// -- float32: the 3xTF32 gather over taps of Cp = C rounded up to 32 -------------

// x_hat = relu(x * a + b) of NHWC x through the 3x3 conv: row m is output
// pixel (b, oh, ow), column kk = tap * Cp + c; a chunk (32 columns) is one
// tap. The slot's parameter area holds the chunk's a and b (32 floats each,
// zeros from C on) and, at prm + 256, one flag per row of the warpgroup's
// 64: 1 when the tap of that row lies inside the image. With C a multiple
// of 4 and a 16-byte aligned x the copies are the aligned route's (16
// bytes, unit lt % 8 of rows lt / 8 + 16 i, their geometry in ibase /
// itm); otherwise thread lt copies rows lt / 32 + 4 m, m < 16, whose
// geometry lane l keeps for m = l % 16 (ibase[0], itm[0]): with C even
// (rows of 8-byte multiples) the channel pair 2 (lt % 16) of rows m = 2 i +
// (lt % 32) / 16 by 8-byte copies, a warp two rows at a time; else channel
// lt % 32 of every row m by 4-byte copies.
struct XHatConvFR {
  static constexpr int kTiles = 1;
  static constexpr bool kStoreA = false;
  const float* x;
  const float* a;
  const float* b;
  int rows, C, Cp, H, W, H2, W2, stride;
  struct State {
    int ir0;
    int ibase[4];
    uint32_t itm[4];
  };

  __device__ __forceinline__ bool wide() const { return wide4(x, C); }
  __device__ __forceinline__ void geometry(int r, int& base, uint32_t& tm) const {
    conv_geometry(r, rows, C, H, W, H2, W2, stride, base, tm);
  }
  __device__ __forceinline__ void issue_rows(State& st, int r0) const {
    st.ir0 = r0;
    if (wide()) {
#pragma unroll
      for (int i = 0; i < 4; ++i) geometry(r0 + 16 * i, st.ibase[i], st.itm[i]);
    } else {
      const int lt = threadIdx.x % 128;
      geometry(r0 - (lt >> 3) + (lt >> 5) + 4 * (lt & 15), st.ibase[0], st.itm[0]);
    }
  }
  __device__ __forceinline__ void issue(const State& st, uint8_t* raw, uint8_t* prm,
                                        int k0) const {
    const int lt = threadIdx.x % 128;
    const int tap = k0 / Cp;
    const int c0 = k0 - tap * Cp;  // the chunk's first channel
    const int off = ((tap / 3) * W + tap % 3) * C;
    float* flag = reinterpret_cast<float*>(prm + 256);
    if (wide()) {
      const int u = lt & 7;
      const int c = c0 + 4 * u;
      const bool in = c < C;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool inside = (st.itm[i] >> tap) & 1u;
        const bool ok = in && inside;
        cp_async16(raw + swz((lt >> 3) + 16 * i, u), ok ? x + st.ibase[i] + off + c : x, ok);
        if (u == 0) flag[(lt >> 3) + 16 * i] = inside ? 1.f : 0.f;
      }
    } else if (!(C & 1) && !(reinterpret_cast<uintptr_t>(x) & 7)) {
      const int lane = lt & 31;
      const int c = c0 + 2 * (lane & 15);
      const bool in = c < C;  // (then c + 1 < C too)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = 2 * i + (lane >> 4);
        const int base = __shfl_sync(0xffffffffu, st.ibase[0], m);
        const uint32_t tm = __shfl_sync(0xffffffffu, st.itm[0], m);
        const bool inside = (tm >> tap) & 1u;
        const bool ok = in && inside;
        const int rl = (lt >> 5) + 4 * m;
        cp_async8(raw + swz4(rl, 2 * (lane & 15)), ok ? x + base + off + c : x, ok);
        if ((lane & 15) == 0) flag[rl] = inside ? 1.f : 0.f;
      }
    } else {
      const int lane = lt & 31;
      const int c = c0 + lane;
      const bool in = c < C;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int base = __shfl_sync(0xffffffffu, st.ibase[0], i);
        const uint32_t tm = __shfl_sync(0xffffffffu, st.itm[0], i);
        const bool inside = (tm >> tap) & 1u;
        const bool ok = in && inside;
        const int rl = (lt >> 5) + 4 * i;
        cp_async4(raw + swz4(rl, lane), ok ? x + base + off + c : x, ok);
        if (lane == 0) flag[rl] = inside ? 1.f : 0.f;
      }
    }
    if (lt < 8) {
      unit_params4r(prm + 16 * lt, a, c0 + 4 * lt, C, 1.f);
      unit_params4r(prm + 128 + 16 * lt, b, c0 + 4 * lt, C, 0.f);
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

// hi / lo (N, 9 Cp) of w^T for w (9 C, N) float32: column t Cp + c of row n
// is w[t C + c][n] split, zero for c >= C. 32 x 32 tiles, 256 threads.
__global__ void __launch_bounds__(256)
    split_taps_kernel(const float* __restrict__ w, float* __restrict__ hi,
                      float* __restrict__ lo, int C, int Cp, int N) {
  __shared__ float t[32][33];
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
  const int k0 = blockIdx.y * 32;  // padded contraction index
  const int n0 = blockIdx.x * 32;
  const int tap = k0 / Cp;         // (32 | Cp: one tap a tile)
  for (int i = ty; i < 32; i += 8) {
    const int c = k0 + i - tap * Cp, n = n0 + tx;
    t[i][tx] = c < C && n < N ? w[(size_t)(tap * C + c) * N + n] : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int n = n0 + i;
    if (n >= N) continue;
    uint32_t h, l;
    split(t[tx][i], h, l);
    hi[(size_t)n * 9 * Cp + k0 + tx] = __uint_as_float(h);
    lo[(size_t)n * 9 * Cp + k0 + tx] = __uint_as_float(l);
  }
}

cudaError_t fwd_f32(const void* x, const void* w, const float* a, const float* b, void* z,
                    float* part1, float* part2, float* s1, float* s2, int B, int H, int W, int C,
                    int N, int stride, int stats, float* wsplit, cudaStream_t s) {
  const int H2 = (H + stride - 1) / stride;
  const int W2 = (W + stride - 1) / stride;
  const int M = B * H2 * W2;
  const int Cp = pad_to(C, kBK);
  // B of z = x_hat w: w^T (N, 9 Cp) tap-major, hi and lo
  float* whi = wsplit;
  float* wlo = wsplit + (size_t)9 * Cp * N;
  split_taps_kernel<<<dim3((N + 31) / 32, 9 * Cp / 32), 256, 0, s>>>(
      static_cast<const float*>(w), whi, wlo, C, Cp, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  XHatConvFR aop{};
  aop.x = static_cast<const float*>(x);
  aop.a = a;
  aop.b = b;
  aop.rows = M;
  aop.C = C;
  aop.Cp = Cp;
  aop.H = H;
  aop.W = W;
  aop.H2 = H2;
  aop.W2 = W2;
  aop.stride = stride;
  e = gemm<true>(whi, wlo, z, aop, StoreZ2{}, M, N, 9 * Cp, stats ? part1 : nullptr, part2, s);
  if (e != cudaSuccess || !stats) return e;
  const int nm = (M + kPartRows - 1) / kPartRows;
  if ((e = sum_rows<float>(part1, nm, N, s1, s)) != cudaSuccess) return e;
  return sum_rows<float>(part2, nm, N, s2, s);
}

}  // namespace
}  // namespace tf32
}  // namespace sm90
}  // namespace bigdl_fg

using namespace bigdl_fg;

// dtype: 0 float32, 1 bfloat16 (x, w, z share it; a, b, s1, s2 are float32,
// 16-byte aligned); part1/part2 hold ceil(B * H2 * W2 / 64) x N float32
// partial sums; wsplit the weight's scratch: float32 2 x N x 9 Cp float32
// (its split halves, Cp = C rounded up to 32), bf16 9 Cp x pad8(N) bf16
// (its padded copy, Cp = C rounded up to 8).
extern "C" int bigdl_fused_conv_fwd(const void* x, const void* w, const float* a,
                                    const float* b, void* z, float* part1, float* part2,
                                    float* s1, float* s2, int dtype, int B, int H, int W, int C,
                                    int N, int stride, int stats, void* stream, float* wsplit) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride != 1 && stride != 2) return cudaErrorInvalidValue;
  if (dtype == 0)
    return sm90::tf32::fwd_f32(x, w, a, b, z, part1, part2, s1, s2, B, H, W, C, N, stride, stats,
                               wsplit, s);
  return sm90::fwd_bf16(x, w, a, b, z, part1, part2, s1, s2, B, H, W, C, N, stride, stats,
                        wsplit, s);
}
