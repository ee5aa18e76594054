// Shared core of the float32 tensor-core routes of the fused ResNet kernels
// for Hopper (fused_matmul_tf32_sm90.cu: K3 and K3-nhwc, forward and
// backward; fused_chain_tf32_sm90.cu: K5, forward and backward). It
// computes what fused_gemm.cuh computes for float32 - the same operands
// (x_hat = act(x * a + b), dz_eff = dz + ds1 + 2 z ds2, the residual
// junction h = relu(z * a + b + r)), the same epilogues and the same
// fixed-order second pass (sum_rows), with no atomics, so reruns agree bit
// for bit - on wgmma ... .tf32 with float32 accumulators, in 3xTF32: every
// float32 operand x is split into hi = tf32_rn(x) and lo = tf32_rn(x - hi)
// (x = hi + lo within 2^-21 |x|), and each product is hi hi + hi lo + lo hi
// (the lo lo term, 2^-22 of it, is left out), which holds the float32
// route's 1e-5 tolerance where one TF32 pass (2^-11) would not. It reuses
// fused_gemm_sm90.cuh's producer / consumer warpgroups, TMA and mbarrier
// rings, swizzle, cp.async A ring, staging stores and column sums.
//
// tf32 wgmma takes no transpose: both shared-memory operands are K-major.
//
// rs_kernel (forward and dx): C (rows x cols) = A (rows x kdim) B (kdim x
// cols), B given as hi and lo arrays of its transpose (cols x kdim, the
// contraction contiguous), which split_w_kernel writes once a call from the
// float32 weight: w^T for the forward, w as stored for dx (whose B is w^T).
// - One block: a producer warpgroup (one working thread) and two consumer
//   warpgroups of 64 rows, so a block owns a 128 x BN tile (BN = 64 or 128:
//   128 for outputs wider than 64 where shared memory allows). Persistent
//   blocks walk the tiles, column tiles of the same rows next to each other.
// - B hi and lo go through TMA into a ring of 128-byte-swizzled tiles, 32
//   deep in the contraction (one 128-byte row of float32: kBK = 32, four k8
//   steps), four stages where they fit, else three or two.
// - A carries the prologue. Each consumer warpgroup copies the raw float32
//   rows of its A tile and the chunk's column parameters with 16-byte
//   cp.async into a swizzled ring of four slots two chunks ahead (the bf16
//   core's ring: the same 128-byte rows), reads its fragment values back
//   (register e of k8 slice kk: row g + 8 (e & 1), column 8 kk + q + 4 (e >>
//   1)), applies the prologue in float32 with each operation rounded (the
//   plain versions' order, so the ReLU masks agree exactly; NaN passes the
//   ReLU), splits each value into hi and lo and feeds wgmma's register A
//   operand; chunk i + 1 converts while chunk i's products run.
// - Each chunk's 12 products (four k8 steps, three passes) go to a fresh
//   register set that is then added to the sum with rounded float32 adds
//   (promote): the tensor cores' own float32 accumulation drifts by about
//   2^-25 of the sum per product (measured on an H100), which a 1024-deep
//   contraction would carry past 1e-5.
// - K5's forward also writes h, its A operand: the conversion writes h over
//   the raw z tile it read (each element by the thread that read it), and
//   the tiles of column tile 0 put that 64 x 32 box out with one TMA store.
// - Epilogue: as the bf16 core's, the functor sees each finished pair once;
//   the float32 values go through a swizzled staging tile (64 x 32 boxes,
//   64-bit shared stores) and out with one TMA store per box; K5's dx writes
//   dz, then dr through the same staging tile; column sums by col_sums.
// Shared memory (bytes, KT raw A tiles a slot): four A slots of KT x 16 KB +
// 1 KB of parameters, the 128 x BN float32 staging tile, 8 KB of column-sum
// scratch at BN = 128, SB B stages of 2 x BN x 128. K3's forward (KT = 1)
// at BN = 128 with two B stages: 68 + 64 + 8 + 64 = 204 KB of 227; with two
// raw A tiles (K3's and K5's dx, K5's forward) BN = 128 would need 268 KB,
// so those run at BN = 64 with three B stages: 132 + 32 + 4 + 48 = 216 KB.
//
// dw_kernel: the weight gradient (K, N) = x_hat^T dz_eff, a contraction over
// the M pixels, 32 pixels a stage. TMA stages the raw x (two 32-channel
// boxes), dz and z tiles (and for K5 the residual r beside x). A = x_hat^T
// comes from registers: the consumer reads its fragment values (channel g +
// 8 (e & 1), pixel 8 kk + q + 4 (e >> 1)) from the raw x tile, applies the
// prologue and splits them. B = dz_eff must be K-major, pixels contiguous:
// the consumer warpgroup that owns the stage makes dz_eff from dz, z and
// the staged ds1 / ds2, splits it and writes hi and lo transposed into its
// own two swizzled BN x 32 tiles, then fence.proxy.async - the one in-smem
// transpose the layout cannot avoid. A block owns a 64 x BN tile of dw and
// a slice of the pixels; its two consumer warpgroups take alternate 32-pixel
// chunks, promote each chunk's products into their sum and each write their
// own float32 partial, which sum_rows adds in a fixed order. Shared memory
// at BN = 128: the four transposed tiles (64 KB), 1 KB of ds1 / ds2, and
// four stages of 40 KB (K3: 225 KB) or three of 48 KB (K5, with r: 209 KB).
#pragma once

#include "fused_gemm_sm90.cuh"

namespace bigdl_fg {
namespace sm90 {
namespace tf32 {

constexpr int kBM = 128;         // rows of C per block
constexpr int kBK = 32;          // contraction depth of one stage: one 128-byte row
constexpr int kBox = 64 * 128;   // bytes of a 64-row x 32-column swizzled float32 box
constexpr int kTileB = 32 * 128; // bytes of a 32-row box (dw's staged tiles)
constexpr int kAParams = 512;    // a chunk's 32 column parameters (two of them) per warpgroup
constexpr int kSmemMax = 232448;

// -- 3xTF32 -----------------------------------------------------------------------

// x rounded to tf32 (10 explicit mantissa bits, to nearest, ties away)
__device__ __forceinline__ uint32_t tf32_rn(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo within 2^-21 |x| (x - hi is exact)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rn(x);
  lo = tf32_rn(__fsub_rn(x, __uint_as_float(hi)));
}

// d (64 x N) = A B + (keep ? d : 0), one k8 step: A from registers (four
// tf32 values), B a K-major shared-memory tile
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                           int keep);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                                  int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(keep));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                                  int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(keep));
}

// d = (a_hi + a_lo)(b_hi + b_lo) without the lo lo term, + (keep ? d : 0);
// small terms first
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N / 2], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint64_t bh, uint64_t bl,
                                     int keep) {
  wgmma_tf32<N>(d, al, bh, keep);
  wgmma_tf32<N>(d, ah, bl, 1);
  wgmma_tf32<N>(d, ah, bh, 1);
}

// The tensor cores' float32 accumulation is not rounded to nearest: on an
// H100 its error grows by about 2^-25 of the sum at every k8 product, in one
// direction, which passes 1e-5 after some 300 products (a 1024-deep
// contraction in three passes). So each 32-deep chunk's products go to a
// fresh accumulator `part` (12 products), which is then added to the sum
// with a rounded float32 add.
template <int N>
__device__ __forceinline__ void promote(float (&acc)[N / 2], const float (&part)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

// byte offset of float32 column c (< 32) of row r in a 128-byte-swizzled box
__device__ __forceinline__ int swz4(int r, int c) { return swz(r, c >> 2) + ((c & 3) << 2); }

__device__ __forceinline__ float lds_f(const uint8_t* p) {
  return *reinterpret_cast<const float*>(p);
}

// the 4 floats of a unit at p: columns c .. c + 3 of src if ok (zeros if
// not), or all `fill` without a source
__device__ __forceinline__ void unit_params4(uint8_t* p, const float* src, int c, bool ok,
                                             float fill) {
  if (src != nullptr)
    cp_async16(p, ok ? src + c : src, ok);
  else
    *reinterpret_cast<float4*>(p) = make_float4(fill, fill, fill, fill);
}

// -- A operands ---------------------------------------------------------------------
//
// The raw float32 A tile of a 32-deep chunk lands in a slot as the bf16
// core's does (per consumer warpgroup 64 rows of 128 bytes, unit u of row r
// at u ^ (r % 8); tile k of warpgroup w at k * kATile + w * kATile / 2), with
// the chunk's two column parameters beside it (32 floats each, at prm and
// prm + 128). issue(st, raw, prm, k0) copies rows r0 + 16 i, i < 4, unit lt %
// 8 of each; convert(st, hi, lo, raw, prm) reads this thread's fragment
// values (register e of k8 slice kk: row 16 wq + g + 8 (e & 1), column 8 kk +
// q + 4 (e >> 1)) and leaves them split for wgmma. Columns past ld read x =
// a = b = 0 and give 0; rows past the end give values never written.

// fragment register e of k8 slice kk: its row in the warpgroup's 64 and its
// column in the chunk's 32
__device__ __forceinline__ int frag_row(int e) {
  const int lt = threadIdx.x % 128;
  return 16 * (lt / 32) + (lt % 32) / 4 + 8 * (e & 1);
}
__device__ __forceinline__ int frag_col(int kk, int e) {
  return 8 * kk + threadIdx.x % 4 + 4 * (e >> 1);
}

// x_hat = act(x * a + b) of row-major (rows, ld) x (K3; without a prologue
// a = 1 and b = 0, which leave x as it is); the ReLU keeps NaN
struct XHatF {
  static constexpr int kTiles = 1;
  static constexpr bool kStoreA = false;
  const float* x;
  const float* a;
  const float* b;
  int rows, ld, relu;
  struct State {
    int ir0;  // the first copy row
  };

  __device__ __forceinline__ void issue_rows(State& st, int r0) const { st.ir0 = r0; }
  __device__ __forceinline__ void issue(const State& st, uint8_t* raw, uint8_t* prm,
                                        int k0) const {
    const int lt = threadIdx.x % 128;
    const int u = lt & 7;
    const int c = k0 + 4 * u;
    const bool in = c < ld;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = st.ir0 + 16 * i;
      const bool ok = in && r < rows;
      cp_async16(raw + swz((lt >> 3) + 16 * i, u), ok ? x + (size_t)r * ld + c : x, ok);
    }
    if (lt < 8) {
      unit_params4(prm + 16 * u, a, c, in, 1.f);
      unit_params4(prm + 128 + 16 * u, b, c, in, 0.f);
    }
  }
  __device__ __forceinline__ void convert(const State&, uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4], uint8_t* raw,
                                          const uint8_t* prm) const {
    const float lo_f = relu ? 0.f : -INFINITY;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = frag_col(kk, e);
        float v = affine(lds_f(raw + swz4(frag_row(e), c)), lds_f(prm + 4 * c),
                         lds_f(prm + 128 + 4 * c));
        v = v < lo_f ? 0.f : v;
        split(v, hi[kk][e], lo[kk][e]);
      }
  }
};

// dz_eff = dz + ds1 + 2 z ds2 of row-major (rows, ld) dz and z: the A
// operand of K3's and K5's dx. A slot holds the dz tile, then the z tile;
// without stats z, ds1 and ds2 are zeros, which leave dz as it is.
struct DzEffF {
  static constexpr int kTiles = 2;
  static constexpr bool kStoreA = false;
  const float* dz;
  const float* z;
  const float* ds1;
  const float* ds2;
  int rows, ld, stats;
  struct State {
    int ir0;
  };

  __device__ __forceinline__ void issue_rows(State& st, int r0) const { st.ir0 = r0; }
  __device__ __forceinline__ void issue(const State& st, uint8_t* raw, uint8_t* prm,
                                        int k0) const {
    const int lt = threadIdx.x % 128;
    const int u = lt & 7;
    const int n = k0 + 4 * u;
    const bool in = n < ld;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = st.ir0 + 16 * i;
      const bool ok = in && r < rows;
      const int o = swz((lt >> 3) + 16 * i, u);
      const size_t e = (size_t)r * ld + n;
      cp_async16(raw + o, ok ? dz + e : dz, ok);
      cp_async16(raw + kATile + o, ok && stats ? z + e : dz, ok && stats);
    }
    if (lt < 8) {
      unit_params4(prm + 16 * u, stats ? ds1 : nullptr, n, in, 0.f);
      unit_params4(prm + 128 + 16 * u, stats ? ds2 : nullptr, n, in, 0.f);
    }
  }
  __device__ __forceinline__ void convert(const State&, uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4], uint8_t* raw,
                                          const uint8_t* prm) const {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = frag_col(kk, e);
        const int o = swz4(frag_row(e), c);
        const float v = __fadd_rn(__fadd_rn(lds_f(raw + o), lds_f(prm + 4 * c)),
                                  __fmul_rn(__fmul_rn(2.f, lds_f(raw + kATile + o)),
                                            lds_f(prm + 128 + 4 * c)));
        split(v, hi[kk][e], lo[kk][e]);
      }
  }
};

// h = relu(z * a + b + r) of row-major (rows, ld) z and r: K5's junction,
// the A operand of its forward, written over the raw z tile it was read
// from (kStoreA: the kernel stores that box). A slot holds the z tile, then
// the r tile, with the chunk's a and b beside them.
struct ResidF {
  static constexpr int kTiles = 2;
  static constexpr bool kStoreA = true;
  const float* z;
  const float* r;
  const float* a;
  const float* b;
  int rows, ld;
  struct State {
    int ir0;
  };

  __device__ __forceinline__ void issue_rows(State& st, int r0) const { st.ir0 = r0; }
  __device__ __forceinline__ void issue(const State& st, uint8_t* raw, uint8_t* prm,
                                        int k0) const {
    const int lt = threadIdx.x % 128;
    const int u = lt & 7;
    const int c = k0 + 4 * u;
    const bool in = c < ld;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = st.ir0 + 16 * i;
      const bool ok = in && row < rows;
      const int o = swz((lt >> 3) + 16 * i, u);
      const size_t e = (size_t)row * ld + c;
      cp_async16(raw + o, ok ? z + e : z, ok);
      cp_async16(raw + kATile + o, ok ? r + e : r, ok);
    }
    if (lt < 8) {
      unit_params4(prm + 16 * u, a, c, in, 0.f);
      unit_params4(prm + 128 + 16 * u, b, c, in, 0.f);
    }
  }
  __device__ __forceinline__ void convert(const State&, uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4], uint8_t* raw,
                                          const uint8_t* prm) const {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = frag_col(kk, e);
        const int o = swz4(frag_row(e), c);
        const float h = relu_f(__fadd_rn(
            affine(lds_f(raw + o), lds_f(prm + 4 * c), lds_f(prm + 128 + 4 * c)),
            lds_f(raw + kATile + o)));
        *reinterpret_cast<float*>(raw + o) = h;
        split(h, hi[kk][e], lo[kk][e]);
      }
  }
};

// -- the product with A from registers ---------------------------------------------

// Shared memory of rs_kernel (see the note at the top)
template <int BN, int KT>
struct Cfg {
  static constexpr int SA = 4;
  static constexpr int A_BYTES = KT * kATile + 2 * kAParams;
  static constexpr int B_BYTES = BN * 128;  // one of hi / lo
  static constexpr int OUT_OFF = SA * A_BYTES;
  static constexpr int RED_OFF = OUT_OFF + kBM * BN * 4;  // float red[8][2][BN]
  static constexpr int B_OFF = RED_OFF + 8 * 2 * BN * 4;
  static constexpr int bytes(int sb) { return 1024 + B_OFF + sb * 2 * B_BYTES + 2 * sb * 8; }
  static constexpr int SB = bytes(4) <= kSmemMax ? 4 : bytes(3) <= kSmemMax ? 3 : 2;
  static constexpr int BAR_OFF = B_OFF + SB * 2 * B_BYTES;
  static constexpr int SMEM = bytes(SB);
  static constexpr bool kFits = SMEM <= kSmemMax;
};

// Grid: min(tiles, SMs) persistent blocks of 384 threads (the producer
// warpgroup, then two consumer warpgroups) over the ceil(rows / 128) x
// ceil(cols / BN) tiles (t = row tile * column tiles + column tile), each in
// 32-deep chunks of the contraction. C goes out through omap (cols, rows) in
// 64 x 32 boxes; with part1 != nullptr, the column sums of the epilogue's s1
// / s2 over each 64 rows go to part1 / part2[64-row tile * cols + c]. omap2
// is a second output: with AOp::kStoreA the converted A (rows, kdim),
// written once by the tiles of column tile 0; with Epi::kOut2 the
// epilogue's second value (rows, cols), through the staging tile after the
// first.
template <int BN, class AOp, class Epi>
__global__ void __launch_bounds__(384, 1)
    rs_kernel(const __grid_constant__ CUtensorMap bhi, const __grid_constant__ CUtensorMap blo,
              const __grid_constant__ CUtensorMap omap,
              const __grid_constant__ CUtensorMap omap2, const AOp aop0, const Epi epi,
              int rows, int cols, int kdim, float* __restrict__ part1,
              float* __restrict__ part2) {
  using C = Cfg<BN, AOp::kTiles>;
  constexpr int SA = C::SA, SB = C::SB;
  static_assert(C::kFits, "shared memory of one block");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(smem + C::RED_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + SB;
  const int ntn = (cols + BN - 1) / BN;
  const int ntiles = ((rows + kBM - 1) / kBM) * ntn;
  const int nch = (kdim + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SB; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: B hi and lo
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int col0 = (t % ntn) * BN;
        for (int j = 0; j < nch; ++j, ++it) {
          const int s = it % SB;
          mbar_wait(&empty[s], ((it / SB) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], 2 * C::B_BYTES);
          uint8_t* dst = smem + C::B_OFF + s * 2 * C::B_BYTES;
          tma_load_3d(dst, &bhi, &full[s], j * kBK, col0, 0);
          tma_load_3d(dst + C::B_BYTES, &blo, &full[s], j * kBK, col0, 0);
        }
      }
    }
    return;
  }

  // consumer warpgroups: A, the products, the epilogue
  setmaxnreg_inc<240>();
  const int wg = threadIdx.x / 128 - 1;
  const int lt = threadIdx.x % 128;
  const int wq = lt / 32;
  const int g = (lt % 32) / 4;
  const int q = lt % 4;
  const AOp& aop = aop0;
  typename AOp::State st;
  uint8_t* aw = smem + wg * (kATile / 2);                     // slot 0: raw rows
  uint8_t* pw = smem + AOp::kTiles * kATile + wg * kAParams;  // ... parameters
  uint8_t* ost = smem + C::OUT_OFF + wg * (BN * 256);
  // the copies run SA - 2 chunks ahead of the conversion, through the same
  // (tile, chunk) sequence; one cp.async group per chunk (empty past the end)
  int ti = blockIdx.x, ji = 0, issued = 0;
  auto issue_next = [&]() {
    if (ti < ntiles) {
      if (ji == 0) aop.issue_rows(st, (ti / ntn) * kBM + 64 * wg + (lt >> 3));
      const int o = (issued % SA) * C::A_BYTES;
      aop.issue(st, aw + o, pw + o, ji * kBK);
      if (++ji == nch) {
        ji = 0;
        ti += gridDim.x;
      }
    }
    cp_async_commit();
    ++issued;
  };
#pragma unroll
  for (int p = 0; p < SA - 1; ++p) issue_next();

  // (kStoreA) chunk jj of tile tt's converted A, written over its raw tile
  // at aw + o: out by one TMA store in column tile 0 (thread 0 waited for
  // the stores of earlier chunks to read their slots before the barrier
  // that precedes the conversion, so no copy lands in a slot being stored)
  auto store_a = [&](int tt, int jj, int o) {
    if constexpr (AOp::kStoreA) {
      if (tt < ntiles && tt % ntn == 0) {
        fence_proxy_async();
        bar_sync(6 + wg, 128);
        const int rw = (tt / ntn) * kBM + 64 * wg;
        if (lt == 0 && rw < rows) {
          tma_store_3d(&omap2, aw + o, jj * kBK, rw);
          bulk_commit();
        }
      }
    }
  };

  float acc[BN / 2], part[BN / 2];  // the sum, and one chunk's products
  uint32_t ha[4][4], la[4][4], hb[4][4], lb[4][4];  // this chunk's A and the next's
  int t = blockIdx.x, j = 0, it = 0;
  cp_async_wait<SA - 2>();
  bar_sync(2 + wg, 128);
  aop.convert(st, ha, la, aw, pw);
  store_a(t, 0, 0);
  // chunk `it` (tile t, chunk j): its products from (hc, lc) while the next
  // chunk's A goes into (hn, ln), then after a tile's last chunk its
  // epilogue; false when the block's tiles are done. The fragment sets take
  // turns, so no copy joins them (ptxas would serialise the products).
  auto step = [&](uint32_t(&hc)[4][4], uint32_t(&lc)[4][4], uint32_t(&hn)[4][4],
                  uint32_t(&ln)[4][4]) {
    const int row0 = (t / ntn) * kBM;
    const int col0 = (t % ntn) * BN;
    const int rw0 = row0 + 64 * wg;  // this warpgroup's first row
    if (j == 0) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    }
    int tn = t, jn = j + 1;  // the next chunk
    if (jn == nch) {
      jn = 0;
      tn += gridDim.x;
    }
    const int s = it % SB;
    mbar_wait(&full[s], (it / SB) & 1);
    const uint8_t* bt = smem + C::B_OFF + s * 2 * C::B_BYTES;
    fence_regs(part);
    fence_regs(hc);
    fence_regs(lc);
    fence_regs(hn);
    fence_regs(ln);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma3<BN>(part, hc[kk], lc[kk], kmajor_desc<128>(bt, C::B_BYTES, kk),
               kmajor_desc<128>(bt + C::B_BYTES, C::B_BYTES, kk), kk);
    wgmma_commit();
    // the next chunk's A while the products run (past the end: a stale
    // slot, never used)
    cp_async_wait<SA - 3>();
    if (AOp::kStoreA && lt == 0) bulk_wait_read();
    bar_sync(2 + wg, 128);
    const int o = ((it + 1) % SA) * C::A_BYTES;
    aop.convert(st, hn, ln, aw + o, pw + o);
    store_a(tn, jn, o);
    fence_regs(part);
    fence_regs(hc);
    fence_regs(lc);
    fence_regs(hn);
    fence_regs(ln);
    wgmma_wait<0>();
    fence_regs(part);
    fence_regs(hc);
    fence_regs(lc);
    promote<BN>(acc, part);
    if (lt % 32 == 0) mbar_arrive(&empty[s]);
    issue_next();  // into the slot converted two chunks ago

    if (jn == 0) {
      // epilogue: the pairs into the staging tile (the previous tile's
      // stores have read it), then one TMA store per 32 columns; the
      // column sums of the tile's rows take the place of the finished
      // accumulators
      if (lt == 0) bulk_wait_read();
      bar_sync(4 + wg, 128);
      float out2[Epi::kOut2 ? BN / 2 : 1];  // the second output
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        const int c = 8 * jj + 2 * q;
        float2 t1 = make_float2(0.f, 0.f), t2 = make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rl = 16 * wq + g + 8 * i;
          const int r = rw0 + rl;
          float2 v = make_float2(0.f, 0.f), v2 = make_float2(0.f, 0.f);
          if (r < rows && col0 + c < cols) {
            float2 s1, s2;
            if constexpr (Epi::kOut2)
              v = epi.pair2(r, col0 + c, acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1], s1, s2,
                            v2);
            else
              v = epi.pair(r, col0 + c, acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1], s1, s2);
            t1.x += s1.x;
            t1.y += s1.y;
            t2.x += s2.x;
            t2.y += s2.y;
          }
          *reinterpret_cast<float2*>(ost + (c >> 5) * kBox + swz4(rl, c & 31)) = v;
          if constexpr (Epi::kOut2) {
            out2[4 * jj + 2 * i] = v2.x;
            out2[4 * jj + 2 * i + 1] = v2.y;
          }
        }
        acc[4 * jj] = t1.x;
        acc[4 * jj + 1] = t1.y;
        acc[4 * jj + 2] = t2.x;
        acc[4 * jj + 3] = t2.y;
      }
      fence_proxy_async();
      bar_sync(4 + wg, 128);
      if (lt == 0 && rw0 < rows) {
#pragma unroll
        for (int p = 0; p < BN / 32; ++p)
          if (col0 + 32 * p < cols) tma_store_3d(&omap, ost + p * kBox, col0 + 32 * p, rw0);
        bulk_commit();
      }
      if constexpr (Epi::kOut2) {
        // the second output through the same staging tile, once the first
        // store has read it
        if (lt == 0) bulk_wait_read();
        bar_sync(4 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int c = 8 * jj + 2 * q;
            *reinterpret_cast<float2*>(ost + (c >> 5) * kBox + swz4(16 * wq + g + 8 * i, c & 31)) =
                make_float2(out2[4 * jj + 2 * i], out2[4 * jj + 2 * i + 1]);
          }
        fence_proxy_async();
        bar_sync(4 + wg, 128);
        if (lt == 0 && rw0 < rows) {
#pragma unroll
          for (int p = 0; p < BN / 32; ++p)
            if (col0 + 32 * p < cols)
              tma_store_3d(&omap2, ost + p * kBox, col0 + 32 * p, rw0);
          bulk_commit();
        }
      }
      if (part1 != nullptr) col_sums<BN>(acc, red, wg, rw0, col0, rows, cols, part1, part2);
    }
    t = tn;
    j = jn;
    ++it;
    return t < ntiles;
  };
  if (t < ntiles) {
    while (step(ha, la, hb, lb) && step(hb, lb, ha, la)) {
    }
  }
  if (lt == 0) bulk_wait();
}

// hi and lo (tf32 values kept as float32) of w (K, N) float32: as stored
// (trans = 0) or transposed to (N, K). 32 x 32 tiles, 256 threads.
__global__ void __launch_bounds__(256)
    split_w_kernel(const float* __restrict__ w, float* __restrict__ hi, float* __restrict__ lo,
                   int K, int N, int trans) {
  __shared__ float t[32][33];
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
  const int k0 = blockIdx.y * 32;
  const int n0 = blockIdx.x * 32;
  for (int i = ty; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + tx;
    if (k >= K || n >= N) continue;
    const float v = w[(size_t)k * N + n];
    if (trans) {
      t[i][tx] = v;
    } else {
      uint32_t h, l;
      split(v, h, l);
      hi[(size_t)k * N + n] = __uint_as_float(h);
      lo[(size_t)k * N + n] = __uint_as_float(l);
    }
  }
  if (!trans) return;
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int n = n0 + i, k = k0 + tx;
    if (k >= K || n >= N) continue;
    uint32_t h, l;
    split(t[tx][i], h, l);
    hi[(size_t)n * K + k] = __uint_as_float(h);
    lo[(size_t)n * K + k] = __uint_as_float(l);
  }
}

// -- the weight gradient: B transposed in shared memory --------------------------

template <int BN, bool RES>
struct DwCfg {
  static constexpr int X_BYTES = 2 * kTileB;         // 32 pixels x 64 rows of dw
  static constexpr int D_BYTES = BN / 32 * kTileB;   // 32 pixels x BN columns
  // x, dz, z (and with RES the residual r, like x)
  static constexpr int STAGE = (RES ? 2 : 1) * X_BYTES + 2 * D_BYTES;
  static constexpr int BT_BYTES = BN * 128;          // BN columns x 32 pixels, hi or lo
  static constexpr int PRM_OFF = 4 * BT_BYTES;       // ds1, ds2 of the block's columns
  static constexpr int ST_OFF = PRM_OFF + 1024;
  static constexpr int bytes(int s) { return 1024 + ST_OFF + s * STAGE + 2 * s * 8; }
  static constexpr int S = bytes(4) <= kSmemMax ? 4 : 3;
  static constexpr int BAR_OFF = ST_OFF + S * STAGE;
  static constexpr int SMEM = bytes(S);
  static_assert(SMEM <= kSmemMax, "shared memory of one block");
};

// Grid (ceil(K / 64), ceil(N / BN), splits), 384 threads; split z covers
// pixels [z * per, min(M, (z + 1) * per)). Consumer warpgroup w writes its
// float32 partial of the block's 64 x BN tile of dw to ws[((2 z + w) * K +
// k) * N + n]. With RES (K5) x_hat is relu(x * a + b + r) of x and the
// residual r (rmap, staged like x).
template <int BN, bool RES>
__global__ void __launch_bounds__(384, 1)
    dw_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dzmap,
              const __grid_constant__ CUtensorMap zmap, const __grid_constant__ CUtensorMap rmap,
              const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ ds1, const float* __restrict__ ds2,
              float* __restrict__ ws, int M, int K, int N, int prologue, int relu, int stats,
              int per) {
  using C = DwCfg<BN, RES>;
  constexpr int S = C::S;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + S;
  const int kc0 = blockIdx.x * 64;
  const int n0 = blockIdx.y * BN;
  const int mb = blockIdx.z * per;
  const int me = min(M, mb + per);
  const int nch = (me - mb + 31) / 32;
  // boxes inside the operand: x's (and r's) 32-channel boxes, dz's and z's
  // 32-column boxes
  const int nx = min(2, (K - kc0 + 31) / 32);
  const int nd = min(BN / 32, (N - n0 + 31) / 32);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the four warps of the stage's warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int j = 0; j < nch; ++j) {
        const int s = j % S;
        mbar_wait(&empty[s], ((j / S) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], ((RES ? 2 : 1) * nx + (stats ? 2 : 1) * nd) * kTileB);
        uint8_t* dst = smem + C::ST_OFF + s * C::STAGE;
        const int m = mb + 32 * j;
        for (int c = 0; c < nx; ++c) {
          tma_load_3d(dst + c * kTileB, &xmap, &full[s], kc0 + 32 * c, m, 0);
          if (RES)
            tma_load_3d(dst + C::X_BYTES + 2 * C::D_BYTES + c * kTileB, &rmap, &full[s],
                        kc0 + 32 * c, m, 0);
        }
        for (int p = 0; p < nd; ++p) {
          tma_load_3d(dst + C::X_BYTES + p * kTileB, &dzmap, &full[s], n0 + 32 * p, m, 0);
          if (stats)
            tma_load_3d(dst + C::X_BYTES + C::D_BYTES + p * kTileB, &zmap, &full[s],
                        n0 + 32 * p, m, 0);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128 - 1;
  const int lt = threadIdx.x % 128;
  const int w4 = lt / 32;
  const int lane = lt % 32;
  const int q = lt % 4;
  // the block's ds1 / ds2 (zeros past N or without stats)
  float* prm = reinterpret_cast<float*>(smem + C::PRM_OFF);
  for (int c = threadIdx.x - 128; c < BN; c += 256) {
    const bool ok = stats && n0 + c < N;
    prm[c] = ok ? ds1[n0 + c] : 0.f;
    prm[BN + c] = ok ? ds2[n0 + c] : 0.f;
  }
  bar_sync(1, 256);
  // this thread's rows of dw (channels kc0 + ch + 8 i) and their prologue
  const int ch = 16 * w4 + (lt % 32) / 4;
  const bool aff = RES || prologue;
  float pa[2], pb[2];
  bool okc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = kc0 + ch + 8 * i;
    okc[i] = c < K;
    pa[i] = aff && okc[i] ? __ldg(a + c) : 1.f;
    pb[i] = aff && okc[i] ? __ldg(b + c) : 0.f;
  }
  uint8_t* bth = smem + wg * 2 * C::BT_BYTES;  // this warpgroup's dz_eff^T, hi
  uint8_t* btl = bth + C::BT_BYTES;            // ... and lo
  float acc[BN / 2], part[BN / 2];  // the sum, and one chunk's products
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int j = wg; j < nch; j += 2) {
    const int s = j % S;
    mbar_wait(&full[s], (j / S) & 1);
    const uint8_t* xt = smem + C::ST_OFF + s * C::STAGE;
    const uint8_t* dzt = xt + C::X_BYTES;
    const uint8_t* zt = dzt + C::D_BYTES;
    const uint8_t* rt = zt + C::D_BYTES;
    const int m0 = mb + 32 * j;
    // B: dz_eff^T. Lane = pixel m; unit u = 4 columns; columns past N and
    // pixels past the slice give 0
    {
      const int m = lane;
      const bool okm = m0 + m < me;
#pragma unroll
      for (int i = 0; i < BN / 16; ++i) {
        const int u = w4 + 4 * i;
        const int off = (u >> 3) * kTileB + swz(m, u & 7);
        float4 d = *reinterpret_cast<const float4*>(dzt + off);
        if (stats) {
          const float4 z4 = *reinterpret_cast<const float4*>(zt + off);
          const float4 d1 = *reinterpret_cast<const float4*>(prm + 4 * u);
          const float4 d2 = *reinterpret_cast<const float4*>(prm + BN + 4 * u);
          d.x = __fadd_rn(__fadd_rn(d.x, d1.x), __fmul_rn(__fmul_rn(2.f, z4.x), d2.x));
          d.y = __fadd_rn(__fadd_rn(d.y, d1.y), __fmul_rn(__fmul_rn(2.f, z4.y), d2.y));
          d.z = __fadd_rn(__fadd_rn(d.z, d1.z), __fmul_rn(__fmul_rn(2.f, z4.z), d2.z));
          d.w = __fadd_rn(__fadd_rn(d.w, d1.w), __fmul_rn(__fmul_rn(2.f, z4.w), d2.w));
        }
        const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 4 * u + e;
          uint32_t h, l;
          split(okm && n0 + n < N ? dv[e] : 0.f, h, l);
          const int o = swz4(n, m);
          *reinterpret_cast<uint32_t*>(bth + o) = h;
          *reinterpret_cast<uint32_t*>(btl + o) = l;
        }
      }
    }
    // A: x_hat^T from registers; register e of k8 slice kk holds channel ch
    // + 8 (e & 1) at pixel 8 kk + q + 4 (e >> 1)
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e & 1;
        const int m = 8 * kk + q + 4 * (e >> 1);
        const int off = (w4 >> 1) * kTileB + swz4(m, (ch & 31) + 8 * i);
        float v = lds_f(xt + off);
        if constexpr (RES) {
          v = relu_f(__fadd_rn(affine(v, pa[i], pb[i]), lds_f(rt + off)));
        } else {
          if (prologue) v = affine(v, pa[i], pb[i]);
          if (relu) v = relu_f(v);
        }
        split(okc[i] && m0 + m < me ? v : 0.f, ah[kk][e], al[kk][e]);
      }
    fence_proxy_async();
    bar_sync(2 + wg, 128);
    if (lt % 32 == 0) mbar_arrive(&empty[s]);  // the stage is read
    fence_regs(part);
    fence_regs(ah);
    fence_regs(al);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma3<BN>(part, ah[kk], al[kk], kmajor_desc<128>(bth, C::BT_BYTES, kk),
               kmajor_desc<128>(btl, C::BT_BYTES, kk), kk);
    wgmma_commit();
    fence_regs(part);
    fence_regs(ah);
    fence_regs(al);
    wgmma_wait<0>();
    fence_regs(part);
    promote<BN>(acc, part);
  }

  float* out = ws + (size_t)(2 * blockIdx.z + wg) * K * N;
  const int r0 = kc0 + ch;
#pragma unroll
  for (int jj = 0; jj < BN / 8; ++jj) {
    const int c = n0 + 8 * jj + 2 * q;
    if (c >= N) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (r0 + 8 * i < K)
        store2<float>(out + (size_t)(r0 + 8 * i) * N + c, acc[4 * jj + 2 * i],
                      acc[4 * jj + 2 * i + 1]);
  }
}

// -- host ---------------------------------------------------------------------------

// The 3-D map (inner, outer, 1) of a contiguous row-major float32 (outer,
// inner) array, with boxes of 32 x box_outer and the 128-byte swizzle
// (inner a multiple of 4: rows of 16-byte multiples)
inline bool make_map_f32(CUtensorMap* map, const void* ptr, int inner, int outer,
                         int box_outer) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(inner), cuuint64_t(outer), 1};
  const cuuint64_t strides[2] = {cuuint64_t(inner) * 4, cuuint64_t(outer) * inner * 4};
  const cuuint32_t box[3] = {32, cuuint32_t(box_outer), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline cudaError_t split_w(const void* w, float* hi, float* lo, int K, int N, bool trans,
                           cudaStream_t s) {
  const dim3 grid((N + 31) / 32, (K + 31) / 32);
  split_w_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(w), hi, lo, K, N, trans);
  return cudaGetLastError();
}

template <int BN, class AOp, class Epi>
cudaError_t run_rs(const float* bhi, const float* blo, void* out, const AOp& aop, const Epi& epi,
                   int rows, int cols, int kdim, float* part1, float* part2, cudaStream_t s,
                   void* out2) {
  // bhi / blo (cols, kdim) in boxes of 32 contraction columns x BN rows;
  // out (rows, cols) in 64 x 32 boxes, out2 (rows, kdim) with kStoreA,
  // (rows, cols) with kOut2
  using C = Cfg<BN, AOp::kTiles>;
  CUtensorMap mh, ml, mo, mo2;
  bool ok = make_map_f32(&mh, bhi, kdim, cols, BN) && make_map_f32(&ml, blo, kdim, cols, BN) &&
            make_map_f32(&mo, out, cols, rows, 64);
  if (AOp::kStoreA || Epi::kOut2)
    ok = ok && out2 != nullptr &&
         make_map_f32(&mo2, out2, AOp::kStoreA ? kdim : cols, rows, 64);
  else
    mo2 = mo;
  if (!ok) return cudaErrorInvalidValue;
  auto kern = rs_kernel<BN, AOp, Epi>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  const int tiles = ((rows + kBM - 1) / kBM) * ((cols + BN - 1) / BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  kern<<<grid, 384, C::SMEM, s>>>(mh, ml, mo, mo2, aop, epi, rows, cols, kdim, part1, part2);
  return cudaGetLastError();
}

// out (rows x cols, float32) = A B with BN = 128 for cols > 64 where shared
// memory allows, else 64; with part1 != nullptr, the epilogue's column sums
// per 64 rows; out2: the second output of an operand with kStoreA or an
// epilogue with kOut2
template <class AOp, class Epi>
cudaError_t gemm(const float* bhi, const float* blo, void* out, const AOp& aop, const Epi& epi,
                 int rows, int cols, int kdim, float* part1, float* part2, cudaStream_t s,
                 void* out2 = nullptr) {
  if constexpr (Cfg<128, AOp::kTiles>::kFits) {
    if (cols > 64)
      return run_rs<128>(bhi, blo, out, aop, epi, rows, cols, kdim, part1, part2, s, out2);
  }
  return run_rs<64>(bhi, blo, out, aop, epi, rows, cols, kdim, part1, part2, s, out2);
}

template <int BN, bool RES>
cudaError_t run_dw(const void* x, const void* dz, const void* z, const void* r, const float* a,
                   const float* b, const float* ds1, const float* ds2, float* ws, int M, int K,
                   int N, int prologue, int relu, int stats, int splits, int per,
                   cudaStream_t s) {
  using C = DwCfg<BN, RES>;
  CUtensorMap xm, dm, zm, rm;
  if (!make_map_f32(&xm, x, K, M, 32) || !make_map_f32(&dm, dz, N, M, 32) ||
      !make_map_f32(&zm, stats ? z : dz, N, M, 32) ||
      !make_map_f32(&rm, RES ? r : x, K, M, 32))
    return cudaErrorInvalidValue;
  auto kern = dw_kernel<BN, RES>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((K + 63) / 64, (N + BN - 1) / BN, splits);
  kern<<<grid, 384, C::SMEM, s>>>(xm, dm, zm, rm, a, b, ds1, ds2, ws, M, K, N, prologue, relu,
                                  stats, per);
  return cudaGetLastError();
}

// ws holds 2 x splits x K x N float32 partials of dw (one per consumer
// warpgroup and split); BN = 64 for N <= 64, else 128. RES: x_hat =
// relu(x * a + b + r) of x and the residual r (K5)
template <bool RES = false>
cudaError_t gemm_dw(const void* x, const void* dz, const void* z, const float* a, const float* b,
                    const float* ds1, const float* ds2, float* ws, int M, int K, int N,
                    int prologue, int relu, int stats, int splits, int per, cudaStream_t s,
                    const void* r = nullptr) {
  if (N <= 64)
    return run_dw<64, RES>(x, dz, z, r, a, b, ds1, ds2, ws, M, K, N, prologue, relu, stats,
                           splits, per, s);
  return run_dw<128, RES>(x, dz, z, r, a, b, ds1, ds2, ws, M, K, N, prologue, relu, stats,
                          splits, per, s);
}

}  // namespace tf32
}  // namespace sm90
}  // namespace bigdl_fg
