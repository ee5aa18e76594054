// Int8 GEMM for Hopper: C[g] (M x N) = A[g] (M x K, int8) . B[g] (N x K, int8)^T in exact
// int32, batched over a group index g (grouped and depthwise convolutions run as G groups),
// stored as int32, or with a per-column scale s and an optional bias as float32:
// y = float32(acc) * s[n] (+ bias[n]), what the quantized layers compute after the contraction.
//
// Replaces no Pallas kernel. The JAX package computes its int8 x int8 -> int32 contractions in
// XLA (bigdl_tpu/quantization/quantize.py:89 `lax.dot_general(..., preferred_element_type=
// int32)`, and `lax.conv_general_dilated` over int8 at :136 and :190) and leaves the rescale
// and bias that follow each of them to XLA, which fuses them into the contraction's output.
// No PyTorch op computes them on a CUDA device: torch.matmul and F.conv2d refuse int8 and int32
// tensors, and torch._int_mm (cuBLASLt) takes only M > 16 with K and N multiples of 8
// (Inception's first convolution has K = 147, a depthwise 3x3 K = 9). It is the contraction of
// the port's QuantizedLinear, QuantizedSpatialConvolution and
// QuantizedSpatialSeparableConvolution (bigdl_tpu_torch/kernels/int8_matmul.py, which forms A
// from an int8 im2col for the convolutions).
//
// What bounds it on an H100: 2 * M * N * K operations at 1,979 dense int8 TOP/s against the
// bytes of A and B read once and of C (four bytes an element) written once at 3.35 TB/s. The
// convolutions of a quantized image model are bound by the bytes: the output alone is four
// times the int8 input (Inception v1's 58 contractions at B32/224: 101 GOP, 387 MB of im2col
// operand, 103 M output elements; 0.24 ms of bytes). Most of them are small: at B32, 41 of the
// 58 have fewer 128 x 128 tiles than the card's 132 SMs, and many are narrow (N = 16 to 64).
// What the design does about it:
// - Operands by TMA. A and B are both K-major, the only layout wgmma takes for 8-bit types.
//   One producer thread loads 128-byte-swizzled tiles, 128 deep in K (one 128-byte row), of A
//   (128 rows) and B (BN rows) into a ring of ST stages (4 to 8, as many as fit in 192 KB)
//   guarded by full / empty mbarriers. The tensor maps are 3-D over (K, rows, G) or (K, G,
//   rows), whichever order the group stride runs in, so rows past M or N and columns past K
//   read as zeros from TMA, never as the next group's. TMA needs 16-byte row strides, not a
//   16-byte K: the wrapper writes its im2col with each group's columns padded to a multiple of
//   16 and the tensor map's K extent stays K, so no byte is loaded a thread.
// - Products on wgmma.mma_async m64nBNk32 .s32.s8.s8, both operands from shared-memory
//   descriptors, int32 accumulators in registers, on two consumer warpgroups of 64 rows each
//   (a 128 x BN tile). BN is one of 16, 32, 64, 128 and 256, chosen with the K split by the
//   wrapper's plan (int8_matmul.plan: the least time of a cost model fitted to every plan's
//   time on the card), so that a narrow N computes few empty columns and small layers still
//   fill the card. One wgmma group stays in flight: a stage is given back when the product
//   after it is issued. (Ping-pong warpgroups on 64-row tiles, each from a ring of its own,
//   measured slower on an H100 at every Inception shape: PERF.md.)
// - A persistent grid with split-K. One block an SM walks the work items (tile, part) in
//   turn, the producer running ahead across tiles. Where a tile's K is long and tiles are
//   few, the plan splits K into parts. Each part writes its int32 partial tile into the
//   workspace (each thread its own registers, 16 bytes a store) and counts its arrival on the
//   tile's counter; the last part to arrive adds the other parts' partials in part order and
//   runs the epilogue, then sets the counter back to 0 for the next call. Integer sums are
//   exact in any order, so results are bit for bit those of the unsplit kernel. The split
//   costs that second pass (about 2 us on an H100), so the plan takes it only where it
//   pays: at none of Inception v1's contractions, where narrow tiles fill the card, but where
//   one tile runs deep in K.
// - The epilogue. int32, or float32 y = __fadd_rn(__fmul_rn(__int2float_rn(acc), s[n]),
//   bias[n]): the explicit roundings keep nvcc from contracting the two into an FMA, so y is
//   bit for bit torch's acc.to(float32) * s + bias. Each thread stores its accumulator pairs
//   (8 bytes) straight from registers; a warp writes 32 bytes of each of 8 rows an
//   instruction. The output is written once, in the caller's layout (ldc, sc).
// Sums are exact in int32 while K * 128 * 128 < 2^31 (the wrapper checks K).
//
// Grid: min(work items, SMs) blocks of 384 threads (the producer warpgroup, then two consumer
// warpgroups); the wrapper passes it with the plan.
#include "attn_sm90.cuh"

namespace bigdl {
namespace int8 {

using namespace sm90;

constexpr int kBM = 128;          // rows of a tile: two consumer warpgroups of 64
constexpr int kBK = 128;          // K of one stage: one 128-byte swizzled row
constexpr int kThreads = 384;
constexpr int kRingBytes = 196608;
constexpr int kMaxStages = 8;

template <int BN>
struct Cfg {
  static constexpr int A_BYTES = kBM * kBK;
  static constexpr int STAGE = A_BYTES + BN * kBK;
  static constexpr int ST = kRingBytes / STAGE < kMaxStages ? kRingBytes / STAGE : kMaxStages;
  static constexpr int BAR_OFF = ST * STAGE;
  static constexpr int FLAG_OFF = BAR_OFF + 2 * ST * 8;
  static constexpr int SMEM = 1024 + FLAG_OFF + 16;
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// d (64 x N, int32) += A (64 x 32) B (32 x N); A and B int8 from shared memory, both
// K-major; acc = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db, int acc);

// (every accumulator register is listed: wgmma names them all)
template <>
__device__ __forceinline__ void wgmma_s8<16>(int (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// descriptor of the k32 slice starting `byte` bytes into a K-major 128-byte-swizzled tile
__device__ __forceinline__ uint64_t kdesc(const uint8_t* tile, int byte) {
  return make_desc<128>(smem_u32(tile) + byte, 16, 8 * 128);
}

struct Params {
  void* c;                 // int32 (scale == nullptr) or float32
  const float* scale;      // per column, group g's at scale + g * sv
  const float* bias;       // per column or nullptr
  int* counters;           // one per tile, 0 between calls (splits > 1)
  int32_t* ws;             // the parts' partial tiles (splits > 1)
  int G, M, N, K, splits;
  long long ldc, sc, sv;
  int a_gmajor, b_gmajor, vec2;
};

// The box at K offset k of rows [row, row + box) of group g.
__device__ __forceinline__ void load_box(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int k, int row, int g, int gmajor) {
  if (gmajor)
    tma_load_3d(dst, map, bar, k, g, row);
  else
    tma_load_3d(dst, map, bar, k, row, g);
}

struct Work {
  int tile, g, m0, n0, j0, j1;
};

template <int BN>
__device__ __forceinline__ Work work_item(const Params& p, int w, int mt, int nt, int nk) {
  Work r;
  r.tile = w / p.splits;
  const int part = w % p.splits;
  r.g = r.tile / (mt * nt);
  const int t = r.tile % (mt * nt);
  r.m0 = (t / nt) * kBM;  // column tiles of the same rows next to each other
  r.n0 = (t % nt) * BN;
  r.j0 = part * nk / p.splits;
  r.j1 = (part + 1) * nk / p.splits;
  return r;
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap bmap, const Params p) {
  using C = Cfg<BN>;
  constexpr int NR = BN / 2;  // accumulator registers a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + C::ST;
  int* flag = reinterpret_cast<int*>(smem + C::FLAG_OFF);
  const int mt = (p.M + kBM - 1) / kBM;
  const int nt = (p.N + BN - 1) / BN;
  const int work = mt * nt * p.G * p.splits;
  const int nk = (p.K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int w = blockIdx.x; w < work; w += gridDim.x) {
        const Work r = work_item<BN>(p, w, mt, nt, nk);
        for (int j = r.j0; j < r.j1; ++j, ++it) {
          const int s = it % C::ST;
          mbar_wait(&empty[s], ((it / C::ST) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], C::STAGE);
          uint8_t* dst = smem + s * C::STAGE;
          load_box(dst, &amap, &full[s], j * kBK, r.m0, r.g, p.a_gmajor);
          load_box(dst + C::A_BYTES, &bmap, &full[s], j * kBK, r.n0, r.g, p.b_gmajor);
        }
      }
    }
    return;
  }

  // consumer warpgroups: rows 64 wg .. 64 wg + 63 of each tile
  setmaxnreg_inc<232>();
  const int ct = threadIdx.x - 128;  // 0 .. 255
  const int wg = ct / 128;
  const int lane = ct % 32;
  const int row_in = 64 * wg + 16 * ((ct % 128) / 32) + lane / 4;  // this thread's first row
  const int col_in = 2 * (lane % 4);                              // its first column
  int acc[NR];
  int it = 0;
  for (int w = blockIdx.x; w < work; w += gridDim.x) {
    const Work r = work_item<BN>(p, w, mt, nt, nk);
    if (r.j0 == r.j1) {  // K = 0
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[i] = 0;
    }
    int prev = -1;
    for (int j = r.j0; j < r.j1; ++j, ++it) {
      const int s = it % C::ST;
      mbar_wait(&full[s], (it / C::ST) & 1);
      const uint8_t* at = smem + s * C::STAGE + wg * 64 * kBK;
      const uint8_t* bt = smem + s * C::STAGE + C::A_BYTES;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_s8<BN>(acc, kdesc(at, 32 * kk), kdesc(bt, 32 * kk), j > r.j0 || kk > 0);
      wgmma_commit();
      fence_acc(acc);
      if (prev >= 0) {  // the product before this one is done: its stage goes back
        wgmma_wait<1>();
        fence_acc(acc);
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = s;
    }
    if (prev >= 0) {
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);
    }

    if (p.splits > 1) {
      // this part's partial tile, then its arrival; the last part to arrive sums
      int4* mine = reinterpret_cast<int4*>(p.ws + (long long)w * 256 * NR);
#pragma unroll
      for (int q = 0; q < NR / 4; ++q)
        mine[q * 256 + ct] = make_int4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
      __threadfence();
      bar_sync(1, 256);
      if (ct == 0) *flag = atomicAdd(&p.counters[r.tile], 1);
      bar_sync(1, 256);
      if (*flag != p.splits - 1) continue;
      __threadfence();
      const int part = w % p.splits;
      for (int o = 0; o < p.splits; ++o) {
        if (o == part) continue;
        const int4* other =
            reinterpret_cast<const int4*>(p.ws + ((long long)r.tile * p.splits + o) * 256 * NR);
#pragma unroll
        for (int q = 0; q < NR / 4; ++q) {
          const int4 v = __ldcg(other + q * 256 + ct);
          acc[4 * q] += v.x;
          acc[4 * q + 1] += v.y;
          acc[4 * q + 2] += v.z;
          acc[4 * q + 3] += v.w;
        }
      }
      if (ct == 0) p.counters[r.tile] = 0;
    }

    // epilogue: register pair (4 q + 2 h, + 1) is row row_in + 8 h, columns 8 q + col_in, + 1
    int32_t* out = static_cast<int32_t*>(p.c) + r.g * p.sc;
    const float* sv = p.scale == nullptr ? nullptr : p.scale + r.g * p.sv;
    const float* bv = p.bias == nullptr ? nullptr : p.bias + r.g * p.sv;
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      const int n = r.n0 + 8 * q + col_in;
      if (n >= p.N) continue;
      const bool two = n + 1 < p.N;
      float s0 = 0.f, s1 = 0.f, b0 = 0.f, b1 = 0.f;
      if (sv != nullptr) {
        s0 = __ldg(sv + n);
        s1 = two ? __ldg(sv + n + 1) : 0.f;
        if (bv != nullptr) {
          b0 = __ldg(bv + n);
          b1 = two ? __ldg(bv + n + 1) : 0.f;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r.m0 + row_in + 8 * h;
        if (m >= p.M) continue;
        int v0 = acc[4 * q + 2 * h], v1 = acc[4 * q + 2 * h + 1];
        if (sv != nullptr) {
          float y0 = __fmul_rn(__int2float_rn(v0), s0);
          float y1 = __fmul_rn(__int2float_rn(v1), s1);
          if (bv != nullptr) {
            y0 = __fadd_rn(y0, b0);
            y1 = __fadd_rn(y1, b1);
          }
          v0 = __float_as_int(y0);
          v1 = __float_as_int(y1);
        }
        int32_t* o = out + (long long)m * p.ldc + n;
        if (p.vec2 && two) {
          *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
        } else {
          o[0] = v0;
          if (two) o[1] = v1;
        }
      }
    }
  }
}

// The 3-D map of group g's (rows x K) int8 operand at ptr + g * sg, rows ld apart, in boxes of
// 128 K-bytes x box_rows rows: (K, rows, G) when the groups lie beyond the rows, else (K, G,
// rows) (a grouped convolution's im2col, whose groups are column runs of one row).
bool make_map_s8(CUtensorMap* map, const void* ptr, int K, int rows, int G, long long ld,
                 long long sg, int box_rows, int* gmajor) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  *gmajor = G > 1 && sg < ld;
  const cuuint64_t gs = G > 1 ? cuuint64_t(sg) : cuuint64_t(ld) * rows;
  const cuuint64_t dims[3] = {cuuint64_t(K > 0 ? K : 1), cuuint64_t(*gmajor ? G : rows),
                              cuuint64_t(*gmajor ? rows : G)};
  const cuuint64_t strides[2] = {*gmajor ? gs : cuuint64_t(ld), *gmajor ? cuuint64_t(ld) : gs};
  const cuuint32_t box[3] = {cuuint32_t(kBK), cuuint32_t(*gmajor ? 1 : box_rows),
                             cuuint32_t(*gmajor ? box_rows : 1)};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch(const void* A, const void* B, Params p, long long lda, long long ldb, long long sa,
           long long sb, int grid, cudaStream_t stream) {
  using C = Cfg<BN>;
  CUtensorMap amap, bmap;
  if (!make_map_s8(&amap, A, p.K, p.M, p.G, lda, sa, kBM, &p.a_gmajor) ||
      !make_map_s8(&bmap, B, p.K, p.N, p.G, ldb, sb, BN, &p.b_gmajor))
    return cudaErrorInvalidValue;
  auto kern = int8_gemm_kernel<BN>;
  static bool smem_set[64] = {};  // the attribute, once a device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !smem_set[dev]) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return e;
    if (dev < 64) smem_set[dev] = true;
  }
  kern<<<grid, kThreads, C::SMEM, stream>>>(amap, bmap, p);
  return cudaGetLastError();
}

bool aligned(const void* p, int n) { return (reinterpret_cast<uintptr_t>(p) % n) == 0; }

}  // namespace int8
}  // namespace bigdl

// A (G, M, K) and B (G, N, K) int8 with row strides lda / ldb and group strides sa / sb (in
// elements; A, B, the row strides and, for G > 1, the group strides 16-byte aligned); C (G, M,
// N) with row stride ldc and group stride sc: int32 when scale is null, else float32 with
// scale (and bias, if not null) per column, group g's at + g * sv. The plan (bn in 16, 32, 64,
// 128, 256; splits; grid) comes from the wrapper; with splits > 1, ws holds tiles x splits x
// 128 x bn int32 partials and counters one int a tile, all 0. Returns the launch's
// cudaError_t.
extern "C" int bigdl_int8_gemm(const void* A, const void* B, void* C, const float* scale,
                               const float* bias, int* counters, int32_t* ws, int G, int M,
                               int N, int K, long long lda, long long ldb, long long ldc,
                               long long sa, long long sb, long long sc, long long sv, int bn,
                               int splits, int grid, void* stream) {
  using namespace bigdl::int8;
  if (G <= 0 || M <= 0 || N <= 0) return cudaSuccess;
  if (K < 0 || splits < 1 || grid < 1 || !aligned(A, 16) || !aligned(B, 16) || lda % 16 != 0 ||
      ldb % 16 != 0 || (G > 1 && (sa % 16 != 0 || sb % 16 != 0)) ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  Params p{};
  p.c = C;
  p.scale = scale;
  p.bias = scale == nullptr ? nullptr : bias;
  p.counters = counters;
  p.ws = ws;
  p.G = G;
  p.M = M;
  p.N = N;
  p.K = K;
  p.splits = splits;
  p.ldc = ldc;
  p.sc = sc;
  p.sv = sv;
  p.vec2 = aligned(C, 8) && ldc % 2 == 0 && (G == 1 || sc % 2 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 16: return launch<16>(A, B, p, lda, ldb, sa, sb, grid, s);
    case 32: return launch<32>(A, B, p, lda, ldb, sa, sb, grid, s);
    case 64: return launch<64>(A, B, p, lda, ldb, sa, sb, grid, s);
    case 128: return launch<128>(A, B, p, lda, ldb, sa, sb, grid, s);
    case 256: return launch<256>(A, B, p, lda, ldb, sa, sb, grid, s);
    default: return cudaErrorInvalidValue;
  }
}
