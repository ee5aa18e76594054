// Shared core of the bf16 tensor-core routes of the fused ResNet kernels for
// Hopper (fused_matmul_sm90.cu: K3 and K3-nhwc, forward and backward;
// fused_conv_sm90.cu: K4; fused_chain_sm90.cu: K5, forward and backward).
// It computes the fused kernels' operands (x_hat = act(x * a + b), dz_eff
// = dz + ds1 + 2 z ds2, the 3x3 conv's tap gather, the residual junction h
// = relu(z * a + b + r)), their epilogues (z with its column sums s1/s2, dx
// with da/db, K5's dz and dr) and fused_gemm.cuh's fixed-order second pass
// (sum_rows) with bf16 wgmma and float32 accumulators in registers;
// fused_gemm_tf32_sm90.cuh (which reuses this header's rings, staging
// stores and column sums) is the float32 tensor-core route. fused_conv.cu
// runs K4's ragged bf16 shapes on gemm_rs_kernel with a ragged 3x3 gather
// of its own (XHatA<9>'s conversion).
//
// gemm_rs_kernel: C (rows x cols) = A (rows x kdim) B (kdim x cols).
// - One block: a producer warpgroup (one working thread, registers given
//   back with setmaxnreg) and two consumer warpgroups of 64 rows each, so a
//   block owns a 128 x BN tile of C (BN = 64, 128 or 256, fitted to cols).
//   Blocks are persistent (at most one per SM) and walk the tiles
//   blockIdx.x, blockIdx.x + gridDim.x, ..., column tiles of the same rows
//   next to each other.
// - B (the weight, a plain bf16 array) goes through TMA into a ring of four
//   (two where shared memory runs short) 128-byte-swizzled tiles, 64 deep
//   in the contraction, guarded by
//   full / empty mbarriers: MN-major (TB = 1, w (kdim, cols) read through
//   the descriptor's transpose bit) or K-major (TB = 0, rows of w).
// - A carries the elementwise prologue, which TMA cannot apply. Each
//   consumer warpgroup copies the raw bf16 rows of its A tile (for K4 the
//   shifted input pixels of each tap, whose image row and column it works
//   out once a tile) and the prologue's parameters of the chunk's columns
//   with 16-byte cp.async into a swizzled ring of four slots; it reads its
//   fragments back with ldmatrix, applies the prologue in float32 in
//   registers, rounds to bf16 and feeds wgmma's register A operand (as
//   flash_fwd_sm90.cu feeds P). With BN <= 128 the conversion of chunk i +
//   1 runs while chunk i's product does, from copies started two chunks
//   ahead; BN = 256 has no registers for a second set of fragments and
//   converts each chunk before its product, from copies three chunks ahead.
//   Elements outside the operand (rows >= rows, columns >= kdim, the conv's
//   zero padding) are 0 after the prologue.
// - K5's forward also writes its A operand (h): the tiles of column tile 0
//   put each converted chunk through a 64 x 64 staging box (stmatrix) and
//   out with one TMA store, so h is written once and never read back.
// - Epilogue: the functor sees each finished float32 pair once and hands
//   back the pair to write (K5's dx: two pairs, dz and dr, the second
//   through the same staging tile once the first store has read it),
//   which goes through a swizzled staging tile in
//   shared memory (stmatrix) and out with one TMA store per 64 x 64 box
//   (the unit clips rows and columns past the end), and values whose column
//   sums are reduced over the thread's two rows, across the accumulator's
//   eight row groups by shuffles that halve what each lane holds, then
//   across the warpgroup's four warps in shared memory in a fixed order,
//   into one partial per 64 rows and column (part1 / part2[64-row tile *
//   cols + c]); sum_rows adds the partials in a fixed order. No atomics:
//   reruns agree bit for bit.
//
// dw_kernel: the weight gradient (K, N) = x_hat^T dz_eff, a contraction
// over the M pixels. Both operands are transformed, so both go to shared
// memory: TMA stages raw x, dz and z tiles (64 pixels deep; for K5 also the
// residual r beside x, x_hat being relu(x * a + b + r)), the consumer
// warpgroup that owns the stage rewrites them in place (x_hat, dz_eff) in
// the swizzled layout, runs fence.proxy.async, and wgmma reads both
// through transposed (MN-major) descriptors. A block owns a 64 x BN tile of
// dw (K = 64 at stage 0 is one m64: no half-empty 128-row tile) and a
// slice of the pixels; its two consumer warpgroups take alternate 64-pixel
// chunks and each writes its own float32 partial, which sum_rows adds in a
// fixed order.
//
// Two load / store policies, a template parameter RG of the operands and
// kernels (as in fused_gemm_tf32_sm90.cuh). Aligned (RG = false, the
// bf16_sm90 route: K and N multiples of 8): the 16-byte copies and TMA
// above. Ragged (RG = true, the bf16_ragged route: any K and N,
// fused_matmul.cu / fused_chain.cu; K4's fused_conv.cu with a 3x3
// gather of its own): the same kernels, rings, swizzle,
// prologues, fragments and column sums, with
// - A, and dw's staged x, r, dz and z tiles, copied into the same swizzled
//   boxes: an operand whose rows are 16-byte multiples by the aligned
//   policy's 16-byte cp.async; otherwise two bf16 elements (4 bytes) a
//   thread, a warp reading 64 neighbouring elements of a row at a time, by
//   4-byte cp.async when the rows start 4-byte aligned (an even row
//   length), else through registers by 2-byte loads (an odd row length
//   puts every other row at an odd element address, which no cp.async can
//   read); dw's producer warpgroup copies its stages (all 128 threads, 56
//   registers each), waits for its copies and arrives on the full barrier,
//   which counts the 128 arrivals;
// - the column parameters by 16-byte cp.async that reads only the columns
//   before ld, the rest zero-filled (columns k >= K give 0 after the
//   prologue);
// - the weight through TMA from a copy with its rows zero-padded to a
//   multiple of 8 (pad_cols_kernel, once a call: weight-sized scratch, no
//   activation is copied or padded), BN at most 128;
// - z, h, dx and K5's dz / dr written from the same staging boxes by
//   predicated stores (16 bytes where the output's rows are 16-byte
//   multiples, else pairs, 4 bytes where the rows allow);
// - dw's partials written element by element.
#pragma once

#include "attn_sm90.cuh"
#include "fused_gemm.cuh"

namespace bigdl_fg {
namespace sm90 {

using namespace bigdl::sm90;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;      // rows of C per block
constexpr int kPartRows = 64; // rows per partial sum (the wrappers size partials by it)
constexpr int kBK = 64;       // contraction depth of one stage: one 128-byte row
constexpr int kStages = 4;
constexpr int kChunk = 64 * 128;  // bytes of one 64 x 64 swizzled bf16 box
constexpr int kDwRows = 64;   // rows of dw per block

// d (64 x N) += A B: A from registers, B MN-major (TB = 1) or K-major (TB = 0)
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);
// d (64 x N) += A B: A and B from shared memory, both MN-major
template <int N>
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[N / 2], uint64_t da, uint64_t db);

// (every accumulator register is listed: wgmma names them all)
template <>
__device__ __forceinline__ void wgmma_rs_t<64, 0>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<64, 1>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<128, 0>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<128, 1>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<256, 1>(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_tt<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_tt<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// -- helpers --------------------------------------------------------------------

// orders this thread's generic-proxy writes to shared memory before later
// async-proxy accesses (wgmma reads, TMA writes) of the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` over `n` threads (0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ uint32_t ldg_pair(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ float2 ldg_f2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// two neighbouring elements of a bf16 or float32 array, as floats
__device__ __forceinline__ float2 ld2(const bf16* p) { return unpack(ldg_pair(p)); }
__device__ __forceinline__ float2 ld2(const float* p) { return ldg_f2(p); }

// ld2, or with RG (rows of any length: p may sit at any element) two
// element loads, the second only when `two` (else 0)
template <bool RG, typename T>
__device__ __forceinline__ float2 ld2g(const T* p, bool two) {
  if constexpr (RG)
    return make_float2(to_f<T>(p[0]), two ? to_f<T>(p[1]) : 0.f);
  else
    return ld2(p);
}

// -- A operands ---------------------------------------------------------------------
//
// The raw bf16 A tile of a 64-deep chunk lands in a shared-memory slot: per
// consumer warpgroup 64 rows of 128 bytes (16-byte unit u of row r at unit
// u ^ (r % 8), so that both the copies and ldmatrix hit distinct banks),
// copied by the warpgroup's own threads with 16-byte cp.async (zero-filled
// where there is no element) ahead of the product. Beside it the slot holds
// the chunk's column parameters per unit u (8 columns): the prologue's
// float32 a and b (or ds1 and ds2) at prm + 32 u and prm + 256 + 32 u, and
// for x_hat the unit's conv tap at prm + 512 + 4 u. An operand's fields are
// kernel parameters; what a thread keeps of it lives in its State:
// issue_rows(st, r0) / issue(st, raw, prm, k0) run on the copying side
// (rows r0 + 16 i, i < 4, unit lt % 8 of each); frag_rows(st, r0) /
// convert(st, f, raw, prm) on the converting side, which reads this
// thread's A fragments back with ldmatrix (slot s of a fragment - k16 slice
// s / 2, its upper 8 columns for odd s - is unit s), applies the prologue
// in float32 in registers, without a branch, and leaves bf16 fragments for
// wgmma. A slot holds kTiles raw tiles of both
// warpgroups (tile k of warpgroup w at k * kATile + w * kATile / 2), then
// each warpgroup's parameters (kParams bytes each).

constexpr int kATile = 2 * 64 * 128;  // one raw 128-row A tile
constexpr int kParams = 1024;

__device__ __forceinline__ void cp_async16(uint8_t* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
// 4 bytes, zero-filled when !ok
__device__ __forceinline__ void cp_async4(uint8_t* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
// the 4 floats at src + c (16-byte aligned) that lie before column ld,
// zeros from ld on
__device__ __forceinline__ void cp_async16n(uint8_t* dst, const float* src, int c, int ld) {
  const int n = min(4, max(0, ld - c));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(n > 0 ? src + c : src), "r"(4 * n)
               : "memory");
}
// the tracked cp.async copies of this thread arrive on `bar` once landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// byte offset of 16-byte unit u of row r in a 128-byte-swizzled tile
__device__ __forceinline__ int swz(int r, int u) { return r * 128 + ((u ^ (r & 7)) << 4); }

// The inverse of ldsm_frag: 16 columns (16 kk ..) of this warp's 16 rows
// of a swizzled tile from a fragment in the accumulator's layout
__device__ __forceinline__ void stsm_frag(uint8_t* tile, int kk, const uint32_t (&f)[4]) {
  const int l = threadIdx.x % 32;
  const int r = 16 * ((threadIdx.x % 128) / 32) + (l & 7) + 8 * ((l >> 3) & 1);
  const uint32_t p = smem_u32(tile) + swz(r, 2 * kk + (l >> 4));
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(p),
               "r"(f[0]), "r"(f[1]), "r"(f[2]), "r"(f[3])
               : "memory");
}

// k16 slice kk of this warp's 16 rows of a warpgroup's tile: the A fragment
// {(g, 2q), (g + 8, 2q), (g, 8 + 2q), (g + 8, 8 + 2q)} as four 8x8 matrices
__device__ __forceinline__ void ldsm_frag(uint32_t (&f)[4], const uint8_t* tile, int kk) {
  const int l = threadIdx.x % 32;
  const int r = 16 * ((threadIdx.x % 128) / 32) + (l & 7) + 8 * ((l >> 3) & 1);
  const uint32_t p = smem_u32(tile) + swz(r, 2 * kk + (l >> 4));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
               : "r"(p)
               : "memory");
}

// the 8 floats of a unit at p: columns c .. c + 7 of src if ok (zeros if
// not), or all `fill` without a source
__device__ __forceinline__ void unit_params(uint8_t* p, const float* src, int c, bool ok,
                                            float fill) {
  if (src != nullptr) {
    cp_async16(p, ok ? src + c : src, ok);
    cp_async16(p + 16, ok ? src + c + 4 : src, ok);
  } else {
    const float4 v = make_float4(fill, fill, fill, fill);
    *reinterpret_cast<float4*>(p) = v;
    *reinterpret_cast<float4*>(p + 16) = v;
  }
}

__device__ __forceinline__ float2 lds_f2(const uint8_t* p) {
  return *reinterpret_cast<const float2*>(p);
}

// -- the ragged policy's copies ------------------------------------------------

// unit_params of a ragged row: the 8 floats from column c (a multiple of 8)
// that lie before ld, zeros from ld on; or all `fill` without a source
__device__ __forceinline__ void unit_params_r(uint8_t* p, const float* src, int c, int ld,
                                              float fill) {
  if (src != nullptr) {
    cp_async16n(p, src, c, ld);
    cp_async16n(p + 16, src, c + 4, ld);
  } else {
    const float4 v = make_float4(fill, fill, fill, fill);
    *reinterpret_cast<float4*>(p) = v;
    *reinterpret_cast<float4*>(p + 16) = v;
  }
}

// A swizzled box of R rows x 64 bf16 columns <- rows r0 .. r0 + R - 1,
// columns c0 .. c0 + 63 of row-major (rows, ld) src, zeros outside it (and
// everywhere without `on`). Rows of 16-byte multiples from a 16-byte
// aligned base go by 16-byte cp.async, thread lt copying unit lt % 8 of
// rows lt / 8 + 16 i (the aligned policy's copies). Otherwise thread lt
// copies the pair of columns c0 + 2 (lt % 32) (+ 1) of rows lt / 32 + 4 i:
// by 4-byte cp.async when every pair sits on a 4-byte boundary (an even
// row length), else by two 2-byte loads through registers, stored once all
// of a batch of rows are in (an odd length puts every other row at an odd
// element address; a cp.async for the rows that are aligned, or word
// loads joined across lanes by a shuffle, both measured slower on an H100).
// FAST: every row's copy in flight at once; else (a producer warpgroup)
// one row, or eight rows' loads, at a time.
template <int R, bool FAST = true>
__device__ __forceinline__ void load_box2(uint8_t* box, const bf16* src, int r0, int rows,
                                          int ld, int c0, bool on = true) {
  const int lt = threadIdx.x % 128;
  if (!(ld & 7) && !(reinterpret_cast<uintptr_t>(src) & 15)) {
    const int u = lt & 7;
    const bool in16 = on && c0 + 8 * u < ld;
    auto unit = [&](int i) {
      const int rl = (lt >> 3) + 16 * i;
      const bool ok = in16 && r0 + rl < rows;
      cp_async16(box + swz(rl, u), ok ? src + (size_t)(r0 + rl) * ld + c0 + 8 * u : src, ok);
    };
    if constexpr (FAST) {
#pragma unroll
      for (int i = 0; i < R / 16; ++i) unit(i);
    } else {
#pragma unroll 1
      for (int i = 0; i < R / 16; ++i) unit(i);
    }
    return;
  }
  const int w = lt & 31;
  const int c = c0 + 2 * w;
  const bool in = on && c < ld;
  const bool two = c + 1 < ld;
  const int wo = 4 * (w & 3);
  const bf16* p = src + (size_t)(r0 + (lt >> 5)) * ld + c;
  if (!(ld & 1) && !(reinterpret_cast<uintptr_t>(src) & 3)) {  // every pair 4-byte aligned
    auto row = [&](int i) {
      const int rl = (lt >> 5) + 4 * i;
      const bool ok = in && r0 + rl < rows;
      cp_async4(box + swz(rl, w >> 2) + wo, ok ? p + (size_t)4 * i * ld : src, ok);
    };
    if constexpr (FAST) {
#pragma unroll
      for (int i = 0; i < R / 4; ++i) row(i);
    } else {
#pragma unroll 1
      for (int i = 0; i < R / 4; ++i) row(i);
    }
    return;
  }
  constexpr int G = FAST ? R / 4 : 8;  // rows loaded before they are stored
#pragma unroll 1
  for (int i0 = 0; i0 < R / 4; i0 += G) {
    uint32_t v[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const bool ok = in && r0 + (lt >> 5) + 4 * (i0 + i) < rows;
      const unsigned short* q =
          reinterpret_cast<const unsigned short*>(p + (size_t)4 * (i0 + i) * ld);
      v[i] = (ok ? uint32_t(__ldg(q)) : 0u) | ((ok && two ? uint32_t(__ldg(q + 1)) : 0u) << 16);
    }
#pragma unroll
    for (int i = 0; i < G; ++i)
      *reinterpret_cast<uint32_t*>(box + swz((lt >> 5) + 4 * (i0 + i), w >> 2) + wo) = v[i];
  }
}

// The inverse: rows r0 .. and columns c0 .. of row-major (rows, ld) dst
// from a swizzled box of R rows x 64 bf16 columns, elements outside dst
// skipped: 16-byte stores, unit lt % 8 of rows lt / 8 + 16 i, where dst's
// rows are 16-byte multiples from a 16-byte aligned base; else pairs,
// columns c0 + 2 (lt % 32) (+ 1) of rows lt / 32 + 4 i, in 4-byte stores
// where the rows allow
template <int R>
__device__ __forceinline__ void store_box2(bf16* dst, const uint8_t* box, int r0, int rows,
                                           int ld, int c0) {
  const int lt = threadIdx.x % 128;
  if (!(ld & 7) && !(reinterpret_cast<uintptr_t>(dst) & 15)) {
    const int u = lt & 7;
    if (c0 + 8 * u >= ld) return;
#pragma unroll
    for (int i = 0; i < R / 16; ++i) {
      const int rl = (lt >> 3) + 16 * i;
      if (r0 + rl < rows)
        *reinterpret_cast<uint4*>(dst + (size_t)(r0 + rl) * ld + c0 + 8 * u) =
            *reinterpret_cast<const uint4*>(box + swz(rl, u));
    }
    return;
  }
  const int w = lt & 31;
  const int c = c0 + 2 * w;
  if (c >= ld) return;
  const bool pairs = !(ld & 1) && !(reinterpret_cast<uintptr_t>(dst) & 3);
#pragma unroll
  for (int i = 0; i < R / 4; ++i) {
    const int rl = (lt >> 5) + 4 * i;
    if (r0 + rl >= rows) continue;
    const uint32_t v = *reinterpret_cast<const uint32_t*>(box + swz(rl, w >> 2) + 4 * (w & 3));
    unsigned short* q = reinterpret_cast<unsigned short*>(dst + (size_t)(r0 + rl) * ld + c);
    if (pairs) {
      *reinterpret_cast<uint32_t*>(q) = v;
    } else {
      q[0] = (unsigned short)(v & 0xffffu);
      if (c + 1 < ld) q[1] = (unsigned short)(v >> 16);
    }
  }
}

// v * a + b in float32 (each operation rounded), then rounded to bf16
__device__ __forceinline__ __nv_bfloat162 affine2(uint32_t v, float2 a, float2 b) {
  const float2 f = unpack(v);
  return __floats2bfloat162_rn(affine(f.x, a.x, b.x), affine(f.y, a.y, b.y));
}

// x_hat = act(x * a + b) of an NHWC input seen through a 1x1 (taps = 1: K3,
// x (rows, C) row-major) or 3x3 (taps = 9: K4, pad 1, stride 1 or 2) conv:
// row m is output pixel (b, oh, ow), column kk = tap * C + c in the HWIO
// weight's row order. Needs C % 8 == 0 (a unit never straddles a tap).
// Without a prologue a = 1 and b = 0, which leave x as it is; columns past
// the contraction read a = b = 0 and x = 0; the ReLU is a max with 0 (or
// -inf without it) that keeps NaN; a tap in the zero padding, or past the
// contraction, is masked to 0 after the prologue.
template <int TAPS, bool RG = false>
struct XHatA {
  static_assert(TAPS == 1 || !RG, "the ragged policy is for the 1x1 conv");
  static constexpr int kTiles = 1;
  static constexpr bool kStoreA = false;
  const bf16* x;
  const float* a;
  const float* b;
  int rows, C, H, W, H2, W2, stride;
  int relu;
  // The per-thread state (the parameters above stay in the kernel's
  // parameter space): the first copy row, and (3x3) the element offset of
  // each copy row's tap-0 pixel with bit t set when tap t lies inside the
  // image (0 past the end); the same bits of the fragment rows. A 1x1 conv
  // keeps no more than the first row: its registers go to the
  // accumulators of BN = 256.
  struct State {
    int ir0;
    int ibase[TAPS == 9 ? 4 : 1];
    uint32_t itm[TAPS == 9 ? 4 : 1];
    uint32_t ctm[TAPS == 9 ? 2 : 1];
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
    if constexpr (TAPS == 9) {
#pragma unroll
      for (int i = 0; i < 4; ++i) geometry(r0 + 16 * i, st.ibase[i], st.itm[i]);
    }
  }
  __device__ __forceinline__ void frag_rows(State& st, int r0) const {
    if constexpr (TAPS == 9) {
      int unused;
#pragma unroll
      for (int i = 0; i < 2; ++i) geometry(r0 + 8 * i, unused, st.ctm[i]);
    }
  }
  __device__ __forceinline__ void issue(const State& st, uint8_t* raw, uint8_t* prm,
                                        int k0) const {
    const int lt = threadIdx.x % 128;
    const int u = lt & 7;
    const int kc = k0 + 8 * u;
    if constexpr (RG) {
      load_box2<64>(raw, x, st.ir0 - (lt >> 3), rows, C, k0);
      if (lt < 8) {
        unit_params_r(prm + 32 * u, a, kc, C, 1.f);
        unit_params_r(prm + 256 + 32 * u, b, kc, C, 0.f);
      }
      return;
    }
    const int tap = TAPS == 1 ? (kc < C ? 0 : 1) : kc / C;
    const int c = kc - tap * C;
    const bool in = tap < TAPS;
    const int off = ((tap / 3) * W + tap % 3) * C + c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok;
      int e;
      if constexpr (TAPS == 1) {
        const int r = st.ir0 + 16 * i;
        ok = in && r < rows;
        e = r * C + c;
      } else {
        ok = in && ((st.itm[i] >> tap) & 1u);
        e = st.ibase[i] + off;
      }
      cp_async16(raw + swz((lt >> 3) + 16 * i, u), ok ? x + e : x, ok);
    }
    if (lt < 8) {
      unit_params(prm + 32 * u, a, c, in, 1.f);
      unit_params(prm + 256 + 32 * u, b, c, in, 0.f);
      if constexpr (TAPS == 9) reinterpret_cast<int*>(prm + 512)[u] = in ? tap : 31;
    }
  }
  // (1x1: columns past C read x = 0, a = b = 0 and give 0 without a mask)
  __device__ __forceinline__ void convert(const State& st, uint32_t (&f)[4][4],
                                          const uint8_t* raw, const uint8_t* prm) const {
    const int q = threadIdx.x % 4;
    const float lo_f = relu ? 0.f : -INFINITY;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(lo_f, lo_f);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldsm_frag(f[kk], raw, kk);
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const float2 av = lds_f2(prm + 32 * s + 8 * q);
      const float2 bv = lds_f2(prm + 256 + 32 * s + 8 * q);
      const int tap = TAPS == 9 ? reinterpret_cast<const int*>(prm + 512)[s] : 0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t& w = f[s >> 1][2 * (s & 1) + i];
        __nv_bfloat162 h = __hmax2_nan(affine2(w, av, bv), lo);
        const bool ok = TAPS == 1 || ((st.ctm[i] >> tap) & 1u);
        w = ok ? *reinterpret_cast<uint32_t*>(&h) : 0u;
      }
    }
  }
};

// dz_eff(m, n) = dz + ds1 + 2 z ds2 rounded to bf16 of row-major (rows, ld)
// dz and z: the A operand of K3's dx. A slot holds the dz tile, then the z
// tile; without stats z and ds1 / ds2 are zeros, which leave dz as it is.
// Columns past ld give 0; rows past the end give values whose products are
// never written.
template <bool RG = false>
struct DzEffA {
  static constexpr int kTiles = 2;
  static constexpr bool kStoreA = false;
  const bf16* dz;
  const bf16* z;
  const float* ds1;
  const float* ds2;
  int rows, ld, stats;
  struct State {
    int ir0;  // the first copy row
  };

  __device__ __forceinline__ void issue_rows(State& st, int r0) const { st.ir0 = r0; }
  __device__ __forceinline__ void frag_rows(State&, int) const {}
  __device__ __forceinline__ void issue(const State& st, uint8_t* raw, uint8_t* prm,
                                        int k0) const {
    const int lt = threadIdx.x % 128;
    const int u = lt & 7;
    const int n = k0 + 8 * u;
    if constexpr (RG) {
      const int r0 = st.ir0 - (lt >> 3);
      load_box2<64>(raw, dz, r0, rows, ld, k0);
      load_box2<64>(raw + kATile, stats ? z : dz, r0, rows, ld, k0, stats);
      if (lt < 8) {
        unit_params_r(prm + 32 * u, stats ? ds1 : nullptr, n, ld, 0.f);
        unit_params_r(prm + 256 + 32 * u, stats ? ds2 : nullptr, n, ld, 0.f);
      }
      return;
    }
    const bool in = n < ld;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = st.ir0 + 16 * i;
      const bool ok = in && r < rows;
      const int o = swz((lt >> 3) + 16 * i, u);
      const int e = r * ld + n;
      cp_async16(raw + o, ok ? dz + e : dz, ok);
      cp_async16(raw + kATile + o, ok && stats ? z + e : dz, ok && stats);
    }
    if (lt < 8) {
      unit_params(prm + 32 * u, stats ? ds1 : nullptr, n, in, 0.f);
      unit_params(prm + 256 + 32 * u, stats ? ds2 : nullptr, n, in, 0.f);
    }
  }
  __device__ __forceinline__ void convert(const State&, uint32_t (&f)[4][4],
                                          const uint8_t* raw, const uint8_t* prm) const {
    const int q = threadIdx.x % 4;
    uint32_t zf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldsm_frag(f[kk], raw, kk);
      ldsm_frag(zf[kk], raw + kATile, kk);
    }
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const float2 d1 = lds_f2(prm + 32 * s + 8 * q);
      const float2 d2 = lds_f2(prm + 256 + 32 * s + 8 * q);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t& w = f[s >> 1][2 * (s & 1) + i];
        const float2 v = unpack(w);
        const float2 zz = unpack(zf[s >> 1][2 * (s & 1) + i]);
        w = pack_bf16(__fadd_rn(__fadd_rn(v.x, d1.x), __fmul_rn(__fmul_rn(2.f, zz.x), d2.x)),
                      __fadd_rn(__fadd_rn(v.y, d1.y), __fmul_rn(__fmul_rn(2.f, zz.y), d2.y)));
      }
    }
  }
};

// h(m, k) = relu(z * a + b + r) rounded to bf16 of row-major (rows, ld) z
// and r: K5's residual junction, the A operand of its forward (the kernel
// also writes h, from the converted fragments: kStoreA). A slot holds the z
// tile, then the r tile, with the chunk's a and b beside them. Columns past
// ld read z = r = a = b = 0 and give 0; rows past the end give values whose
// products and h are never written.
template <bool RG = false>
struct ResidA {
  static constexpr int kTiles = 2;
  static constexpr bool kStoreA = true;
  const bf16* z;
  const bf16* r;
  const float* a;
  const float* b;
  int rows, ld;
  struct State {
    int ir0;  // the first copy row
  };

  __device__ __forceinline__ void issue_rows(State& st, int r0) const { st.ir0 = r0; }
  __device__ __forceinline__ void frag_rows(State&, int) const {}
  __device__ __forceinline__ void issue(const State& st, uint8_t* raw, uint8_t* prm,
                                        int k0) const {
    const int lt = threadIdx.x % 128;
    const int u = lt & 7;
    const int c = k0 + 8 * u;
    if constexpr (RG) {
      const int r0 = st.ir0 - (lt >> 3);
      load_box2<64>(raw, z, r0, rows, ld, k0);
      load_box2<64>(raw + kATile, r, r0, rows, ld, k0);
      if (lt < 8) {
        unit_params_r(prm + 32 * u, a, c, ld, 0.f);
        unit_params_r(prm + 256 + 32 * u, b, c, ld, 0.f);
      }
      return;
    }
    const bool in = c < ld;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = st.ir0 + 16 * i;
      const bool ok = in && row < rows;
      const int o = swz((lt >> 3) + 16 * i, u);
      const int e = row * ld + c;
      cp_async16(raw + o, ok ? z + e : z, ok);
      cp_async16(raw + kATile + o, ok ? r + e : r, ok);
    }
    if (lt < 8) {
      unit_params(prm + 32 * u, a, c, in, 0.f);
      unit_params(prm + 256 + 32 * u, b, c, in, 0.f);
    }
  }
  __device__ __forceinline__ void convert(const State&, uint32_t (&f)[4][4],
                                          const uint8_t* raw, const uint8_t* prm) const {
    const int q = threadIdx.x % 4;
    uint32_t rf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldsm_frag(f[kk], raw, kk);
      ldsm_frag(rf[kk], raw + kATile, kk);
    }
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const float2 av = lds_f2(prm + 32 * s + 8 * q);
      const float2 bv = lds_f2(prm + 256 + 32 * s + 8 * q);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t& w = f[s >> 1][2 * (s & 1) + i];
        const float2 zz = unpack(w);
        const float2 rr = unpack(rf[s >> 1][2 * (s & 1) + i]);
        w = pack_bf16(relu_f(__fadd_rn(affine(zz.x, av.x, bv.x), rr.x)),
                      relu_f(__fadd_rn(affine(zz.y, av.y, bv.y), rr.y)));
      }
    }
  }
};

// -- epilogues: pair(r, c, v0, v1, s1, s2) for columns c, c + 1 of row r
// (both inside C) returns the two values to write and sets the values s1 /
// s2 whose column sums are kept; an epilogue with kOut2 has pair2 instead,
// which also sets the pair of a second output of C's shape ---------------------------

// z in bf16; with stats, s1 = z and s2 = z^2 from the float32 sums
struct StoreZ2 {
  static constexpr bool kOut2 = false;
  __device__ __forceinline__ float2 pair(int, int, float v0, float v1, float2& s1,
                                         float2& s2) const {
    s1 = make_float2(v0, v1);
    s2 = make_float2(__fmul_rn(v0, v0), __fmul_rn(v1, v1));
    return make_float2(v0, v1);
  }
};

// K3's dx: the ReLU mask from the recomputed x * a + b, dx = dxn * a, and
// da = sum dxn x, db = sum dxn; x in T (bf16 or float32). RG: rows of any
// length ld, column c + 1 read only inside them
template <typename T, bool RG = false>
struct DxEpi2 {
  static constexpr bool kOut2 = false;
  const T* x;
  const float* a;
  const float* b;
  int ld, prologue, relu;
  __device__ __forceinline__ float2 pair(int r, int c, float v0, float v1, float2& s1,
                                         float2& s2) const {
    const bool two = !RG || c + 1 < ld;
    const float2 xv = ld2g<RG>(x + ((size_t)r * ld + c), two);
    float2 av = make_float2(1.f, 1.f), xn = xv;
    if (prologue) {
      av = ld2g<RG>(a + c, two);
      const float2 bv = ld2g<RG>(b + c, two);
      xn = make_float2(affine(xv.x, av.x, bv.x), affine(xv.y, av.y, bv.y));
    }
    const float d0 = (relu && !(xn.x > 0.f)) ? 0.f : v0;
    const float d1 = (relu && !(xn.y > 0.f)) ? 0.f : v1;
    s1 = make_float2(d0 * xv.x, d1 * xv.y);
    s2 = make_float2(d0, d1);
    return prologue ? make_float2(d0 * av.x, d1 * av.y) : make_float2(d0, d1);
  }
};

// K5's dz / dr: g = [z * a + b + r > 0] (dh + v), dz = g a, dr = g (the
// second output), and da = sum g z, db = sum g; z, r and dh in T. RG: as
// DxEpi2's
template <typename T, bool RG = false>
struct ChainDxEpi2 {
  static constexpr bool kOut2 = true;
  const T* z;
  const T* r;
  const T* dh;
  const float* a;
  const float* b;
  int ld;
  __device__ __forceinline__ float2 pair2(int m, int c, float v0, float v1, float2& s1,
                                          float2& s2, float2& o2) const {
    const size_t i = (size_t)m * ld + c;
    const bool two = !RG || c + 1 < ld;
    const float2 zv = ld2g<RG>(z + i, two);
    const float2 rv = ld2g<RG>(r + i, two);
    const float2 dv = ld2g<RG>(dh + i, two);
    const float2 av = ld2g<RG>(a + c, two);
    const float2 bv = ld2g<RG>(b + c, two);
    const float g0 = __fadd_rn(affine(zv.x, av.x, bv.x), rv.x) > 0.f ? v0 + dv.x : 0.f;
    const float g1 = __fadd_rn(affine(zv.y, av.y, bv.y), rv.y) > 0.f ? v1 + dv.y : 0.f;
    s1 = make_float2(g0 * zv.x, g1 * zv.y);
    s2 = make_float2(g0, g1);
    o2 = make_float2(g0, g1);
    return make_float2(g0 * av.x, g1 * av.y);
  }
};

// -- the product with A from registers ---------------------------------------------

// One round of a warp sum that halves what each lane holds: of v[0, N) the
// lane keeps the half its lane bit O selects, adds the partner lane's
// (lane ^ O) copy of that half, and leaves the sums in v[0, N / 2).
template <int N, int O, int L>
__device__ __forceinline__ void halve(float (&v)[L]) {
  const bool up = (threadIdx.x & O) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = up ? v[i] : v[i + N / 2];
    const float keep = up ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// TMA store of a 64 x 64 box from shared memory at (c0, c1, 0) of a map
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const uint8_t* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(0)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the issued stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The column sums of a finished tile (consumer warpgroup wg, rows rw0 ..
// rw0 + 63, columns col0 ..): on entry acc[4 jj ..] holds s1 of columns
// 8 jj + 2 q (+1), then s2 of them, summed over the thread's two rows. The
// sum over the eight row groups g of the warp leaves lane (g, q) with pairs
// jj = BN / 64 * g + p, p < BN / 64, in acc[4 p ..]; then over the
// warpgroup's four warps in `red` (float[8][2][BN]) in a fixed order, one
// partial per 64 rows: part1 / part2[(rw0 / 64) * cols + col0 + c].
template <int BN>
__device__ __forceinline__ void col_sums(float (&acc)[BN / 2], float* red, int wg, int rw0,
                                         int col0, int rows, int cols, float* part1,
                                         float* part2) {
  const int lt = threadIdx.x % 128;
  const int wq = lt / 32;
  const int g = (lt % 32) / 4;
  const int q = lt % 4;
  halve<BN / 2, 16>(acc);
  halve<BN / 4, 8>(acc);
  halve<BN / 8, 4>(acc);
  float* rw = red + (4 * wg + wq) * 2 * BN + 2 * q;
#pragma unroll
  for (int p = 0; p < BN / 64; ++p) {
    const int c = 8 * (BN / 64 * g + p);
    rw[c] = acc[4 * p];
    rw[c + 1] = acc[4 * p + 1];
    rw[BN + c] = acc[4 * p + 2];
    rw[BN + c + 1] = acc[4 * p + 3];
  }
  bar_sync(4 + wg, 128);
  for (int c = lt; c < BN && col0 + c < cols && rw0 < rows; c += 128) {
    const float* rr = red + 4 * wg * 2 * BN + c;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int w4 = 0; w4 < 4; ++w4) {
      s1 += rr[w4 * 2 * BN];
      s2 += rr[w4 * 2 * BN + BN];
    }
    part1[(size_t)(rw0 / 64) * cols + col0 + c] = s1;
    part2[(size_t)(rw0 / 64) * cols + col0 + c] = s2;
  }
}

// Shared memory of gemm_rs_kernel: SA slots of A (raw tiles, then the
// parameters), the output staging (128 x BN bf16), with AS a 64 x 64 staging
// box of the converted A per consumer warpgroup, the column-sum scratch, SB
// stages of B (four where they fit, else two), the barriers.
template <int BN, int KT, bool AS>
struct RsCfg {
  static constexpr int SA = 4;
  static constexpr int A_BYTES = KT * kATile + 2 * kParams;
  static constexpr int B_BYTES = BN * kBK * 2;
  static constexpr int OUT_OFF = SA * A_BYTES;
  static constexpr int AOUT_OFF = OUT_OFF + kBM * BN * 2;
  static constexpr int RED_OFF = AOUT_OFF + (AS ? 2 * kChunk : 0);  // float red[8][2][BN]
  static constexpr int B_OFF = RED_OFF + 8 * 2 * BN * 4;
  static constexpr int SB = 1024 + B_OFF + 4 * B_BYTES + 64 <= 232448 ? 4 : 2;
  static constexpr int BAR_OFF = B_OFF + SB * B_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 2 * SB * 8;
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// Grid: min(tiles, SMs) persistent blocks of 384 threads (the producer
// warpgroup, then two consumer warpgroups) over the ceil(rows / 128) x
// ceil(cols / BN) tiles (t = row tile * column tiles +
// column tile), each in 64-deep chunks of the contraction. A consumer
// warpgroup multiplies chunk i while it converts chunk i + 1's A tile,
// whose copies it started two chunks earlier. C goes out in bf16 through
// omap (cols, rows) in 64 x 64 boxes; with part1 != nullptr, the column
// sums of the epilogue's s1 / s2 over each 64 rows (a warpgroup's half of
// a tile) go to part1 / part2[64-row tile * cols + c]. omap2 is a second
// output: with AOp::kStoreA the converted A (rows, kdim), written once by
// the tiles of column tile 0; with Epi::kOut2 the epilogue's second value
// (rows, cols), through the same staging tile after the first. With RG the
// outputs go to outp (rows, cols) and out2p (rows, kdim or cols) by element
// stores, and omap / omap2 are not read.
template <int BN, int TB, bool RG, class AOp, class Epi>
__global__ void __launch_bounds__(384, 1)
    gemm_rs_kernel(const __grid_constant__ CUtensorMap bmap,
                   const __grid_constant__ CUtensorMap omap,
                   const __grid_constant__ CUtensorMap omap2, const AOp aop0, const Epi epi,
                   int rows, int cols, int kdim, float* __restrict__ part1,
                   float* __restrict__ part2, bf16* __restrict__ outp,
                   bf16* __restrict__ out2p) {
  using Cfg = RsCfg<BN, AOp::kTiles, AOp::kStoreA>;
  constexpr int SA = Cfg::SA, SB = Cfg::SB;
  // BN = 256 keeps one set of A fragments: a second one beside its 128
  // accumulators would spill, so its chunks convert before their products
  constexpr bool kOverlap = BN <= 128;
  static_assert(kOverlap || !AOp::kStoreA, "A is stored from the overlapped conversion");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(smem + Cfg::RED_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cfg::BAR_OFF);
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

  if (threadIdx.x < 128) {  // producer warpgroup: B
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int col0 = (t % ntn) * BN;
        for (int j = 0; j < nch; ++j, ++it) {
          const int s = it % SB;
          mbar_wait(&empty[s], ((it / SB) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], Cfg::B_BYTES);
          uint8_t* dst = smem + Cfg::B_OFF + s * Cfg::B_BYTES;
          if (TB) {  // BN / 64 boxes of 64 columns x 64 contraction rows
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)
              tma_load_3d(dst + c * kChunk, &bmap, &full[s], col0 + 64 * c, j * kBK, 0);
          } else {  // one box of 64 contraction columns x BN rows
            tma_load_3d(dst, &bmap, &full[s], j * kBK, col0, 0);
          }
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
  const int rofs = 64 * wg + 16 * wq + g;  // this thread's first row in a tile
  const AOp& aop = aop0;
  typename AOp::State st;
  uint8_t* aw = smem + wg * (kATile / 2);                      // slot 0: raw rows
  uint8_t* pw = smem + AOp::kTiles * kATile + wg * kParams;    // ... parameters
  uint8_t* ost = smem + Cfg::OUT_OFF + wg * (BN * 128);
  uint8_t* ast = smem + Cfg::AOUT_OFF + wg * kChunk;
  // the copies run SA - 2 chunks ahead of the conversion, through the same
  // (tile, chunk) sequence; one cp.async group per chunk (empty past the end)
  int ti = blockIdx.x, ji = 0, issued = 0;
  auto issue_next = [&]() {
    if (ti < ntiles) {
      if (ji == 0) aop.issue_rows(st, (ti / ntn) * kBM + 64 * wg + (lt >> 3));
      const int o = (issued % SA) * Cfg::A_BYTES;
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

  // (kStoreA) chunk jj of tile tt's converted A, in column tile 0: stmatrix
  // into this warpgroup's staging box and out by one TMA store (thread 0
  // waited for the previous store to read the box before the barrier that
  // precedes the conversion); with RG by the warpgroup's predicated stores,
  // which end before its next conversion barrier
  auto store_a = [&](const uint32_t(&f)[4][4], int tt, int jj) {
    if constexpr (AOp::kStoreA && RG) {
      if (tt < ntiles && tt % ntn == 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) stsm_frag(ast, kk, f[kk]);
        bar_sync(6 + wg, 128);
        store_box2<64>(out2p, ast, (tt / ntn) * kBM + 64 * wg, rows, kdim, jj * kBK);
      }
    } else if constexpr (AOp::kStoreA) {
      if (tt < ntiles && tt % ntn == 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) stsm_frag(ast, kk, f[kk]);
        fence_proxy_async();
        bar_sync(6 + wg, 128);
        const int rw = (tt / ntn) * kBM + 64 * wg;
        if (lt == 0 && rw < rows) {
          tma_store_3d(&omap2, ast, jj * kBK, rw);
          bulk_commit();
        }
      }
    }
  };

  float acc[BN / 2];
  uint32_t fa[4][4], fb[4][4];  // the A fragments of this chunk and the next
  int t = blockIdx.x, j = 0, it = 0;
  aop.frag_rows(st, (t / ntn) * kBM + rofs);
  if constexpr (kOverlap) {
    cp_async_wait<SA - 2>();
    bar_sync(2 + wg, 128);
    aop.convert(st, fa, aw, pw);
    store_a(fa, t, 0);
  }
  // chunk `it` (tile t, chunk j): its product from fcur while the next
  // chunk's A goes into fnext, then after a tile's last chunk its epilogue;
  // false when the block's tiles are done. The two fragment sets take
  // turns, so no copy joins them (ptxas would serialise the products).
  auto step = [&](uint32_t(&fcur)[4][4], uint32_t(&fnext)[4][4]) {
    const int row0 = (t / ntn) * kBM;
    const int col0 = (t % ntn) * BN;
    const int rw0 = row0 + 64 * wg;  // this warpgroup's first row
    if (j == 0) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    }
    if constexpr (!kOverlap) {  // this chunk's A, then its product
      if (j == 0) aop.frag_rows(st, (t / ntn) * kBM + rofs);
      cp_async_wait<SA - 2>();
      bar_sync(2 + wg, 128);
      const int o = (it % SA) * Cfg::A_BYTES;
      aop.convert(st, fcur, aw + o, pw + o);
    }
    int tn = t, jn = j + 1;  // the next chunk
    if (jn == nch) {
      jn = 0;
      tn += gridDim.x;
      if constexpr (kOverlap) aop.frag_rows(st, (tn / ntn) * kBM + rofs);
    }
    const int s = it % SB;
    mbar_wait(&full[s], (it / SB) & 1);
    const uint8_t* bt = smem + Cfg::B_OFF + s * Cfg::B_BYTES;
    fence_regs(acc);
    fence_regs(fcur);
    if constexpr (kOverlap) fence_regs(fnext);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_t<BN, TB>(acc, fcur[kk],
                         TB ? mnmajor_desc<128>(bt, kChunk, kk)
                            : kmajor_desc<128>(bt, BN * 128, kk));
    wgmma_commit();
    if constexpr (kOverlap) {
      // the next chunk's A while the product runs (past the end: a stale
      // slot, never used)
      cp_async_wait<SA - 3>();
      if (AOp::kStoreA && lt == 0) bulk_wait_read();
      bar_sync(2 + wg, 128);
      const int o = ((it + 1) % SA) * Cfg::A_BYTES;
      aop.convert(st, fnext, aw + o, pw + o);
      store_a(fnext, tn, jn);
    }
    fence_regs(acc);
    fence_regs(fcur);
    if constexpr (kOverlap) fence_regs(fnext);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(fcur);
    if (lt % 32 == 0) mbar_arrive(&empty[s]);
    issue_next();  // into the slot converted two chunks ago

    if (jn == 0) {
      // epilogue: the pairs into the staging tile (the previous tile's
      // store has read it), then one TMA store per 64 columns; the column
      // sums of the tile's rows take the place of the finished accumulators
      if (lt == 0) bulk_wait_read();
      bar_sync(4 + wg, 128);
      // 16 columns (pairs jj = 2 p, 2 p + 1) of the warp's 16 rows at a
      // time, written by one stmatrix: the four 8x8 matrices (rows g / g +
      // 8, columns 0-7 / 8-15) are the fragment layout of the accumulator
      uint32_t out2[Epi::kOut2 ? BN / 16 : 1][4];  // the second output, packed
#pragma unroll
      for (int p = 0; p < BN / 16; ++p) {
        uint32_t out[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int jj = 2 * p + h;
          const int c = 8 * jj + 2 * q;
          float2 t1 = make_float2(0.f, 0.f), t2 = make_float2(0.f, 0.f);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = rw0 + 16 * wq + g + 8 * i;
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
            out[2 * h + i] = pack_bf16(v.x, v.y);
            if constexpr (Epi::kOut2) out2[p][2 * h + i] = pack_bf16(v2.x, v2.y);
          }
          acc[4 * jj] = t1.x;
          acc[4 * jj + 1] = t1.y;
          acc[4 * jj + 2] = t2.x;
          acc[4 * jj + 3] = t2.y;
        }
        stsm_frag(ost + (p / 4) * kChunk, p % 4, out);
      }
      fence_proxy_async();
      bar_sync(4 + wg, 128);
      if constexpr (RG) {
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          store_box2<64>(outp, ost + c * kChunk, rw0, rows, cols, col0 + 64 * c);
      } else if (lt == 0 && rw0 < rows) {
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          if (col0 + 64 * c < cols) tma_store_3d(&omap, ost + c * kChunk, col0 + 64 * c, rw0);
        bulk_commit();
      }
      if constexpr (Epi::kOut2) {
        // the second output through the same staging tile, once the first
        // store has read it
        if (lt == 0) bulk_wait_read();
        bar_sync(4 + wg, 128);
#pragma unroll
        for (int p = 0; p < BN / 16; ++p) stsm_frag(ost + (p / 4) * kChunk, p % 4, out2[p]);
        fence_proxy_async();
        bar_sync(4 + wg, 128);
        if constexpr (RG) {
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            store_box2<64>(out2p, ost + c * kChunk, rw0, rows, cols, col0 + 64 * c);
        } else if (lt == 0 && rw0 < rows) {
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            if (col0 + 64 * c < cols)
              tma_store_3d(&omap2, ost + c * kChunk, col0 + 64 * c, rw0);
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
    if constexpr (kOverlap) {
      while (step(fa, fb) && step(fb, fa)) {
      }
    } else {
      while (step(fa, fb)) {
      }
    }
  }
  if (lt == 0) bulk_wait();
}

// -- the weight gradient: both operands transformed in shared memory -------------

template <int BN, bool RES>
struct DwCfg {
  static constexpr int X_BYTES = kChunk;                 // 64 pixels x 64 rows of dw
  static constexpr int D_BYTES = BN / 64 * kChunk;       // 64 pixels x BN columns
  // x, dz, z (and with RES the residual r, like x)
  static constexpr int STAGE = (RES ? 2 : 1) * X_BYTES + 2 * D_BYTES;
  static constexpr int S = kStages;
  static constexpr int BAR_OFF = S * STAGE;
  static constexpr int SMEM = 1024 + BAR_OFF + 2 * S * 8;
};

// 8 bf16 values of a 16-byte unit, through f(e, v) -> v
template <class F>
__device__ __forceinline__ uint4 map8(uint4 u, F f) {
  uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float2 v = unpack(w[p]);
    w[p] = pack_bf16(f(2 * p, v.x), f(2 * p + 1, v.y));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Grid (ceil(K / 64), ceil(N / BN), splits), 384 threads; split z covers
// pixels [z * per, min(M, (z + 1) * per)), per a multiple of 128.
// Consumer warpgroup w writes its float32 partial of the block's 64 x BN
// tile of dw to ws[((2 z + w) * K + k) * N + n]. With RES (K5) x_hat is
// relu(x * a + b + r) of x and the residual r (rmap, staged like x). With
// RG the producer warpgroup's 128 threads copy the stage's boxes from xp,
// dzp, zp, rp (the maps are not read), wait for their copies and arrive;
// the partials are written element by element.
template <int BN, bool RES, bool RG>
__global__ void __launch_bounds__(384, 1)
    dw_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dzmap,
              const __grid_constant__ CUtensorMap zmap, const __grid_constant__ CUtensorMap rmap,
              const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ ds1, const float* __restrict__ ds2,
              float* __restrict__ ws, int M, int K, int N, int prologue, int relu, int stats,
              int per, const bf16* __restrict__ xp, const bf16* __restrict__ dzp,
              const bf16* __restrict__ zp, const bf16* __restrict__ rp) {
  using Cfg = DwCfg<BN, RES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cfg::BAR_OFF);
  uint64_t* empty = full + Cfg::S;
  const int kc0 = blockIdx.x * kDwRows;
  const int n0 = blockIdx.y * BN;
  const int mb = blockIdx.z * per;
  const int me = min(M, mb + per);
  const int nch = (me - mb + 63) / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg::S; ++s) {
      mbar_init(&full[s], RG ? 128 : 1);  // (RG) one arrival per producer thread
      mbar_init(&empty[s], 4);  // the four warps of the stage's warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    // (RG) 56 registers for the copies' batches of rows; the consumers give
    // up 8 (the 64,512 granted at launch: 128 x 56 + 256 x 224)
    setmaxnreg_dec<RG ? 56 : 40>();
    if constexpr (RG) {
      for (int j = 0; j < nch; ++j) {
        const int s = j % Cfg::S;
        mbar_wait(&empty[s], ((j / Cfg::S) & 1) ^ 1);
        uint8_t* dst = smem + s * Cfg::STAGE;
        const int m = mb + 64 * j;
        load_box2<64, false>(dst, xp, m, M, K, kc0);
        if (RES) load_box2<64, false>(dst + Cfg::X_BYTES + 2 * Cfg::D_BYTES, rp, m, M, K, kc0);
        for (int c = 0; c < BN / 64; ++c) {
          load_box2<64, false>(dst + Cfg::X_BYTES + c * kChunk, dzp, m, M, N, n0 + 64 * c);
          if (stats)
            load_box2<64, false>(dst + Cfg::X_BYTES + Cfg::D_BYTES + c * kChunk, zp, m, M, N,
                                 n0 + 64 * c);
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        mbar_arrive(&full[s]);
      }
    } else if (threadIdx.x == 0) {
      for (int j = 0; j < nch; ++j) {
        const int s = j % Cfg::S;
        mbar_wait(&empty[s], ((j / Cfg::S) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s],
                              (RES ? 2 : 1) * Cfg::X_BYTES + (stats ? 2 : 1) * Cfg::D_BYTES);
        uint8_t* dst = smem + s * Cfg::STAGE;
        const int m = mb + 64 * j;
        tma_load_3d(dst, &xmap, &full[s], kc0, m, 0);
        if (RES) tma_load_3d(dst + Cfg::X_BYTES + 2 * Cfg::D_BYTES, &rmap, &full[s], kc0, m, 0);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c) {
          tma_load_3d(dst + Cfg::X_BYTES + c * kChunk, &dzmap, &full[s], n0 + 64 * c, m, 0);
          if (stats)
            tma_load_3d(dst + Cfg::X_BYTES + Cfg::D_BYTES + c * kChunk, &zmap, &full[s],
                        n0 + 64 * c, m, 0);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<RG ? 224 : 232>();
  const int wg = threadIdx.x / 128 - 1;
  const int lt = threadIdx.x % 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int j = wg; j < nch; j += 2) {
    const int s = j % Cfg::S;
    mbar_wait(&full[s], (j / Cfg::S) & 1);
    uint8_t* xt = smem + s * Cfg::STAGE;
    uint8_t* dzt = xt + Cfg::X_BYTES;
    const uint8_t* zt = dzt + Cfg::D_BYTES;
    const uint8_t* rt = zt + Cfg::D_BYTES;
    const int m0 = mb + 64 * j;
    // x -> x_hat in place; unit p of row m holds columns 8 (p ^ (m % 8)) ..
    // (the 128-byte swizzle); pixels past the slice and columns past K give 0
    for (int u = lt; u < 512; u += 128) {
      const int m = u >> 3;
      const int kc = kc0 + 8 * ((u & 7) ^ (m & 7));
      uint4* p = reinterpret_cast<uint4*>(xt + m * 128 + (u & 7) * 16);
      if (m0 + m >= me || kc >= K) {
        *p = make_uint4(0, 0, 0, 0);
      } else if constexpr (RES) {
        const uint4 ru = *reinterpret_cast<const uint4*>(rt + m * 128 + (u & 7) * 16);
        const uint32_t rw[4] = {ru.x, ru.y, ru.z, ru.w};
        *p = map8(*p, [&](int e, float v) {
          if (RG && kc + e >= K) return 0.f;  // (RG) a unit across K's end
          const float2 rr = unpack(rw[e >> 1]);
          return relu_f(__fadd_rn(affine(v, __ldg(a + kc + e), __ldg(b + kc + e)),
                                  (e & 1) ? rr.y : rr.x));
        });
      } else if (prologue || relu) {
        *p = map8(*p, [&](int e, float v) {
          if (RG && kc + e >= K) return 0.f;
          if (prologue) v = round_to<bf16>(affine(v, __ldg(a + kc + e), __ldg(b + kc + e)));
          return relu ? relu_f(v) : v;
        });
      }
    }
    // dz -> dz_eff in place, column chunk c of 64 at c * kChunk
    for (int u = lt; u < BN * 8; u += 128) {
      const int m = (u >> 3) & 63;
      const int off = (u >> 9) * kChunk + m * 128 + (u & 7) * 16;
      const int n = n0 + 64 * (u >> 9) + 8 * ((u & 7) ^ (m & 7));
      uint4* p = reinterpret_cast<uint4*>(dzt + off);
      if (m0 + m >= me || n >= N) {
        *p = make_uint4(0, 0, 0, 0);
      } else if (stats) {
        const uint4 zu = *reinterpret_cast<const uint4*>(zt + off);
        const uint32_t zw[4] = {zu.x, zu.y, zu.z, zu.w};
        *p = map8(*p, [&](int e, float v) {
          if (RG && n + e >= N) return 0.f;  // (RG) a unit across N's end
          const float2 zz = unpack(zw[e >> 1]);
          const float zv = (e & 1) ? zz.y : zz.x;
          return round_to<bf16>(__fadd_rn(__fadd_rn(v, __ldg(ds1 + n + e)),
                                          __fmul_rn(__fmul_rn(2.f, zv), __ldg(ds2 + n + e))));
        });
      }
    }
    fence_proxy_async();
    bar_sync(2 + wg, 128);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_tt<BN>(acc, mnmajor_desc<128>(xt, kChunk, kk), mnmajor_desc<128>(dzt, kChunk, kk));
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<0>();
    fence_regs(acc);
    if (lt % 32 == 0) mbar_arrive(&empty[s]);
  }

  float* out = ws + (size_t)(2 * blockIdx.z + wg) * K * N;
  const int r0 = kc0 + 16 * (lt / 32) + (lt % 32) / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + 8 * j + 2 * (lt % 4);
    if (c >= N) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (r0 + 8 * i < K) {
        float* o = out + (size_t)(r0 + 8 * i) * N + c;
        if constexpr (RG) {  // rows of any length: element stores
          o[0] = acc[4 * j + 2 * i];
          if (c + 1 < N) o[1] = acc[4 * j + 2 * i + 1];
        } else {
          store2<float>(o, acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        }
      }
  }
}

// -- host ---------------------------------------------------------------------------

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// the row length of the ragged route's weight copy: a multiple of 8 (16
// bytes of bf16, as TMA needs)
inline int pad8(int n) { return (n + 7) / 8 * 8; }

// out (K, np) = w (K, N) bf16 with zero columns from N on
__global__ void __launch_bounds__(256)
    pad_cols_kernel(const bf16* __restrict__ w, bf16* __restrict__ out, int K, int N, int np) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= (size_t)K * np) return;
  const int k = int(i / np), n = int(i % np);
  out[i] = n < N ? w[(size_t)k * N + n] : __float2bfloat16(0.f);
}

// the ragged route's copy of w (K, N): (K, pad8(N)) into wpad
inline cudaError_t pad_cols(const void* w, void* wpad, int K, int N, cudaStream_t s) {
  const size_t n = (size_t)K * pad8(N);
  pad_cols_kernel<<<unsigned((n + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16*>(w), static_cast<bf16*>(wpad), K, N, pad8(N));
  return cudaGetLastError();
}

template <int BN, int TB, bool RG, class AOp, class Epi>
cudaError_t run_rs(const void* w, void* out, const AOp& aop, const Epi& epi, int rows, int cols,
                   int kdim, float* part1, float* part2, cudaStream_t s, void* out2) {
  // TB: w (kdim, cols), boxes of 64 columns x 64 rows; else w (cols,
  // kdim), boxes of 64 columns x BN rows (with RG w is pad_cols' copy:
  // rows of pad8(cols) or pad8(kdim)); out (rows, cols) in 64 x 64 boxes,
  // out2 (rows, kdim) with kStoreA, (rows, cols) with kOut2 (with RG no
  // maps: predicated stores)
  using Cfg = RsCfg<BN, AOp::kTiles, AOp::kStoreA>;
  CUtensorMap bmap, omap{}, omap2{};
  const int ldw = TB ? (RG ? pad8(cols) : cols) : (RG ? pad8(kdim) : kdim);
  bool ok = TB ? make_map(&bmap, w, ldw, kdim, 1, 64, 128)
               : make_map(&bmap, w, ldw, cols, 1, BN, 128);
  if (AOp::kStoreA || Epi::kOut2) ok = ok && out2 != nullptr;
  if (!RG) {
    ok = ok && make_map(&omap, out, cols, rows, 1, 64, 128);
    if (AOp::kStoreA || Epi::kOut2)
      ok = ok && make_map(&omap2, out2, AOp::kStoreA ? kdim : cols, rows, 1, 64, 128);
    else
      omap2 = omap;
  }
  if (!ok) return cudaErrorInvalidValue;
  auto kern = gemm_rs_kernel<BN, TB, RG, AOp, Epi>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (e != cudaSuccess) return e;
  const int tiles = ((rows + kBM - 1) / kBM) * ((cols + BN - 1) / BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  kern<<<grid, 384, Cfg::SMEM, s>>>(bmap, omap, omap2, aop, epi, rows, cols, kdim, part1, part2,
                                    static_cast<bf16*>(out), static_cast<bf16*>(out2));
  return cudaGetLastError();
}

// out (rows x cols, bf16) = A B with BN = 64, 128 or (BNMAX 256) 256
// fitted to cols; with part1 != nullptr, the epilogue's column sums per 64
// rows; out2: the second output of an operand with kStoreA or an epilogue
// with kOut2. RG: the ragged policy (the operand's too; BNMAX at most 128)
template <int BNMAX, int TB, bool RG = false, class AOp, class Epi>
cudaError_t gemm_rs(const void* w, void* out, const AOp& aop, const Epi& epi, int rows, int cols,
                    int kdim, float* part1, float* part2, cudaStream_t s,
                    void* out2 = nullptr) {
  static_assert(!RG || BNMAX <= 128, "the ragged copies keep no registers for BN = 256");
  if (cols <= 64)
    return run_rs<64, TB, RG>(w, out, aop, epi, rows, cols, kdim, part1, part2, s, out2);
  if constexpr (BNMAX >= 256) {
    if (cols > 128)
      return run_rs<256, TB, RG>(w, out, aop, epi, rows, cols, kdim, part1, part2, s, out2);
  }
  return run_rs<128, TB, RG>(w, out, aop, epi, rows, cols, kdim, part1, part2, s, out2);
}

template <int BN, bool RES, bool RG>
cudaError_t run_dw(const void* x, const void* dz, const void* z, const void* r, const float* a,
                   const float* b, const float* ds1, const float* ds2, float* ws, int M, int K,
                   int N, int prologue, int relu, int stats, int splits, int per,
                   cudaStream_t s) {
  using Cfg = DwCfg<BN, RES>;
  CUtensorMap xm{}, dm{}, zm{}, rm{};
  if (!RG && (!make_map(&xm, x, K, M, 1, 64, 128) || !make_map(&dm, dz, N, M, 1, 64, 128) ||
              !make_map(&zm, stats ? z : dz, N, M, 1, 64, 128) ||
              !make_map(&rm, RES ? r : x, K, M, 1, 64, 128)))
    return cudaErrorInvalidValue;
  auto kern = dw_kernel<BN, RES, RG>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((K + kDwRows - 1) / kDwRows, (N + BN - 1) / BN, splits);
  kern<<<grid, 384, Cfg::SMEM, s>>>(xm, dm, zm, rm, a, b, ds1, ds2, ws, M, K, N, prologue, relu,
                                    stats, per, static_cast<const bf16*>(x),
                                    static_cast<const bf16*>(dz), static_cast<const bf16*>(z),
                                    static_cast<const bf16*>(r));
  return cudaGetLastError();
}

// ws holds 2 x splits x K x N float32 partials of dw (one per consumer
// warpgroup and split); BN = 64 for N <= 64, else 128. RES: x_hat =
// relu(x * a + b + r) of x and the residual r (K5). RG: the ragged policy
template <bool RES = false, bool RG = false>
cudaError_t gemm_dw(const void* x, const void* dz, const void* z, const float* a, const float* b,
                    const float* ds1, const float* ds2, float* ws, int M, int K, int N,
                    int prologue, int relu, int stats, int splits, int per, cudaStream_t s,
                    const void* r = nullptr) {
  if (N <= 64)
    return run_dw<64, RES, RG>(x, dz, z, r, a, b, ds1, ds2, ws, M, K, N, prologue, relu, stats,
                               splits, per, s);
  return run_dw<128, RES, RG>(x, dz, z, r, a, b, ds1, ds2, ws, M, K, N, prologue, relu, stats,
                              splits, per, s);
}

}  // namespace sm90
}  // namespace bigdl_fg
