// Flash attention forward (K1-fwd) for Hopper, bfloat16, on the tensor cores.
//
// Replaces the Pallas kernel bigdl_tpu/kernels/flash_attention.py `_flash_fwd`
// (body `_fwd_kernel`) for bf16 inputs: online-softmax attention over q of
// shape (B, H, Tq, D) and k, v of shape (B, H, Tkv, D), D a multiple of 16
// up to 128, causal or rectangular-causal (query row r sits at global position
// q_offset + r and sees keys <= q_offset + r), over the first kv_len keys only.
// Returns o (B, H, Tq, D) in bf16 and the per-row log-sum-exp lse (B, H, Tq)
// in float32; rows that see no key give o = 0 and lse = -inf. float32 inputs
// take the 3xTF32 kernels of flash_fwd_tf32_sm90.cu.
//
// What bounds it on an H100: at the training shape (T = 1024, D = 64, causal)
// the two products do 4 * D operations per (row, visible key) pair against
// 8 * D bytes per row read or written, about 250 operations per byte: near the
// bf16 ridge (295), so both the tensor cores and the copies have to be kept
// busy; at serving shapes (T of a few hundred) it is bound by memory and
// launch latency. What the design does:
// - a block owns 128 query rows of one (b, h): a producer warp starts TMA
//   loads of the Q tile once and of 128-key K and V tiles into a two-stage
//   ring guarded by "full" and "empty" mbarriers, and two consumer
//   warpgroups of 64 rows each run S = Q K^T and O += P V as bf16 wgmma with
//   float32 accumulators; inside a warpgroup, tile j's P V runs while tile
//   j + 1's S is made and its softmax computed, and one warpgroup's softmax
//   overlaps the other's products and the next tiles' copies;
// - the online softmax (m, l) stays in registers in float32; P is rounded to
//   bf16 in registers and fed as wgmma's register A operand (JAX rounds p to
//   the input type before its PV product, flash_attention.py:104); no score
//   reaches shared or device memory;
// - tensor maps are (D, T, B * H), so a ragged tile's rows past T are filled
//   with zeros by the TMA unit and the kernel masks keys past kv_len or above
//   the diagonal to -inf; the key loop stops at the causal / kv_len bound, and
//   kv_len = 0 reads no tile at all;
// - query tiles are launched heaviest first (the causal triangle's last
//   tiles see the most keys), so the short tiles fill the tail.
//
// Grid: B * H * ceil(Tq / 128) blocks, heaviest tiles first; 384 threads: warpgroup 0 is the producer
// (one working warp, registers given back with setmaxnreg), warpgroups 1 and 2
// the consumers.
#include "attn_sm90.cuh"

namespace bigdl {
namespace sm90 {

template <int D>
struct FwdCfg {
  static constexpr int BM = 128;                 // query rows per block
  static constexpr int BK = 128;                 // keys per tile
  static constexpr int kStages = 2;
  static constexpr int SW = head_sw<D>();        // swizzle = bytes per chunk row
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;  // K tile, then V tile
  static constexpr int BAR_OFF = Q_BYTES + kStages * STAGE_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 64;  // + alignment slack, barriers
};

template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_sm90_kernel(__grid_constant__ const CUtensorMap qmap,
                          __grid_constant__ const CUtensorMap kmap,
                          __grid_constant__ const CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int Tq, int causal, int q_offset, int kv_len,
                          float scale) {
  using C = FwdCfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint8_t* qs = smem;
  uint8_t* stages = smem + C::Q_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + C::kStages;

  // heads vary fastest over the grid and the last (heaviest) query tiles of
  // every head come first
  const int nt = (Tq + C::BM - 1) / C::BM;
  const int nbh = gridDim.x / nt;
  const int bh = blockIdx.x % nbh;
  const int q0 = (nt - 1 - blockIdx.x / nbh) * C::BM;
  const int nrows = min(C::BM, Tq - q0);
  int kend = kv_len;
  if (causal) kend = min(kend, q_offset + q0 + nrows);
  const int ntiles = kend > 0 ? (kend + C::BK - 1) / C::BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0 && ntiles > 0) {
      mbar_arrive_expect_tx(qbar, C::Q_BYTES);
      tma_load_tile<C::BM, D, C::SW>(qs, &qmap, qbar, q0, bh);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % C::kStages;
        mbar_wait(&empty[s], ((j / C::kStages) & 1) ^ 1);
        uint8_t* st = stages + s * C::STAGE_BYTES;
        mbar_arrive_expect_tx(&full[s], C::STAGE_BYTES);
        tma_load_tile<C::BK, D, C::SW>(st, &kmap, &full[s], j * C::BK, bh);
        tma_load_tile<C::BK, D, C::SW>(st + C::KV_BYTES, &vmap, &full[s], j * C::BK, bh);
      }
    }
  } else {  // consumer warpgroups
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128 - 1;
    const int qw = q0 + 64 * wg;  // this warpgroup's first row
    const float sl2 = scale * kLog2e;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of s * scale * log2(e)
    float l[2] = {0.f, 0.f};              // this thread's partial row sums
    const uint8_t* qw_s = qs + 64 * wg * C::SW;
    float sc[C::BK / 2];          // S of one key tile, then its P (float32)
    uint32_t pf[C::BK / 16][4];   // P in bf16: the A operand of O += P V
    float alpha[2];

    // S = Q K_j^T into sc, asynchronously (the caller waits for the tile,
    // commits and waits for the product)
    auto start_s = [&](int j) {
      const uint8_t* ks = stages + (j % C::kStages) * C::STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<C::BK>(sc, kmajor_desc<C::SW>(qw_s, C::BM * C::SW, kk),
                        kmajor_desc<C::SW>(ks, C::BK * C::SW, kk), kk > 0);
    };
    // the online softmax of tile j: masks sc, moves m and l, and leaves P in
    // sc and the factor for the O accumulated so far in alpha
    auto softmax = [&](int j) {
      // keys past kv_len or above the diagonal: selects, no branch
      const int lim0 = min(kv_len - 1, causal ? q_offset + qw + acc_row(0) : kv_len) - j * C::BK;
      const int lim1 = min(kv_len - 1, causal ? q_offset + qw + acc_row(2) : kv_len) - j * C::BK;
#pragma unroll
      for (int i = 0; i < C::BK / 2; ++i)
        sc[i] = acc_col(i) > ((i >> 1) & 1 ? lim1 : lim0) ? -INFINITY : sc[i];
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < C::BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mnew = fmaxf(m[r], quad_max(mx[r]) * sl2);
        base[r] = mnew == -INFINITY ? 0.f : mnew;
        alpha[r] = exp2f(m[r] - base[r]);
        m[r] = mnew;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < C::BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = exp2f(fmaf(sc[i], sl2, -base[r]));
        rs[r] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    };

    if (ntiles > 0) {
      mbar_wait(qbar, 0);
      mbar_wait(&full[0], 0);
      fence_regs(sc);
      wgmma_fence();
      start_s(0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(0);
      to_a_frags<C::BK>(pf, sc);
    }
    // O += P_j V_j, asynchronously (the caller commits and waits)
    auto start_pv = [&](int j) {
      const uint8_t* vs = stages + (j % C::kStages) * C::STAGE_BYTES + C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk)
        wgmma_rs<D>(acc, pf[kk], mnmajor_desc<C::SW>(vs, C::BK * C::SW, kk));
    };
    // Every register a product reads or writes is settled before its
    // wgmma_fence, and no branch separates a product from its wait: ptxas
    // serialises wgmma otherwise.
    auto settle = [&]() {
      fence_regs(acc);
      fence_regs(pf);
      fence_regs(sc);
    };
    // Tile j's P V runs on the tensor cores while tile j + 1's S is made and
    // its softmax computed; O is rescaled once P V is done.
    for (int j = 0; j + 1 < ntiles; ++j) {
      mbar_wait(&full[(j + 1) % C::kStages], ((j + 1) / C::kStages) & 1);
      settle();
      wgmma_fence();
      start_s(j + 1);
      wgmma_commit();
      start_pv(j);
      wgmma_commit();
      settle();
      wgmma_wait<1>();
      fence_regs(sc);
      softmax(j + 1);
      wgmma_wait<0>();
      settle();
      if (threadIdx.x % 32 == 0) mbar_arrive(&empty[j % C::kStages]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      to_a_frags<C::BK>(pf, sc);
    }
    if (ntiles > 0) {  // the last tile's P V
      settle();
      wgmma_fence();
      start_pv(ntiles - 1);
      wgmma_commit();
      wgmma_wait<0>();
      settle();
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lt = quad_sum(l[r]);
      inv[r] = lt > 0.f ? 1.f / lt : 0.f;
      const int row = qw + acc_row(2 * r);
      if (threadIdx.x % 4 == 0 && row < Tq)
        lse[size_t(bh) * Tq + row] =
            lt > 0.f ? m[r] * 0.6931471805599453f + logf(lt) : -INFINITY;
    }
    store_acc<__nv_bfloat16, D>(o + size_t(bh) * Tq * D, acc, qw, Tq, inv[0], inv[1]);
  }
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                       int H, int Tq, int Tkv, int causal, int q_offset, int kv_len, float scale,
                       cudaStream_t stream) {
  using C = FwdCfg<D>;
  CUtensorMap qm, km, vm;
  const int BH = B * H;
  if (!make_map(&qm, q, D, Tq, BH, C::BM, C::SW) || !make_map(&km, k, D, Tkv, BH, C::BK, C::SW) ||
      !make_map(&vm, v, D, Tkv, BH, C::BK, C::SW))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_sm90_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(BH * ((Tq + C::BM - 1) / C::BM));
  kern<<<grid, 384, C::SMEM, stream>>>(qm, km, vm, static_cast<__nv_bfloat16*>(o),
                                       static_cast<float*>(lse), Tq, causal, q_offset, kv_len,
                                       scale);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace bigdl

// bf16 q, k, v (contiguous (B, H, T, D)), D a multiple of 16 up to 128; o
// bf16, lse float32. Returns a cudaError_t (0 = launched).
extern "C" int bigdl_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int H, int Tq, int Tkv, int D, int causal,
                                    int q_offset, int kv_len, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return bigdl::sm90::launch_fwd<16>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 32: return bigdl::sm90::launch_fwd<32>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 48: return bigdl::sm90::launch_fwd<48>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 64: return bigdl::sm90::launch_fwd<64>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 80: return bigdl::sm90::launch_fwd<80>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 96: return bigdl::sm90::launch_fwd<96>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 112: return bigdl::sm90::launch_fwd<112>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    case 128: return bigdl::sm90::launch_fwd<128>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
