// Flash attention backward (K1-bwd) for Hopper, bfloat16, on the tensor cores.
//
// Replaces the Pallas kernels bigdl_tpu/kernels/flash_attention.py
// `_flash_bwd` for bf16 inputs: `_bwd_kv_kernel` (dK and dV over query tiles)
// and `_bwd_q_kernel` (dQ over key tiles). Given q, k, v, dO in bf16, the
// forward's log-sum-exp lse (B, H, Tq) and delta = rowsum(dO * O) (B, H, Tq)
// in float32, both kernels recompute, tile by tile,
//   p  = exp(q k^T * scale - lse), 0 where causal and col > row, on rows past
//        Tq and on rows whose lse is -inf;
//   dp = dO v^T;  ds = p * (dp - delta) * scale
// and accumulate dV = p^T dO and dK = ds^T q (first kernel) and dQ = ds k
// (second kernel) in float32 registers, written once in bf16 or float32
// (out_f32, for callers that sum gradients over several calls). p and ds are
// rounded to bf16 before their products, where JAX rounds them
// (flash_attention.py:215, :218, :256). There are no atomics: reruns give
// bitwise-equal gradients. float32 inputs take flash_bwd_tf32_sm90.cu (D up
// to 192).
//
// What bounds it on an H100: the seven products per tile pair (two for S and
// dP in each kernel, dV and dK in the first, dQ in the second) do 14 * D
// operations per (row, visible key) pair against 8 * 2 * D bytes per row read
// or written, so at the training shape (T = 1024, D = 64) it is bound by the
// tensor cores. What the design does: a block owns 128 keys (dK/dV) or 128
// queries (dQ) of one (b, h), held in shared memory for the whole block; a
// producer warp streams 64-row tiles of the other side (Q and dO with their
// lse and delta, or K and V) by TMA through a two-stage mbarrier ring; two
// consumer warpgroups of 64 rows each run S^T = K Q^T and dP^T = V dO^T (or
// S = Q K^T and dP = dO V^T) as bf16 wgmma from shared memory, turn them into
// P and dS in float32 registers, and feed them back as the bf16 register A
// operand of dV += P^T dO, dK += dS^T Q (or dQ += dS K), whose B operand is
// the same shared tile read MN-major. Causal loops start (dK/dV) or stop (dQ)
// at the diagonal; ragged tiles are zero-filled by TMA and masked. In the dQ
// kernel, tile j's dS K runs while tile j + 1's S and dP are made.
//
// Grids: B * H * ceil(Tkv / 128) blocks for dK/dV, B * H * ceil(Tq / 128)
// for dQ, one head's tiles together (its streamed tiles stay in L2),
// heaviest first; 384 threads: warpgroup 0 the producer (one working warp),
// warpgroups 1 and 2 the consumers.
#include "attn_sm90.cuh"

namespace bigdl {
namespace sm90 {

template <int D>
struct BwdCfg {
  static constexpr int BN = 128;  // keys (dK/dV) or queries (dQ) a block owns
  static constexpr int BT = 64;   // rows of each streamed tile
  static constexpr int kStages = 2;
  static constexpr int SW = head_sw<D>();
  static constexpr int FIX_BYTES = BN * D * 2;
  static constexpr int TILE_BYTES = BT * D * 2;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int STAT_OFF = 2 * FIX_BYTES + kStages * STAGE_BYTES;
  static constexpr int BAR_OFF = STAT_OFF + kStages * 2 * BT * 4;
  static constexpr int SMEM = 1024 + BAR_OFF + 64;
};

// One block per (128 keys, b * h): dK and dV of those keys.
template <int D, typename OT>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dkdv_sm90_kernel(__grid_constant__ const CUtensorMap qmap,
                               __grid_constant__ const CUtensorMap kmap,
                               __grid_constant__ const CUtensorMap vmap,
                               __grid_constant__ const CUtensorMap domap,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               OT* __restrict__ dk, OT* __restrict__ dv, int Tq, int Tkv,
                               int causal, float scale) {
  using C = BwdCfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint8_t* ks = smem;
  uint8_t* vs = smem + C::FIX_BYTES;
  uint8_t* stages = smem + 2 * C::FIX_BYTES;  // per stage: Q tile, then dO tile
  float* stats = reinterpret_cast<float*>(smem + C::STAT_OFF);  // per stage: lse2, delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* kvbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + C::kStages;

  // one head's key tiles are neighbours in the grid; causal: the first key
  // tiles see the most queries and go first
  const int nt = (Tkv + C::BN - 1) / C::BN;
  const int bh = blockIdx.x / nt;
  const int k0 = blockIdx.x % nt * C::BN;
  const int qt0 = causal ? k0 / C::BT : 0;
  const int ntiles = max(0, (Tq + C::BT - 1) / C::BT - qt0);

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes (one with the bytes)
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32 && ntiles > 0) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(kvbar, 2 * C::FIX_BYTES);
        tma_load_tile<C::BN, D, C::SW>(ks, &kmap, kvbar, k0, bh);
        tma_load_tile<C::BN, D, C::SW>(vs, &vmap, kvbar, k0, bh);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % C::kStages;
        const int q0 = (qt0 + j) * C::BT;
        mbar_wait(&empty[s], ((j / C::kStages) & 1) ^ 1);
        float* st = stats + s * 2 * C::BT;
        for (int r = lane; r < C::BT; r += 32) {
          const int q = q0 + r;
          const float L = q < Tq ? lse[size_t(bh) * Tq + q] : -INFINITY;
          // p = exp2(s * scale * log2(e) - lse2): +inf gives p = 0
          st[r] = L == -INFINITY ? INFINITY : L * kLog2e;
          st[C::BT + r] = q < Tq ? delta[size_t(bh) * Tq + q] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], C::STAGE_BYTES);
          uint8_t* tile = stages + s * C::STAGE_BYTES;
          tma_load_tile<C::BT, D, C::SW>(tile, &qmap, &full[s], q0, bh);
          tma_load_tile<C::BT, D, C::SW>(tile + C::TILE_BYTES, &domap, &full[s], q0, bh);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {  // consumer warpgroups
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128 - 1;
    const int kw = k0 + 64 * wg;
    const float sl2 = scale * kLog2e;
    const uint8_t* ksw = ks + 64 * wg * C::SW;
    const uint8_t* vsw = vs + 64 * wg * C::SW;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    float st[32], dpt[32];  // S^T and dP^T of one query tile: 64 keys x 64 queries
    uint32_t pf[4][4], dsf[4][4];  // P^T and dS^T in bf16: the A operands
    // S^T = K Q_j^T and dP^T = V dO_j^T, asynchronously (one commit group;
    // the caller waits for the tile first)
    auto start_s_dp = [&](int j) {
      const uint8_t* qs = stages + (j % C::kStages) * C::STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64>(st, kmajor_desc<C::SW>(ksw, C::BN * C::SW, kk),
                     kmajor_desc<C::SW>(qs, C::BT * C::SW, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64>(dpt, kmajor_desc<C::SW>(vsw, C::BN * C::SW, kk),
                     kmajor_desc<C::SW>(qs + C::TILE_BYTES, C::BT * C::SW, kk), kk > 0);
      wgmma_commit();
    };
    // P^T into st and dS^T into dpt (float32) for query tile j
    auto probs = [&](int j) {
      const int q0 = (qt0 + j) * C::BT;
      const float* lse2 = stats + (j % C::kStages) * 2 * C::BT;
      const float* dl = lse2 + C::BT;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qc = acc_col(i);
        float p = exp2f(fmaf(st[i], sl2, -lse2[qc]));
        p = causal && kw + acc_row(i) > q0 + qc ? 0.f : p;  // a select, no branch
        st[i] = p;
        dpt[i] = p * (dpt[i] - dl[qc]) * scale;
      }
    };
    // dV += P^T dO_j and dK += dS^T Q_j, asynchronously (one commit group)
    auto start_dkdv = [&](int j) {
      const uint8_t* qs = stages + (j % C::kStages) * C::STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(dv_acc, pf[kk], mnmajor_desc<C::SW>(qs + C::TILE_BYTES, C::BT * C::SW, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(dk_acc, dsf[kk], mnmajor_desc<C::SW>(qs, C::BT * C::SW, kk));
      wgmma_commit();
    };
    // Every register a product reads or writes is settled before its
    // wgmma_fence, and no branch separates a product from its wait: ptxas
    // serialises wgmma otherwise.
    auto settle = [&]() {
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      fence_regs(pf);
      fence_regs(dsf);
      fence_regs(st);
      fence_regs(dpt);
    };

    // Tile by tile: S^T and dP^T, then P^T and dS^T, then the dV and dK
    // products. (Overlapping tile j's dV and dK with tile j + 1's S^T and
    // dP^T, as the dQ kernel does, measured slower on the H100 at the
    // training shape; see PERF.md.)
    if (ntiles > 0) mbar_wait(kvbar, 0);
    for (int j = 0; j < ntiles; ++j) {
      mbar_wait(&full[j % C::kStages], (j / C::kStages) & 1);
      settle();
      wgmma_fence();
      start_s_dp(j);
      wgmma_wait<0>();
      settle();
      probs(j);
      to_a_frags<64>(pf, st);
      to_a_frags<64>(dsf, dpt);
      settle();
      wgmma_fence();
      start_dkdv(j);
      wgmma_wait<0>();
      settle();
      if (threadIdx.x % 32 == 0) mbar_arrive(&empty[j % C::kStages]);
    }
    store_acc<OT, D>(dk + size_t(bh) * Tkv * D, dk_acc, kw, Tkv, 1.f, 1.f);
    store_acc<OT, D>(dv + size_t(bh) * Tkv * D, dv_acc, kw, Tkv, 1.f, 1.f);
  }
}

// One block per (128 queries, b * h): dQ of those rows.
template <int D, typename OT>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_sm90_kernel(__grid_constant__ const CUtensorMap qmap,
                             __grid_constant__ const CUtensorMap kmap,
                             __grid_constant__ const CUtensorMap vmap,
                             __grid_constant__ const CUtensorMap domap,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             OT* __restrict__ dq, int Tq, int Tkv, int causal, float scale) {
  using C = BwdCfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint8_t* qs = smem;
  uint8_t* dos = smem + C::FIX_BYTES;
  uint8_t* stages = smem + 2 * C::FIX_BYTES;  // per stage: K tile, then V tile
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + C::kStages;

  // one head's query tiles are neighbours in the grid; causal: the last
  // (heaviest) tile first
  const int nt = (Tq + C::BN - 1) / C::BN;
  const int bh = blockIdx.x / nt;
  const int q0 = (nt - 1 - blockIdx.x % nt) * C::BN;
  const int nrows = min(C::BN, Tq - q0);
  const int kend = causal ? min(Tkv, q0 + nrows) : Tkv;
  const int ntiles = kend > 0 ? (kend + C::BT - 1) / C::BT : 0;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0 && ntiles > 0) {
      mbar_arrive_expect_tx(qbar, 2 * C::FIX_BYTES);
      tma_load_tile<C::BN, D, C::SW>(qs, &qmap, qbar, q0, bh);
      tma_load_tile<C::BN, D, C::SW>(dos, &domap, qbar, q0, bh);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % C::kStages;
        mbar_wait(&empty[s], ((j / C::kStages) & 1) ^ 1);
        uint8_t* tile = stages + s * C::STAGE_BYTES;
        mbar_arrive_expect_tx(&full[s], C::STAGE_BYTES);
        tma_load_tile<C::BT, D, C::SW>(tile, &kmap, &full[s], j * C::BT, bh);
        tma_load_tile<C::BT, D, C::SW>(tile + C::TILE_BYTES, &vmap, &full[s], j * C::BT, bh);
      }
    }
  } else {  // consumer warpgroups
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128 - 1;
    const int qw = q0 + 64 * wg;
    const float sl2 = scale * kLog2e;
    const uint8_t* qsw = qs + 64 * wg * C::SW;
    const uint8_t* dosw = dos + 64 * wg * C::SW;
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = qw + acc_row(2 * r);
      const float L = q < Tq ? lse[size_t(bh) * Tq + q] : -INFINITY;
      lse2[r] = L == -INFINITY ? INFINITY : L * kLog2e;
      dl[r] = q < Tq ? delta[size_t(bh) * Tq + q] : 0.f;
    }
    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    float sc[32], dp[32];  // S and dP of one key tile: 64 queries x 64 keys
    uint32_t dsf[4][4];    // dS in bf16: the A operand of dQ += dS K

    // S = Q K_j^T and dP = dO V_j^T, asynchronously (one commit group; the
    // caller waits for the tile first)
    auto start_s_dp = [&](int j) {
      const uint8_t* ks = stages + (j % C::kStages) * C::STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64>(sc, kmajor_desc<C::SW>(qsw, C::BN * C::SW, kk),
                     kmajor_desc<C::SW>(ks, C::BT * C::SW, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64>(dp, kmajor_desc<C::SW>(dosw, C::BN * C::SW, kk),
                     kmajor_desc<C::SW>(ks + C::TILE_BYTES, C::BT * C::SW, kk), kk > 0);
      wgmma_commit();
    };
    // dS of tile j (float32, into sc)
    auto dscores = [&](int j) {
      // keys past Tkv or above the diagonal: selects, no branch
      const int lim0 = min(Tkv - 1, causal ? qw + acc_row(0) : Tkv) - j * C::BT;
      const int lim1 = min(Tkv - 1, causal ? qw + acc_row(2) : Tkv) - j * C::BT;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float p = exp2f(fmaf(sc[i], sl2, -lse2[r]));
        p = acc_col(i) > (r ? lim1 : lim0) ? 0.f : p;
        sc[i] = p * (dp[i] - dl[r]) * scale;
      }
    };

    // dQ += dS_j K_j, asynchronously (one commit group)
    auto start_dq = [&](int j) {
      const uint8_t* ks = stages + (j % C::kStages) * C::STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(dq_acc, dsf[kk], mnmajor_desc<C::SW>(ks, C::BT * C::SW, kk));
      wgmma_commit();
    };
    auto settle = [&]() {  // as in the dK/dV kernel
      fence_regs(dq_acc);
      fence_regs(dsf);
      fence_regs(sc);
      fence_regs(dp);
    };
    if (ntiles > 0) {
      mbar_wait(qbar, 0);
      mbar_wait(&full[0], 0);
      settle();
      wgmma_fence();
      start_s_dp(0);
      wgmma_wait<0>();
      settle();
      dscores(0);
      to_a_frags<64>(dsf, sc);
    }
    // Tile j's dS K runs on the tensor cores while tile j + 1's S and dP are
    // made and its dS computed.
    for (int j = 0; j + 1 < ntiles; ++j) {
      mbar_wait(&full[(j + 1) % C::kStages], ((j + 1) / C::kStages) & 1);
      settle();
      wgmma_fence();
      start_s_dp(j + 1);
      start_dq(j);
      settle();
      wgmma_wait<1>();
      settle();
      dscores(j + 1);
      wgmma_wait<0>();
      settle();
      if (threadIdx.x % 32 == 0) mbar_arrive(&empty[j % C::kStages]);
      to_a_frags<64>(dsf, sc);
    }
    if (ntiles > 0) {
      settle();
      wgmma_fence();
      start_dq(ntiles - 1);
      wgmma_wait<0>();
      settle();
    }
    store_acc<OT, D>(dq + size_t(bh) * Tq * D, dq_acc, qw, Tq, 1.f, 1.f);
  }
}

template <int D, typename OT>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                       int H, int Tq, int Tkv, int causal, float scale, cudaStream_t stream) {
  using C = BwdCfg<D>;
  const int BH = B * H;
  CUtensorMap qt, kf, vf, dot, qf, kt, vt, dof;  // t: 64-row tiles, f: 128-row blocks
  if (!make_map(&qt, q, D, Tq, BH, C::BT, C::SW) || !make_map(&kf, k, D, Tkv, BH, C::BN, C::SW) ||
      !make_map(&vf, v, D, Tkv, BH, C::BN, C::SW) ||
      !make_map(&dot, dout, D, Tq, BH, C::BT, C::SW) ||
      !make_map(&qf, q, D, Tq, BH, C::BN, C::SW) || !make_map(&kt, k, D, Tkv, BH, C::BT, C::SW) ||
      !make_map(&vt, v, D, Tkv, BH, C::BT, C::SW) ||
      !make_map(&dof, dout, D, Tq, BH, C::BN, C::SW))
    return cudaErrorInvalidValue;
  auto kv_kern = flash_bwd_dkdv_sm90_kernel<D, OT>;
  cudaError_t err =
      cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  kv_kern<<<BH * ((Tkv + C::BN - 1) / C::BN), 384, C::SMEM, stream>>>(
      qt, kf, vf, dot, lse, delta, static_cast<OT*>(dk), static_cast<OT*>(dv), Tq, Tkv, causal,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto q_kern = flash_bwd_dq_sm90_kernel<D, OT>;
  err = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  q_kern<<<BH * ((Tq + C::BN - 1) / C::BN), 384, C::SMEM, stream>>>(
      qf, kt, vt, dof, lse, delta, static_cast<OT*>(dq), Tq, Tkv, causal, scale);
  return cudaGetLastError();
}

template <typename OT>
cudaError_t dispatch_bwd(int D, const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dq, void* dk, void* dv,
                         int B, int H, int Tq, int Tkv, int causal, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch_bwd<16, OT>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tkv, causal, scale, s);
    case 32: return launch_bwd<32, OT>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tkv, causal, scale, s);
    case 48: return launch_bwd<48, OT>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tkv, causal, scale, s);
    case 64: return launch_bwd<64, OT>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tkv, causal, scale, s);
    case 80: return launch_bwd<80, OT>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tkv, causal, scale, s);
    case 96: return launch_bwd<96, OT>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tkv, causal, scale, s);
    case 112: return launch_bwd<112, OT>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tkv, causal, scale, s);
    case 128: return launch_bwd<128, OT>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tkv, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace bigdl

// bf16 q, k, v, dout (contiguous (B, H, T, D)), D a multiple of 16 up to
// 128; lse and delta float32
// (B, H, Tq); dq, dk, dv bf16, or float32 when out_f32. Launches the dK/dV
// kernel, then the dQ kernel, on `stream`. Returns a cudaError_t (0 = both
// launched).
extern "C" int bigdl_flash_bwd_sm90(const void* q, const void* k, const void* v, const void* dout,
                                    const void* lse, const void* delta, void* dq, void* dk,
                                    void* dv, int out_f32, int B, int H, int Tq, int Tkv, int D,
                                    int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (out_f32)
    return bigdl::sm90::dispatch_bwd<float>(D, q, k, v, dout, l, dl, dq, dk, dv, B, H, Tq, Tkv,
                                            causal, scale, s);
  return bigdl::sm90::dispatch_bwd<__nv_bfloat16>(D, q, k, v, dout, l, dl, dq, dk, dv, B, H, Tq,
                                                  Tkv, causal, scale, s);
}
