// Flash attention backward (K1-bwd) for Hopper, float32, on the tensor cores
// in 3xTF32.
//
// Replaces, for float32 inputs whose head dim D is at most 64, the Pallas
// kernels bigdl_tpu/kernels/flash_attention.py `_flash_bwd`: `_bwd_kv_kernel`
// (dK and dV over query tiles) and `_bwd_q_kernel` (dQ over key tiles); JAX
// takes p and ds in the input type before their products, which for float32
// keeps them float32. It computes what flash_bwd.cu computes, through the
// same C arguments: given q, k, v, dO (B, H, T, D), the forward's log-sum-exp
// lse (B, H, Tq) and delta = rowsum(dO * O) (B, H, Tq), both float32, it
// recomputes tile by tile
//   p  = exp(q k^T * scale - lse), 0 where causal and col > row, on rows past
//        Tq and on rows whose lse is -inf;
//   dp = dO v^T;  ds = p * (dp - delta) * scale
// and sums dV = p^T dO, dK = ds^T q (first kernel) and dQ = ds k (second
// kernel), written once in float32. There are no atomics: reruns give
// bitwise-equal gradients. flash_bwd.cu stays the route of wider heads (D up
// to 192).
//
// Numerics: every float32 operand x is split into hi = tf32_rn(x) and lo =
// tf32_rn(x - hi), and each product is lo hi + hi lo + hi hi on wgmma ...
// .tf32 (fused_gemm_tf32_sm90.cuh). The contractions over D (S and dP) run
// whole into one accumulator (at most 24 products at D = 64, as the
// forward's S); the sums over tiles (dV and dK over the query tiles, dQ over
// the key tiles) take each tile's 12 products into a fresh register set,
// which is then added to the float32 total with a rounded add, so the
// tensor cores' own accumulation (about 2^-25 of the sum per k8 product, in
// one direction) never runs over more than one tile.
//
// What bounds it on an H100: five products of 2 D operations per (row,
// visible key) pair, run three times as tf32 (495 TF/s dense, so 165 TF/s of
// float32 work), against q, k, v, dO, dq, dk, dv of 4 D bytes a row and lse
// and delta: causal at D = 64, about 40 float32 operations per byte at T =
// 256 (the float32 LM training shape), where the bytes bound it (0.020 ms at
// (8,16,256,64)), and 160 at T = 1024, where the tensor cores do (0.065 ms
// at (2,16,1024,64)); the CUDA-core kernel is bound by its float32 FMAs (67
// TF/s). What the design does:
// - tf32 wgmma takes both shared-memory operands K-major only. The
//   contractions over the streamed side (dV += P^T dO and dK += dS^T Q over
//   queries, dQ += dS K over keys) need that side transposed: dO^T, Q^T and
//   K^T, queries or keys contiguous. Each streamed tile (32 rows) lands raw
//   by TMA in a two-stage ring; the consumers split it into its natural hi
//   and lo tiles (the B operand of S^T = K Q^T, dP^T = V dO^T, or of S = Q
//   K^T, dP = dO V^T) and write the transposed hi and lo tiles beside them
//   (D rows of 32 floats, 128-byte swizzled), with no scratch in device
//   memory. Within each group of 8 the transposed tiles keep the order 0,
//   2, 4, 6, 1, 3, 5, 7 (vt_pos, attn_tf32_sm90.cuh), so the P^T / dS^T (or
//   dS) accumulators' registers {d0, d2, d1, d3} are the A fragments of the
//   tile products, split into hi and lo in registers.
// - dK/dV kernel: a block owns 128 keys of one (b, h), two consumer
//   warpgroups of 64 keys; K and V land once by TMA and each warpgroup
//   splits its rows in place (hi over the raw values, lo beside); the loop
//   over query tiles starts at the causal diagonal. Per tile: S^T and dP^T
//   as three shared-memory products a k8 slice, P^T and dS^T in float32
//   registers, then dV's and dK's tile products from registers.
// - dQ kernel: a block owns 128 queries (Q and dO split in place once), the
//   loop over key tiles stops at the diagonal; per tile S and dP, dS in
//   registers, dQ's tile product over K^T.
// - One split set of the streamed tile serves both warpgroups: a named
//   barrier over the 256 consumer threads guards it (the previous tile's
//   products are done before it is written, and it is written before the
//   products read it); the raw stage is released to the producer as soon
//   as it is split, so the next tiles' loads run under the products.
// Head dims: every multiple of 16 up to 64, the widest whose fixed halves
// (128 rows of K and V, hi and lo: 128 KB at D = 64), split set (64 KB) and
// two raw stages (32 KB) fit a block's 227 KB; a row's chunks are 128-byte
// swizzled where 4 D is a multiple of 128 bytes, else 64-byte.
//
// Grids: B * H * ceil(Tkv / 128) blocks for dK/dV, B * H * ceil(Tq / 128)
// for dQ, heads fastest and the heaviest tiles (causal) first, so the light
// ones fill the last wave;
// 384 threads: warpgroup 0 the producer (one working warp), warpgroups 1 and
// 2 the consumers.
#include "attn_tf32_sm90.cuh"

namespace bigdl_fg {
namespace sm90 {
namespace tf32 {

template <int D>
struct BwdCfg {
  static constexpr int BN = 128;  // keys (dK/dV) or queries (dQ) a block owns
  static constexpr int BT = 32;   // rows of each streamed tile (one 128-byte transposed row)
  static constexpr int kStages = 2;
  static constexpr int SW = (4 * D) % 128 == 0 ? 128 : 64;  // swizzle of the D-wide rows
  static constexpr int FIX = BN * D * 4;   // one fixed tile (raw, then hi; or lo)
  static constexpr int TILE = BT * D * 4;  // one streamed tile, natural or transposed
  // fixed: 4 FIX (hi / lo of two tensors); split set: 8 tiles (dK/dV: Q,
  // dO, Q^T, dO^T) or 6 (dQ: K, V, K^T), each hi and lo; raw stages: two
  // tiles each; then dK/dV's statistics (lse2 and delta of the set and of
  // each stage), the barriers, and the slack of the 1024-byte alignment
  static constexpr int SMEM_KV =
      1024 + 4 * FIX + 8 * TILE + kStages * 2 * TILE + (kStages + 1) * 2 * BT * 4 + 64;
  static constexpr int SMEM_Q = 1024 + 4 * FIX + 6 * TILE + kStages * 2 * TILE + 64;
  static_assert(D % 16 == 0 && SMEM_KV <= kSmemMax && SMEM_Q <= kSmemMax,
                "shared memory of one block");
};

// byte offset of 16-byte unit u of row r in a tile of SW-byte rows with the
// TMA's SW-byte swizzle (128: unit ^ r % 8; 64: unit ^ (r / 2) % 4)
template <int SW>
__device__ __forceinline__ int swz_unit(int r, int u) {
  return r * SW + ((u ^ (SW == 128 ? (r & 7) : ((r >> 1) & 3))) << 4);
}

// Splits rows [r0, r0 + 64) of a fixed tile (R rows, chunks of SW bytes) in
// place: hi over the raw values, lo at the same offset of `lo` (an
// elementwise map, so the swizzle does not matter). One warpgroup.
template <int D, int SW, int R>
__device__ __forceinline__ void split_rows(uint8_t* hi, uint8_t* lo, int r0) {
#pragma unroll
  for (int c = 0; c < 4 * D / SW; ++c) {
    const int base = c * R * SW + r0 * SW;
    for (int i = threadIdx.x % 128; i < 4 * SW; i += 128) {
      float4* h4 = reinterpret_cast<float4*>(hi + base + 16 * i);
      const float4 x = *h4;
      uint32_t h[4], l[4];
      split(x.x, h[0], l[0]);
      split(x.y, h[1], l[1]);
      split(x.z, h[2], l[2]);
      split(x.w, h[3], l[3]);
      *reinterpret_cast<uint4*>(h4) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + base + 16 * i) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
}

// A raw streamed tile (BT rows of D floats, as TMA swizzled it) into its hi
// and lo tiles (same layout) and, with `thi`, its transposed hi and lo tiles:
// D rows of the BT = 32 row values, 128-byte swizzled, row r's value at
// column vt_pos(r). The 256 consumer threads, each a 16-byte unit at a time,
// rows fastest (conflict-free reads and transposed writes).
template <int D, int SW, int BT>
__device__ __forceinline__ void split_tile(const uint8_t* raw, uint8_t* hi, uint8_t* lo,
                                           uint8_t* thi, uint8_t* tlo, int ct) {
  constexpr int UPR = SW / 16;  // units a chunk row
  for (int u = ct; u < BT * D / 4; u += 256) {
    const int r = u % BT;
    const int cu = u / BT;  // unit along the row: columns 4 cu .. 4 cu + 3
    const int off = (cu / UPR) * BT * SW + swz_unit<SW>(r, cu % UPR);
    const float4 x = *reinterpret_cast<const float4*>(raw + off);
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
    if (thi != nullptr) {
      const int c = vt_pos(r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        *reinterpret_cast<uint32_t*>(thi + swz4(4 * cu + e, c)) = h[e];
        *reinterpret_cast<uint32_t*>(tlo + swz4(4 * cu + e, c)) = l[e];
      }
    }
  }
}

// d (64 x N) = (A hi + A lo)(B hi + B lo) without lo lo, over a whole
// contraction of KD (D) from shared memory: A rows `a` (chunks a_chunk bytes
// apart), B rows `b` (chunks b_chunk apart), both K-major with SW-byte rows.
// The caller fences, commits and waits.
template <int N, int KD, int SW>
__device__ __forceinline__ void mma3_ss(float (&d)[N / 2], const uint8_t* ah, const uint8_t* al,
                                        int a_chunk, const uint8_t* bh, const uint8_t* bl,
                                        int b_chunk) {
#pragma unroll
  for (int kk = 0; kk < KD / 8; ++kk) {
    const uint64_t dah = kmajor_desc<SW>(ah, a_chunk, kk);
    const uint64_t dbh = kmajor_desc<SW>(bh, b_chunk, kk);
    wgmma_ss_tf32<N>(d, kmajor_desc<SW>(al, a_chunk, kk), dbh, kk > 0);
    wgmma_ss_tf32<N>(d, dah, kmajor_desc<SW>(bl, b_chunk, kk), 1);
    wgmma_ss_tf32<N>(d, dah, dbh, 1);
  }
}

// part (64 x D) = the tile product of register A fragments (hi, lo; BT / 8
// k8 slices) and a transposed B (D rows of BT values, 128-byte swizzled)
template <int D, int BT>
__device__ __forceinline__ void mma3_rs(float (&part)[D / 2], const uint32_t (&ah)[BT / 8][4],
                                        const uint32_t (&al)[BT / 8][4], const uint8_t* bh,
                                        const uint8_t* bl) {
#pragma unroll
  for (int kk = 0; kk < BT / 8; ++kk) {
    const uint64_t dbh = kmajor_desc<128>(bh, D * 128, kk);
    wgmma_tf32<D>(part, al[kk], dbh, kk > 0);
    wgmma_tf32<D>(part, ah[kk], kmajor_desc<128>(bl, D * 128, kk), 1);
    wgmma_tf32<D>(part, ah[kk], dbh, 1);
  }
}

// The A fragments of an accumulator (64 x BT, float32): slice kk's registers
// {d0, d2, d1, d3}, each split into hi and lo
template <int BT>
__device__ __forceinline__ void frags(uint32_t (&ah)[BT / 8][4], uint32_t (&al)[BT / 8][4],
                                      const float (&d)[BT / 2]) {
#pragma unroll
  for (int kk = 0; kk < BT / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) split(d[4 * kk + ((e & 1) << 1) + (e >> 1)], ah[kk][e], al[kk][e]);
}

template <int N>
__device__ __forceinline__ void add_part(float (&acc)[N / 2], const float (&part)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

// One block per (128 keys, b * h): dK and dV of those keys.
template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dkdv_tf32_kernel(__grid_constant__ const CUtensorMap qmap,
                               __grid_constant__ const CUtensorMap kmap,
                               __grid_constant__ const CUtensorMap vmap,
                               __grid_constant__ const CUtensorMap domap,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               float* __restrict__ dk, float* __restrict__ dv, int Tq, int Tkv,
                               int causal, float scale) {
  using C = BwdCfg<D>;
  constexpr int BN = C::BN, BT = C::BT, SW = C::SW, FIX = C::FIX, TILE = C::TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint8_t* kh = smem;  // raw K by TMA, then its hi half
  uint8_t* kl = kh + FIX;
  uint8_t* vh = kl + FIX;
  uint8_t* vl = vh + FIX;
  // the split set of the current query tile: Q and dO hi / lo, then their
  // transposed hi / lo
  uint8_t* qh = smem + 4 * FIX;
  uint8_t* ql = qh + TILE;
  uint8_t* doh = ql + TILE;
  uint8_t* dol = doh + TILE;
  uint8_t* qth = dol + TILE;
  uint8_t* qtl = qth + TILE;
  uint8_t* doth = qtl + TILE;
  uint8_t* dotl = doth + TILE;
  uint8_t* raw = dotl + TILE;  // per stage: raw Q, then raw dO
  float* sstat = reinterpret_cast<float*>(raw + C::kStages * 2 * TILE);  // the set's lse2, delta
  float* rstat = sstat + 2 * BT;  // per stage: lse2, delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(rstat + C::kStages * 2 * BT);
  uint64_t* kvbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + C::kStages;

  // heads vary fastest over the grid; causal: the first key tiles of every
  // head see the most queries and go first
  const int nt = (Tkv + BN - 1) / BN;
  const int nbh = gridDim.x / nt;
  const int bh = blockIdx.x % nbh;
  const int k0 = blockIdx.x / nbh * BN;
  const int qt0 = causal ? k0 / BT : 0;
  const int ntiles = max(0, (Tq + BT - 1) / BT - qt0);

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes (one with the bytes)
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32 && ntiles > 0) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(kvbar, 2 * FIX);
        for (int c = 0; c < 4 * D / SW; ++c) {
          tma_load_3d(kh + c * BN * SW, &kmap, kvbar, c * SW / 4, k0, bh);
          tma_load_3d(vh + c * BN * SW, &vmap, kvbar, c * SW / 4, k0, bh);
        }
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % C::kStages;
        const int q0 = (qt0 + j) * BT;
        mbar_wait(&empty[s], ((j / C::kStages) & 1) ^ 1);
        float* st = rstat + s * 2 * BT;
        for (int r = lane; r < BT; r += 32) {
          const int q = q0 + r;
          const float L = q < Tq ? lse[size_t(bh) * Tq + q] : -INFINITY;
          // p = exp2(s * scale * log2(e) - lse2): +inf gives p = 0
          st[r] = L == -INFINITY ? INFINITY : L * kLog2e;
          st[BT + r] = q < Tq ? delta[size_t(bh) * Tq + q] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * TILE);
          uint8_t* t = raw + s * 2 * TILE;
          for (int c = 0; c < 4 * D / SW; ++c) {
            tma_load_3d(t + c * BT * SW, &qmap, &full[s], c * SW / 4, q0, bh);
            tma_load_3d(t + TILE + c * BT * SW, &domap, &full[s], c * SW / 4, q0, bh);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // consumer warpgroups
  setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128 - 1;
  const int ct = threadIdx.x - 128;  // 0 .. 255
  const int kw = k0 + 64 * wg;       // this warpgroup's first key
  const float sl2 = scale * kLog2e;
  const uint8_t* khw = kh + 64 * wg * SW;
  const uint8_t* klw = kl + 64 * wg * SW;
  const uint8_t* vhw = vh + 64 * wg * SW;
  const uint8_t* vlw = vl + 64 * wg * SW;
  float dk_acc[D / 2], dv_acc[D / 2], part[D / 2];
  float st[BT / 2], dpt[BT / 2];          // S^T, dP^T of one query tile: 64 keys x 32 queries
  uint32_t ah[BT / 8][4], al[BT / 8][4];  // P^T, then dS^T: hi and lo A fragments
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  // Every register a product reads or writes is settled before its
  // wgmma_fence, and no branch separates a product from its wait: ptxas
  // serialises wgmma otherwise.
  auto settle = [&]() {
    fence_regs(part);
    fence_regs(ah);
    fence_regs(al);
    fence_regs(st);
    fence_regs(dpt);
  };

  if (ntiles > 0) {
    mbar_wait(kvbar, 0);
    split_rows<D, SW, BN>(kh, kl, 64 * wg);
    split_rows<D, SW, BN>(vh, vl, 64 * wg);
    fence_proxy_async();
    bar_sync(1 + wg, 128);
  }
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % C::kStages;
    const int q0 = (qt0 + j) * BT;
    mbar_wait(&full[s], (j / C::kStages) & 1);
    bar_sync(3, 256);  // both warpgroups' products of the previous tile are done
    const uint8_t* rq = raw + s * 2 * TILE;
    split_tile<D, SW, BT>(rq, qh, ql, qth, qtl, ct);
    split_tile<D, SW, BT>(rq + TILE, doh, dol, doth, dotl, ct);
    if (ct < 2 * BT) sstat[ct] = rstat[s * 2 * BT + ct];
    fence_proxy_async();
    bar_sync(3, 256);
    if (ct % 32 == 0) mbar_arrive(&empty[s]);

    // S^T = K Q_j^T and dP^T = V dO_j^T
    settle();
    wgmma_fence();
    mma3_ss<BT, D, SW>(st, khw, klw, BN * SW, qh, ql, BT * SW);
    mma3_ss<BT, D, SW>(dpt, vhw, vlw, BN * SW, doh, dol, BT * SW);
    wgmma_commit();
    wgmma_wait<0>();
    settle();
    // P^T into st and dS^T into dpt (float32): key kw + row, query q0 + col
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) {
      const int qc = acc_col(i);
      float p = exp2f(fmaf(st[i], sl2, -sstat[qc]));
      p = causal && kw + acc_row(i) > q0 + qc ? 0.f : p;  // a select, no branch
      st[i] = p;
      dpt[i] = p * (dpt[i] - sstat[BT + qc]) * scale;
    }
    // dV += P^T dO_j, its own register set first
    frags<BT>(ah, al, st);
    settle();
    wgmma_fence();
    mma3_rs<D, BT>(part, ah, al, doth, dotl);
    wgmma_commit();
    wgmma_wait<0>();
    settle();
    add_part<D>(dv_acc, part);
    // dK += dS^T Q_j
    frags<BT>(ah, al, dpt);
    settle();
    wgmma_fence();
    mma3_rs<D, BT>(part, ah, al, qth, qtl);
    wgmma_commit();
    wgmma_wait<0>();
    settle();
    add_part<D>(dk_acc, part);
  }
  store_acc<float, D>(dk + size_t(bh) * Tkv * D, dk_acc, kw, Tkv, 1.f, 1.f);
  store_acc<float, D>(dv + size_t(bh) * Tkv * D, dv_acc, kw, Tkv, 1.f, 1.f);
}

// One block per (128 queries, b * h): dQ of those rows.
template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_tf32_kernel(__grid_constant__ const CUtensorMap qmap,
                             __grid_constant__ const CUtensorMap kmap,
                             __grid_constant__ const CUtensorMap vmap,
                             __grid_constant__ const CUtensorMap domap,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dq, int Tq, int Tkv, int causal, float scale) {
  using C = BwdCfg<D>;
  constexpr int BN = C::BN, BT = C::BT, SW = C::SW, FIX = C::FIX, TILE = C::TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint8_t* qh = smem;  // raw Q by TMA, then its hi half
  uint8_t* ql = qh + FIX;
  uint8_t* doh = ql + FIX;
  uint8_t* dol = doh + FIX;
  // the split set of the current key tile: K and V hi / lo, K^T hi / lo
  uint8_t* kh = smem + 4 * FIX;
  uint8_t* kl = kh + TILE;
  uint8_t* vh = kl + TILE;
  uint8_t* vl = vh + TILE;
  uint8_t* kth = vl + TILE;
  uint8_t* ktl = kth + TILE;
  uint8_t* raw = ktl + TILE;  // per stage: raw K, then raw V
  uint64_t* bars = reinterpret_cast<uint64_t*>(raw + C::kStages * 2 * TILE);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + C::kStages;

  // heads vary fastest over the grid; causal: the last (heaviest) query
  // tiles of every head first
  const int nt = (Tq + BN - 1) / BN;
  const int nbh = gridDim.x / nt;
  const int bh = blockIdx.x % nbh;
  const int q0 = (nt - 1 - blockIdx.x / nbh) * BN;
  const int nrows = min(BN, Tq - q0);
  const int kend = causal ? min(Tkv, q0 + nrows) : Tkv;
  const int ntiles = kend > 0 ? (kend + BT - 1) / BT : 0;

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
      mbar_arrive_expect_tx(qbar, 2 * FIX);
      for (int c = 0; c < 4 * D / SW; ++c) {
        tma_load_3d(qh + c * BN * SW, &qmap, qbar, c * SW / 4, q0, bh);
        tma_load_3d(doh + c * BN * SW, &domap, qbar, c * SW / 4, q0, bh);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % C::kStages;
        mbar_wait(&empty[s], ((j / C::kStages) & 1) ^ 1);
        uint8_t* t = raw + s * 2 * TILE;
        mbar_arrive_expect_tx(&full[s], 2 * TILE);
        for (int c = 0; c < 4 * D / SW; ++c) {
          tma_load_3d(t + c * BT * SW, &kmap, &full[s], c * SW / 4, j * BT, bh);
          tma_load_3d(t + TILE + c * BT * SW, &vmap, &full[s], c * SW / 4, j * BT, bh);
        }
      }
    }
    return;
  }

  // consumer warpgroups
  setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128 - 1;
  const int ct = threadIdx.x - 128;
  const int qw = q0 + 64 * wg;  // this warpgroup's first row
  const float sl2 = scale * kLog2e;
  const uint8_t* qhw = qh + 64 * wg * SW;
  const uint8_t* qlw = ql + 64 * wg * SW;
  const uint8_t* dohw = doh + 64 * wg * SW;
  const uint8_t* dolw = dol + 64 * wg * SW;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = qw + acc_row(2 * r);
    const float L = q < Tq ? lse[size_t(bh) * Tq + q] : -INFINITY;
    lse2[r] = L == -INFINITY ? INFINITY : L * kLog2e;
    dl[r] = q < Tq ? delta[size_t(bh) * Tq + q] : 0.f;
  }
  float dq_acc[D / 2], part[D / 2];
  float sc[BT / 2], dp[BT / 2];           // S and dP of one key tile: 64 queries x 32 keys
  uint32_t ah[BT / 8][4], al[BT / 8][4];  // dS: hi and lo A fragments
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  auto settle = [&]() {  // as in the dK/dV kernel
    fence_regs(part);
    fence_regs(ah);
    fence_regs(al);
    fence_regs(sc);
    fence_regs(dp);
  };

  if (ntiles > 0) {
    mbar_wait(qbar, 0);
    split_rows<D, SW, BN>(qh, ql, 64 * wg);
    split_rows<D, SW, BN>(doh, dol, 64 * wg);
    fence_proxy_async();
    bar_sync(1 + wg, 128);
  }
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % C::kStages;
    mbar_wait(&full[s], (j / C::kStages) & 1);
    bar_sync(3, 256);  // both warpgroups' products of the previous tile are done
    const uint8_t* rk = raw + s * 2 * TILE;
    split_tile<D, SW, BT>(rk, kh, kl, kth, ktl, ct);
    split_tile<D, SW, BT>(rk + TILE, vh, vl, nullptr, nullptr, ct);
    fence_proxy_async();
    bar_sync(3, 256);
    if (ct % 32 == 0) mbar_arrive(&empty[s]);

    // S = Q K_j^T and dP = dO V_j^T
    settle();
    wgmma_fence();
    mma3_ss<BT, D, SW>(sc, qhw, qlw, BN * SW, kh, kl, BT * SW);
    mma3_ss<BT, D, SW>(dp, dohw, dolw, BN * SW, vh, vl, BT * SW);
    wgmma_commit();
    wgmma_wait<0>();
    settle();
    // dS of tile j (float32, into sc); keys past Tkv or above the diagonal
    // give 0: selects, no branch
    const int lim0 = min(Tkv - 1, causal ? qw + acc_row(0) : Tkv) - j * BT;
    const int lim1 = min(Tkv - 1, causal ? qw + acc_row(2) : Tkv) - j * BT;
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) {
      const int r = (i >> 1) & 1;
      float p = exp2f(fmaf(sc[i], sl2, -lse2[r]));
      p = acc_col(i) > (r ? lim1 : lim0) ? 0.f : p;
      sc[i] = p * (dp[i] - dl[r]) * scale;
    }
    // dQ += dS_j K_j, its own register set first
    frags<BT>(ah, al, sc);
    settle();
    wgmma_fence();
    mma3_rs<D, BT>(part, ah, al, kth, ktl);
    wgmma_commit();
    wgmma_wait<0>();
    settle();
    add_part<D>(dq_acc, part);
  }
  store_acc<float, D>(dq + size_t(bh) * Tq * D, dq_acc, qw, Tq, 1.f, 1.f);
}

// -- host ---------------------------------------------------------------------------

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, float* dq, float* dk, float* dv,
                       int B, int H, int Tq, int Tkv, int causal, float scale,
                       cudaStream_t stream) {
  using C = BwdCfg<D>;
  const int BH = B * H;
  // no keys: dQ is 0; no queries: dK and dV are 0 (a tensor map needs rows)
  if (Tkv == 0) return cudaMemsetAsync(dq, 0, size_t(BH) * Tq * D * 4, stream);
  if (Tq == 0) {
    cudaError_t err = cudaMemsetAsync(dk, 0, size_t(BH) * Tkv * D * 4, stream);
    if (err != cudaSuccess) return err;
    return cudaMemsetAsync(dv, 0, size_t(BH) * Tkv * D * 4, stream);
  }
  // t: 32-row streamed tiles, f: 128-row fixed blocks
  CUtensorMap qt, kf, vf, dot, qf, kt, vt, dof;
  const int box = C::SW / 4;
  if (!make_map3(&qt, q, D, Tq, BH, D, size_t(Tq) * D, box, C::BT, C::SW) ||
      !make_map3(&dot, dout, D, Tq, BH, D, size_t(Tq) * D, box, C::BT, C::SW) ||
      !make_map3(&kf, k, D, Tkv, BH, D, size_t(Tkv) * D, box, C::BN, C::SW) ||
      !make_map3(&vf, v, D, Tkv, BH, D, size_t(Tkv) * D, box, C::BN, C::SW) ||
      !make_map3(&qf, q, D, Tq, BH, D, size_t(Tq) * D, box, C::BN, C::SW) ||
      !make_map3(&dof, dout, D, Tq, BH, D, size_t(Tq) * D, box, C::BN, C::SW) ||
      !make_map3(&kt, k, D, Tkv, BH, D, size_t(Tkv) * D, box, C::BT, C::SW) ||
      !make_map3(&vt, v, D, Tkv, BH, D, size_t(Tkv) * D, box, C::BT, C::SW))
    return cudaErrorInvalidValue;
  auto kv_kern = flash_bwd_dkdv_tf32_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_KV);
  if (err != cudaSuccess) return err;
  kv_kern<<<BH * ((Tkv + C::BN - 1) / C::BN), 384, C::SMEM_KV, stream>>>(
      qt, kf, vf, dot, lse, delta, dk, dv, Tq, Tkv, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto q_kern = flash_bwd_dq_tf32_kernel<D>;
  err = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_Q);
  if (err != cudaSuccess) return err;
  q_kern<<<BH * ((Tq + C::BN - 1) / C::BN), 384, C::SMEM_Q, stream>>>(
      qf, kt, vt, dof, lse, delta, dq, Tq, Tkv, causal, scale);
  return cudaGetLastError();
}

}  // namespace tf32
}  // namespace sm90
}  // namespace bigdl_fg

// The arguments of flash_bwd.cu's entry point: float32 q, k, v, dout
// (contiguous (B, H, T, D)), D a multiple of 16 up to 64, 16-byte aligned;
// lse and delta float32 (B, H, Tq); dq, dk, dv float32. Launches the dK/dV
// kernel, then the dQ kernel, on `stream`. Returns a cudaError_t (0 = both
// launched).
extern "C" int bigdl_flash_bwd_tf32_sm90(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         void* dq, void* dk, void* dv, int B, int H, int Tq,
                                         int Tkv, int D, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* gq = static_cast<float*>(dq);
  float* gk = static_cast<float*>(dk);
  float* gv = static_cast<float*>(dv);
  switch (D) {
    case 16: return bigdl_fg::sm90::tf32::launch_bwd<16>(q, k, v, dout, l, dl, gq, gk, gv, B, H, Tq, Tkv, causal, scale, s);
    case 32: return bigdl_fg::sm90::tf32::launch_bwd<32>(q, k, v, dout, l, dl, gq, gk, gv, B, H, Tq, Tkv, causal, scale, s);
    case 48: return bigdl_fg::sm90::tf32::launch_bwd<48>(q, k, v, dout, l, dl, gq, gk, gv, B, H, Tq, Tkv, causal, scale, s);
    case 64: return bigdl_fg::sm90::tf32::launch_bwd<64>(q, k, v, dout, l, dl, gq, gk, gv, B, H, Tq, Tkv, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
