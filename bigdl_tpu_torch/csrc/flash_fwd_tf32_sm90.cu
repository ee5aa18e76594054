// Flash attention forward (K1-fwd) for Hopper, float32, on the tensor cores
// in 3xTF32.
//
// Replaces, for float32 inputs, the Pallas kernel
// bigdl_tpu/kernels/flash_attention.py `_flash_fwd` (body `_fwd_kernel`;
// JAX takes p in the input type before P V, so for float32 p stays float32):
// online-softmax attention over q (B, H, Tq, D) and k, v (B, H, Tkv, D), D
// a multiple of 16 up to 256, causal or rectangular-causal (query row r
// sits at global position q_offset + r and sees keys <= q_offset + r), over
// the first kv_len keys only; o (B, H, Tq, D) and the per-row log-sum-exp
// lse (B, H, Tq) in float32; rows that see no key give o = 0 and lse =
// -inf. The float32 backward (flash_bwd_tf32_sm90.cu, D up to 192) reads o
// and lse as they are.
//
// What bounds it on an H100: 4 D operations per (row, visible key) pair, run
// three times as tf32 products (495 TF/s dense, so 165 TF/s of float32
// work, a balance point near 50 operations per byte), against q, k, v and o
// read or written once in float32: causal at D = 64, about 32 operations
// per byte at T = 256 (the float32 LM training shape: memory bounds it) and
// 128 at T = 1024 (the tensor cores do); at D = 128 and T = 256 about 64
// (bytes 0.020 ms, operations 0.013 at (8,16,256,128)). Float32 FMAs on the
// CUDA cores (67 TF/s) would be bound by the operations at every shape.
//
// Two kernels share the design below; up to D = 112 (flash_fwd_tf32_kernel):
// - split_kv_kernel runs once a call: it writes K's tf32 halves hi =
//   tf32_rn(k) and lo = tf32_rn(k - hi) as K is laid out, and V's halves
//   transposed (D rows of keys, keys contiguous), because tf32 wgmma takes no
//   transposed operand and P V contracts over the keys. Within each group of
//   8 keys V^T keeps the order 0, 2, 4, 6, 1, 3, 5, 7: the S accumulator
//   holds keys (2q, 2q + 1) of each 8-key slice in a thread's registers
//   (PTX ISA, wgmma D fragment: row g + 8 (e >> 1), column 2q + (e & 1)),
//   while the tf32 A fragment takes columns (q, q + 4) (row g + 8 (e & 1),
//   column q + 4 (e >> 1)); with the keys so ordered, the accumulator's
//   registers are P's A fragment, {d0, d2, d1, d3}, with no shuffle. Only
//   the first kv_len keys are split (rounded up to 8, the rest zeros).
// - a block owns 128 query rows of one (b, h): a producer warp TMA-loads
//   the raw Q tile once and K hi / lo and V^T hi / lo tiles of BK keys (64
//   for D <= 64, else 32) into a two-stage ring guarded by full / empty
//   mbarriers; two consumer warpgroups of 64 rows each split their Q rows in
//   place into hi and lo tiles, then per key tile run S = Q K^T as three
//   shared-memory products a k8 slice (lo hi, hi lo, hi hi) into a fresh
//   accumulator, take the online softmax (m, l) in float32 registers, split
//   P into hi and lo in registers and run P V as three register-A products
//   a k8 slice into a fresh register set, which then joins the output as
//   acc = acc * alpha + tile: the softmax's rescale is also the promotion
//   that keeps the tensor cores' float32 accumulation (about 2^-25 of the
//   sum per k8 product on an H100) from drifting over long rows. Tile j's
//   P V runs while tile j + 1's S is made and its softmax computed;
// - the key loop stops at the causal / kv_len bound (no key tile above the
//   diagonal or past kv_len is read), keys past them are masked to -inf by
//   index, rows and keys past the ends come in as TMA's zeros, and query
//   tiles are launched heaviest first.
// Past D = 112 (flash_fwd_tf32_wide_kernel) the two Q halves would not fit
// beside two stages (D = 128 at BK = 32: 256 KB against a block's 227), nor
// would a second D-wide register set for P V (D = 256: 256 registers); so:
// - Q stays raw in shared memory and each consumer thread splits its A
//   fragment of a k8 slice into hi and lo in registers as it reads it (S =
//   Q K^T on register-A wgmma, the next slice's fragment made while the
//   one before runs); S's products go to a fresh sum every 64 columns of D
//   (24 products), added to S with rounded float32 adds;
// - K and V come raw by TMA into one stage, and the producer warpgroup (128
//   threads) splits them in shared memory into a two-stage ring of K hi /
//   lo (K's own layout) and V^T hi / lo (transposed, vt_pos order) tiles,
//   with no scratch in device memory and no split kernel (at D = 128 that
//   pass was 0.043 of 0.108 ms); keys from kv_len on come in as TMA's
//   zeros. BK = 32 keys at D = 128, 16 up to D = 192, 8 past it;
// - P V runs in slices of at most 64 output columns, each into a fresh
//   register set promoted at once (acc = acc * alpha + slice), so that the
//   float32 row of 256 fits beside one slice.
// Swizzle: Q's and K's rows in 128-byte chunks where 4 D is a multiple of
// 128 bytes, else 64-byte; V^T's rows (BK keys) in a BK * 4-byte swizzle.
//
// Grid: B * H * ceil(Tq / 128) blocks, 384 threads: warpgroup 0 is the
// producer (up to D = 112 one working thread, registers given back with
// setmaxnreg; past it all 128 threads split K and V, on 40 registers),
// warpgroups 1 and 2 the consumers.
#include "attn_tf32_sm90.cuh"

namespace bigdl_fg {
namespace sm90 {
namespace tf32 {

// -- the split of K and V -------------------------------------------------------

// K hi / lo (BH, kvp, D) of the first kv_len keys of k (BH, Tkv, D), as k is
// laid out; V^T hi / lo (BH, D, kvp) of v's, keys in vt_pos order, zeros for
// keys kv_len .. kvp - 1. Blocks of 32 keys x 32 columns (heads
// blockIdx.z, blockIdx.z + gridDim.z, ...), 256 threads.
__global__ void __launch_bounds__(256)
    split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                    float* __restrict__ khi, float* __restrict__ klo, float* __restrict__ vhi,
                    float* __restrict__ vlo, int BH, int Tkv, int kv_len, int kvp, int D) {
  __shared__ float t[32][33];
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
  const int k0 = blockIdx.x * 32;
  const int d0 = blockIdx.y * 32;
  for (size_t bh = blockIdx.z; bh < size_t(BH); bh += gridDim.z) {
    __syncthreads();  // the previous head's transpose is read
    for (int i = ty; i < 32; i += 8) {
      const int key = k0 + i, d = d0 + tx;
      float vv = 0.f;
      if (key < kv_len && d < D) {
        uint32_t h, l;
        split(k[(bh * Tkv + key) * D + d], h, l);
        khi[(bh * kvp + key) * D + d] = __uint_as_float(h);
        klo[(bh * kvp + key) * D + d] = __uint_as_float(l);
        vv = v[(bh * Tkv + key) * D + d];
      }
      t[i][tx] = vv;
    }
    __syncthreads();
    for (int i = ty; i < 32; i += 8) {
      const int d = d0 + i, key = k0 + tx;
      if (d >= D || key >= kvp) continue;
      uint32_t h, l;
      split(t[tx][i], h, l);
      const size_t o = (bh * D + d) * kvp + vt_pos(key);
      vhi[o] = __uint_as_float(h);
      vlo[o] = __uint_as_float(l);
    }
  }
}

// -- the attention kernel ---------------------------------------------------------

template <int D>
struct FlashCfg {
  static constexpr int BM = 128;                  // query rows per block
  static constexpr int BK = D <= 64 ? 64 : 32;    // keys per tile
  static constexpr int kStages = 2;
  static constexpr int SW = (4 * D) % 128 == 0 ? 128 : 64;  // Q and K rows' swizzle
  static constexpr int NCH = 4 * D / SW;          // their chunks a row
  static constexpr int Q_BYTES = BM * D * 4;      // one of Q hi / lo
  static constexpr int K_BYTES = BK * D * 4;      // one of K hi / lo
  static constexpr int V_BYTES = D * BK * 4;      // one of V^T hi / lo (128-byte swizzle)
  static constexpr int STAGE_BYTES = 2 * K_BYTES + 2 * V_BYTES;
  static constexpr int BAR_OFF = 2 * Q_BYTES + kStages * STAGE_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 64;  // + alignment slack, barriers
  static_assert(D % 16 == 0 && SMEM <= kSmemMax, "shared memory of one block");
};

template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_tf32_kernel(__grid_constant__ const CUtensorMap qmap,
                          __grid_constant__ const CUtensorMap khmap,
                          __grid_constant__ const CUtensorMap klmap,
                          __grid_constant__ const CUtensorMap vhmap,
                          __grid_constant__ const CUtensorMap vlmap, float* __restrict__ o,
                          float* __restrict__ lse, int Tq, int causal, int q_offset, int kv_len,
                          float scale) {
  using C = FlashCfg<D>;
  constexpr int BK = C::BK, SW = C::SW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint8_t* qh = smem;                // raw Q by TMA, then its hi half
  uint8_t* ql = smem + C::Q_BYTES;   // ... and its lo half
  uint8_t* stages = smem + 2 * C::Q_BYTES;
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
  const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;

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
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && ntiles > 0) {
      mbar_arrive_expect_tx(qbar, C::Q_BYTES);
      for (int c = 0; c < C::NCH; ++c)
        tma_load_3d(qh + c * C::BM * SW, &qmap, qbar, c * SW / 4, q0, bh);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % C::kStages;
        mbar_wait(&empty[s], ((j / C::kStages) & 1) ^ 1);
        uint8_t* st = stages + s * C::STAGE_BYTES;
        mbar_arrive_expect_tx(&full[s], C::STAGE_BYTES);
        for (int c = 0; c < C::NCH; ++c) {
          tma_load_3d(st + c * BK * SW, &khmap, &full[s], c * SW / 4, j * BK, bh);
          tma_load_3d(st + C::K_BYTES + c * BK * SW, &klmap, &full[s], c * SW / 4, j * BK, bh);
        }
        for (int c = 0; c < BK / 32; ++c) {
          tma_load_3d(st + 2 * C::K_BYTES + c * D * 128, &vhmap, &full[s], j * BK + 32 * c, 0,
                      bh);
          tma_load_3d(st + 2 * C::K_BYTES + C::V_BYTES + c * D * 128, &vlmap, &full[s],
                      j * BK + 32 * c, 0, bh);
        }
      }
    }
    return;
  }

  // consumer warpgroups
  setmaxnreg_inc<240>();
  const int wg = threadIdx.x / 128 - 1;
  const int lt = threadIdx.x % 128;
  const int qw = q0 + 64 * wg;  // this warpgroup's first row
  const float sl2 = scale * kLog2e;
  float acc[D / 2];    // O, unnormalised
  float part[D / 2];   // one key tile's P V
  float sc[BK / 2];    // S of one key tile, then its P (float32)
  uint32_t ph[BK / 8][4], pl[BK / 8][4];  // P's hi and lo: the A operand of P V
  float m[2] = {-INFINITY, -INFINITY};    // running max of s * scale * log2(e)
  float l[2] = {0.f, 0.f};                // this thread's partial row sums
  float alpha[2], apv[2];  // the newest tile's rescale, and that of the tile in P V
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint8_t* qhw = qh + 64 * wg * SW;
  const uint8_t* qlw = ql + 64 * wg * SW;

  // S = Q K_j^T into sc, asynchronously (the caller waits for the tile,
  // commits and waits for the products): per k8 slice lo hi, hi lo, hi hi,
  // small terms first
  auto start_s = [&](int j) {
    const uint8_t* kh = stages + (j % C::kStages) * C::STAGE_BYTES;
    const uint8_t* kl = kh + C::K_BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint64_t dqh = kmajor_desc<SW>(qhw, C::BM * SW, kk);
      const uint64_t dkh = kmajor_desc<SW>(kh, BK * SW, kk);
      wgmma_ss_tf32<BK>(sc, kmajor_desc<SW>(qlw, C::BM * SW, kk), dkh, kk > 0);
      wgmma_ss_tf32<BK>(sc, dqh, kmajor_desc<SW>(kl, BK * SW, kk), 1);
      wgmma_ss_tf32<BK>(sc, dqh, dkh, 1);
    }
  };
  // the online softmax of tile j: masks sc, moves m and l, and leaves P in
  // sc and the factor for the O accumulated so far in alpha
  auto softmax = [&](int j) {
    // keys past kv_len or above the diagonal: selects, no branch
    const int lim0 = min(kv_len - 1, causal ? q_offset + qw + acc_row(0) : kv_len) - j * BK;
    const int lim1 = min(kv_len - 1, causal ? q_offset + qw + acc_row(2) : kv_len) - j * BK;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      sc[i] = acc_col(i) > ((i >> 1) & 1 ? lim1 : lim0) ? -INFINITY : sc[i];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
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
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = exp2f(fmaf(sc[i], sl2, -base[r]));
      rs[r] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
  };
  // P's A fragments: slice kk's registers in the order {d0, d2, d1, d3}
  // (see the note at the top), each split into hi and lo
  auto split_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) split(sc[4 * kk + ((e & 1) << 1) + (e >> 1)], ph[kk][e], pl[kk][e]);
    apv[0] = alpha[0];
    apv[1] = alpha[1];
  };
  // P_j V_j into part, asynchronously (the caller commits and waits)
  auto start_pv = [&](int j) {
    const uint8_t* vh = stages + (j % C::kStages) * C::STAGE_BYTES + 2 * C::K_BYTES;
    const uint8_t* vl = vh + C::V_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t dvh = kmajor_desc<128>(vh, D * 128, kk);
      wgmma_tf32<D>(part, pl[kk], dvh, kk > 0);
      wgmma_tf32<D>(part, ph[kk], kmajor_desc<128>(vl, D * 128, kk), 1);
      wgmma_tf32<D>(part, ph[kk], dvh, 1);
    }
  };
  // the finished tile joins the output: acc = acc * alpha + P V
  auto promote_pv = [&]() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = __fadd_rn(__fmul_rn(acc[i], apv[(i >> 1) & 1]), part[i]);
  };
  // Every register a product reads or writes is settled before its
  // wgmma_fence, and no branch separates a product from its wait: ptxas
  // serialises wgmma otherwise.
  auto settle = [&]() {
    fence_regs(part);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(sc);
  };

  if (ntiles > 0) {
    // this warpgroup's 64 Q rows: hi over the raw values, lo beside them
    // (an elementwise map, so the swizzle does not matter)
    mbar_wait(qbar, 0);
#pragma unroll
    for (int c = 0; c < C::NCH; ++c) {
      const int base = c * C::BM * SW + 64 * wg * SW;
      for (int i = lt; i < 4 * SW; i += 128) {
        float4* h4 = reinterpret_cast<float4*>(qh + base + 16 * i);
        const float4 x = *h4;
        uint32_t h[4], lo[4];
        split(x.x, h[0], lo[0]);
        split(x.y, h[1], lo[1]);
        split(x.z, h[2], lo[2]);
        split(x.w, h[3], lo[3]);
        *reinterpret_cast<uint4*>(h4) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(ql + base + 16 * i) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
    fence_proxy_async();
    bar_sync(1 + wg, 128);
    mbar_wait(&full[0], 0);
    settle();
    wgmma_fence();
    start_s(0);
    wgmma_commit();
    wgmma_wait<0>();
    settle();
    softmax(0);
    split_p();
  }
  // Tile j's P V runs on the tensor cores while tile j + 1's S is made and
  // its softmax computed; tile j then joins the output.
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
    if (lt % 32 == 0) mbar_arrive(&empty[j % C::kStages]);
    promote_pv();
    split_p();
  }
  if (ntiles > 0) {  // the last tile's P V
    settle();
    wgmma_fence();
    start_pv(ntiles - 1);
    wgmma_commit();
    wgmma_wait<0>();
    settle();
    promote_pv();
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    inv[r] = lsum > 0.f ? 1.f / lsum : 0.f;
    const int row = qw + acc_row(2 * r);
    if (lt % 4 == 0 && row < Tq)
      lse[size_t(bh) * Tq + row] = lsum > 0.f ? m[r] * 0.6931471805599453f + logf(lsum) : -INFINITY;
  }
  store_acc<float, D>(o + size_t(bh) * Tq * D, acc, qw, Tq, inv[0], inv[1]);
}

// -- the wide kernel: D from 128 to 256 ---------------------------------------------

// Q stays raw in shared memory (its hi and lo halves are made in registers
// as each A fragment is read), and K and V come raw by TMA into one stage
// that the producer warpgroup splits into a two-stage ring of K hi / lo and
// V^T hi / lo tiles: BK = 32 keys a tile at D = 128, 16 up to D = 192, 8
// past it (D = 256: 128 + 64 + 16 KB).
template <int D>
struct WideCfg {
  static constexpr int BM = 128;                            // query rows per block
  static constexpr int SW = (4 * D) % 128 == 0 ? 128 : 64;  // Q and K rows' swizzle
  static constexpr int NCH = 4 * D / SW;                    // their chunks a row
  static constexpr int Q_BYTES = BM * D * 4;                // raw Q
  static constexpr int kStages = 2;                         // split K / V^T sets
  static constexpr int bytes(int bk) {
    return 1024 + Q_BYTES + kStages * 4 * bk * D * 4 + 2 * bk * D * 4 + 64;
  }
  static constexpr int BK = bytes(32) <= kSmemMax ? 32 : bytes(16) <= kSmemMax ? 16 : 8;
  static constexpr int SWV = 4 * BK;         // V^T rows (BK keys) and their swizzle
  static constexpr int K_BYTES = BK * D * 4;  // one of K hi / lo, or raw K
  static constexpr int V_BYTES = D * BK * 4;  // one of V^T hi / lo, or raw V
  static constexpr int STAGE_BYTES = 2 * K_BYTES + 2 * V_BYTES;
  static constexpr int RAW_OFF = Q_BYTES + kStages * STAGE_BYTES;
  static constexpr int RAW_BYTES = K_BYTES + V_BYTES;
  static constexpr int BAR_OFF = RAW_OFF + RAW_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 64;  // + alignment slack, barriers
  static_assert(D % 16 == 0 && D <= 256 && SMEM <= kSmemMax, "shared memory of one block");
  // every tile starts on its swizzle's repeat (8 rows)
  static_assert(K_BYTES % (8 * SW) == 0 && V_BYTES % (8 * SWV) == 0, "tile alignment");
};

template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_tf32_wide_kernel(__grid_constant__ const CUtensorMap qmap,
                               __grid_constant__ const CUtensorMap kmap,
                               __grid_constant__ const CUtensorMap vmap,
                               float* __restrict__ o, float* __restrict__ lse, int Tq,
                               int causal, int q_offset, int kv_len, float scale) {
  using C = WideCfg<D>;
  constexpr int BK = C::BK, SW = C::SW, SWV = C::SWV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint8_t* qs = smem;                    // raw Q, NCH chunks of BM rows
  uint8_t* stages = smem + C::Q_BYTES;   // the split K / V^T sets
  uint8_t* raw = smem + C::RAW_OFF;      // raw K, then raw V, as Q is laid out
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* qbar = bars;
  uint64_t* rawbar = bars + 1;
  uint64_t* full = bars + 2;
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
  const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    mbar_init(rawbar, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: the loads and the split
    setmaxnreg_dec<40>();
    const int pt = threadIdx.x;
    // raw K and V of key tile j (rows past kv_len come in as TMA's zeros)
    auto load_raw = [&](int j) {
      mbar_arrive_expect_tx(rawbar, C::RAW_BYTES);
      for (int c = 0; c < C::NCH; ++c) {
        tma_load_3d(raw + c * BK * SW, &kmap, rawbar, c * SW / 4, j * BK, bh);
        tma_load_3d(raw + C::K_BYTES + c * BK * SW, &vmap, rawbar, c * SW / 4, j * BK, bh);
      }
    };
    if (ntiles > 0 && pt == 0) {
      mbar_arrive_expect_tx(qbar, C::Q_BYTES);
      for (int c = 0; c < C::NCH; ++c)
        tma_load_3d(qs + c * C::BM * SW, &qmap, qbar, c * SW / 4, q0, bh);
      load_raw(0);
    }
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % C::kStages;
      uint8_t* st = stages + s * C::STAGE_BYTES;
      mbar_wait(&empty[s], ((j / C::kStages) & 1) ^ 1);
      mbar_wait(rawbar, j & 1);
      // K hi / lo: the raw tile's layout, 16 bytes at a time
      for (int u = pt; u < C::K_BYTES / 16; u += 128) {
        const float4 x = *reinterpret_cast<const float4*>(raw + 16 * u);
        uint32_t h[4], l[4];
        split(x.x, h[0], l[0]);
        split(x.y, h[1], l[1]);
        split(x.z, h[2], l[2]);
        split(x.w, h[3], l[3]);
        *reinterpret_cast<uint4*>(st + 16 * u) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(st + C::K_BYTES + 16 * u) = make_uint4(l[0], l[1], l[2], l[3]);
      }
      // V^T hi / lo: row d holds the tile's keys in vt_pos order, so keys
      // 8 g + p, + 2, + 4, + 6 fill the 16 bytes of positions 8 g + 4 p ..
      const uint8_t* rv = raw + C::K_BYTES;
      uint8_t* vh = st + 2 * C::K_BYTES;
      for (int it = pt; it < D * BK / 4; it += 128) {
        const int d = it % D;
        const int gp = it / D;  // group of 8 keys and parity: 2 g + p
        const int k0 = 8 * (gp >> 1) + (gp & 1);
        const int c = d / (SW / 4);
        const uint8_t* col = rv + c * BK * SW;
        uint32_t h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(lds_f(col + swz_f32<SW>(k0 + 2 * e, d % (SW / 4))), h[e], l[e]);
        const int o = swz_f32<SWV>(d, 4 * gp);
        *reinterpret_cast<uint4*>(vh + o) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(vh + C::V_BYTES + o) = make_uint4(l[0], l[1], l[2], l[3]);
      }
      fence_proxy_async();  // the split tiles before wgmma, the raw reads before TMA
      bar_sync(1, 128);
      if (pt == 0) {
        if (j + 1 < ntiles) load_raw(j + 1);
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumer warpgroups
  setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128 - 1;
  const int lt = threadIdx.x % 128;
  const int qw = q0 + 64 * wg;  // this warpgroup's first row
  const float sl2 = scale * kLog2e;
  float acc[D / 2];                       // O, unnormalised
  float sc[BK / 2];                       // S of one key tile, then its P (float32)
  float sp[BK / 2];                       // one 64-column block's part of S
  uint32_t qh[2][4], ql[2][4];            // Q's A fragments, two k8 slices in turn
  uint32_t ph[BK / 8][4], pl[BK / 8][4];  // P's hi and lo: the A operand of P V
  float m[2] = {-INFINITY, -INFINITY};    // running max of s * scale * log2(e)
  float l[2] = {0.f, 0.f};                // this thread's partial row sums
  float alpha[2];                         // the newest tile's rescale
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // this thread's fragment rows in the Q tile (register e: row + 8 (e & 1))
  const int frow = 64 * wg + 16 * (lt / 32) + (lt % 32) / 4;

  // Q's k8 slice kk as a tf32 A fragment (register e: column 8 kk + q + 4
  // (e >> 1)), split into hi and lo from the raw values
  auto q_frag = [&](int kk, uint32_t(&h)[4], uint32_t(&lo)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * kk + lt % 4 + 4 * (e >> 1);
      const int c = col / (SW / 4);
      split(lds_f(qs + c * C::BM * SW + swz_f32<SW>(frow + 8 * (e & 1), col % (SW / 4))), h[e],
            lo[e]);
    }
  };
  // S = Q K_j^T into sc: per k8 slice lo hi, hi lo, hi hi into sp, a fresh
  // sum every 64 columns of D (24 products) that is then added to sc with
  // a rounded add; each slice's fragments are made while the one before
  // runs
  auto s_tile = [&](int j) {
    const uint8_t* kh = stages + (j % C::kStages) * C::STAGE_BYTES;
    const uint8_t* kl = kh + C::K_BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int b = kk & 1;
      if (kk % 8 >= 2) {  // the slice that last read these registers is done
        wgmma_wait<1>();
        fence_regs(qh);
        fence_regs(ql);
      }
      q_frag(kk, qh[b], ql[b]);
      fence_regs(sp);
      fence_regs(qh);
      fence_regs(ql);
      wgmma_fence();
      const uint64_t dkh = kmajor_desc<SW>(kh, BK * SW, kk);
      wgmma_tf32<BK>(sp, ql[b], dkh, kk % 8 > 0);
      wgmma_tf32<BK>(sp, qh[b], kmajor_desc<SW>(kl, BK * SW, kk), 1);
      wgmma_tf32<BK>(sp, qh[b], dkh, 1);
      wgmma_commit();
      if (kk % 8 == 7 || kk == D / 8 - 1) {
        fence_regs(sp);
        fence_regs(qh);
        fence_regs(ql);
        wgmma_wait<0>();
        fence_regs(sp);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] = kk < 8 ? sp[i] : __fadd_rn(sc[i], sp[i]);
      }
    }
  };
  // the online softmax of tile j: masks sc, moves m and l, and leaves P in
  // sc and the factor for the O accumulated so far in alpha
  auto softmax = [&](int j) {
    const int lim0 = min(kv_len - 1, causal ? q_offset + qw + acc_row(0) : kv_len) - j * BK;
    const int lim1 = min(kv_len - 1, causal ? q_offset + qw + acc_row(2) : kv_len) - j * BK;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      sc[i] = acc_col(i) > ((i >> 1) & 1 ? lim1 : lim0) ? -INFINITY : sc[i];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
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
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = exp2f(fmaf(sc[i], sl2, -base[r]));
      rs[r] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) split(sc[4 * kk + ((e & 1) << 1) + (e >> 1)], ph[kk][e], pl[kk][e]);
  };
  // columns [c0, c0 + N) of P_j V_j, three products a k8 slice into a fresh
  // register set, which then joins the output: acc = acc * alpha + part
  // (the promotion that keeps the tensor cores' accumulation from drifting)
  auto pv_slice = [&](auto& part, int j, auto ncols) {
    constexpr int N = decltype(ncols)::value;
    constexpr int c0 = decltype(ncols)::c0;
    const uint8_t* vh = stages + (j % C::kStages) * C::STAGE_BYTES + 2 * C::K_BYTES + c0 * SWV;
    const uint8_t* vl = vh + C::V_BYTES;
    fence_regs(part);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t dvh = kmajor_desc<SWV>(vh, D * SWV, kk);
      wgmma_tf32<N>(part, pl[kk], dvh, kk > 0);
      wgmma_tf32<N>(part, ph[kk], kmajor_desc<SWV>(vl, D * SWV, kk), 1);
      wgmma_tf32<N>(part, ph[kk], dvh, 1);
    }
    wgmma_commit();
    fence_regs(part);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      acc[c0 / 2 + i] = __fadd_rn(__fmul_rn(acc[c0 / 2 + i], alpha[(i >> 1) & 1]), part[i]);
  };

  if (ntiles > 0) mbar_wait(qbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    mbar_wait(&full[j % C::kStages], (j / C::kStages) & 1);
    s_tile(j);
    softmax(j);
    for_each_slice(std::make_integer_sequence<int, D / 64>{}, [&](auto cols) {
      float part[32];
      pv_slice(part, j, cols);
    });
    if constexpr (D % 64 != 0) {
      float part[(D % 64) / 2];
      pv_slice(part, j, PvCols<D % 64, D / 64 * 64>{});
    }
    if (lt % 32 == 0) mbar_arrive(&empty[j % C::kStages]);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    inv[r] = lsum > 0.f ? 1.f / lsum : 0.f;
    const int row = qw + acc_row(2 * r);
    if (lt % 4 == 0 && row < Tq)
      lse[size_t(bh) * Tq + row] = lsum > 0.f ? m[r] * 0.6931471805599453f + logf(lsum) : -INFINITY;
  }
  store_acc<float, D>(o + size_t(bh) * Tq * D, acc, qw, Tq, inv[0], inv[1]);
}

// -- host ---------------------------------------------------------------------------

// keys of the split scratch a head: kv_len rounded up to 8 (at least 8)
inline int split_keys(int kv_len) { return kv_len > 8 ? (kv_len + 7) / 8 * 8 : 8; }

// The D <= 112 kernel over the split K and V in ws: Q and K in boxes of
// SW / 4 columns, V^T in boxes of 32 keys (loaded BK / 32 times a tile)
template <int D>
cudaError_t launch_split(const void* q, void* o, void* lse, int BH, int Tq, int causal,
                         int q_offset, int kv_len, float scale, float* ws,
                         cudaStream_t stream) {
  using C = FlashCfg<D>;
  const int kvp = split_keys(kv_len);
  const size_t n = size_t(BH) * kvp * D;
  const int kvl = kv_len > 0 ? kv_len : 1;
  CUtensorMap qm, khm, klm, vhm, vlm;
  if (!make_map3(&qm, q, D, Tq, BH, D, size_t(Tq) * D, C::SW / 4, C::BM, C::SW) ||
      !make_map3(&khm, ws, D, kvl, BH, D, size_t(kvp) * D, C::SW / 4, C::BK, C::SW) ||
      !make_map3(&klm, ws + n, D, kvl, BH, D, size_t(kvp) * D, C::SW / 4, C::BK, C::SW) ||
      !make_map3(&vhm, ws + 2 * n, kvp, D, BH, kvp, size_t(D) * kvp, 32, D, 128) ||
      !make_map3(&vlm, ws + 3 * n, kvp, D, BH, kvp, size_t(D) * kvp, 32, D, 128))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_tf32_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(BH * ((Tq + C::BM - 1) / C::BM));
  kern<<<grid, 384, C::SMEM, stream>>>(qm, khm, klm, vhm, vlm, static_cast<float*>(o),
                                       static_cast<float*>(lse), Tq, causal, q_offset, kv_len,
                                       scale);
  return cudaGetLastError();
}

// The wide kernel over raw q, k and v (k and v's rows from kv_len on read
// as zeros), all in boxes of SW / 4 columns
template <int D>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                        int Tq, int Tkv, int causal, int q_offset, int kv_len, float scale,
                        cudaStream_t stream) {
  using C = WideCfg<D>;
  const int kvl = kv_len > 0 ? kv_len : 1;
  CUtensorMap qm, km, vm;
  if (!make_map3(&qm, q, D, Tq, BH, D, size_t(Tq) * D, C::SW / 4, C::BM, C::SW) ||
      !make_map3(&km, k, D, kvl, BH, D, size_t(Tkv) * D, C::SW / 4, C::BK, C::SW) ||
      !make_map3(&vm, v, D, kvl, BH, D, size_t(Tkv) * D, C::SW / 4, C::BK, C::SW))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_tf32_wide_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(BH * ((Tq + C::BM - 1) / C::BM));
  kern<<<grid, 384, C::SMEM, stream>>>(qm, km, vm, static_cast<float*>(o),
                                       static_cast<float*>(lse), Tq, causal, q_offset, kv_len,
                                       scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                         int H, int Tq, int Tkv, int causal, int q_offset, int kv_len,
                         float scale, float* ws, cudaStream_t stream) {
  const int BH = B * H;
  if constexpr (D > 112) {
    return launch_wide<D>(q, k, v, o, lse, BH, Tq, Tkv, causal, q_offset, kv_len, scale,
                          stream);
  } else {
    const int kvp = split_keys(kv_len);
    const size_t n = size_t(BH) * kvp * D;
    if (kv_len > 0) {
      const dim3 g((kvp + 31) / 32, (D + 31) / 32, BH < 65535 ? BH : 65535);
      split_kv_kernel<<<g, 256, 0, stream>>>(static_cast<const float*>(k),
                                             static_cast<const float*>(v), ws, ws + n,
                                             ws + 2 * n, ws + 3 * n, BH, Tkv, kv_len, kvp, D);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    return launch_split<D>(q, o, lse, BH, Tq, causal, q_offset, kv_len, scale, ws, stream);
  }
}

}  // namespace tf32
}  // namespace sm90
}  // namespace bigdl_fg

// q, k, v, o, lse, B, H, Tq, Tkv, D, causal, q_offset, kv_len, scale and
// the stream (the arguments of flash_fwd_sm90.cu's entry point), then ws: up
// to D = 112, 4 x B x H x kvp x D float32 of scratch for the split K and V
// (kvp = kv_len rounded up to a multiple of 8, at least 8); past it none
// (the wide kernel splits them in shared memory; ws is not read). float32
// q, k, v (contiguous (B, H, T, D)), D a multiple of 16 up to 256, 16-byte
// aligned; o, lse float32. Returns a cudaError_t (0 = launched).
extern "C" int bigdl_flash_fwd_tf32_sm90(const void* q, const void* k, const void* v, void* o,
                                         void* lse, int B, int H, int Tq, int Tkv, int D,
                                         int causal, int q_offset, int kv_len, float scale,
                                         void* stream, float* ws) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return bigdl_fg::sm90::tf32::launch_flash<16>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, ws, s);
    case 32: return bigdl_fg::sm90::tf32::launch_flash<32>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, ws, s);
    case 48: return bigdl_fg::sm90::tf32::launch_flash<48>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, ws, s);
    case 64: return bigdl_fg::sm90::tf32::launch_flash<64>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, ws, s);
    case 80: return bigdl_fg::sm90::tf32::launch_flash<80>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, ws, s);
    case 96: return bigdl_fg::sm90::tf32::launch_flash<96>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, ws, s);
    case 112: return bigdl_fg::sm90::tf32::launch_flash<112>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, ws, s);
    case 128: return bigdl_fg::sm90::tf32::launch_flash<128>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, ws, s);
    case 144: return bigdl_fg::sm90::tf32::launch_flash<144>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, ws, s);
    case 160: return bigdl_fg::sm90::tf32::launch_flash<160>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, ws, s);
    case 176: return bigdl_fg::sm90::tf32::launch_flash<176>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, ws, s);
    case 192: return bigdl_fg::sm90::tf32::launch_flash<192>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, ws, s);
    case 208: return bigdl_fg::sm90::tf32::launch_flash<208>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, ws, s);
    case 224: return bigdl_fg::sm90::tf32::launch_flash<224>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, ws, s);
    case 240: return bigdl_fg::sm90::tf32::launch_flash<240>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, ws, s);
    case 256: return bigdl_fg::sm90::tf32::launch_flash<256>(q, k, v, o, lse, B, H, Tq, Tkv, causal, q_offset, kv_len, scale, ws, s);
    default: return cudaErrorInvalidValue;
  }
}
