// Flash attention backward (K1-bwd) for Hopper, float32, on the tensor cores
// in 3xTF32.
//
// Replaces, for float32 inputs (head dim D a multiple of 16 up to 192), the
// Pallas kernels bigdl_tpu/kernels/flash_attention.py `_flash_bwd`:
// `_bwd_kv_kernel` (dK and dV over query tiles) and `_bwd_q_kernel` (dQ over
// key tiles); JAX takes p and ds in the input type before their products,
// which for float32 keeps them float32. Given q, k, v, dO (B, H, T, D), the
// forward's log-sum-exp lse (B, H, Tq) and delta = rowsum(dO * O) (B, H,
// Tq), both float32, it recomputes tile by tile
//   p  = exp(q k^T * scale - lse), 0 where causal and col > row, on rows past
//        Tq and on rows whose lse is -inf;
//   dp = dO v^T;  ds = p * (dp - delta) * scale
// and sums dV = p^T dO, dK = ds^T q (first kernel) and dQ = ds k (second
// kernel), written once in float32. There are no atomics: reruns give
// bitwise-equal gradients.
//
// Numerics: every float32 operand x is split into hi = tf32_rn(x) and lo =
// tf32_rn(x - hi), and each product is lo hi + hi lo + hi hi on wgmma ...
// .tf32 (fused_gemm_tf32_sm90.cuh). The contractions over D (S and dP) run
// whole into one accumulator up to D = 64 (at most 24 products, as the
// forward's S) and in 64-column pieces past it, each piece's 24 products
// into a fresh sum added to the total with a rounded add; the sums over
// tiles (dV and dK over the query tiles, dQ over the key tiles) take each
// tile's products (12, or 6 on 16-row tiles) into a fresh register set,
// which is then added to the float32 total with a rounded add, so the
// tensor cores' own accumulation (about 2^-25 of the sum per k8 product, in
// one direction) never runs over more than 24 products.
//
// What bounds it on an H100: five products of 2 D operations per (row,
// visible key) pair, run three times as tf32 (495 TF/s dense, so 165 TF/s of
// float32 work), against q, k, v, dO, dq, dk, dv of 4 D bytes a row and lse
// and delta: causal at T = 256 (the float32 LM training shape) about 40
// float32 operations per byte at every D, where the bytes bound it (0.020
// ms at (8,16,256,64) and at (8,8,256,128)), and 160 at T = 1024, where the
// tensor cores do (0.065 ms at (2,16,1024,64)). Float32 FMAs on the CUDA
// cores (67 TF/s) would be bound by the operations at every shape. What the
// design does:
// - tf32 wgmma takes both shared-memory operands K-major only. The
//   contractions over the streamed side (dV += P^T dO and dK += dS^T Q over
//   queries, dQ += dS K over keys) need that side transposed: dO^T, Q^T and
//   K^T, queries or keys contiguous. Each streamed tile (BT rows) lands raw
//   by TMA in a ring of one or two stages; the consumers split it into its
//   natural hi and lo tiles (the B operand of S^T = K Q^T, dP^T = V dO^T, or
//   of S = Q K^T, dP = dO V^T) and write the transposed hi and lo tiles
//   beside them (D rows of BT floats in a 4 BT-byte swizzle), with no
//   scratch in device memory. Within each group of 8 the transposed tiles
//   keep the order 0, 2, 4, 6, 1, 3, 5, 7 (vt_pos, attn_tf32_sm90.cuh), so
//   the P^T / dS^T (or dS) accumulators' registers {d0, d2, d1, d3} are the
//   A fragments of the tile products, split into hi and lo in registers.
// - The raw stage is released to the producer as soon as it is split, so
//   the next tile's load runs under the products.
// - The loops over tiles start (dK/dV) or stop (dQ) at the causal diagonal.
// Up to D = 64 (the narrow pair, BT = 32):
// - dK/dV kernel: a block owns 128 keys of one (b, h), two consumer
//   warpgroups of 64 keys; K and V land once by TMA and each warpgroup
//   splits its rows in place (hi over the raw values, lo beside). Per tile:
//   S^T and dP^T as three shared-memory products a k8 slice, P^T and dS^T
//   in float32 registers, then dV's and dK's tile products from registers.
// - dQ kernel: a block owns 128 queries (Q and dO split in place once), per
//   key tile S and dP, dS in registers, dQ's tile product over K^T.
// - One split set of the streamed tile serves both consumer warpgroups,
//   split by all 256 consumer threads: a named barrier over them guards it
//   (the previous tile's products are done before it is written, and it is
//   written before the products read it).
// - The fixed halves (128 rows of K and V, hi and lo: 128 KB at D = 64),
//   the split set (64 KB) and two raw stages (32 KB) fill a block's 227 KB.
// From D = 80 to 192 (the wide pair) those fixed halves would take 256 KB
// at D = 128, and dK's and dV's accumulators side by side in one thread D
// registers (192 at D = 192, beside the tiles and fragments). So:
// - a block owns 64 rows (keys, or queries) of one (b, h), held raw as TMA
//   put them (2 x 64 x D x 4 bytes: 96 KB at D = 192); the fixed operand's
//   A fragments are split into hi and lo in registers, as the wide forward
//   does with Q, 64 columns of D (eight k8 slices) at a time, so that a
//   piece's 24 products go out with no wait between them (fragments held
//   in registers across the tiles instead would need D registers);
// - both consumer warpgroups take all 64 rows and share out the products,
//   not the rows. dK/dV kernel: warpgroup 1 makes S^T = K Q^T and P^T,
//   hands P^T over in shared memory (it arrives at a named barrier and
//   goes on) and sums dV += P^T dO; warpgroup 2 makes dP^T = V dO^T, takes
//   P^T, makes dS^T and sums dK += dS^T Q. Each holds one D-wide
//   accumulator (D / 2 registers) and runs its tile product in one register
//   set up to D = 128, past it in 64-column slices, each promoted at once.
//   dQ kernel: warpgroup 1 makes S = Q K^T and P, warpgroup 2 dP and, from
//   that P, dS, which it hands back; each sums half of dQ's columns, dQ[:,
//   half] += dS K[:, half] (N = D / 2). No product is made twice. The hand-
//   over buffer (64 x BT floats) lies over the lo half of Q's (K's) natural
//   tile, which no product reads once S^T (S) is made;
// - the consumer warpgroups split the raw tiles themselves, under named
//   barriers of their own where they can. dK/dV kernel: warpgroup 1 splits
//   Q whole (the natural halves of its S^T's B, and Q^T for warpgroup 2's
//   tile product), warpgroup 2 dO (its dP^T's B, and dO^T), so each element
//   is split once; dQ kernel: warpgroup 1 splits K's natural halves, 2
//   V's, and each its half of K^T's rows while its first 64 columns of S
//   (dP) are on the tensor cores;
// - the streamed tile narrows with D so that the fixed tiles, the split set
//   (8 tiles in the dK/dV kernel, 6 in the dQ kernel) and the raw stages
//   fit: BT = 32 rows up to D = 128 (dK/dV) or 144 (dQ), else 16; two raw
//   stages where they fit, else one.
// A row's chunks are 128-byte swizzled where 4 D is a multiple of 128
// bytes, else 64-byte.
//
// Grids: B * H * ceil(Tkv / BN) blocks for dK/dV, B * H * ceil(Tq / BN) for
// dQ (BN = 128 rows up to D = 64, 64 past it), heads fastest and the
// heaviest tiles (causal) first, so the light ones fill the last wave; 384
// threads: warpgroup 0 the producer (one working warp, on 40 registers),
// warpgroups 1 and 2 the consumers.
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

// The wide pair's shape at head dim D: KV the dK/dV kernel (split set of 8
// tiles), else the dQ kernel (6). The widest streamed tile (32 rows, then
// 16) and then the most raw stages (2, then 1) that fit beside the raw
// fixed tiles and the statistics. The 64 x BT hand-over buffer takes the
// place of the lo half of warpgroup 1's natural B tile (Q's in dK/dV, K's
// in dQ), which no product reads once that warpgroup's S^T or S is made.
template <int D, bool KV>
struct WideCfg {
  static constexpr int BN = 64;  // rows a block owns, taken by both consumer warpgroups
  static constexpr int SW = (4 * D) % 128 == 0 ? 128 : 64;  // swizzle of the D-wide rows
  static constexpr int NCH = 4 * D / SW;                    // their chunks a row
  static constexpr int FIX = BN * D * 4;                    // one raw fixed tile
  static constexpr int NSET = KV ? 8 : 6;                   // tiles of the split set
  static constexpr int bytes(int bt, int stages) {
    return 1024 + 2 * FIX + (NSET + 2 * stages) * bt * D * 4 + (stages + 1) * 2 * bt * 4 + 64;
  }
  static constexpr int BT = bytes(32, 1) <= kSmemMax ? 32 : 16;
  static constexpr int kStages = bytes(BT, 2) <= kSmemMax ? 2 : 1;
  static constexpr int SWT = 4 * BT;        // transposed rows (BT values) and their swizzle
  static constexpr int TILE = BT * D * 4;   // one streamed tile, natural or transposed
  static constexpr int SMEM = bytes(BT, kStages);
  static_assert(D % 16 == 0 && D <= 192 && SMEM <= kSmemMax, "shared memory of one block");
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

// Columns [C0, C0 + NC) of a raw streamed tile (BT rows of D floats, as
// TMA swizzled it) into, with `hi`, its hi and lo tiles (same layout) and,
// with `thi`, its transposed hi and lo tiles: D rows of the BT row values
// in a 4 BT-byte swizzle, row r's value at column vt_pos(r). NT threads (t
// = 0 .. NT - 1), each a 16-byte unit at a time, rows fastest
// (conflict-free reads and transposed writes at BT = 32).
template <int D, int SW, int BT, int NT = 256, int C0 = 0, int NC = D>
__device__ __forceinline__ void split_tile(const uint8_t* raw, uint8_t* hi, uint8_t* lo,
                                           uint8_t* thi, uint8_t* tlo, int t) {
  constexpr int UPR = SW / 16;  // units a chunk row
  for (int u = t; u < BT * NC / 4; u += NT) {
    const int r = u % BT;
    const int cu = C0 / 4 + u / BT;  // unit along the row: columns 4 cu .. 4 cu + 3
    const int off = (cu / UPR) * BT * SW + swz_unit<SW>(r, cu % UPR);
    const float4 x = *reinterpret_cast<const float4*>(raw + off);
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    if (hi != nullptr) {
      *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    if (thi != nullptr) {
      const int c = vt_pos(r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        *reinterpret_cast<uint32_t*>(thi + swz_f32<4 * BT>(4 * cu + e, c)) = h[e];
        *reinterpret_cast<uint32_t*>(tlo + swz_f32<4 * BT>(4 * cu + e, c)) = l[e];
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

// part (64 x N) = the tile product of register A fragments (hi, lo; BT / 8
// k8 slices) and N rows of a transposed B (rows of BT values, 4 BT-byte
// swizzle)
template <int N, int BT>
__device__ __forceinline__ void mma3_rs(float (&part)[N / 2], const uint32_t (&ah)[BT / 8][4],
                                        const uint32_t (&al)[BT / 8][4], const uint8_t* bh,
                                        const uint8_t* bl) {
#pragma unroll
  for (int kk = 0; kk < BT / 8; ++kk) {
    const uint64_t dbh = kmajor_desc<4 * BT>(bh, 0, kk);
    wgmma_tf32<N>(part, al[kk], dbh, kk > 0);
    wgmma_tf32<N>(part, ah[kk], kmajor_desc<4 * BT>(bl, 0, kk), 1);
    wgmma_tf32<N>(part, ah[kk], dbh, 1);
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

// -- the wide pair: D from 80 to 192 ------------------------------------------------

// sc (64 x BT) = F B^T over the head dim, in pieces of 64 columns. F: the
// 64 raw rows of a fixed tile (chunks of 64 x SW bytes); a piece's A
// fragments (eight k8 slices) are read and split into hi and lo in
// registers first, then its 24 products go out with no wait between them.
// B: the hi and lo halves of a streamed tile (BT rows, chunks BT x SW bytes
// apart). Each piece's sum sp is added to sc with a rounded add. `during`
// runs while the first piece's products are on the tensor cores.
template <int D, int BT, int SW, class F>
__device__ __forceinline__ void s_wide(float (&sc)[BT / 2], float (&sp)[BT / 2],
                                       uint32_t (&fh)[8][4], uint32_t (&fl)[8][4],
                                       const uint8_t* f, const uint8_t* bh, const uint8_t* bl,
                                       int frow, F&& during) {
  const int lt = threadIdx.x % 128;
#pragma unroll
  for (int pc = 0; pc < (D + 63) / 64; ++pc) {
    // register e of slice kk: row frow + 8 (e & 1), column 8 kk + lt % 4 + 4 (e >> 1)
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int kk = 8 * pc + b;
      if (kk < D / 8) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * kk + lt % 4 + 4 * (e >> 1);
          split(lds_f(f + col / (SW / 4) * 64 * SW +
                      swz_f32<SW>(frow + 8 * (e & 1), col % (SW / 4))),
                fh[b][e], fl[b][e]);
        }
      }
    }
    fence_regs(sp);
    fence_regs(fh);
    fence_regs(fl);
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int kk = 8 * pc + b;
      if (kk < D / 8) {
        const uint64_t dbh = kmajor_desc<SW>(bh, BT * SW, kk);
        wgmma_tf32<BT>(sp, fl[b], dbh, b > 0);
        wgmma_tf32<BT>(sp, fh[b], kmajor_desc<SW>(bl, BT * SW, kk), 1);
        wgmma_tf32<BT>(sp, fh[b], dbh, 1);
      }
    }
    wgmma_commit();
    if (pc == 0) during();
    fence_regs(sp);
    fence_regs(fh);
    fence_regs(fl);
    wgmma_wait<0>();
    fence_regs(sp);
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) sc[i] = pc == 0 ? sp[i] : __fadd_rn(sc[i], sp[i]);
  }
}

// acc (64 x N) += the tile product of the A fragments (ah, al) and N rows
// of a transposed B from row c0 on: three products a k8 slice into a fresh
// register set, added at once with rounded adds
template <int N, int BT, int C0, int NA>
__device__ __forceinline__ void tile_slice(float (&acc)[NA / 2], uint32_t (&ah)[BT / 8][4],
                                           uint32_t (&al)[BT / 8][4], const uint8_t* th,
                                           const uint8_t* tl) {
  float part[N / 2];
  fence_regs(part);
  fence_regs(ah);
  fence_regs(al);
  wgmma_fence();
  mma3_rs<N, BT>(part, ah, al, th + C0 * 4 * BT, tl + C0 * 4 * BT);
  wgmma_commit();
  fence_regs(part);
  fence_regs(ah);
  fence_regs(al);
  wgmma_wait<0>();
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[C0 / 2 + i] = __fadd_rn(acc[C0 / 2 + i], part[i]);
}

// Stores columns [c0, c0 + N) of a 64 x N float32 accumulator to rows row0 ..
// of a row-major (rows, ld) tensor, skipping rows >= nrows
template <int N>
__device__ __forceinline__ void store_cols(float* __restrict__ out, const float (&d)[N / 2],
                                           int row0, int nrows, int ld, int c0) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int r = acc_row(i);
    if (row0 + r < nrows)
      *reinterpret_cast<float2*>(out + size_t(row0 + r) * ld + c0 + acc_col(i)) =
          make_float2(d[i], d[i + 1]);
  }
}

// One block per (64 keys, b * h): dK and dV of those keys. Consumer
// warpgroup 1: S^T, P^T (handed over) and dV; warpgroup 2: dP^T, dS^T and
// dK.
template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dkdv_wide_kernel(__grid_constant__ const CUtensorMap qmap,
                               __grid_constant__ const CUtensorMap kmap,
                               __grid_constant__ const CUtensorMap vmap,
                               __grid_constant__ const CUtensorMap domap,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               float* __restrict__ dk, float* __restrict__ dv, int Tq, int Tkv,
                               int causal, float scale) {
  using C = WideCfg<D, true>;
  constexpr int BN = C::BN, BT = C::BT, SW = C::SW, FIX = C::FIX, TILE = C::TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint8_t* kf = smem;  // raw K and V, NCH chunks of BN rows each
  uint8_t* vf = kf + FIX;
  // the split set of the current query tile: Q and dO hi / lo, then their
  // transposed hi / lo
  uint8_t* qh = vf + FIX;
  uint8_t* ql = qh + TILE;
  uint8_t* doh = ql + TILE;
  uint8_t* dol = doh + TILE;
  uint8_t* qth = dol + TILE;
  uint8_t* qtl = qth + TILE;
  uint8_t* doth = qtl + TILE;
  uint8_t* dotl = doth + TILE;
  uint8_t* raw = dotl + TILE;  // per stage: raw Q, then raw dO
  // P^T by register (64 x BT floats), over Q's lo half once S^T is made
  float* xp = reinterpret_cast<float*>(ql);
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
        for (int c = 0; c < C::NCH; ++c) {
          tma_load_3d(kf + c * BN * SW, &kmap, kvbar, c * SW / 4, k0, bh);
          tma_load_3d(vf + c * BN * SW, &vmap, kvbar, c * SW / 4, k0, bh);
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
          for (int c = 0; c < C::NCH; ++c) {
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

  // consumer warpgroups: 0 makes S^T, P^T and dV; 1 dP^T, dS^T and dK.
  // Each splits one raw tile whole: 0 Q (its S^T's B, and Q^T, the B of
  // 1's tile product), 1 dO (its dP^T's B, and dO^T, 0's).
  setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128 - 1;
  const int lt = threadIdx.x % 128;
  const float sl2 = scale * kLog2e;
  const uint8_t* fix = wg == 0 ? kf : vf;  // A of S^T = K Q^T, or of dP^T = V dO^T
  uint8_t* nh = wg == 0 ? qh : doh;        // their B: Q's or dO's halves
  uint8_t* nl = wg == 0 ? ql : dol;
  uint8_t* sth = wg == 0 ? qth : doth;     // the transposed halves this warpgroup writes
  uint8_t* stl = wg == 0 ? qtl : dotl;
  const uint8_t* th = wg == 0 ? doth : qth;  // B of its tile product: dO^T or Q^T
  const uint8_t* tl = wg == 0 ? dotl : qtl;
  const int frow = 16 * (lt / 32) + (lt % 32) / 4;
  float acc[D / 2];                       // dV (warpgroup 0) or dK (1)
  float sc[BT / 2], sp[BT / 2];           // S^T or dP^T of one query tile, then P^T or dS^T
  uint32_t fh[8][4], fl[8][4];            // K's or V's A fragments of 64 columns
  uint32_t ah[BT / 8][4], al[BT / 8][4];  // P^T or dS^T: hi and lo A fragments
  float st[BT / 4];                       // this thread's queries' lse2 (0) or delta (1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  if (ntiles > 0) mbar_wait(kvbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % C::kStages;
    const int q0 = (qt0 + j) * BT;
    mbar_wait(&full[s], (j / C::kStages) & 1);
    // both warpgroups' products of the previous tile are done (they read
    // the transposed halves, and the P^T handed over lies over Q's lo half)
    bar_sync(3, 256);
    split_tile<D, SW, BT, 128>(raw + s * 2 * TILE + wg * TILE, nh, nl, sth, stl, lt);
    if (wg == 0 && lt < 2 * BT) sstat[lt] = rstat[s * 2 * BT + lt];
    fence_proxy_async();
    if (lt % 32 == 0) mbar_arrive(&empty[s]);  // this warp has read the raw stage
    bar_sync(1 + wg, 128);
    if (wg == 1) bar_arrive(6, 256);  // dO^T is written, for warpgroup 0's product

    // S^T = K Q_j^T (warpgroup 0) or dP^T = V dO_j^T (1)
    s_wide<D, BT, SW>(sc, sp, fh, fl, fix, nh, nl, frow, [] {});
    // key k0 + row, query q0 + col (column acc_col(i) = 8 (i / 4) + 2 (lt %
    // 4) + i % 2: st[2 (i / 4) + i % 2])
    if (wg == 0) {  // P^T, handed to warpgroup 1
#pragma unroll
      for (int c = 0; c < BT / 4; ++c) st[c] = sstat[8 * (c >> 1) + 2 * (lt % 4) + (c & 1)];
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) {
        const int qc = acc_col(i);
        float p = exp2f(fmaf(sc[i], sl2, -st[2 * (i >> 2) + (i & 1)]));
        p = causal && k0 + acc_row(i) > q0 + qc ? 0.f : p;  // a select, no branch
        sc[i] = p;
        xp[i * 128 + lt] = p;
      }
      bar_arrive(4, 256);   // P^T and Q^T are written
      bar_sync(6, 256);
    } else {  // dS^T from the P^T handed over
      bar_sync(4, 256);
#pragma unroll
      for (int c = 0; c < BT / 4; ++c)
        st[c] = sstat[BT + 8 * (c >> 1) + 2 * (lt % 4) + (c & 1)];
#pragma unroll
      for (int i = 0; i < BT / 2; ++i)
        sc[i] = xp[i * 128 + lt] * (sc[i] - st[2 * (i >> 2) + (i & 1)]) * scale;
    }
    // dV += P^T dO_j (over dO^T) or dK += dS^T Q_j (over Q^T): all D
    // columns in one register set up to D = 128, else 64 at a time
    frags<BT>(ah, al, sc);
    if constexpr (D <= 128) {
      tile_slice<D, BT, 0, D>(acc, ah, al, th, tl);
    } else {
      for_each_slice(std::make_integer_sequence<int, D / 64>{}, [&](auto cols) {
        tile_slice<64, BT, decltype(cols)::c0, D>(acc, ah, al, th, tl);
      });
      if constexpr (D % 64 != 0) tile_slice<D % 64, BT, D / 64 * 64, D>(acc, ah, al, th, tl);
    }
  }
  store_acc<float, D>((wg == 0 ? dv : dk) + size_t(bh) * Tkv * D, acc, k0, Tkv, 1.f, 1.f);
}

// One block per (64 queries, b * h): dQ of those rows. Consumer warpgroup 1
// makes S and P (handed over), warpgroup 2 dP and dS (handed back); each
// sums half of dQ's columns.
template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_wide_kernel(__grid_constant__ const CUtensorMap qmap,
                             __grid_constant__ const CUtensorMap kmap,
                             __grid_constant__ const CUtensorMap vmap,
                             __grid_constant__ const CUtensorMap domap,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dq, int Tq, int Tkv, int causal, float scale) {
  using C = WideCfg<D, false>;
  constexpr int BN = C::BN, BT = C::BT, SW = C::SW, FIX = C::FIX, TILE = C::TILE;
  constexpr int SWT = C::SWT, DH = D / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint8_t* qf = smem;  // raw Q and dO, NCH chunks of BN rows each
  uint8_t* dof = qf + FIX;
  // the split set of the current key tile: K and V hi / lo, K^T hi / lo
  uint8_t* kh = dof + FIX;
  uint8_t* kl = kh + TILE;
  uint8_t* vh = kl + TILE;
  uint8_t* vl = vh + TILE;
  uint8_t* kth = vl + TILE;
  uint8_t* ktl = kth + TILE;
  uint8_t* raw = ktl + TILE;  // per stage: raw K, then raw V
  // P, then dS, by register (64 x BT floats), over K's lo half once S is made
  float* xp = reinterpret_cast<float*>(kl);
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
      for (int c = 0; c < C::NCH; ++c) {
        tma_load_3d(qf + c * BN * SW, &qmap, qbar, c * SW / 4, q0, bh);
        tma_load_3d(dof + c * BN * SW, &domap, qbar, c * SW / 4, q0, bh);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % C::kStages;
        mbar_wait(&empty[s], ((j / C::kStages) & 1) ^ 1);
        uint8_t* t = raw + s * 2 * TILE;
        mbar_arrive_expect_tx(&full[s], 2 * TILE);
        for (int c = 0; c < C::NCH; ++c) {
          tma_load_3d(t + c * BT * SW, &kmap, &full[s], c * SW / 4, j * BT, bh);
          tma_load_3d(t + TILE + c * BT * SW, &vmap, &full[s], c * SW / 4, j * BT, bh);
        }
      }
    }
    return;
  }

  // consumer warpgroups: 0 makes S and P, 1 dP and dS; each sums dQ's
  // columns [wg D / 2, (wg + 1) D / 2). Each splits its own operands of the
  // raw tiles: the natural halves of its S's (dP's) B, K (V), and rows [wg
  // D / 2, ...) of K^T, these while its first S (dP) products run.
  setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128 - 1;
  const int lt = threadIdx.x % 128;
  const float sl2 = scale * kLog2e;
  const uint8_t* fix = wg == 0 ? qf : dof;  // A of S = Q K^T, or of dP = dO V^T
  uint8_t* nh = wg == 0 ? kh : vh;          // their B: K's or V's halves
  uint8_t* nl = wg == 0 ? kl : vl;
  const int rn = wg == 0 ? 0 : TILE;        // the raw tile split naturally (K or V)
  const int frow = 16 * (lt / 32) + (lt % 32) / 4;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + acc_row(2 * r);
    const float L = q < Tq ? lse[size_t(bh) * Tq + q] : -INFINITY;
    lse2[r] = L == -INFINITY ? INFINITY : L * kLog2e;
    dl[r] = q < Tq ? delta[size_t(bh) * Tq + q] : 0.f;
  }
  float acc[DH / 2];                      // dQ's half
  float sc[BT / 2], sp[BT / 2];           // S or dP of one key tile, then P or dS
  uint32_t fh[8][4], fl[8][4];            // Q's or dO's A fragments of 64 columns
  uint32_t ah[BT / 8][4], al[BT / 8][4];  // dS: hi and lo A fragments
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

  if (ntiles > 0) mbar_wait(qbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % C::kStages;
    const uint8_t* rs = raw + s * 2 * TILE;
    mbar_wait(&full[s], (j / C::kStages) & 1);
    split_tile<D, SW, BT, 128>(rs + rn, nh, nl, nullptr, nullptr, lt);
    fence_proxy_async();
    bar_sync(1 + wg, 128);

    // S = Q K_j^T (warpgroup 0) or dP = dO V_j^T (1); this warpgroup's half
    // of K_j^T meanwhile
    s_wide<D, BT, SW>(sc, sp, fh, fl, fix, nh, nl, frow, [&] {
      if (wg == 0)
        split_tile<D, SW, BT, 128, 0, DH>(rs, nullptr, nullptr, kth, ktl, lt);
      else
        split_tile<D, SW, BT, 128, DH, DH>(rs, nullptr, nullptr, kth, ktl, lt);
      fence_proxy_async();
    });
    if (lt % 32 == 0) mbar_arrive(&empty[s]);  // this warp has read the raw stage
    bar_sync(1 + wg, 128);                       // its half of K^T is written
    if (wg == 0) {
      // P (keys past Tkv or above the diagonal give 0: selects, no
      // branch), handed over; then dS, handed back
      const int lim0 = min(Tkv - 1, causal ? q0 + acc_row(0) : Tkv) - j * BT;
      const int lim1 = min(Tkv - 1, causal ? q0 + acc_row(2) : Tkv) - j * BT;
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) {
        const int r = (i >> 1) & 1;
        const float p = exp2f(fmaf(sc[i], sl2, -lse2[r]));
        xp[i * 128 + lt] = acc_col(i) > (r ? lim1 : lim0) ? 0.f : p;
      }
      bar_arrive(4, 256);
      bar_sync(5, 256);
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) sc[i] = xp[i * 128 + lt];
    } else {
      bar_sync(4, 256);
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) {
        sc[i] = xp[i * 128 + lt] * (sc[i] - dl[(i >> 1) & 1]) * scale;
        xp[i * 128 + lt] = sc[i];
      }
      bar_arrive(5, 256);
    }
    // dQ[:, half] += dS_j K_j[:, half], over rows [wg D / 2, ...) of K^T
    frags<BT>(ah, al, sc);
    const int c0 = wg * DH;
    tile_slice<DH, BT, 0, DH>(acc, ah, al, kth + c0 * SWT, ktl + c0 * SWT);
  }
  store_cols<DH>(dq + size_t(bh) * Tq * D, acc, q0, Tq, D, wg * DH);
}

// -- host ---------------------------------------------------------------------------

// The narrow pair (D <= 64): t, 32-row streamed tiles; f, 128-row fixed blocks
template <int D>
cudaError_t launch_narrow(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, float* dq, float* dk, float* dv,
                          int BH, int Tq, int Tkv, int causal, float scale, cudaStream_t stream) {
  using C = BwdCfg<D>;
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

// The wide pair (D from 80 to 192): each kernel's streamed tiles in boxes of
// its BT rows, its fixed blocks in boxes of 64 rows
template <int D>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, float* dq, float* dk, float* dv,
                        int BH, int Tq, int Tkv, int causal, float scale, cudaStream_t stream) {
  using CK = WideCfg<D, true>;
  using CQ = WideCfg<D, false>;
  CUtensorMap qt, kf, vf, dot, qf, kt, vt, dof;
  const int box = CK::SW / 4;
  if (!make_map3(&qt, q, D, Tq, BH, D, size_t(Tq) * D, box, CK::BT, CK::SW) ||
      !make_map3(&dot, dout, D, Tq, BH, D, size_t(Tq) * D, box, CK::BT, CK::SW) ||
      !make_map3(&kf, k, D, Tkv, BH, D, size_t(Tkv) * D, box, CK::BN, CK::SW) ||
      !make_map3(&vf, v, D, Tkv, BH, D, size_t(Tkv) * D, box, CK::BN, CK::SW) ||
      !make_map3(&qf, q, D, Tq, BH, D, size_t(Tq) * D, box, CQ::BN, CQ::SW) ||
      !make_map3(&dof, dout, D, Tq, BH, D, size_t(Tq) * D, box, CQ::BN, CQ::SW) ||
      !make_map3(&kt, k, D, Tkv, BH, D, size_t(Tkv) * D, box, CQ::BT, CQ::SW) ||
      !make_map3(&vt, v, D, Tkv, BH, D, size_t(Tkv) * D, box, CQ::BT, CQ::SW))
    return cudaErrorInvalidValue;
  auto kv_kern = flash_bwd_dkdv_wide_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, CK::SMEM);
  if (err != cudaSuccess) return err;
  kv_kern<<<BH * ((Tkv + CK::BN - 1) / CK::BN), 384, CK::SMEM, stream>>>(
      qt, kf, vf, dot, lse, delta, dk, dv, Tq, Tkv, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto q_kern = flash_bwd_dq_wide_kernel<D>;
  err = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, CQ::SMEM);
  if (err != cudaSuccess) return err;
  q_kern<<<BH * ((Tq + CQ::BN - 1) / CQ::BN), 384, CQ::SMEM, stream>>>(
      qf, kt, vt, dof, lse, delta, dq, Tq, Tkv, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, float* dq, float* dk, float* dv,
                       int B, int H, int Tq, int Tkv, int causal, float scale,
                       cudaStream_t stream) {
  const int BH = B * H;
  // no keys: dQ is 0; no queries: dK and dV are 0 (a tensor map needs rows)
  if (Tkv == 0) return cudaMemsetAsync(dq, 0, size_t(BH) * Tq * D * 4, stream);
  if (Tq == 0) {
    cudaError_t err = cudaMemsetAsync(dk, 0, size_t(BH) * Tkv * D * 4, stream);
    if (err != cudaSuccess) return err;
    return cudaMemsetAsync(dv, 0, size_t(BH) * Tkv * D * 4, stream);
  }
  if constexpr (D <= 64)
    return launch_narrow<D>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Tq, Tkv, causal, scale,
                            stream);
  else
    return launch_wide<D>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Tq, Tkv, causal, scale,
                          stream);
}

}  // namespace tf32
}  // namespace sm90
}  // namespace bigdl_fg

// float32 q, k, v, dout (contiguous (B, H, T, D)), D a multiple of 16 up to
// 192, 16-byte aligned; lse and delta float32 (B, H, Tq); dq, dk, dv
// float32. Launches the dK/dV kernel, then the dQ kernel, on `stream`.
// Returns a cudaError_t (0 = both launched).
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
    case 80: return bigdl_fg::sm90::tf32::launch_bwd<80>(q, k, v, dout, l, dl, gq, gk, gv, B, H, Tq, Tkv, causal, scale, s);
    case 96: return bigdl_fg::sm90::tf32::launch_bwd<96>(q, k, v, dout, l, dl, gq, gk, gv, B, H, Tq, Tkv, causal, scale, s);
    case 112: return bigdl_fg::sm90::tf32::launch_bwd<112>(q, k, v, dout, l, dl, gq, gk, gv, B, H, Tq, Tkv, causal, scale, s);
    case 128: return bigdl_fg::sm90::tf32::launch_bwd<128>(q, k, v, dout, l, dl, gq, gk, gv, B, H, Tq, Tkv, causal, scale, s);
    case 144: return bigdl_fg::sm90::tf32::launch_bwd<144>(q, k, v, dout, l, dl, gq, gk, gv, B, H, Tq, Tkv, causal, scale, s);
    case 160: return bigdl_fg::sm90::tf32::launch_bwd<160>(q, k, v, dout, l, dl, gq, gk, gv, B, H, Tq, Tkv, causal, scale, s);
    case 176: return bigdl_fg::sm90::tf32::launch_bwd<176>(q, k, v, dout, l, dl, gq, gk, gv, B, H, Tq, Tkv, causal, scale, s);
    case 192: return bigdl_fg::sm90::tf32::launch_bwd<192>(q, k, v, dout, l, dl, gq, gk, gv, B, H, Tq, Tkv, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
