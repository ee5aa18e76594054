// Paged attention (K2) for Hopper, float32 and bfloat16 pages: split-K
// (flash-decoding) over the page walk.
//
// Replaces the Pallas kernel bigdl_tpu/kernels/paged_attention.py
// `paged_decode_attention` (body `_kernel`) for every page dtype and every S:
// attention straight out of the paged KV pool through per-row block tables
// and positions, with no gathered (B, kvH, T, D) view. q arrives as (B, kvH,
// G * S, D), the kv-major fold of (B, nH, S, D) with nH = kvH * G; row g * S +
// s of kv head h is query head h * G + g at position positions[b] + s and
// sees keys <= positions[b] + s. Pages are (num_blocks, kvH, block_size, D);
// tables (B, max_blocks) int32 with block 0 the null block; positions (B,)
// int32. Only the logical blocks 0 .. pos + S - 1 of a row are read (no page
// past its end), the G query heads of a kv head share one pass over its
// pages, the softmax is float32 and o comes out in the page dtype.
// paged_attention.cu, the kernel this one succeeds, keeps its entry point.
//
// What bounds it on an H100: decode (S = 1) does 4 D operations per K / V row
// of 2 D sizeof(page) bytes, about one operation per byte in float32, so it
// is bound by the bytes of the pages each row needs: about 10 MB, 2.9 us at
// HBM speed, at the smoke's decode case (B8, 16 heads, D 64, positions
// 32-320).
// What the design does:
// - Split-K: the grid is (splits x row tiles, kvH, B); split i owns the
//   logical keys [i span, (i + 1) span) of its row, so a decode step
//   launches B kvH splits blocks instead of B kvH, and a long context walks
//   its pages in parallel. The wrapper sizes splits and span from the
//   table's width and the card's SM count (no device value is read). A split
//   that starts past its row's pos + S - 1 writes an empty partial (m =
//   -inf, l = 0, acc = 0) and exits.
// - Loads: each of a block's 4 warps walks its own tiles of KT keys (the
//   split's tiles w, w + 4, ...) through a private two-stage ring, each key
//   row of K and V copied as 16-byte cp.async units, so the next tile is in
//   flight while one is used; a warp reads the table entry of each page of
//   a tile once (one lane a page) and hands it to the copying lanes by
//   shuffle. bf16 pages are widened in registers. Two stages keep the ring
//   at 64 KB, so three blocks share an SM (measured faster on an H100 than
//   three or four stages and two blocks).
// - Arithmetic on the CUDA cores: 16 lanes a key, each lane D / 16 columns
//   of q (in registers) and of the key; a score is a 4-step shuffle sum. Each
//   half warp keeps its own float32 online softmax (m, l, acc) for the
//   block's query rows (8 up to D = 64, 4 up to 128, 2 past it: a lane's
//   columns of q and acc stay under 64 registers) and updates it once a
//   tile. The 8 half-warp states are merged through shared memory in a
//   fixed order at the end.
// - Combine: with more than one split the block writes its (acc, m, l)
//   partial, (B, kvH, splits, G S, D + 2) float32, and paged_combine_kernel
//   merges a row's splits in split order (deterministic) and writes o; with
//   one split the block writes o itself and no combine is launched.
//
// Grid: (splits * ceil(G S / R), kvH, B), 128 threads; the combine kernel
// one thread per output element.
#include "attn_tile.cuh"

#include <stdint.h>

namespace bigdl_pa {

using bigdl::from_f;
using bigdl::to_f;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct PagedCfg {
  static constexpr int ROW_BYTES = D * int(sizeof(T));
  static constexpr int E = D / 16;  // columns a lane owns
  // keys a tile: a K tile of at most 4 KB, 16 keys at most
  static constexpr int KT = ROW_BYTES <= 256 ? 16 : ROW_BYTES <= 512 ? 8 : 4;
  static constexpr int KH = KT / 2;             // keys a half warp takes of a tile
  static constexpr int UNITS = KT * ROW_BYTES / 16;  // 16-byte units of a K tile
  static constexpr int TILE = KT * ROW_BYTES;
  static constexpr int R = 32 / (E <= 4 ? 4 : E <= 8 ? 8 : 16);  // query rows a block
  static constexpr int RING = kWarps * kStages * 2 * TILE;
  static constexpr int MERGE = 2 * kWarps * R * (D + 2) * 4;
  static constexpr int SMEM = RING > MERGE ? RING : MERGE;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zeros when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// E consecutive elements at p (aligned to their size x E) as floats
template <typename T, int E>
__device__ __forceinline__ void load_row(float (&out)[E], const T* p) {
  if constexpr (sizeof(T) == 4 && E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = f.x;
      out[4 * i + 1] = f.y;
      out[4 * i + 2] = f.z;
      out[4 * i + 3] = f.w;
    }
  } else if constexpr (sizeof(T) == 2 && E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const uint2 u = reinterpret_cast<const uint2*>(p)[i];
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      out[4 * i] = a.x;
      out[4 * i + 1] = a.y;
      out[4 * i + 2] = b.x;
      out[4 * i + 3] = b.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = to_f<T>(p[e]);
  }
}

// Three blocks an SM, as the 64 KB ring allows; stating it also keeps ptxas
// from trading register spills for a further resident block.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 3)
    paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages, const int* __restrict__ tables,
                       const int* __restrict__ positions, T* __restrict__ o,
                       float* __restrict__ part, int kvH, int rows, int S, int bs,
                       int max_blocks, int splits, int span, float scale) {
  using C = PagedCfg<T, D>;
  constexpr int R = C::R, E = C::E, KT = C::KT, KH = C::KH;
  extern __shared__ __align__(16) uint8_t smem[];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int split = blockIdx.x % splits;
  const int r0 = blockIdx.x / splits * R;
  const int nrows = min(R, rows - r0);
  const int pos = positions[b];
  const int n_valid = min(pos + S, max_blocks * bs);  // logical keys 0 .. n_valid - 1
  const int kbeg = split * span;
  const int kend = min(kbeg + span, n_valid);
  const size_t head = size_t(b) * kvH + h;
  const int* tbl = tables + size_t(b) * max_blocks;

  if (kbeg >= kend) {  // no key of this row in the split
    for (int i = threadIdx.x; i < nrows * (D + 2); i += kThreads) {
      const int r = i / (D + 2), c = i % (D + 2);
      if (part == nullptr) {
        if (c < D) o[(head * rows + r0 + r) * D + c] = from_f<T>(0.f);
      } else {
        part[((head * splits + split) * rows + r0 + r) * (D + 2) + c] = c == D ? -INFINITY : 0.f;
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int half = lane / 16;
  const int l16 = lane % 16;
  const float sl2 = scale * kLog2e;

  // this warp's tiles of the split: w, w + 4, ...
  const int ntiles = (kend - kbeg + KT - 1) / KT;
  const int mine = ntiles > warp ? (ntiles - 1 - warp) / kWarps + 1 : 0;
  uint8_t* ring = smem + warp * kStages * 2 * C::TILE;

  // tile i of this warp into its ring slot: K and V rows of keys t0 .. t0 +
  // KT - 1 (zeros past kend); lane j reads the page of the tile's j-th
  // logical block (one table read a page) and hands it to the copying lanes
  auto issue = [&](int i) {
    const int t0 = kbeg + (warp + kWarps * i) * KT;
    const int blk0 = t0 / bs;
    const int nblk = (min(t0 + KT, kend) - 1) / bs - blk0 + 1;
    const int page = lane < nblk ? tbl[blk0 + lane] : 0;
    uint8_t* ks = ring + (i % kStages) * 2 * C::TILE;
    uint8_t* vs = ks + C::TILE;
#pragma unroll
    for (int j = 0; j < (C::UNITS + 31) / 32; ++j) {
      const int u = lane + 32 * j;
      const int key = u / (C::ROW_BYTES / 16);
      const int c = u % (C::ROW_BYTES / 16);
      const int t = t0 + key;
      const bool ok = u < C::UNITS && t < kend;
      const int pg = __shfl_sync(0xffffffffu, page, ok ? t / bs - blk0 : 0);
      const size_t src = ((size_t(pg) * kvH + h) * bs + (ok ? t % bs : 0)) * C::ROW_BYTES + 16 * c;
      if (u < C::UNITS) {
        cp_async16(ks + 16 * u, reinterpret_cast<const uint8_t*>(k_pages) + (ok ? src : 0), ok);
        cp_async16(vs + 16 * u, reinterpret_cast<const uint8_t*>(v_pages) + (ok ? src : 0), ok);
      }
    }
  };

  // the first tiles' copies go out first, then q is read while they fly
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < mine) issue(s);
    cp_async_commit();
  }
  float qv[R][E], acc[R][E], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nrows) {
      load_row<T, E>(qv[r], q + (head * rows + r0 + r) * D + l16 * E);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qv[r][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  for (int i = 0; i < mine; ++i) {
    if (i + kStages - 1 < mine) issue(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const T* ks = reinterpret_cast<const T*>(ring + (i % kStages) * 2 * C::TILE);
    const T* vs = ks + KT * D;
    const int tk = kbeg + (warp + kWarps * i) * KT + half * KH;  // this half warp's first key
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nrows) {  // uniform over the block
        const int lim = min(pos + (r0 + r) % S, kend - 1);  // the row's last key
        float sv[KH];
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < KH; ++j) {
          float kf[E];
          load_row<T, E>(kf, ks + (half * KH + j) * D + l16 * E);
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qv[r][e], kf[e], dot);
#pragma unroll
          for (int off = 8; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
          sv[j] = tk + j <= lim ? dot * sl2 : -INFINITY;
          mx = fmaxf(mx, sv[j]);
        }
        const float mnew = fmaxf(m[r], mx);
        const float base = mnew == -INFINITY ? 0.f : mnew;
        const float alpha = exp2f(m[r] - base);  // m = -inf gives 0
        float psum = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
#pragma unroll
        for (int j = 0; j < KH; ++j) {
          const float p = exp2f(sv[j] - base);  // masked keys give exactly 0
          psum += p;
          float vf[E];
          load_row<T, E>(vf, vs + (half * KH + j) * D + l16 * E);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
        }
        l[r] = l[r] * alpha + psum;
        m[r] = mnew;
      }
    }
    __syncwarp();  // every lane is done with the slot before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: the merge area overlaps it

  // each half warp's state, then the block's merge in half-warp order
  float* mg = reinterpret_cast<float*>(smem);
  const int hw = 2 * warp + half;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nrows) {
      float* st = mg + (hw * R + r) * (D + 2);
#pragma unroll
      for (int e = 0; e < E; ++e) st[l16 * E + e] = acc[r][e];
      if (l16 == 0) {
        st[D] = m[r];
        st[D + 1] = l[r];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int x = 0; x < 2 * kWarps; ++x) M = fmaxf(M, mg[(x * R + r) * (D + 2) + D]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int x = 0; x < 2 * kWarps; ++x) {
      const float* st = mg + (x * R + r) * (D + 2);
      const float w = st[D] == -INFINITY ? 0.f : exp2f(st[D] - M);
      L = fmaf(w, st[D + 1], L);
      A = fmaf(w, st[d], A);
    }
    if (part == nullptr) {
      o[(head * rows + r0 + r) * D + d] = from_f<T>(L > 0.f ? A / L : 0.f);
    } else {
      float* pr = part + ((head * splits + split) * rows + r0 + r) * (D + 2);
      pr[d] = A;
      if (d == 0) {
        pr[D] = M;
        pr[D + 1] = L;
      }
    }
  }
}

// o of one (b, kv head, row, column) a thread: the row's partials merged in
// split order, one pass (acc and l rescaled as the running maximum moves)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_combine_kernel(const float* __restrict__ part, T* __restrict__ o, int nrow, int rows,
                         int splits, int D) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= nrow * D) return;
  const int gr = i / D;  // head * rows + row
  const int d = i % D;
  const size_t stride = size_t(rows) * (D + 2);  // from one split to the next
  const float* p = part + (size_t(gr / rows) * splits * rows + gr % rows) * (D + 2);
  float M = -INFINITY, L = 0.f, A = 0.f;
#pragma unroll 4
  for (int x = 0; x < splits; ++x, p += stride) {
    const float m = p[D];
    const float mn = fmaxf(M, m);
    const float base = mn == -INFINITY ? 0.f : mn;
    const float a = exp2f(M - base);  // M = -inf gives 0
    const float w = exp2f(m - base);  // an empty split (m = -inf) weighs 0
    L = fmaf(L, a, w * p[D + 1]);
    A = fmaf(A, a, w * p[d]);
    M = mn;
  }
  o[i] = from_f<T>(L > 0.f ? A / L : 0.f);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* tables,
                   const int* positions, void* o, float* part, int B, int kvH, int rows, int S,
                   int bs, int max_blocks, int splits, int span, float scale,
                   cudaStream_t stream) {
  using C = PagedCfg<T, D>;
  auto kern = paged_split_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(splits * ((rows + C::R - 1) / C::R), kvH, B);
  kern<<<grid, kThreads, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), tables,
      positions, static_cast<T*>(o), splits > 1 ? part : nullptr, kvH, rows, S, bs, max_blocks,
      splits, span, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int nrow = B * kvH * rows;
  paged_combine_kernel<T><<<(nrow * D + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part, static_cast<T*>(o), nrow, rows, splits, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* kp, const void* vp, const int* tables,
                       const int* positions, void* o, float* part, int B, int kvH, int rows,
                       int S, int bs, int max_blocks, int splits, int span, float scale,
                       cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, kp, vp, tables, positions, o, part, B, kvH, rows, S, bs, max_blocks, splits, span, scale, s);
    case 32: return launch<T, 32>(q, kp, vp, tables, positions, o, part, B, kvH, rows, S, bs, max_blocks, splits, span, scale, s);
    case 48: return launch<T, 48>(q, kp, vp, tables, positions, o, part, B, kvH, rows, S, bs, max_blocks, splits, span, scale, s);
    case 64: return launch<T, 64>(q, kp, vp, tables, positions, o, part, B, kvH, rows, S, bs, max_blocks, splits, span, scale, s);
    case 80: return launch<T, 80>(q, kp, vp, tables, positions, o, part, B, kvH, rows, S, bs, max_blocks, splits, span, scale, s);
    case 96: return launch<T, 96>(q, kp, vp, tables, positions, o, part, B, kvH, rows, S, bs, max_blocks, splits, span, scale, s);
    case 112: return launch<T, 112>(q, kp, vp, tables, positions, o, part, B, kvH, rows, S, bs, max_blocks, splits, span, scale, s);
    case 128: return launch<T, 128>(q, kp, vp, tables, positions, o, part, B, kvH, rows, S, bs, max_blocks, splits, span, scale, s);
    case 144: return launch<T, 144>(q, kp, vp, tables, positions, o, part, B, kvH, rows, S, bs, max_blocks, splits, span, scale, s);
    case 160: return launch<T, 160>(q, kp, vp, tables, positions, o, part, B, kvH, rows, S, bs, max_blocks, splits, span, scale, s);
    case 176: return launch<T, 176>(q, kp, vp, tables, positions, o, part, B, kvH, rows, S, bs, max_blocks, splits, span, scale, s);
    case 192: return launch<T, 192>(q, kp, vp, tables, positions, o, part, B, kvH, rows, S, bs, max_blocks, splits, span, scale, s);
    case 208: return launch<T, 208>(q, kp, vp, tables, positions, o, part, B, kvH, rows, S, bs, max_blocks, splits, span, scale, s);
    case 224: return launch<T, 224>(q, kp, vp, tables, positions, o, part, B, kvH, rows, S, bs, max_blocks, splits, span, scale, s);
    case 240: return launch<T, 240>(q, kp, vp, tables, positions, o, part, B, kvH, rows, S, bs, max_blocks, splits, span, scale, s);
    case 256: return launch<T, 256>(q, kp, vp, tables, positions, o, part, B, kvH, rows, S, bs, max_blocks, splits, span, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bigdl_pa

// The arguments of paged_attention.cu's entry point, then part (splits > 1:
// B x kvH x splits x rows x (D + 2) float32 of scratch for the partials;
// else unused), splits and span (logical keys a split; splits x span covers
// the table). dtype: 0 = float32, 1 = bfloat16 (q, pages and output share
// it); rows = G * S; D a multiple of 16 up to 256; pages 16-byte aligned.
// Returns a cudaError_t (0 = launched).
extern "C" int bigdl_paged_attention_sm90(const void* q, const void* k_pages,
                                          const void* v_pages, const void* tables,
                                          const void* positions, void* o, void* part, int dtype,
                                          int B, int kvH, int rows, int S, int D, int bs,
                                          int max_blocks, int splits, int span, float scale,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(tables);
  const int* pos = static_cast<const int*>(positions);
  float* p = static_cast<float*>(part);
  if (splits < 1 || span < 1 || (splits > 1 && p == nullptr)) return cudaErrorInvalidValue;
  if (dtype == 0)
    return bigdl_pa::dispatch_d<float>(D, q, k_pages, v_pages, tbl, pos, o, p, B, kvH, rows, S,
                                       bs, max_blocks, splits, span, scale, s);
  if (dtype == 1)
    return bigdl_pa::dispatch_d<__nv_bfloat16>(D, q, k_pages, v_pages, tbl, pos, o, p, B, kvH,
                                               rows, S, bs, max_blocks, splits, span, scale, s);
  return cudaErrorInvalidValue;
}
