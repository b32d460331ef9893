// Paged attention on the tensor cores, split over the keys (flash-decoding):
// one skeleton for the decode step (W = 1) and the speculative verify (W
// causal queries a slot). The kernel templates and the plan; the bf16 and
// f16 instances are compiled from paged_split_bf16.cu and paged_split_f16.cu,
// and both entry points (ltt_paged_attention in paged_attention.cu,
// ltt_paged_window_attention in paged_window_attention.cu) call them on
// their route "split".
//
// Replaces, with the classic kernels beside it,
// laser_tpu/ops/paged_attention.py:121 build_paged_attention and :318
// build_paged_window_attention (float pools, and int8 pools with per-token
// scales; no window).
//
// Layouts: q (S, W, Hq, hd) (the decode q (S, Hq, hd) is W = 1); pools
// (P, Hkv, ps, hd) in q's dtype or int8 with k_scale, v_scale (P, Hkv, ps)
// f32; tables (S, max_pages) int32; lengths (S,) int32; out as q. Query row
// w of slot s sits at lengths[s] - W + w and attends causally to the keys
// its table holds (the raw length places the rows; the table's max_pages *
// ps keys cap the keys). Consecutive q heads share a kv head: the G = W *
// group rows of a (slot, kv head) are row = w * group + g, read in place
// from q's layout.
//
// What bounds it on the H100: every K/V row of a slot is read once for all
// G rows of its kv head, so the KV bytes from HBM (8 slots x 16 heads x up
// to 1024 keys x 128 x 2 x 2 bytes = 64 MiB a layer at the serving slice's
// widths; int8 pages half of that plus 8 bytes of scales a key). The
// classic kernels ran one block per (slot, kv head), 64-128 blocks on 132
// SMs with the longest slot setting the time, scalar FFMA over fp32 tiles.
//
// Design:
// - The grid is (key chunk, kv head, slot). The chunk (tpc tiles of 64
//   keys) comes from the table's capacity and the SM count (ps_plan), never
//   from lengths, which live on the card: no host read, and a grid a CUDA
//   graph can capture. A block whose chunk starts at or past its slot's
//   length exits; with one chunk the block writes the output itself.
// - Each tile of 64 keys is gathered row by row (a key's page is
//   table[pos / ps], so any page size works) by 16-byte cp.async into
//   shared memory in the pool's own dtype (int8 stays int8: 8 KB a K tile at
//   hd 128) through a 3-stage ring, the tile's k/v scales beside it; rows
//   past the length are zero-filled.
// - Four warps. Rows go to the m16 dimension of mma.sync m16n8k16 (fp32
//   accumulators), padded to 16: KPW = 16 keys a warp a tile for G <= 16
//   (the four warps split the tile), 32 for G <= 32 (two row slabs x two key
//   halves), 64 for G <= 64 (four slabs, every key). The decode's idle MMA
//   rows cost nothing: the kernel is bound by HBM. Each warp keeps the
//   online softmax (fp32 m, l) of its two rows a lane in registers; the
//   warps of one slab merge through shared memory in a fixed order at the
//   end of the chunk.
// - 16-bit pools: K fragments by ldmatrix, V by ldmatrix.trans, over
//   csrc/hopper.cuh's swizzle, as flash_fwd_mma_kernel. int8 pools: a
//   lane's K values come as one 16-byte load (the head dim is permuted
//   alike in the Q fragments, which a dot product allows) and its V values
//   as 4-byte loads along the head dim (the output columns are permuted
//   instead and put back when written), each int8 value converted exactly
//   to the q dtype (|v| <= 127); both tiles are swizzled for those reads.
// - Numerics, in laser_tpu's int8 order (paged_attention.py:381-410): s =
//   (q.k) * scale * k_scale[token]; l sums p before p *= v_scale[token];
//   then p rounds to the q dtype and enters P.V. Masked lanes get p = 0, a
//   length of 0 writes zeros.
// - More than one chunk: each block writes fp32 partials (m, l and G x hd
//   accumulators) to a workspace the wrapper sizes (ltt_paged_workspace),
//   and paged_merge_kernel (a block a row, a thread a column) combines a
//   row's chunks in a fixed order: two calls give the same bits, and at W =
//   1 the decode and the verify run the same instance, so they give the
//   same bits too.
#pragma once

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

// One call's operands (see the note above); ws: the fp32 workspace, null
// where the plan has one chunk.
struct PsArgs {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* lengths;
  void* out;
  float* ws;
  int S, W, Hq, Hkv, ps, hd, max_pages;
  float scale;
};

namespace ltt {

constexpr int PS_WARPS = 4;
constexpr int PS_THREADS = PS_WARPS * 32;
constexpr int PS_BK = 64;          // keys a tile
constexpr int PS_STAGES = 3;       // tiles in the cp.async ring
constexpr int PS_MAX_ROWS = 64;    // G = W * group rows a (slot, kv head)
constexpr int PS_BLOCKS_PER_SM = 4;  // the grid the plan aims for
constexpr int PS_MAX_CHUNKS = 64;    // the merge's weights of a row fit in shared memory

// chunks of a slot's keys and 64-key tiles a chunk
struct PsPlan {
  int tpc;
  int chunks;
};

// From the table's capacity (max_pages * ps keys) and the SM count: enough
// blocks for PS_BLOCKS_PER_SM an SM, at most PS_MAX_CHUNKS chunks, whole
// tiles a chunk, no empty chunk past the capacity.
inline PsPlan ps_plan(int S, int Hkv, int ps, int max_pages) {
  const int tiles = std::max(1, (max_pages * ps + PS_BK - 1) / PS_BK);
  const int pairs = std::max(1, S * Hkv);
  const int want = std::max(1, (PS_BLOCKS_PER_SM * hp::sm_count() + pairs - 1) / pairs);
  const int chunks = std::min({tiles, want, PS_MAX_CHUNKS});
  const int tpc = (tiles + chunks - 1) / chunks;
  return {tpc, (tiles + tpc - 1) / tpc};
}

// fp32 workspace bytes of a call: per (slot, kv head, chunk) m and l of
// each of the G rows and their G x hd accumulators; 0 for one chunk
inline long long ps_workspace_bytes(int S, int W, int Hq, int Hkv, int ps, int hd,
                                    int max_pages) {
  const PsPlan p = ps_plan(S, Hkv, ps, max_pages);
  if (p.chunks <= 1) return 0;
  const long long G = (long long)W * (Hq / Hkv);
  return (long long)S * Hkv * p.chunks * G * (hd + 2) * 4;
}

// The split route takes 16-bit q at hd 64 or 128, G <= 64, pools in q's
// dtype or int8, 16-byte-aligned q, pools and out.
inline bool ps_fits(int dtype, int hd, int W, int Hq, int Hkv, const void* q,
                    const void* k_pool, const void* v_pool, const void* out) {
  return (dtype == kBF16 || dtype == kF16) && (hd == 64 || hd == 128) &&
         W * (Hq / Hkv) <= PS_MAX_ROWS && hp::aligned16(q) && hp::aligned16(k_pool) &&
         hp::aligned16(v_pool) && (out == nullptr || hp::aligned16(out));
}

// one per q dtype, each defined in its own source; pool_dtype is the q
// dtype's code or kI8
int paged_split_bf16(const PsArgs& a, int pool_dtype, cudaStream_t s);
int paged_split_f16(const PsArgs& a, int pool_dtype, cudaStream_t s);

// route codes shared with ops/paged_attention.py (ROUTES)
enum PagedRoute { kPagedAuto = 0, kPagedClassic = 1, kPagedSplit = 2 };

// The route a call takes: the split kernel where it fits unless the classic
// one is asked for; -1 where the route asked for does not fit (or is no
// route). Nothing falls back.
inline int ps_route(int route, bool fits) {
  switch (route) {
    case kPagedAuto: return fits ? kPagedSplit : kPagedClassic;
    case kPagedClassic: return kPagedClassic;
    case kPagedSplit: return fits ? kPagedSplit : -1;
    default: return -1;
  }
}

inline int paged_split(const PsArgs& a, int dtype, int pool_dtype, cudaStream_t s) {
  return dtype == kBF16 ? paged_split_bf16(a, pool_dtype, s) : paged_split_f16(a, pool_dtype, s);
}

}  // namespace ltt

namespace {

using ltt::kNegInf;
using ltt::PS_BK;
using ltt::PS_STAGES;
using ltt::PS_THREADS;
using ltt::PS_WARPS;
using ltt::hp::cp_async16;
using ltt::hp::cp_async4;
using ltt::hp::cp_async_commit;
using ltt::hp::cp_async_wait;
using ltt::hp::ldsm_x4;
using ltt::hp::ldsm_x4_trans;
using ltt::hp::mma16816;
using ltt::hp::pack2;
using ltt::hp::smem_u32;
using ltt::hp::swz;

constexpr float PS_LOG2E = 1.4426950408889634f;

// int8 tiles: 16-byte chunk c of row r. K rows are read a 16-byte chunk a
// lane, two rows a quarter-warp (r, r + 1: odd rows take the other half of
// a 128-byte row); V rows 4 bytes a lane at one chunk pair, four rows two
// apart a load (rows r, r + 2, r + 4, r + 6 take different pairs).
template <int D>
__device__ __forceinline__ int k8_off(int r, int c) {
  return r * D + ((c ^ ((r & 1) << 2)) & (D / 16 - 1)) * 16;
}
template <int D>
__device__ __forceinline__ int v8_off(int r, int c) {
  return r * D + ((c ^ (((r >> 1) & 3) << 1)) & (D / 16 - 1)) * 16;
}

// the head-dim column d of mma k index kk of k-chunk kc in the int8 path:
// lane quad q's 16-byte K load covers d 64 (kc / 4) + 16 q + [0, 16), word
// kc % 4 its four values (k 2q, 2q+1, 2q+8, 2q+9)
__device__ __forceinline__ int q8_col(int kc, int kk) {
  return 64 * (kc >> 2) + 16 * ((kk & 7) >> 1) + 4 * (kc & 3) + 2 * (kk >> 3) + (kk & 1);
}

// the output column of accumulator column n of d block nb: natural for
// 16-bit pools; in the int8 path a lane's 4-byte V load at byte 4 g + 32 j
// serves d blocks 4 j .. 4 j + 3
template <bool QUANT>
__device__ __forceinline__ int out_col(int nb, int n) {
  return QUANT ? 32 * (nb >> 2) + 4 * n + (nb & 3) : 8 * nb + n;
}

// the four signed bytes of w as exact floats: 2^23 + (b ^ 0x80) built in a
// float's bits by one byte permute, less 2^23 + 128 (csrc/hopper.cuh's
// nibbles8 trick); no integer-to-float conversion, a quarter-rate
// instruction
__device__ __forceinline__ void i8x4(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + j)) - 8388736.f;
}

template <typename KT, int D>
__host__ __device__ constexpr int ps_stage_bytes() {
  return 2 * PS_BK * D * (int)sizeof(KT) +
         (std::is_same<KT, int8_t>::value ? 2 * PS_BK * (int)sizeof(float) : 0);
}

// the ring, or after it the merge buffers (64 rows of m, l and hd
// accumulators), whichever is larger
template <typename KT, int D>
constexpr size_t ps_smem_bytes() {
  return std::max((size_t)PS_STAGES * ps_stage_bytes<KT, D>(),
                  (size_t)PS_WARPS * 16 * (D + 2) * sizeof(float));
}

// The 64-key tile at tile0 into a ring stage: K, V (rows past kend
// zero-filled, their source clamped to key kend - 1) and, for int8 pools,
// the tile's k and v scales.
template <typename KT, int D>
__device__ __forceinline__ void ps_load_tile(uint8_t* stage, const KT* __restrict__ kp,
                                             const KT* __restrict__ vp,
                                             const float* __restrict__ ks,
                                             const float* __restrict__ vs,
                                             const int* __restrict__ table, int tile0, int kend,
                                             int Hkv, int h, int ps) {
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  constexpr int EPC = 16 / sizeof(KT);  // elements a 16-byte chunk
  constexpr int CH = D / EPC;           // chunks a row
  KT* Kt = reinterpret_cast<KT*>(stage);
  KT* Vt = Kt + PS_BK * D;
#pragma unroll
  for (int it = 0; it < PS_BK * CH / PS_THREADS; ++it) {
    const int i = threadIdx.x + it * PS_THREADS;
    const int r = i / CH, c = i % CH;
    const int pos = tile0 + r;
    const bool valid = pos < kend;
    const int p = valid ? pos : kend - 1;
    const size_t row = ((size_t)table[p / ps] * Hkv + h) * ps + p % ps;
    const int koff = QUANT ? k8_off<D>(r, c) : swz<D>(r, c);
    const int voff = QUANT ? v8_off<D>(r, c) : swz<D>(r, c);
    cp_async16(smem_u32(Kt + koff), kp + row * D + c * EPC, valid);
    cp_async16(smem_u32(Vt + voff), vp + row * D + c * EPC, valid);
  }
  if constexpr (QUANT) {
    float* sc = reinterpret_cast<float*>(Vt + PS_BK * D);  // [k 64][v 64]
    const int r = threadIdx.x & (PS_BK - 1);
    const int pos = tile0 + r;
    const bool valid = pos < kend;
    const int p = valid ? pos : kend - 1;
    const size_t row = ((size_t)table[p / ps] * Hkv + h) * ps + p % ps;
    cp_async4(smem_u32(sc + threadIdx.x), (threadIdx.x < PS_BK ? ks : vs) + row, valid);
  }
}

// T: q's dtype (bf16/f16); KT: the pool's, T or int8_t; D: the head dim;
// KPW: keys a warp a tile (16, 32, 64 for G <= 16, 32, 64).
template <typename T, typename KT, int D, int KPW>
__global__ void __launch_bounds__(PS_THREADS)
    paged_split_kernel(PsArgs a, int tpc, int chunks) {
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  constexpr int NSLAB = KPW / 16;         // 16-row slabs
  constexpr int KC = D / 16;              // k16 chunks of the head dim
  constexpr int NBD = D / 8;              // n8 blocks of the output
  constexpr int NBK = KPW / 8;            // n8 key blocks a warp
  constexpr int KCK = KPW / 16;           // k16 key chunks a warp
  constexpr int R = NSLAB * 16;           // rows the merge buffers hold a key group
  extern __shared__ __align__(128) uint8_t ps_smem[];

  const int chunk = blockIdx.x, h = blockIdx.y, slot = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int slab = warp % NSLAB, kg = warp / NSLAB;
  const int key0 = kg * KPW;  // the warp's keys in a tile
  const int W = a.W, Hq = a.Hq, Hkv = a.Hkv;
  const int group = Hq / Hkv, G = W * group;
  const int qlen = a.lengths[slot];
  const int length = min(qlen, a.max_pages * a.ps);
  const int k0 = chunk * tpc * PS_BK;
  if (chunks > 1 && k0 >= length) return;  // the merge reads no partial of it
  const int kend = min(k0 + tpc * PS_BK, length);
  const int nt = kend > k0 ? (kend - k0 + PS_BK - 1) / PS_BK : 0;
  const int* table = a.tables + (size_t)slot * a.max_pages;
  const KT* kp = static_cast<const KT*>(a.k_pool);
  const KT* vp = static_cast<const KT*>(a.v_pool);

  for (int st = 0; st < PS_STAGES - 1; ++st) {
    if (st < nt)
      ps_load_tile<KT, D>(ps_smem + st * ps_stage_bytes<KT, D>(), kp, vp, a.k_scale,
                          a.v_scale, table, k0 + st * PS_BK, kend, Hkv, h, a.ps);
    cp_async_commit();
  }

  // this lane's rows (slab 16 + g, + 8): positions and Q fragments
  // (a0a1 row g, a2a3 row g + 8, a4a5 / a6a7 the same at k + 8)
  const T* q = static_cast<const T*>(a.q);
  int qp[2];
  const T* qrow[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = slab * 16 + g + 8 * hh;
    qp[hh] = r < G ? qlen - W + r / group : -1;
    qrow[hh] = r < G ? q + (((size_t)slot * W + r / group) * Hq + h * group + r % group) * D
                     : nullptr;
  }
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = 2 * t4 + 8 * (j >> 1);
      const int d = QUANT ? q8_col(kc, kk) : 16 * kc + kk;
      const T* qr = qrow[j & 1];
      qf[kc][j] = qr ? *reinterpret_cast<const uint32_t*>(qr + d) : 0u;
    }
  }

  float acc[NBD][4];
#pragma unroll
  for (int i = 0; i < NBD; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's partial sums
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: which matrix, which row of it

  for (int t = 0; t < nt; ++t) {
    if (t + PS_STAGES - 1 < nt)
      ps_load_tile<KT, D>(ps_smem + ((t + PS_STAGES - 1) % PS_STAGES) * ps_stage_bytes<KT, D>(),
                          kp, vp, a.k_scale, a.v_scale, table,
                          k0 + (t + PS_STAGES - 1) * PS_BK, kend, Hkv, h, a.ps);
    cp_async_commit();
    cp_async_wait<PS_STAGES - 1>();
    __syncthreads();
    const int tile0 = k0 + t * PS_BK;
    if (tile0 + key0 < kend) {  // warp-uniform: the warp's keys hold one before kend
      const uint8_t* stage = ps_smem + (t % PS_STAGES) * ps_stage_bytes<KT, D>();
      const KT* Ks = reinterpret_cast<const KT*>(stage);
      const KT* Vs = Ks + PS_BK * D;
      const float* sc = reinterpret_cast<const float*>(Vs + PS_BK * D);

      // S = Q K^T, 16 rows x KPW keys: s[nb] is key block nb of the warp
      float s[NBK][4];
#pragma unroll
      for (int nb = 0; nb < NBK; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      if constexpr (QUANT) {
        const int8_t* K8 = reinterpret_cast<const int8_t*>(Ks);
#pragma unroll
        for (int nb = 0; nb < NBK; ++nb) {
          const int r = key0 + 8 * nb + g;
#pragma unroll
          for (int cg = 0; cg < D / 64; ++cg) {
            const uint4 w = *reinterpret_cast<const uint4*>(K8 + k8_off<D>(r, 4 * cg + t4));
            const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float f[4];
              i8x4(wv[i], f);
              mma16816<T>(s[nb], qf[4 * cg + i], pack2<T>(f[0], f[1]), pack2<T>(f[2], f[3]));
            }
          }
        }
      } else {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
          for (int np = 0; np < NBK / 2; ++np) {
            // matrices (keys 0-7, d 0-7), (keys 0-7, d 8-15), (keys 8-15,
            // d 0-7), (keys 8-15, d 8-15) of key pair np
            uint32_t b[4];
            ldsm_x4(b, smem_u32(Ks + swz<D>(key0 + np * 16 + mr + 8 * (mi >> 1),
                                            2 * kc + (mi & 1))));
            mma16816<T>(s[2 * np], qf[kc], b[0], b[1]);
            mma16816<T>(s[2 * np + 1], qf[kc], b[2], b[3]);
          }
        }
      }

      // mask, scale and the online softmax: s[nb][2 hh + e] is row g + 8 hh,
      // key tile0 + key0 + 8 nb + 2 t4 + e
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nb = 0; nb < NBK; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = key0 + 8 * nb + 2 * t4 + (e & 1);
          const int key = tile0 + kr;
          const bool valid = key < kend && key <= qp[e >> 1];
          float sv = s[nb][e] * a.scale;
          if constexpr (QUANT) sv *= sc[kr];
          s[nb][e] = valid ? sv : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
        }
      }
      float ml[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float mn = fmaxf(m[hh], mx[hh]);  // m starts at the finite kNegInf
        const float corr = exp2f((m[hh] - mn) * PS_LOG2E);
        m[hh] = mn;
        ml[hh] = mn * PS_LOG2E;
        l[hh] *= corr;
#pragma unroll
        for (int i = 0; i < NBD; ++i) {
          acc[i][2 * hh] *= corr;
          acc[i][2 * hh + 1] *= corr;
        }
      }
      // P in registers, rounded to T (times v_scale first for int8 pools):
      // block nb's values are the A fragment of key chunk nb / 2
      uint32_t pf[KCK][4];
#pragma unroll
      for (int nb = 0; nb < NBK; ++nb) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f(fmaf(s[nb][e], PS_LOG2E, -ml[e >> 1]));
          l[e >> 1] += p[e];
          if constexpr (QUANT) p[e] *= sc[PS_BK + key0 + 8 * nb + 2 * t4 + (e & 1)];
        }
        pf[nb >> 1][2 * (nb & 1)] = pack2<T>(p[0], p[1]);
        pf[nb >> 1][2 * (nb & 1) + 1] = pack2<T>(p[2], p[3]);
      }

      // O += P V over the warp's key chunks
      if constexpr (QUANT) {
        const int8_t* V8 = reinterpret_cast<const int8_t*>(Vs);
#pragma unroll
        for (int kc = 0; kc < KCK; ++kc) {
          const int r0 = key0 + 16 * kc + 2 * t4;  // keys r0, r0 + 1, r0 + 8, r0 + 9
#pragma unroll
          for (int j = 0; j < D / 32; ++j) {
            const int c = 2 * j + (g >> 2), byte = 4 * (g & 3);
            float v[4][4];  // keys r0, r0 + 1, r0 + 8, r0 + 9; d blocks 4 j + i
            const int kr[4] = {r0, r0 + 1, r0 + 8, r0 + 9};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              i8x4(*reinterpret_cast<const uint32_t*>(V8 + v8_off<D>(kr[e], c) + byte), v[e]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              mma16816<T>(acc[4 * j + i], pf[kc], pack2<T>(v[0][i], v[1][i]),
                          pack2<T>(v[2][i], v[3][i]));
          }
        }
      } else {
#pragma unroll
        for (int kc = 0; kc < KCK; ++kc) {
#pragma unroll
          for (int dp = 0; dp < NBD / 2; ++dp) {
            uint32_t b[4];
            ldsm_x4_trans(b, smem_u32(Vs + swz<D>(key0 + kc * 16 + mr + 8 * (mi & 1),
                                                  2 * dp + (mi >> 1))));
            mma16816<T>(acc[2 * dp], pf[kc], b[0], b[1]);
            mma16816<T>(acc[2 * dp + 1], pf[kc], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is refilled PS_STAGES - 1 tiles on
  }
  cp_async_wait<0>();

  // the warps of a slab merge in key-group order through the ring's memory
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  float* Mb = reinterpret_cast<float*>(ps_smem);  // [key group][R]
  float* Lb = Mb + PS_WARPS * 16;                 // (KW x R = 64 rows)
  float* Ab = Lb + PS_WARPS * 16;                 // [key group][R][D]
  const int rb = kg * R + slab * 16 + g;
  if (t4 == 0) {
    Mb[rb] = m[0];
    Mb[rb + 8] = m[1];
    Lb[rb] = l[0];
    Lb[rb + 8] = l[1];
  }
#pragma unroll
  for (int nb = 0; nb < NBD; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      Ab[(size_t)(rb + 8 * (e >> 1)) * D + out_col<QUANT>(nb, 2 * t4 + (e & 1))] = acc[nb][e];
  }
  __syncthreads();

  constexpr int KW = PS_WARPS / NSLAB;
  T* out = static_cast<T*>(a.out);
  float* ws = chunks > 1 ? a.ws + ((size_t)(slot * Hkv + h) * chunks + chunk) * G * (D + 2)
                         : nullptr;
  for (int i = threadIdx.x; i < G * D; i += PS_THREADS) {
    const int r = i / D, d = i % D;
    float M = kNegInf;
#pragma unroll
    for (int k = 0; k < KW; ++k) M = fmaxf(M, Mb[k * R + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      const float f = exp2f((Mb[k * R + r] - M) * PS_LOG2E);
      L += Lb[k * R + r] * f;
      A += Ab[(size_t)(k * R + r) * D + d] * f;
    }
    if (chunks == 1) {
      out[(((size_t)slot * W + r / group) * Hq + h * group + r % group) * D + d] =
          ltt::from_f32<T>(L > 0.f ? A / L : 0.f);
    } else {
      if (d == 0) {
        ws[r] = M;
        ws[G + r] = L;
      }
      ws[2 * G + (size_t)r * D + d] = A;
    }
  }
}

// The chunks' partials of one row of a (slot, kv head), a block a row and a
// thread a column (blockDim = hd): the chunks' weights once into shared
// memory, then each column's sum over the chunks in chunk order.
template <typename T>
__global__ void __launch_bounds__(128) paged_merge_kernel(PsArgs a, int tpc, int chunks) {
  __shared__ float wt[ltt::PS_MAX_CHUNKS];
  __shared__ float red[32];
  const int h = blockIdx.x, slot = blockIdx.y, r = blockIdx.z;
  const int W = a.W, Hq = a.Hq, Hkv = a.Hkv, D = a.hd;
  const int group = Hq / Hkv, G = W * group;
  const int length = min(a.lengths[slot], a.max_pages * a.ps);
  const int CK = tpc * PS_BK;
  const int n = (length + CK - 1) / CK;  // chunks that wrote a partial
  const size_t stride = (size_t)G * (D + 2);
  const float* ws = a.ws + (size_t)(slot * Hkv + h) * chunks * stride;
  float mx = kNegInf;
  for (int c = threadIdx.x; c < n; c += blockDim.x) mx = fmaxf(mx, ws[c * stride + r]);
  const float M = ltt::block_max(mx, red);
  float sum = 0.f;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const float f = exp2f((ws[c * stride + r] - M) * PS_LOG2E);
    wt[c] = f;
    sum += ws[c * stride + G + r] * f;
  }
  const float L = ltt::block_sum(sum, red);  // its barriers publish wt
  float A = 0.f;
  for (int c = 0; c < n; ++c) A += wt[c] * ws[c * stride + 2 * G + (size_t)r * D + threadIdx.x];
  T* out = static_cast<T*>(a.out);
  out[(((size_t)slot * W + r / group) * Hq + h * group + r % group) * D + threadIdx.x] =
      ltt::from_f32<T>(L > 0.f ? A / L : 0.f);
}

template <typename T, typename KT, int D, int KPW>
int ps_launch_rows(const PsArgs& a, cudaStream_t s) {
  const ltt::PsPlan pl = ltt::ps_plan(a.S, a.Hkv, a.ps, a.max_pages);
  if (pl.chunks > 1 && a.ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ps_smem_bytes<KT, D>();
  int st = ltt::allow_smem(paged_split_kernel<T, KT, D, KPW>, smem);
  if (st != 0) return st;
  paged_split_kernel<T, KT, D, KPW>
      <<<dim3(pl.chunks, a.Hkv, a.S), PS_THREADS, smem, s>>>(a, pl.tpc, pl.chunks);
  st = ltt::launch_status();
  if (st != 0 || pl.chunks == 1) return st;
  const int G = a.W * (a.Hq / a.Hkv);
  paged_merge_kernel<T><<<dim3(a.Hkv, a.S, G), D, 0, s>>>(a, pl.tpc, pl.chunks);
  return ltt::launch_status();
}

// keys a warp a tile: the fewest slabs of 16 rows that hold G
template <typename T, typename KT, int D>
int ps_launch_g(const PsArgs& a, cudaStream_t s) {
  const int G = a.W * (a.Hq / a.Hkv);
  if (G <= 16) return ps_launch_rows<T, KT, D, 16>(a, s);
  if (G <= 32) return ps_launch_rows<T, KT, D, 32>(a, s);
  return ps_launch_rows<T, KT, D, 64>(a, s);
}

// the pool in q's dtype or int8; hd 64 or 128 (ps_fits)
template <typename T>
int ps_launch(const PsArgs& a, int pool_dtype, cudaStream_t s) {
  if (pool_dtype == ltt::kI8)
    return a.hd == 64 ? ps_launch_g<T, int8_t, 64>(a, s) : ps_launch_g<T, int8_t, 128>(a, s);
  return a.hd == 64 ? ps_launch_g<T, T, 64>(a, s) : ps_launch_g<T, T, 128>(a, s);
}

}  // namespace
