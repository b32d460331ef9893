// Paged window attention (the speculative verify): W causal queries per slot
// over the slot's block-table pages. The kernel templates; each q dtype's
// instances are compiled in a source of their own
// (paged_window_attention.cu: f32 and the C entry point;
// paged_window_attention_bf16.cu, paged_window_attention_f16.cu), so that
// the build's one nvcc per source compiles them in parallel.
//
// Replaces laser_tpu/ops/paged_attention.py:318 build_paged_window_attention
// (float pools, and int8 pools with per-token scales; no window). Since the
// split kernel of paged_split.cuh (the tensor cores) took the bf16/f16 calls
// at hd 64 and 128, this kernel is the verify's route "classic".
//
// Layouts (as the TPU kernel's wrapper): q (S, W, Hq, hd); pools
// (P, Hkv, ps, hd); tables (S, max_pages) int32; lengths (S,) int32; out
// (S, W, Hq, hd); with int8 pools also k_scale, v_scale (P, Hkv, ps) f32.
// Query w of slot s sits at position lengths[s] - W + w and attends keys
// 0 .. lengths[s] - W + w that the table holds (a table row holds
// max_pages * ps keys: positions past them, which the engine never emits,
// attend the keys there are, as in the TPU kernel). Consecutive q heads
// share a kv head; the TPU wrapper folds (W, group) into G = W * group rows,
// row = w * group + g (paged_attention.py:504-506). This kernel reads those
// rows in place from q's layout, so no fold copy is made on either side.
//
// What bounds it on the H100: every key and value row of a slot is used by
// all G rows of its kv head, so the call is bound by the KV bytes read from
// HBM (8 slots x 16 kv heads x up to 1024 keys x 128 x 2 x 2 bytes = 64 MiB
// per layer at the serving slice's width; int8 pages a half of that plus 4
// bytes of scale per row).
//
// Design: one block per (slot, kv head), 8 warps, and a loop over 32-key
// tiles in place of the TPU's sequential page axis. The whole block copies
// each tile once from HBM into shared memory (fp32; int8 rows exactly, with
// their scales beside them), so K/V are read from HBM once per
// (slot, kv head) whatever G is: no multiple of the bytes. Each thread
// loads its share of the NEXT tile (4 keys x hd/32 columns of K and V) into
// registers while the block computes on the current tile, and converts and
// stores it to shared memory at the top of the next iteration. The loads
// are unconditional (a key past the length reads a valid row and is zeroed
// after), so the unrolled loop issues all of them back to back: one HBM
// round trip per tile, behind the tile's compute. Warp w owns rows w,
// w + 8, ... (RPW = 1, 2, 4 or 8 of them, a compile-time count picked from
// G <= 64, so no issue slot goes to an absent row) and keeps their online
// softmax (fp32 m, l, accumulator) in registers across all tiles: no merge
// between warps. Scores: lane = key (the K tile is padded by one column,
// so the 32 lanes hit 32 banks); P.V: lane = head-dim column, P broadcast
// by shuffle and rounded to the q dtype first, as the TPU kernel does. A
// tile that starts past a row's position is skipped for that row (a
// warp-uniform test), so every tile a row processes holds at least one of
// its keys and its running max is a real score; masked lanes still get
// p = 0 explicitly (the TPU kernel's rule, paged_attention.py:398-399).
// Keys at or past the (table-capped) length are never used; length 0
// writes zeros.
//
// int8 pools (a compile-time variant, KT = int8_t) follow the TPU kernel's
// order (paged_attention.py:381-410): s = (q.k) * scale * k_scale[token], l
// sums p BEFORE p *= v_scale[token], then p rounds to the q dtype (a no-op
// for f32, JAX's "base" tier) and enters the P.V product.
#pragma once

#include <type_traits>

#include "common.cuh"

// One call's operands: q (S, W, Hq, hd); k_pool, v_pool (P, Hkv, ps, hd) in
// q's dtype, or int8 with k_scale, v_scale (P, Hkv, ps) f32 (null for float
// pools); tables (S, max_pages) int32; lengths (S,) int32; out
// (S, W, Hq, hd). hd <= 256, W * (Hq / Hkv) <= 64.
struct PwArgs {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* lengths;
  void* out;
  int S, W, Hq, Hkv, ps, hd, max_pages;
  float scale;
};

namespace ltt {
// one per q dtype, each defined in its own source; pool_dtype is the q
// dtype's code or kI8
int paged_window_f32(const PwArgs& a, int pool_dtype, cudaStream_t s);
int paged_window_bf16(const PwArgs& a, int pool_dtype, cudaStream_t s);
int paged_window_f16(const PwArgs& a, int pool_dtype, cudaStream_t s);
}  // namespace ltt

namespace {

using ltt::from_f32;
using ltt::kNegInf;
using ltt::to_f32;

constexpr int PW_WARPS = 8;
constexpr int PW_THREADS = PW_WARPS * 32;
constexpr int PW_TILE = 32;                  // keys per tile: one per lane
constexpr int PW_KPW = PW_TILE / PW_WARPS;   // keys each warp copies per tile

// fp32 shared memory: q rows [G][hd], the K tile [32][hd + 1], the V tile
// [32][hd] and the tile's two scale vectors [32]
size_t smem_bytes(int G, int hd) {
  return sizeof(float) *
         ((size_t)G * hd + (size_t)PW_TILE * (hd + 1) + (size_t)PW_TILE * hd + 2 * PW_TILE);
}

// One thread's share of the tile at `base`, raw: keys warp + 8 jj, columns
// lane + 32 c. Addresses are clamped into the slot's keys and the row, so
// every load is valid and none waits on a test (length > 0 here); the
// caller zeroes what lies past them.
template <typename KT, int DC>
__device__ __forceinline__ void load_tile(const KT* __restrict__ k_pool,
                                          const KT* __restrict__ v_pool,
                                          const float* __restrict__ k_scale,
                                          const float* __restrict__ v_scale,
                                          const int* __restrict__ table, int base, int length,
                                          int Hkv, int h, int ps, int hd, int warp, int lane,
                                          KT (&kr)[PW_KPW][DC], KT (&vr)[PW_KPW][DC],
                                          float (&ksr)[PW_KPW], float (&vsr)[PW_KPW]) {
  size_t row[PW_KPW];
#pragma unroll
  for (int jj = 0; jj < PW_KPW; ++jj) {
    const int pos = min(base + warp + PW_WARPS * jj, length - 1);
    row[jj] = ((size_t)table[pos / ps] * Hkv + h) * ps + pos % ps;
  }
#pragma unroll
  for (int jj = 0; jj < PW_KPW; ++jj) {
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const size_t at = row[jj] * hd + min(lane + 32 * c, hd - 1);
      kr[jj][c] = k_pool[at];
      vr[jj][c] = v_pool[at];
    }
    if constexpr (std::is_same<KT, int8_t>::value) {
      ksr[jj] = k_scale[row[jj]];
      vsr[jj] = v_scale[row[jj]];
    }
  }
}

// KT: the pool element type, T or int8_t (then k_scale, v_scale are read);
// RPW: rows per warp, G <= 8 * RPW
template <typename T, typename KT, int DC, int RPW>
__global__ void __launch_bounds__(PW_THREADS) paged_window_kernel(PwArgs a) {
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  extern __shared__ float smem[];
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const KT* __restrict__ k_pool = static_cast<const KT*>(a.k_pool);
  const KT* __restrict__ v_pool = static_cast<const KT*>(a.v_pool);
  const int W = a.W, Hq = a.Hq, Hkv = a.Hkv, ps = a.ps, hd = a.hd;
  const int group = Hq / Hkv;
  const int G = W * group;
  float* qs = smem;                          // [G][hd]
  float* kt = qs + (size_t)G * hd;           // [PW_TILE][hd + 1]
  float* vt = kt + (size_t)PW_TILE * (hd + 1);  // [PW_TILE][hd]
  float* kscl = vt + (size_t)PW_TILE * hd;   // [PW_TILE]
  float* vscl = kscl + PW_TILE;              // [PW_TILE]

  const int slot = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* table = a.tables + (size_t)slot * a.max_pages;
  // rows sit at positions from the slot's length; the keys they can see
  // stop where its table row does
  const int qlen = a.lengths[slot];
  const int length = min(qlen, a.max_pages * ps);

  // row r = w * group + g is q[slot, w, h * group + g, :]
  for (int i = tid; i < G * hd; i += PW_THREADS) {
    const int r = i / hd, d = i % hd;
    const int w = r / group, g = r % group;
    qs[i] = to_f32(q[(((size_t)slot * W + w) * Hq + h * group + g) * hd + d]);
  }

  float m[RPW], l[RPW], acc[RPW][DC];
  int qpos[RPW];  // this warp's rows' positions; -1 for a row past G
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + PW_WARPS * i;
    qpos[i] = r < G ? qlen - W + r / group : -1;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int ntiles = (length + PW_TILE - 1) / PW_TILE;
  KT kr[PW_KPW][DC], vr[PW_KPW][DC];
  float ksr[PW_KPW], vsr[PW_KPW];
  if (ntiles > 0)
    load_tile<KT, DC>(k_pool, v_pool, a.k_scale, a.v_scale, table, 0, length, Hkv, h, ps, hd,
                      warp, lane, kr, vr, ksr, vsr);
  for (int t = 0; t < ntiles; ++t) {
    const int base = t * PW_TILE;
    __syncthreads();  // the previous tile is consumed; on the first, q is written
#pragma unroll
    for (int jj = 0; jj < PW_KPW; ++jj) {
      const int j = warp + PW_WARPS * jj;
      const bool in = base + j < length;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        if (d < hd) {
          kt[j * (hd + 1) + d] = in ? to_f32(kr[jj][c]) : 0.f;
          vt[j * hd + d] = in ? to_f32(vr[jj][c]) : 0.f;
        }
      }
      if constexpr (QUANT) {
        if (lane == 0) {
          kscl[j] = in ? ksr[jj] : 0.f;
          vscl[j] = in ? vsr[jj] : 0.f;
        }
      }
    }
    __syncthreads();
    if (t + 1 < ntiles)  // in flight while this tile is computed
      load_tile<KT, DC>(k_pool, v_pool, a.k_scale, a.v_scale, table, base + PW_TILE, length,
                        Hkv, h, ps, hd, warp, lane, kr, vr, ksr, vsr);

    // rows of this warp that see a key of this tile (warp-uniform)
    bool on[RPW];
    int last = -1;  // the warp's largest row position
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      on[i] = qpos[i] >= base;
      last = max(last, qpos[i]);
    }
    if (last < base) continue;  // the barrier at the top keeps the block in step

    const int pos = base + lane;
    float s[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = 0.f;
    const float* krow = kt + lane * (hd + 1);
#pragma unroll 8
    for (int d = 0; d < hd; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        if (on[i]) s[i] = fmaf(qs[(warp + PW_WARPS * i) * hd + d], kd, s[i]);
    }
    float p[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      p[i] = 0.f;
      if (on[i]) {
        const bool valid = pos <= qpos[i] && pos < length;  // causal, and in the table
        float sv = s[i] * a.scale;
        if constexpr (QUANT) sv *= kscl[lane];
        sv = valid ? sv : kNegInf;
        const float m_new = fmaxf(m[i], ltt::warp_max(sv));
        const float corr = expf(m[i] - m_new);
        const float pv = valid ? expf(sv - m_new) : 0.f;
        l[i] = l[i] * corr + ltt::warp_sum(pv);
        m[i] = m_new;
        p[i] = ltt::round_through<T>(QUANT ? pv * vscl[lane] : pv);
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
      }
    }
    // keys past the warp's last row position carry p = 0 for every row
    const int nkeys = min(PW_TILE, last - base + 1);
#pragma unroll 4
    for (int j = 0; j < nkeys; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < hd ? vt[j * hd + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        if (on[i]) {
          const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pj, vv[c], acc[i][c]);
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + PW_WARPS * i;
    if (r < G) {
      const int w = r / group, g = r % group;
      T* orow = out + (((size_t)slot * W + w) * Hq + h * group + g) * hd;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        if (d < hd) orow[d] = from_f32<T>(l[i] > 0.f ? acc[i][c] / l[i] : 0.f);
      }
    }
  }
}

template <typename T, typename KT, int DC, int RPW>
int launch_rows(const PwArgs& a, cudaStream_t s) {
  const size_t smem = smem_bytes(a.W * (a.Hq / a.Hkv), a.hd);
  const int st = ltt::allow_smem(paged_window_kernel<T, KT, DC, RPW>, smem);
  if (st != 0) return st;
  paged_window_kernel<T, KT, DC, RPW><<<dim3(a.S, a.Hkv), PW_THREADS, smem, s>>>(a);
  return ltt::launch_status();
}

// rows per warp: the fewest of 1, 2, 4, 8 that hold G = W * group rows
template <typename T, typename KT, int DC>
int launch_g(const PwArgs& a, cudaStream_t s) {
  const int G = a.W * (a.Hq / a.Hkv);
  if (G <= PW_WARPS) return launch_rows<T, KT, DC, 1>(a, s);
  if (G <= 2 * PW_WARPS) return launch_rows<T, KT, DC, 2>(a, s);
  if (G <= 4 * PW_WARPS) return launch_rows<T, KT, DC, 4>(a, s);
  return launch_rows<T, KT, DC, 8>(a, s);
}

// head-dim columns per lane: hd <= 32, 64, 128, 256
template <typename T, typename KT>
int launch_d(const PwArgs& a, cudaStream_t s) {
  if (a.hd <= 32) return launch_g<T, KT, 1>(a, s);
  if (a.hd <= 64) return launch_g<T, KT, 2>(a, s);
  if (a.hd <= 128) return launch_g<T, KT, 4>(a, s);
  return launch_g<T, KT, 8>(a, s);
}

// the pool is either q's dtype or int8
template <typename T>
int launch_pool(const PwArgs& a, int pool_dtype, cudaStream_t s) {
  if (pool_dtype == ltt::kI8) return launch_d<T, int8_t>(a, s);
  return launch_d<T, T>(a, s);
}

}  // namespace
