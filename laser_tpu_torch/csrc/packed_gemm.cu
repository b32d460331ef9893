// GEMM over pre-blocked, zero-padded operands: out = alpha * A B + beta * C.
//
// Replaces laser_tpu/ops/gemm/prepacked.py:80 _build_packed_gemm.
//
// The packed layout is laser_tpu's, byte for byte: A is (gm, gk, bm, bk),
// B is (gk, gn, bk, bn), each block row-major, the padding zero
// (ops/gemm/prepacked.py). C is the (M, N) accumulator-typed matrix or null;
// out is (M, N), written by a masked epilogue (no padded output).
//
// What bounds it on the H100: at bench.py's 4096^3, operations: the bf16 and
// f16 products on the tensor cores (989 TFLOP/s dense), f32 as full-fp32
// FFMA (67 TFLOP/s; never TF32, config.matmul_precision "highest"), int8 on
// the int8 tensor cores (int32 accumulators that wrap mod 2^32, as
// laser_tpu's int32 accumulator does).
//
// Routes; the launcher picks one, or is asked for one (enum Route), and
// reports it:
// - wgmma (bf16/f16 inputs, bm and bn multiples of 128, bk of 64, 16-byte
//   bases, any float output): packed_wgmma_kernel, the persistent wgmma +
//   TMA skeleton of csrc/wgmma_gemm.cuh (a producer warp, a 3-stage ring of
//   128 x 64 A and 64 x 128 B boxes, two consumer warpgroups on wgmma
//   m64n128k16) that csrc/gemm.cu's gemm_wgmma_kernel runs. Packing makes
//   the fit exact: a packed block is a row-major (bm, bk) or (bk, bn)
//   matrix, so packed A is the 3-D tensor map (inner bk, outer bm, batch
//   gm * gk) and packed B (inner bn, outer bk, batch gk * gn), the block
//   index the outer coordinate; with the sizes above every box lies inside
//   one block and its zero padding, so the k loop walks gk * bk / 64 steps
//   with no fill and no masks (the padding is inert). Only the epilogue,
//   laser_tpu's per-op rounding below, masks rows >= M and columns >= N.
// - simt (f32 inputs, bm and bn multiples of 128, bk of 16, 16-byte bases,
//   any float output: every planned f32 plan, tiling.CTA's f32 k step is
//   16): packed_simt_kernel, the FFMA skeleton of csrc/simt_gemm.cuh that
//   csrc/gemm.cu's gemm_simt_kernel runs (a 128 x 128 tile, 8 x 8 outputs a
//   thread, a 3-stage ring of 16-deep slabs staged k-major). Packed B's
//   block rows are k-major (cp.async), packed A's are k-minor (registers,
//   stored transposed); with the sizes above a tile and a slab lie inside
//   one block and its zero padding, so nothing is masked but the epilogue,
//   laser_tpu's per-op rounding below. It sums each output in k order from
//   0 with fmaf, as packed_f32_kernel does: the same bits on both routes.
// - wgmma int8 (int8 inputs, an int32 output, bm and bn multiples of 128,
//   bk of 128, 16-byte bases, and B's K-major twin): packed_i8_wgmma_kernel,
//   the same skeleton with wgmma m64n128k32 s8 (int32 accumulators that
//   wrap) and a 128 x 128 x 128 stage. The int8 wgmma reads both operands
//   K-major from shared memory, and packed B's blocks are (bk, bn) with N
//   contiguous, so this route reads B's K-major twin: the same blocks
//   transposed, (gk, gn, bn, bk), made once when B is packed
//   (ops/gemm/prepacked.py, PackedMatrix.kmajor), never per call. Packed A
//   is the 3-D map (inner bk, outer bm, batch gm * gk), the twin (inner bk,
//   outer bn, batch gk * gn); with the sizes above every box lies inside
//   one block, so the k loop walks gk * bk / 128 steps with no masks. Its
//   epilogue is the classic int8 kernel's, alpha * acc + beta * C mod 2^32:
//   the same bits.
// - classic, every other plan or type: the kernels below.
// Design of the classic kernels. Packing exists so that the multiply reads
// each block as one contiguous run and needs no edge masks; the "blocks"
// route (fast = 1) exploits both. A CTA owns a CM x CN output tile inside one (bm, bn)
// block (bm % CM == 0, bn % CN == 0). Its rows of an A block are one
// contiguous run of CM * bk elements, and with bn == CN the B block is one
// run of bk * CN; each k-block is staged whole (D = bk deep) into shared
// memory by 16-byte cp.async copies, consecutive threads on consecutive
// addresses, into rows padded against bank conflicts, two stages deep so
// the next block loads while this one multiplies. The zero padding makes
// tail blocks inert, so the main loop has no masks at all. Float types:
// CTA 128 x 128, 256 threads; bf16/f16 through WMMA 16x16x16 (each warp 64
// x 32, fp32 accumulators), f32 as FFMA (each thread 8 x 8). int8: CTA 64
// x 64, 128 threads, WMMA s8 on the 64-deep staged tiles of
// csrc/int8_tile.cuh, one slab at a time.
// Any other block plan laser_tpu accepts (e.g. bm 48, bn 80, bk 40) takes
// the "gather" route (fast = 0): the same kernels, each slab 32 (16-bit),
// 16 (f32) or 64 (int8) deep gathered element by element from the blocked
// layout with its index arithmetic, zero past the padded extent, loaded
// synchronously.
#include <mma.h>

#include "common.cuh"
#include "int8_tile.cuh"
#include "simt_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace nvcuda;
namespace hp = ltt::hp;
namespace simt = ltt::simt;

enum Route { kRouteAuto = 0, kRouteClassic = 1, kRouteWgmma = 2, kRouteSimt = 3 };
using ltt::from_f32;
using ltt::to_f32;

struct PackedArgs {
  const void* a;  // (gm, gk, bm, bk)
  const void* b;  // (gk, gn, bk, bn)
  const void* c;  // (M, N) fp32 (int32 for int8 inputs) or null
  void* out;      // (M, N) in out_dtype
  int M, N, gm, gn, gk, bm, bn, bk;
  float alpha, beta;
  int alpha_i, beta_i;  // the int8 path's int32 alpha and beta
  int out_dtype;
};

// Element (m, k) of packed A, or (k, n) of packed B; 0 past the padded extent.
template <typename T>
__device__ __forceinline__ T packed_a_at(const PackedArgs& p, int m, int k) {
  const int i = m / p.bm, kb = k / p.bk;
  if (i >= p.gm || kb >= p.gk) return from_f32<T>(0.f);
  const size_t idx = (((size_t)i * p.gk + kb) * p.bm + (m - i * p.bm)) * p.bk + (k - kb * p.bk);
  return static_cast<const T*>(p.a)[idx];
}

template <typename T>
__device__ __forceinline__ T packed_b_at(const PackedArgs& p, int k, int n) {
  const int kb = k / p.bk, j = n / p.bn;
  if (kb >= p.gk || j >= p.gn) return from_f32<T>(0.f);
  const size_t idx = (((size_t)kb * p.gn + j) * p.bk + (k - kb * p.bk)) * p.bn + (n - j * p.bn);
  return static_cast<const T*>(p.b)[idx];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void store_out(void* out, size_t i, float v, int dt) {
  if (dt == ltt::kF32)
    static_cast<float*>(out)[i] = v;
  else if (dt == ltt::kBF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  else
    static_cast<__half*>(out)[i] = __float2half(v);
}

// laser_tpu's epilogue (prepacked.py:112-116) in the fp32 accumulator type:
// alpha * acc, then + beta * C, each product and sum rounded on its own
__device__ __forceinline__ void epilogue(const PackedArgs& p, float acc, int m, int n) {
  if (m >= p.M || n >= p.N) return;
  const size_t i = (size_t)m * p.N + n;
  float r = __fmul_rn(acc, p.alpha);
  if (p.c) r = __fadd_rn(r, __fmul_rn(p.beta, static_cast<const float*>(p.c)[i]));
  store_out(p.out, i, r, p.out_dtype);
}

// ---------------------------------------------------------------------------
// Float types: a CTA of 128 x 128 outputs, 256 threads, a two-stage ring of
// (CM x D) A and (D x CN) B slabs in dynamic shared memory
// ---------------------------------------------------------------------------
constexpr int CM = 128, CN = 128, F_THREADS = 256;

template <typename T>
__host__ __device__ constexpr int pad_of() { return 16 / (int)sizeof(T); }
// the gather route's slab depth: two WMMA steps, or 16 FFMA steps
template <typename T>
__host__ __device__ constexpr int gather_depth() { return sizeof(T) == 2 ? 32 : 16; }

template <typename T>
__host__ __device__ constexpr long long stage_elems(int D) {
  return (long long)CM * (D + pad_of<T>()) + (long long)D * (CN + pad_of<T>());
}

// Stage slab s (k-block s on the blocks route, K rows [s D, s D + D) on the
// gather route) of the CTA's A rows m0.. and B columns n0.. into As / Bs.
template <typename T, bool FAST>
__device__ __forceinline__ void load_stage(const PackedArgs& p, T* As, T* Bs, int D, int s,
                                           int m0, int n0) {
  constexpr int PAD = pad_of<T>(), V = 16 / (int)sizeof(T);
  const int lda = D + PAD, ldb = CN + PAD;
  if (FAST) {
    // the CTA's rows of A block (m0 / bm, s): one run of CM * bk elements
    const int i = m0 / p.bm;
    const T* ga =
        static_cast<const T*>(p.a) + (((size_t)i * p.gk + s) * p.bm + (m0 - i * p.bm)) * p.bk;
    const int per_row = D / V;
    for (int c = threadIdx.x; c < CM * per_row; c += F_THREADS) {
      const int r = c / per_row;
      cp_async16(As + r * lda + (c - r * per_row) * V, ga + (size_t)c * V);
    }
    // B block (s, n0 / bn), columns n0 % bn ..: bk rows of CN (one run when bn == CN)
    const int j = n0 / p.bn;
    const T* gb = static_cast<const T*>(p.b) + ((size_t)s * p.gn + j) * p.bk * p.bn +
                  (n0 - j * p.bn);
    constexpr int per_brow = CN / V;
    for (int c = threadIdx.x; c < D * per_brow; c += F_THREADS) {
      const int k = c / per_brow, nn = (c - k * per_brow) * V;
      cp_async16(Bs + k * ldb + nn, gb + (size_t)k * p.bn + nn);
    }
  } else {
    const int k0 = s * D;
    for (int e = threadIdx.x; e < CM * D; e += F_THREADS) {
      const int r = e / D, kk = e - r * D;
      As[r * lda + kk] = packed_a_at<T>(p, m0 + r, k0 + kk);
    }
    for (int e = threadIdx.x; e < D * CN; e += F_THREADS) {
      const int k = e / CN, nn = e - k * CN;
      Bs[k * ldb + nn] = packed_b_at<T>(p, k0 + k, n0 + nn);
    }
  }
}

// The two-stage ring over the slabs: begin() stages slab 0; at(s) stages
// slab s + 1 into the other buffer, waits for slab s and returns its A slab
// (its B slab follows at + a_elems). The caller multiplies, then syncs the
// block before the next at() overwrites the buffer it read.
template <typename T, bool FAST>
struct Ring {
  int D, slabs;
  long long stage, a_elems;
  T* smem;
  int m0, n0;

  __device__ __forceinline__ Ring(const PackedArgs& p, T* smem_, int m0_, int n0_)
      : D(FAST ? p.bk : gather_depth<T>()),
        slabs(FAST ? p.gk : (p.gk * p.bk + D - 1) / D),
        stage(stage_elems<T>(D)),
        a_elems((long long)CM * (D + pad_of<T>())),
        smem(smem_),
        m0(m0_),
        n0(n0_) {}

  __device__ __forceinline__ void begin(const PackedArgs& p) {
    if (slabs == 0) return;  // K = 0: no blocks
    load_stage<T, FAST>(p, smem, smem + a_elems, D, 0, m0, n0);
    cp_async_commit();
  }

  __device__ __forceinline__ const T* at(const PackedArgs& p, int s) {
    if (s + 1 < slabs) {
      T* nxt = smem + ((s + 1) & 1) * stage;
      load_stage<T, FAST>(p, nxt, nxt + a_elems, D, s + 1, m0, n0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    return smem + (s & 1) * stage;
  }
};

// bf16 / f16 on the tensor cores: 8 warps as 2 x 4, each 64 x 32 outputs
template <typename T, bool FAST>
__global__ void __launch_bounds__(F_THREADS) packed_tc_kernel(PackedArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int m0 = blockIdx.y * CM, n0 = blockIdx.x * CN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  constexpr int PAD = pad_of<T>(), ldb = CN + PAD;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  Ring<T, FAST> ring(p, smem, m0, n0);
  const int lda = ring.D + PAD;
  ring.begin(p);
  for (int s = 0; s < ring.slabs; ++s) {
    const T* As = ring.at(p, s);
    const T* Bs = As + ring.a_elems;
    for (int kk = 0; kk < ring.D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm + i * 16) * lda + kk, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * ldb + wn + j * 16, ldb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // each warp stages one 16 x 16 fragment at a time through its own scratch
  constexpr int LDS = 20;
  float* scratch = reinterpret_cast<float*>(smem_raw) + warp * 16 * LDS;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], LDS, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, cc = e & 15;
        epilogue(p, scratch[r * LDS + cc], m0 + wm + i * 16 + r, n0 + wn + j * 16 + cc);
      }
      __syncwarp();
    }
}

// f32 as FFMA: thread (ty, tx) owns rows ty + 16 i and columns tx * 4 + j,
// 64 + tx * 4 + j (conflict-free float4 reads of B; A rows of the warp's two
// ty values fall in different banks)
template <bool FAST>
__global__ void __launch_bounds__(F_THREADS) packed_f32_kernel(PackedArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int m0 = blockIdx.y * CM, n0 = blockIdx.x * CN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  constexpr int ldb = CN + 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  Ring<float, FAST> ring(p, smem, m0, n0);
  const int lda = ring.D + 4;
  ring.begin(p);
  for (int s = 0; s < ring.slabs; ++s) {
    const float* As = ring.at(p, s);
    const float* Bs = As + ring.a_elems;
    for (int kk = 0; kk < ring.D; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(ty + 16 * i) * lda + kk];
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * ldb + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * ldb + 64 + tx * 4);
      b[0] = b0.x, b[1] = b0.y, b[2] = b0.z, b[3] = b0.w;
      b[4] = b1.x, b[5] = b1.y, b[6] = b1.z, b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      epilogue(p, acc[i][j], m0 + ty + 16 * i, n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4));
}

// ---------------------------------------------------------------------------
// int8: a CTA of 64 x 64 outputs, 4 warps of 32 x 32, WMMA s8 with int32
// accumulators, one 64-deep slab of each operand staged at a time
// ---------------------------------------------------------------------------
constexpr int I8_THREADS = 128;
constexpr int I8_LDC = 64 + 4;

// Gather a 64 x 64 slab into the staged layout of csrc/int8_tile.cuh: A
// K-contiguous (chunk (row, k part)), B not (chunk (k, column part)); byte
// idx of the tile is chunk idx / 16, element idx % 16.
template <bool A_OPERAND>
__device__ __forceinline__ void gather_i8(int8_t* S, const PackedArgs& p, int r0, int k0) {
  namespace i8 = ltt::i8;
  for (int idx = threadIdx.x; idx < i8::kTileBytes; idx += I8_THREADS) {
    const int chunk = idx >> 4, e = idx & 15;
    const int part = chunk / i8::kTile, line = chunk - part * i8::kTile;
    S[idx] = A_OPERAND ? packed_a_at<int8_t>(p, r0 + line, k0 + 16 * part + e)
                       : packed_b_at<int8_t>(p, k0 + line, r0 + 16 * part + e);
  }
}

template <bool FAST>
__global__ void __launch_bounds__(I8_THREADS) packed_i8_kernel(PackedArgs p) {
  namespace i8 = ltt::i8;
  __shared__ __align__(128) int8_t As[i8::kTileBytes];
  __shared__ __align__(128) int8_t Bs[i8::kTileBytes];
  __shared__ __align__(128) int Cs[i8::kTile * I8_LDC];
  const int m0 = blockIdx.y * i8::kTile, n0 = blockIdx.x * i8::kTile;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int8_t* A = static_cast<const int8_t*>(p.a);
  const int8_t* B = static_cast<const int8_t*>(p.b);
  const int i = m0 / p.bm, j = n0 / p.bn;

  i8::FragAcc acc[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) wmma::fill_fragment(acc[a][b], 0);

  const int slabs = (p.gk * p.bk + i8::kTile - 1) / i8::kTile;
  for (int s = 0; s < slabs; ++s) {
    const int k0 = s * i8::kTile;
    if (FAST) {  // bk % 64 == 0: the slab lies in k-block kb, from row kin of it
      const int kb = k0 / p.bk, kin = k0 - kb * p.bk;
      i8::stage_tile<true>(As, A + ((size_t)i * p.gk + kb) * p.bm * p.bk, p.bk, m0 - i * p.bm,
                           p.bm, kin, p.bk, true);
      i8::stage_tile<false>(Bs, B + ((size_t)kb * p.gn + j) * p.bk * p.bn, p.bn, n0 - j * p.bn,
                            p.bn, kin, p.bk, true);
    } else {
      gather_i8<true>(As, p, m0, k0);
      gather_i8<false>(Bs, p, n0, k0);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < i8::kTile / 16; ++ks) {
      i8::FragA<true> fa[2];
      i8::FragB<false> fb[2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
        wmma::load_matrix_sync(fa[a], i8::frag_ptr<true>(As, wm + a * 16, ks), 16);
#pragma unroll
      for (int b = 0; b < 2; ++b)
        wmma::load_matrix_sync(fb[b], i8::frag_ptr<false>(Bs, wn + b * 16, ks), 16);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) wmma::mma_sync(acc[a][b], fa[a], fb[b], acc[a][b]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      wmma::store_matrix_sync(Cs + (wm + a * 16) * I8_LDC + wn + b * 16, acc[a][b], I8_LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < i8::kTile * i8::kTile; e += I8_THREADS) {
    const int r = e / i8::kTile, cc = e % i8::kTile;
    const int gm = m0 + r, gn = n0 + cc;
    if (gm >= p.M || gn >= p.N) continue;
    const size_t o = (size_t)gm * p.N + gn;
    // alpha * acc + beta * C mod 2^32 (uint32: signed overflow is undefined)
    uint32_t v = (uint32_t)Cs[r * I8_LDC + cc] * (uint32_t)p.alpha_i;
    if (p.c) v += (uint32_t)p.beta_i * (uint32_t)static_cast<const int*>(p.c)[o];
    static_cast<int*>(p.out)[o] = (int)v;
  }
}

// epilogue() on 4 neighbouring outputs (row < M, col < N, col a multiple
// of 4), stored as one vector where the row holds all four and they are
// aligned
__device__ __forceinline__ void store4_epilogue(const PackedArgs& p, int row, int col,
                                                float4 v) {
  const size_t i = (size_t)row * p.N + col;
  float r[4] = {v.x, v.y, v.z, v.w};
  const int n = min(4, p.N - col);
  const float* cm = static_cast<const float*>(p.c);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    r[e] = __fmul_rn(r[e], p.alpha);
    if (cm && e < n) r[e] = __fadd_rn(r[e], __fmul_rn(p.beta, cm[i + e]));
  }
  if (n == 4 && (p.N & 3) == 0) {
    if (p.out_dtype == ltt::kF32) {
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + i) =
          make_float4(r[0], r[1], r[2], r[3]);
    } else if (p.out_dtype == ltt::kBF16) {
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + i);
      o[0] = __floats2bfloat162_rn(r[0], r[1]);
      o[1] = __floats2bfloat162_rn(r[2], r[3]);
    } else {
      __half2* o = reinterpret_cast<__half2*>(static_cast<__half*>(p.out) + i);
      o[0] = __floats2half2_rn(r[0], r[1]);
      o[1] = __floats2half2_rn(r[2], r[3]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) store_out(p.out, i + e, r[e], p.out_dtype);
  }
}

// ---------------------------------------------------------------------------
// bf16 / f16 on Hopper: the wgmma + TMA skeleton over the packed blocks
// ---------------------------------------------------------------------------

// The skeleton's tile policy: a (tile, k step) reads A block (m0 / bm, k0 /
// bk) at (k0 % bk, m0 % bm) and the two 64-wide halves of B block (k0 / bk,
// n0 / bn) at (n0 % bn (+ 64), k0 % bk); the epilogue is laser_tpu's.
struct PackedTiles : hp::OneSegment {
  PackedArgs p;
  int M, N;

  __device__ __forceinline__ void load(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                       uint8_t* a_tile, uint8_t* b_tile, uint64_t* bar,
                                       const hp::TileCoord& c, int kt) const {
    const int k0 = kt * hp::WG_BK;
    const int kb = k0 / p.bk, kin = k0 - kb * p.bk;
    const int i = c.m0 / p.bm, j = c.n0 / p.bn;
    hp::tma_load_3d(a_tile, map_a, bar, kin, c.m0 - i * p.bm, i * p.gk + kb);
    const int nin = c.n0 - j * p.bn, zb = kb * p.gn + j;
    hp::tma_load_3d(b_tile, map_b, bar, nin, kin, zb);
    hp::tma_load_3d(b_tile + hp::WG_HALF_BYTES, map_b, bar, nin + 64, kin, zb);
  }

  __device__ __forceinline__ void store4(const hp::TileCoord&, int, int row, int col,
                                         float4 v) const {
    store4_epilogue(p, row, col, v);
  }
};

template <typename T>
__global__ void __launch_bounds__(hp::WG_THREADS, hp::WG_BLOCKS_PER_SM)
    packed_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b, const PackedTiles tiles,
                        int ntiles) {
  hp::wgmma_gemm<T, false, false>(&map_a, &map_b, tiles, ntiles);
}

bool wgmma_fits(const PackedArgs& p, int in_dtype) {
  return (in_dtype == ltt::kBF16 || in_dtype == ltt::kF16) && p.M > 0 && p.N > 0 && p.gk > 0 &&
         p.bm % hp::WG_BM == 0 && p.bn % hp::WG_BN == 0 && p.bk % hp::WG_BK == 0 &&
         hp::aligned16(p.a) && hp::aligned16(p.b) &&
         (p.out_dtype == ltt::kF32 || p.out_dtype == ltt::kBF16 || p.out_dtype == ltt::kF16);
}

template <typename T>
int launch_wgmma(const PackedArgs& p, int in_dtype, cudaStream_t s) {
  CUtensorMap ma, mb;
  if (!hp::encode_map(&ma, p.a, in_dtype, p.bk, p.bm, (uint64_t)p.gm * p.gk, hp::WG_BK,
                      hp::WG_BM) ||
      !hp::encode_map(&mb, p.b, in_dtype, p.bn, p.bk, (uint64_t)p.gk * p.gn, 64, hp::WG_BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = ltt::allow_smem(packed_wgmma_kernel<T>, hp::WG_SMEM_BYTES);
  if (err) return err;
  const long long tiles =
      (long long)((p.M + hp::WG_BM - 1) / hp::WG_BM) * ((p.N + hp::WG_BN - 1) / hp::WG_BN);
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int ntiles = static_cast<int>(tiles);
  const int slots = hp::sm_count() * hp::WG_BLOCKS_PER_SM;
  const PackedTiles pol{{p.gk * (p.bk / hp::WG_BK)}, p, p.M, p.N};
  packed_wgmma_kernel<T><<<ntiles > slots ? slots : ntiles, hp::WG_THREADS, hp::WG_SMEM_BYTES,
                           s>>>(ma, mb, pol, ntiles);
  return ltt::launch_status();
}

// ---------------------------------------------------------------------------
// int8 on Hopper: the int8 wgmma skeleton over packed A and B's K-major twin
// ---------------------------------------------------------------------------

// The int8 epilogue of packed_i8_kernel on 4 neighbouring outputs (row < M,
// col < N, col a multiple of 4): alpha * acc + beta * C mod 2^32, one
// 16-byte store where the row holds all four.
__device__ __forceinline__ void store4_i8(const PackedArgs& p, int row, int col, int4 v) {
  const size_t i = (size_t)row * p.N + col;
  const int r[4] = {v.x, v.y, v.z, v.w};
  const int n = min(4, p.N - col);
  const int* cm = static_cast<const int*>(p.c);
  int o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t u = (uint32_t)r[e] * (uint32_t)p.alpha_i;
    if (cm && e < n) u += (uint32_t)p.beta_i * (uint32_t)cm[i + e];
    o[e] = (int)u;
  }
  int* out = static_cast<int*>(p.out);
  if (n == 4 && (p.N & 3) == 0) {
    *reinterpret_cast<int4*>(out + i) = make_int4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) out[i + e] = o[e];
  }
}

// The skeleton's tile policy: a (tile, k step) reads A block (m0 / bm, k0 /
// bk) at (k0 % bk, m0 % bm) and twin block (k0 / bk, n0 / bn) at (k0 % bk,
// n0 % bn), each a 128 x 128-byte box.
struct PackedI8Tiles : hp::OneSegment {
  PackedArgs p;
  int M, N;

  __device__ __forceinline__ void load(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                       uint8_t* a_tile, uint8_t* b_tile, uint64_t* bar,
                                       const hp::TileCoord& c, int kt) const {
    const int k0 = kt * hp::WG_BK_I8;
    const int kb = k0 / p.bk, kin = k0 - kb * p.bk;
    const int i = c.m0 / p.bm, j = c.n0 / p.bn;
    hp::tma_load_3d(a_tile, map_a, bar, kin, c.m0 - i * p.bm, i * p.gk + kb);
    hp::tma_load_3d(b_tile, map_b, bar, kin, c.n0 - j * p.bn, kb * p.gn + j);
  }

  __device__ __forceinline__ void store4(const hp::TileCoord&, int, int row, int col,
                                         int4 v) const {
    store4_i8(p, row, col, v);
  }
};

__global__ void __launch_bounds__(hp::WG_THREADS, hp::WG_BLOCKS_PER_SM)
    packed_i8_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b, const PackedI8Tiles tiles,
                           int ntiles) {
  hp::wgmma_gemm<int8_t, false, true>(&map_a, &map_b, tiles, ntiles);
}

bool wgmma_i8_fits(const PackedArgs& p, int in_dtype, const void* bt) {
  return in_dtype == ltt::kI8 && p.out_dtype == ltt::kI32 && bt != nullptr && p.M > 0 &&
         p.N > 0 && p.gk > 0 && p.bm % hp::WG_BM == 0 && p.bn % hp::WG_BN == 0 &&
         p.bk % hp::WG_BK_I8 == 0 && hp::aligned16(p.a) && hp::aligned16(bt);
}

// bt: B's K-major twin, (gk, gn, bn, bk)
int launch_i8_wgmma(const PackedArgs& p, const void* bt, cudaStream_t s) {
  CUtensorMap ma, mb;
  if (!hp::encode_map_i8(&ma, p.a, p.bk, p.bm, (uint64_t)p.gm * p.gk, hp::WG_BM) ||
      !hp::encode_map_i8(&mb, bt, p.bk, p.bn, (uint64_t)p.gk * p.gn, hp::WG_BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = ltt::allow_smem(packed_i8_wgmma_kernel, hp::WG_SMEM_BYTES);
  if (err) return err;
  const long long tiles =
      (long long)((p.M + hp::WG_BM - 1) / hp::WG_BM) * ((p.N + hp::WG_BN - 1) / hp::WG_BN);
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int ntiles = static_cast<int>(tiles);
  const int slots = hp::sm_count() * hp::WG_BLOCKS_PER_SM;
  const PackedI8Tiles pol{{p.gk * (p.bk / hp::WG_BK_I8)}, p, p.M, p.N};
  packed_i8_wgmma_kernel<<<ntiles > slots ? slots : ntiles, hp::WG_THREADS, hp::WG_SMEM_BYTES,
                           s>>>(ma, mb, pol, ntiles);
  return ltt::launch_status();
}

// ---------------------------------------------------------------------------
// f32 on the simt skeleton (csrc/simt_gemm.cuh) over the packed blocks
// ---------------------------------------------------------------------------

// The skeleton's tile policy: slab kt (k0 = 16 kt) of the tile at (m0, n0)
// reads rows m0 % bm .. + 127 of A block (m0 / bm, k0 / bk) at columns k0 %
// bk .. + 15 (k-minor) and rows k0 % bk .. + 15 of B block (k0 / bk, n0 /
// bn) at columns n0 % bn .. + 127 (k-major); all inside the padded blocks.
struct SimtPacked {
  static constexpr bool kAKMajor = false, kBKMajor = true;
  PackedArgs p;
  int M, N, ktiles;
  const float* a0;  // the tile's first row in A block (m0 / bm, 0)
  const float* b0;  // its first column in B block (0, n0 / bn)

  __device__ __forceinline__ const float* a(int kt, int x, int y, bool& ok) const {
    const int k0 = kt * simt::kBK, kb = k0 / p.bk;
    ok = true;
    return a0 + (size_t)kb * p.bm * p.bk + x * p.bk + (k0 - kb * p.bk) + y;
  }

  __device__ __forceinline__ const float* b(int kt, int x, int y, bool& ok) const {
    const int k0 = kt * simt::kBK, kb = k0 / p.bk;
    ok = true;
    return b0 + (size_t)kb * p.gn * p.bk * p.bn + (k0 - kb * p.bk + x) * p.bn + y;
  }

  __device__ __forceinline__ void store4(int row, int col, float4 v) const {
    store4_epilogue(p, row, col, v);
  }
};

__global__ void __launch_bounds__(simt::kThreads, simt::kBlocksPerSm)
    packed_simt_kernel(const PackedArgs p) {
  extern __shared__ __align__(16) float simt_smem[];
  const int m0 = blockIdx.y * simt::kBM, n0 = blockIdx.x * simt::kBN;
  const int i = m0 / p.bm, j = n0 / p.bn;
  const float* a0 =
      static_cast<const float*>(p.a) + ((size_t)i * p.gk * p.bm + m0 - i * p.bm) * p.bk;
  const float* b0 = static_cast<const float*>(p.b) + (size_t)j * p.bk * p.bn + n0 - j * p.bn;
  const SimtPacked t{p, p.M, p.N, p.gk * (p.bk / simt::kBK), a0, b0};
  simt::gemm_tile(t, m0, n0, simt_smem);
}

bool simt_fits(const PackedArgs& p, int in_dtype) {
  return in_dtype == ltt::kF32 && p.M > 0 && p.N > 0 && p.bm % simt::kBM == 0 &&
         p.bn % simt::kBN == 0 && p.bk % simt::kBK == 0 && hp::aligned16(p.a) &&
         hp::aligned16(p.b) &&
         (p.out_dtype == ltt::kF32 || p.out_dtype == ltt::kBF16 || p.out_dtype == ltt::kF16);
}

int launch_simt(const PackedArgs& p, cudaStream_t s) {
  const int err = ltt::allow_smem(packed_simt_kernel, simt::kSmemBytes);
  if (err) return err;
  dim3 grid((p.N + simt::kBN - 1) / simt::kBN, (p.M + simt::kBM - 1) / simt::kBM);
  packed_simt_kernel<<<grid, simt::kThreads, simt::kSmemBytes, s>>>(p);
  return ltt::launch_status();
}

constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can opt into

template <typename T>
size_t smem_bytes(int D) {
  return (size_t)(2 * stage_elems<T>(D)) * sizeof(T);
}

template <typename T, typename K>
int launch_float(K kernel, const PackedArgs& p, int fast, cudaStream_t s) {
  const size_t bytes = smem_bytes<T>(fast ? p.bk : gather_depth<T>());
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int st = ltt::allow_smem(kernel, bytes);
  if (st) return st;
  dim3 grid((p.N + CN - 1) / CN, (p.M + CM - 1) / CM);
  kernel<<<grid, F_THREADS, bytes, s>>>(p);
  return ltt::launch_status();
}

bool blocks_route_ok(const PackedArgs& p, int cm, int cn, int kalign) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p.a), b = reinterpret_cast<uintptr_t>(p.b);
  return p.bm % cm == 0 && p.bn % cn == 0 && p.bk % kalign == 0 && a % 16 == 0 && b % 16 == 0;
}

}  // namespace

// a: (gm, gk, bm, bk) and b: (gk, gn, bk, bn), contiguous, of in_dtype (f32,
// bf16, f16 or int8); bt: B's K-major twin (gk, gn, bn, bk), int8 only, or
// null; c: (M, N) fp32 (int32 for int8) or null; out: (M, N) in out_dtype
// (f32/bf16/f16 for float inputs, int32 for int8). alpha and beta: the
// int32 values for int8 inputs. route: 0 picks (wgmma where wgmma_fits or
// wgmma_i8_fits, simt where simt_fits, else classic), 1 the classic
// kernels, 2 wgmma (int8: packed_i8_wgmma_kernel), 3 simt; *taken gets the
// route that launched. fast, for the classic kernels: the blocks route (bm
// and bn multiples of the CTA tile, bk of the k alignment, both pointers
// 16-byte aligned, two stages of bk-deep slabs within 227 KB), else the
// gather route.
LTT_API int ltt_gemm_packed(const void* a, const void* b, const void* bt, const void* c,
                            void* out, int M, int N, int gm, int gn, int gk, int bm, int bn,
                            int bk, double alpha, double beta, int in_dtype, int out_dtype,
                            int fast, int route, int* taken, void* stream) {
  PackedArgs p = {a, b, c, out, M, N, gm, gn, gk, bm, bn, bk,
                  static_cast<float>(alpha), static_cast<float>(beta), 0, 0, out_dtype};
  if (in_dtype == ltt::kI8) {
    p.alpha_i = static_cast<int>(alpha);  // int32 values, exact in a double
    p.beta_i = static_cast<int>(beta);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wg8 = wgmma_i8_fits(p, in_dtype, bt);
  const bool wg = wg8 || wgmma_fits(p, in_dtype), sm = simt_fits(p, in_dtype);
  *taken = route == kRouteAuto ? (wg ? kRouteWgmma : sm ? kRouteSimt : kRouteClassic)
           : route == kRouteClassic ? kRouteClassic
           : route == kRouteWgmma && wg ? kRouteWgmma
           : route == kRouteSimt && sm  ? kRouteSimt
                                        : -1;
  if (*taken < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (*taken == kRouteWgmma && wg8) return launch_i8_wgmma(p, bt, s);
  if (*taken == kRouteWgmma)
    return in_dtype == ltt::kBF16 ? launch_wgmma<__nv_bfloat16>(p, in_dtype, s)
                                  : launch_wgmma<__half>(p, in_dtype, s);
  if (*taken == kRouteSimt) return launch_simt(p, s);
  if (in_dtype == ltt::kI8) {
    if (out_dtype != ltt::kI32) return static_cast<int>(cudaErrorInvalidValue);
    if (fast && !blocks_route_ok(p, ltt::i8::kTile, ltt::i8::kTile, ltt::i8::kTile))
      return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((N + ltt::i8::kTile - 1) / ltt::i8::kTile, (M + ltt::i8::kTile - 1) / ltt::i8::kTile);
    if (fast)
      packed_i8_kernel<true><<<grid, I8_THREADS, 0, s>>>(p);
    else
      packed_i8_kernel<false><<<grid, I8_THREADS, 0, s>>>(p);
    return ltt::launch_status();
  }
  if (out_dtype != ltt::kF32 && out_dtype != ltt::kBF16 && out_dtype != ltt::kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  // k alignment of the blocks route: a 16-byte copy per row chunk, and 16
  // deep WMMA steps for the 16-bit types
  if (fast && !blocks_route_ok(p, CM, CN, in_dtype == ltt::kF32 ? 4 : 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == ltt::kF32)
    return fast ? launch_float<float>(packed_f32_kernel<true>, p, 1, s)
                : launch_float<float>(packed_f32_kernel<false>, p, 0, s);
  if (in_dtype == ltt::kBF16)
    return fast ? launch_float<__nv_bfloat16>(packed_tc_kernel<__nv_bfloat16, true>, p, 1, s)
                : launch_float<__nv_bfloat16>(packed_tc_kernel<__nv_bfloat16, false>, p, 0, s);
  if (in_dtype == ltt::kF16)
    return fast ? launch_float<__half>(packed_tc_kernel<__half, true>, p, 1, s)
                : launch_float<__half>(packed_tc_kernel<__half, false>, p, 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
