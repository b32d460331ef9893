// Hopper building blocks shared by the GEMM kernels (csrc/gemm.cu,
// csrc/w4_gemm.cu and the split-K skeleton in csrc/splitk.cuh), the
// flash kernels (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu) and
// the paged attention split kernel (csrc/paged_split.cuh):
// cp.async, ldmatrix and mma.sync m16n8k16, swizzled 16-bit tiles;
// mbarriers, TMA tensor maps and loads,
// wgmma m64n128k16 (16-bit) and m64n128k32 (int8) with their shared-memory
// descriptors, and the tile walk of the persistent wgmma kernels.
// Everything here is inline: each including source gets its own copy of
// the device code.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through cudart

#include <type_traits>

#include "common.cuh"

namespace ltt {
namespace hp {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// cp.async, ldmatrix, mma.sync
// ---------------------------------------------------------------------------

// 16 bytes from src into shared memory at dst; zeros when !valid (src is
// then not read, but must still be a mapped address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes through L1 (the paged kernels' per-key scales); zeros when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 16, row) b (16 x 8, col), fp32 accumulators. Fragments
// (lane t, g = t / 4, q = t % 4): a0a1 (row g, k 2q, 2q+1), a2a3 (row g + 8),
// a4a5 (row g, k + 8), a6a7 (row g + 8, k + 8); b0b1 (k 2q, 2q+1, column g),
// b2b3 (k + 8); c0c1 (row g, columns 2q, 2q+1), c2c3 (row g + 8)
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two floats rounded (to nearest) to T, the first in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

// ---------------------------------------------------------------------------
// Swizzled [rows][D] tiles of 16-bit elements (the flash kernels)
// ---------------------------------------------------------------------------

// element offset of 16-byte chunk c of row r: the chunk index XOR the row's
// low 3 bits, so ldmatrix's eight row reads at one chunk column fall in
// eight distinct bank groups
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

// rows [row0, row0 + ROWS) of a (S, D) row-major matrix into a swizzled
// tile by cp.async over THREADS threads; rows at or past S are zero-filled
// (0 * garbage could be NaN in a product), their source clamped to row S - 1
template <typename T, int D, int ROWS, int THREADS>
__device__ __forceinline__ void cp_async_tile(T* dst, const T* __restrict__ src, int row0,
                                              int S) {
  static_assert(sizeof(T) == 2 && ROWS * (D / 8) % THREADS == 0, "16-bit rows, whole chunks");
  constexpr int CH = D / 8;
#pragma unroll
  for (int it = 0; it < ROWS * CH / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / CH, c = i % CH;
    const int gr = row0 + r;
    cp_async16(smem_u32(dst + swz<D>(r, c)), src + (size_t)min(gr, S - 1) * D + c * 8, gr < S);
  }
}

// ---------------------------------------------------------------------------
// int4 dequantization (laser_tpu's layout: csrc/w4_gemm.cu's note)
// ---------------------------------------------------------------------------

// The 8 signed nibbles of the packed word w (bytes j = 0..3, each a column's
// two k rows) as exact floats: lo[j] the low nibble of byte j, hi[j] the
// high one. Each is 2^23 + (u ^ 8) built in a float's bits (one byte
// permute puts the byte under the exponent 0x4B) less 2^23 + 8, which is
// ((u ^ 8) - 8), the nibble's sign extension. 1.4 integer operations a
// weight (the integer pipe runs at half the fp32 rate) and no
// integer-to-float conversion (a quarter-rate instruction).
__device__ __forceinline__ void nibbles8(uint32_t w, float (&lo)[4], float (&hi)[4]) {
  const uint32_t l = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t h = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo[j] = __int_as_float(__byte_perm(l, 0x4B000000u, 0x7440u + j)) - 8388616.f;
    hi[j] = __int_as_float(__byte_perm(h, 0x4B000000u, 0x7440u + j)) - 8388616.f;
  }
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// generic-proxy writes to shared memory made visible to the async proxy
// (wgmma's operand reads, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// one box of a 3-D tensor map (coordinates innermost first) into shared
// memory; the bytes complete on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma on 128-byte-swizzled tiles, and the persistent tile walk
// ---------------------------------------------------------------------------
// A stage's operand tile is 128 rows (or k rows) of 128 bytes: k 64 of a
// 16-bit type (WG_BK), k 128 of int8 (WG_BK_I8); each instruction takes 32
// bytes of K (k16 of a 16-bit type, k32 of int8)
constexpr int WG_BM = 128, WG_BN = 128, WG_BK = 64, WG_BK_I8 = 128;
constexpr int WG_CONSUMERS = 2;           // warpgroups, 64 rows each
constexpr int WG_HALF_BYTES = 64 * 128;   // one 64-wide MN-major box: 64 K-rows of 128 bytes
// tile rows walked together before the next column of tiles (L2 reuse)
constexpr int WG_GROUP_M = 8;

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each >> 4 (PTX ISA, "matrix descriptor")
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

// K-major (K contiguous, 128-byte rows): rows at 128 B, 8-row groups at 1024
// B (SBO); a 32-byte k step (k16 16-bit, k32 int8) is +32 B within the
// swizzled row. MN-major (16-bit only; 64
// M or N values a 128-byte row, one row a k): 8-k groups at 1024 B (SBO),
// 64-wide MN blocks at WG_HALF_BYTES (LBO); the k16 step is +2048 B.
template <bool KMAJOR>
__device__ __forceinline__ uint64_t operand_desc(uint32_t tile, int kk) {
  return KMAJOR ? wg_desc(tile + kk * 32, 16, 1024)
                : wg_desc(tile + kk * 2048, WG_HALF_BYTES, 1024);
}

// Byte offset of 16-byte chunk `chunk` (8 values) of k-row `k` in an
// MN-major 128-byte-swizzled tile of two 64-wide halves (the layout TMA
// writes for B not transposed, and the one operand_desc<false> reads):
// half `half` at WG_HALF_BYTES, rows of 128 bytes, the chunk index XOR the
// row's low three bits.
__device__ __forceinline__ int mn_major_chunk(int half, int k, int chunk) {
  return half * WG_HALF_BYTES + k * 128 + ((chunk ^ (k & 7)) << 4);
}

__device__ __forceinline__ void acc_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void acc_fence(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define LTT_WGMMA_M64N128K16(TY)                                                                    \
  asm volatile(                                                                                     \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                                  \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                                 \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                                            \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                                      \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                                    \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                                                    \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                                                    \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                                                    \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                                                    \
      "%56, %57, %58, %59, %60, %61, %62, %63"                                                      \
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"                                                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),     \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),  \
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),  \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),  \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),  \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),  \
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),  \
        "+f"(d[63])                                                                                 \
      : "l"(da), "l"(db), "r"(1), "n"(TA ? 1 : 0), "n"(TB ? 0 : 1))

// d += A (64 x 16) B (16 x 128). The transpose bits: 0 reads an operand
// K-major, 1 MN-major; A is K-major unless TA, B is K-major only if TB.
template <typename T, bool TA, bool TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<T, __half>::value) {
    LTT_WGMMA_M64N128K16("f16");
  } else {
    LTT_WGMMA_M64N128K16("bf16");
  }
}
#undef LTT_WGMMA_M64N128K16

// d += A (64 x 32) B (32 x 128) of int8, int32 accumulators, both operands
// K-major (the only layout the 8-bit forms read from shared memory). No
// .satfinite: the sum wraps mod 2^32, as the classic int8 kernels' does.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// One 32-byte k step of the skeleton's product in T's form: k16 of a 16-bit
// type (fp32 accumulators), k32 of int8 (int32 accumulators).
template <typename T, bool TA, bool TB, typename Acc>
__device__ __forceinline__ void wgmma_k32b(Acc (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<T, int8_t>::value) {
    static_assert(!TA && TB, "the 8-bit forms read both operands K-major");
    wgmma_m64n128k32_s8(d, da, db);
  } else {
    wgmma_m64n128k16<T, TA, TB>(d, da, db);
  }
}

// Output tile t of the grid's walk: (row, column, batch entry) origin.
// Tiles go WG_GROUP_M rows at a time down each column of tiles, so a wave
// of blocks shares its B columns and A rows in L2.
struct TileCoord {
  int m0, n0, z;
};

__device__ __forceinline__ TileCoord tile_coord(int t, int M, int N) {
  const int tiles_m = (M + WG_BM - 1) / WG_BM, tiles_n = (N + WG_BN - 1) / WG_BN;
  const int per_z = tiles_m * tiles_n;
  const int z = t / per_z, r = t % per_z;
  const int group = r / (WG_GROUP_M * tiles_n);
  const int first_m = group * WG_GROUP_M;
  const int rows = min(tiles_m - first_m, WG_GROUP_M);
  const int in_group = r % (WG_GROUP_M * tiles_n);
  return {(first_m + in_group % rows) * WG_BM, (in_group / rows) * WG_BN, z};
}

// The consumer warpgroups' named barrier (no other warp joins it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(WG_CONSUMERS * 128) : "memory");
}

// Element (r, c) of a 128 x 64 fp32 staging tile: rows of 64 floats, 8-float
// groups XORed with the row's low two bits, so the accumulator layout's
// stores (8 rows x 8 floats a warp) hit 2 rows a bank, not 8.
__device__ __forceinline__ int staged(int r, int c) { return r * 64 + (c ^ ((r & 3) << 3)); }

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: fetch it through
// the runtime's entry-point lookup (no -lcuda on the link line)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// A row-major (batch, outer, inner) tensor of `elem` bytes an element as a
// 3-D tensor map with (box_inner, box_outer, 1) boxes, zero fill out of
// range. Row strides must be multiples of 16 bytes and the base 16-byte
// aligned (the caller checks).
inline bool encode_tiled(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem,
                         uint64_t inner, uint64_t outer, uint64_t batch, uint32_t box_inner,
                         uint32_t box_outer, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {inner, outer, batch};
  const cuuint64_t strides[2] = {inner * elem, inner * outer * elem};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {box_inner, box_outer, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 16-bit (batch, outer, inner) matrix, 128-byte swizzle (the wgmma tiles).
inline bool encode_map(CUtensorMap* map, const void* base, int dtype, uint64_t inner,
                       uint64_t outer, uint64_t batch, uint32_t box_inner, uint32_t box_outer) {
  return encode_tiled(map, base,
                      dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                      2, inner, outer, batch, box_inner, box_outer, CU_TENSOR_MAP_SWIZZLE_128B);
}

// An int8 (batch, outer, inner) matrix, 128-byte swizzle: the int8 wgmma
// tiles, 128 bytes (k 128) by box_outer rows.
inline bool encode_map_i8(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
                          uint64_t batch, uint32_t box_outer) {
  return encode_tiled(map, base, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, inner, outer, batch, 128,
                      box_outer, CU_TENSOR_MAP_SWIZZLE_128B);
}

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace hp
}  // namespace ltt
