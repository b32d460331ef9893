// int8 operand tiles for the tensor cores (WMMA s8 16x16x16 with int32
// accumulators), shared by csrc/gemm.cu (the int8 GEMM) and
// csrc/limb_gemm.cu (the digit-plane GEMMs).
//
// A 64 x 64 tile of an int8 operand (64 rows or columns by a 64-deep slab
// of K) is staged in shared memory as 256 chunks of 16 bytes, laid out so
// that every 16 x 16 sub-block the fragments read is 256 contiguous bytes:
// 32-byte aligned with ldm = 16, as wmma::load_matrix_sync requires (a
// plain row-major tile would put the second 16-deep step 16 bytes off that
// alignment). Each chunk is one aligned 16-byte global load where the
// operand allows it (contiguous extent a multiple of 16, base aligned),
// else 16 masked byte loads. Out-of-range rows and K lanes load as 0 on
// both operands, so tails need no other masking.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace ltt {
namespace i8 {

using namespace nvcuda;

constexpr int kTile = 64;                   // the int8 GEMM's tile edge and K depth
constexpr int kTileBytes = kTile * kTile;   // 4096

// Stage an operand tile of LINES x (16 PARTS) bytes into S (16-byte aligned).
// KCONTIG: the operand is G[r * ld + k] (the contraction index contiguous):
//   LINES rows r0.. by a K slab k0..k0 + 16 PARTS; chunk (r, kc) holds k in
//   [k0 + 16 kc, +16) of row r0 + r, at S[(kc * LINES + r) * 16].
// else:    G[k * ld + r]: LINES rows k0.. of K by 16 PARTS columns r0..;
//   chunk (k, rc) holds r in [r0 + 16 rc, +16) of row k0 + k, at
//   S[(rc * LINES + k) * 16].
// R and K bound the operand; vec: an in-range chunk is one aligned load.
template <bool KCONTIG, int LINES = kTile, int PARTS = kTile / 16>
__device__ __forceinline__ void stage_tile(int8_t* __restrict__ S, const int8_t* __restrict__ G,
                                           int ld, int r0, int R, int k0, int K, bool vec) {
  const int slim = KCONTIG ? R : K;  // bound of the strided index
  const int clim = KCONTIG ? K : R;  // bound of the contiguous index
  for (int c = threadIdx.x; c < LINES * PARTS; c += blockDim.x) {
    const int line = c / PARTS;
    const int part = c % PARTS;
    const int s = (KCONTIG ? r0 : k0) + line;
    const int c0 = (KCONTIG ? k0 : r0) + 16 * part;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (s < slim && c0 < clim) {
      const int8_t* src = G + (size_t)s * ld + c0;
      if (vec && c0 + 16 <= clim) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (c0 + e < clim) w[e >> 2] |= (uint32_t)(uint8_t)src[e] << (8 * (e & 3));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(S + (part * LINES + line) * 16) = v;
  }
}

// The 16 x 16 sub-block of a staged tile at row (or column) r (a multiple of
// 16) and 16-deep step ks; ldm is 16 in both layouts.
template <bool KCONTIG, int LINES = kTile>
__device__ __forceinline__ const signed char* frag_ptr(const int8_t* S, int r, int ks) {
  return reinterpret_cast<const signed char*>(
      KCONTIG ? S + (ks * LINES + r) * 16 : S + ((r >> 4) * LINES + ks * 16) * 16);
}

// A (M x K) staged K-contiguous reads row-major, else column-major; B (K x N)
// staged K-contiguous (B transposed) reads column-major, else row-major.
template <bool KCONTIG>
using a_layout = std::conditional_t<KCONTIG, wmma::row_major, wmma::col_major>;
template <bool KCONTIG>
using b_layout = std::conditional_t<KCONTIG, wmma::col_major, wmma::row_major>;

template <bool KCONTIG>
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, a_layout<KCONTIG>>;
template <bool KCONTIG>
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, b_layout<KCONTIG>>;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

}  // namespace i8
}  // namespace ltt
