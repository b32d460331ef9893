// Transposes: (B, R, C) -> (B, C, R) out of place, and a square (N, N) in
// place. Both move raw elements, templated on the element size (1, 2, 4 or
// 8 bytes), so every dtype goes through them and the result is bit-exact.
//
// transpose_kernel replaces laser_tpu/ops/transpose.py:42 _build_transpose
// (pallas_call at :47), which transpose2d, transpose2d_batched, nchw2nhwc
// and nhwc2nchw reach. transpose_inplace_kernel replaces both in-place
// kernels: :94 _build_inplace_transpose (pallas_call at :138, serialized
// DMA) and :151 _build_inplace_transpose_pipelined (at :271, double-buffered
// manual DMA), which transpose2d(x, donate=True) reaches.
//
// What bounds them on the H100: bytes. Each element is read once and
// written once (8192^2 f32: 512 MB, 160 us at 3.35 TB/s); there is no
// arithmetic.
//
// Design. The TPU kernels move (256, 256) or (512, 512) VMEM tiles and swap
// them on the VPU. Here a block of 32 x 8 threads moves 32 x 32 tiles
// through shared memory, each row padded by one element so that the
// column-wise reads of the transposed write hit 32 different banks:
// - out of place, one block per (tile_r, tile_c, b): coalesced reads of a
//   tile's rows, __syncthreads, coalesced writes of the transposed tile's
//   rows; ragged edges are masked. Grid dims past the launch limits loop.
// - in place, one block per tile pair (r, c) with r <= c on a 2-D grid
//   (blocks with r > c exit at once): it loads tile (r, c) and tile (c, r)
//   into shared memory, __syncthreads, then writes each transposed into the
//   other's place. A diagonal tile is loaded once and stored once, as in
//   laser_tpu's pipelined kernel (transpose.py:162-166). Each block owns
//   its pair, so no two blocks touch the same element. The overlap of loads
//   and stores that the pipelined TPU kernel builds by hand comes on Hopper
//   from the many blocks resident on each SM, so this one kernel covers
//   both TPU in-place kernels.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // thread rows: each thread moves kTile / kRows elements
constexpr int64_t kMaxGridYZ = 65535;

template <typename T>
__global__ void __launch_bounds__(kTile * kRows)
    transpose_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t B, int64_t R,
                     int64_t C) {
  __shared__ T tile[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t tiles_r = (R + kTile - 1) / kTile, tiles_c = (C + kTile - 1) / kTile;
  for (int64_t b = blockIdx.z; b < B; b += gridDim.z) {
    const T* xb = x + b * R * C;
    T* yb = y + b * R * C;
    for (int64_t tr = blockIdx.y; tr < tiles_r; tr += gridDim.y) {
      for (int64_t tc = blockIdx.x; tc < tiles_c; tc += gridDim.x) {
        const int64_t r0 = tr * kTile, c0 = tc * kTile;
#pragma unroll
        for (int i = ty; i < kTile; i += kRows) {
          const int64_t r = r0 + i, c = c0 + tx;
          if (r < R && c < C) tile[i][tx] = xb[r * C + c];
        }
        __syncthreads();
#pragma unroll
        for (int i = ty; i < kTile; i += kRows) {
          const int64_t c = c0 + i, r = r0 + tx;
          if (c < C && r < R) yb[c * R + r] = tile[tx][i];
        }
        __syncthreads();  // the tile is reused by the next iteration
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kTile * kRows) transpose_inplace_kernel(T* x, int64_t N) {
  __shared__ T a[kTile][kTile + 1];
  __shared__ T b[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t nt = (N + kTile - 1) / kTile;
  for (int64_t r = blockIdx.y; r < nt; r += gridDim.y) {
    for (int64_t c = blockIdx.x; c < nt; c += gridDim.x) {
      if (r > c) continue;  // the pair (c, r) is this one's mirror
      const int64_t r0 = r * kTile, c0 = c * kTile;
      const bool diag = r == c;
      // a = x[r0 + i, c0 + j], b = x[c0 + i, r0 + j]
#pragma unroll
      for (int i = ty; i < kTile; i += kRows) {
        if (r0 + i < N && c0 + tx < N) a[i][tx] = x[(r0 + i) * N + c0 + tx];
        if (!diag && c0 + i < N && r0 + tx < N) b[i][tx] = x[(c0 + i) * N + r0 + tx];
      }
      __syncthreads();
      // y[c0 + i, r0 + j] = a[j][i]; off the diagonal y[r0 + i, c0 + j] = b[j][i]
#pragma unroll
      for (int i = ty; i < kTile; i += kRows) {
        if (c0 + i < N && r0 + tx < N) x[(c0 + i) * N + r0 + tx] = a[tx][i];
        if (!diag && r0 + i < N && c0 + tx < N) x[(r0 + i) * N + c0 + tx] = b[tx][i];
      }
      __syncthreads();
    }
  }
}

template <typename T>
int launch(const void* x, void* y, int64_t B, int64_t R, int64_t C, cudaStream_t s) {
  const int64_t tiles_r = (R + kTile - 1) / kTile, tiles_c = (C + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(std::min<int64_t>(tiles_c, int64_t{1} << 30)),
                  static_cast<unsigned>(std::min(tiles_r, kMaxGridYZ)),
                  static_cast<unsigned>(std::min(B, kMaxGridYZ)));
  transpose_kernel<T><<<grid, dim3(kTile, kRows), 0, s>>>(static_cast<const T*>(x),
                                                         static_cast<T*>(y), B, R, C);
  return ltt::launch_status();
}

template <typename T>
int launch_inplace(void* x, int64_t N, cudaStream_t s) {
  const unsigned nt = static_cast<unsigned>(std::min((N + kTile - 1) / kTile, kMaxGridYZ));
  transpose_inplace_kernel<T><<<dim3(nt, nt), dim3(kTile, kRows), 0, s>>>(static_cast<T*>(x), N);
  return ltt::launch_status();
}

}  // namespace

// x: (B, R, C) contiguous, y: (B, C, R) contiguous, not overlapping x;
// elem_size 1, 2, 4 or 8 bytes (another size returns cudaErrorInvalidValue)
LTT_API int ltt_transpose(const void* x, void* y, int64_t B, int64_t R, int64_t C,
                          int elem_size, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 1: return launch<uint8_t>(x, y, B, R, C, s);
    case 2: return launch<uint16_t>(x, y, B, R, C, s);
    case 4: return launch<uint32_t>(x, y, B, R, C, s);
    case 8: return launch<uint64_t>(x, y, B, R, C, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x: (N, N) contiguous, transposed in place
LTT_API int ltt_transpose_inplace(void* x, int64_t N, int elem_size, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 1: return launch_inplace<uint8_t>(x, N, s);
    case 2: return launch_inplace<uint16_t>(x, N, s);
    case 4: return launch_inplace<uint32_t>(x, N, s);
    case 8: return launch_inplace<uint64_t>(x, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
