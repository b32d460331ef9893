// Jacobi and red-black Gauss-Seidel sweeps of the 5-point Poisson stencil,
// edges fixed: u[r, c] <- 0.25 * ((((up + down) + left) + right) - f[r, c]).
//
// Replaces laser_tpu/ops/stencil.py:56 _build_sweeps.
//
// What bounds it on the H100: bytes. laser_tpu keeps the grid in one TPU
// core's VMEM for all iterations. An SM's 228 KB of shared memory holds
// 1/18 of bench.py's 1024^2 f32 grid, and a grid-wide dependency links
// every half-sweep to the last, so here the grid stays in device memory:
// at 4 MiB, with 4 MiB of f, both stay in the 50 MB L2 between launches.
// The least time for the work is its compulsory bytes (u and f read once,
// u written once); a design that is not resident streams u and f through
// every half-sweep, which is what this kernel does, from L2.
//
// Design: one launch per half-sweep (red-black) or sweep (Jacobi), the
// simplest design that is right. Red-black updates one colour in place:
// a cell of one colour reads only cells of the other colour and f, so the
// launch has no race. Red, (r + c) % 2 == 0, goes first, from the old grid;
// black then reads the updated red cells. Jacobi reads one buffer and
// writes the other (the caller ping-pongs two buffers whose edges are
// equal). One thread per interior cell of the colour: thread (r, k) takes
// column 2k + parity, so neighbouring threads read every second word.
// Arithmetic in the grid's dtype, rounded at every op as PyTorch's eager
// ops round (bf16 and f16 through fp32, one rounding each).
#include "common.cuh"

namespace {

using ltt::from_f32;
using ltt::round_through;
using ltt::to_f32;

constexpr int kBx = 32, kBy = 8;
constexpr int kJacobi = 2;  // colour 0: red, 1: black, 2: every interior cell

template <typename T>
__global__ void __launch_bounds__(kBx* kBy)
    stencil_kernel(const T* __restrict__ src, const T* __restrict__ f, T* dst, int rows, int cols,
                   int colour) {
  const int r = blockIdx.y * kBy + threadIdx.y + 1;
  const int k = blockIdx.x * kBx + threadIdx.x;
  if (r >= rows - 1) return;
  const int c = colour == kJacobi ? k + 1 : 2 * k + ((r + colour) & 1);
  if (c < 1 || c >= cols - 1) return;
  const size_t i = (size_t)r * cols + c;
  float s = round_through<T>(__fadd_rn(to_f32(src[i - cols]), to_f32(src[i + cols])));
  s = round_through<T>(__fadd_rn(s, to_f32(src[i - 1])));
  s = round_through<T>(__fadd_rn(s, to_f32(src[i + 1])));
  s = round_through<T>(__fsub_rn(s, to_f32(f[i])));
  dst[i] = from_f32<T>(__fmul_rn(0.25f, s));
}

template <typename T>
int launch(const void* src, const void* f, void* dst, int rows, int cols, int colour,
           cudaStream_t s) {
  const int width = colour == kJacobi ? cols - 2 : (cols + 1) / 2;
  dim3 block(kBx, kBy);
  dim3 grid((width + kBx - 1) / kBx, (rows - 2 + kBy - 1) / kBy);
  stencil_kernel<T><<<grid, block, 0, s>>>(static_cast<const T*>(src), static_cast<const T*>(f),
                                           static_cast<T*>(dst), rows, cols, colour);
  return ltt::launch_status();
}

}  // namespace

// One half-sweep (colour 0 red, 1 black; src == dst) or one Jacobi sweep
// (colour 2; src != dst, edges already equal) over a contiguous rows x cols
// grid, rows and cols >= 3; f has the grid's shape and dtype.
LTT_API int ltt_stencil_sweep(const void* src, const void* f, void* dst, int rows, int cols,
                              int colour, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 3 || cols < 3 || colour < 0 || colour > kJacobi)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == ltt::kF32) return launch<float>(src, f, dst, rows, cols, colour, s);
  if (dtype == ltt::kBF16) return launch<__nv_bfloat16>(src, f, dst, rows, cols, colour, s);
  if (dtype == ltt::kF16) return launch<__half>(src, f, dst, rows, cols, colour, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
