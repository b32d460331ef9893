// Direct 2-D convolution: NCHW activations, OIHW weights, NCHW out, zero
// padding (ph, pw) applied while loading (no padded copy of x).
//
// conv_planewise_kernel replaces laser_tpu/ops/conv.py:95
// _build_planewise_conv (pallas_call at :128): the small-channel conv,
// C * kh * kw <= 64, stride 1, as per-tap FMAs of shifted input planes with
// scalar fp32 weights (the TPU kernel's SMEM scalars, :134 and :314).
//
// The direct kernels replace both kernels of laser_tpu/ops/conv.py:152
// _build_direct_conv: kernel_patch (:177-195, pallas_call at :211), which
// builds an (oh*ow, taps*C) patch in VMEM and writes (N, c_out, oh*ow) with
// one transposed dot (:224, :341-342), and kernel_taps (:197-207,
// pallas_call at :232), which accumulates one dot per tap and writes NHWC
// for an XLA transpose (:243, :343-344); and, with the stride in the
// kernel, laser_tpu's strided branch (:251-270), which sums s_h * s_w
// stride-1 phase convs of subsampled inputs. laser_tpu picks between its
// kernels by a VMEM budget; here one implicit GEMM covers them all: per
// image, out (c_out, oh*ow) = W (c_out, K) x patches (K, oh*ow), K = C*kh*kw
// in OIHW order, a patch element being x at (c, oy*sh + i - ph,
// ox*sw + j - pw), gathered from x (NCHW, read directly: no NHWC transpose)
// as it is consumed, the result written straight into the NCHW plane.
//
// What bounds them on the H100 (f32 at the CNN path's shapes): conv 1 of
// the path (N16, 3->20, 224^2) reads 9.6 MB and writes 64.2 MB for 0.87
// GFLOP, so bytes (22 us at 3.35 TB/s); convs 2 and 3 (20->64 at 112^2,
// 64->64 at 56^2) do 4.6 and 3.7 GFLOP against 68 and 26 MB, so fp32 FFMA
// (69 and 55 us at 67 TFLOP/s); conv 3 at stride 2, 0.92 GFLOP (14 us). In
// bf16, conv 3's 6.4 + 6.4 MB against 3.7 GFLOP at 989 TFLOP/s: bytes
// (3.9 us).
//
// Three routes; the launcher picks one from the dtype, or is asked for one
// (enum Route), and reports it:
// - ffma (f32, any stride): conv_direct_ffma_kernel. A block owns 64
//   output channels x 128 consecutive pixels of the batch (a tile may run
//   from one image into the next, so only the batch's last tile is ragged
//   and C1's conv 3 is 392 blocks, one wave at 3 blocks an SM, not 400),
//   128 threads, 8 x 8 outputs a thread in full fp32 (config.matmul_precision "highest", as laser_tpu's
//   Precision.HIGHEST at conv.py:174). The K walk's tap table (each k's
//   channel plane offset plus i*W + j, and (i, j)) is decoded once per
//   block into shared memory (in chunks of TBL taps), not once per slab.
//   Weights (c_out, ldw), K-contiguous, are staged 16 deep by 16-byte
//   cp.async; the patches of the next slab are gathered into registers
//   (one pixel a thread, neighbouring threads on neighbouring pixels) while
//   the current slab's FMAs run, and stored after them: one barrier a slab.
// - mma (bf16/f16, any stride): conv_direct_mma_kernel, the same block tile
//   on the tensor cores: 256 threads, mma.sync m16n8k16 with fp32
//   accumulators, slabs 64 deep, two blocks an SM. A = the weights by
//   cp.async into an XOR-swizzled K-major tile (ldmatrix), B = the patches,
//   gathered through the same register double buffer (two neighbouring
//   pixels a thread, kept and stored as one 32-bit pair) into the swizzled
//   k-major layout ldmatrix.trans reads; zeros past K and outside the
//   image. One rounding to T; the epilogue writes NCHW rows as pairs.
// - classic (stride 1 only): the first kernels, kept to time against:
//   conv_direct_f32_kernel (64 x 64 tile, 4 x 4 FFMA a thread, 16-deep slabs
//   loaded synchronously, the tap table re-decoded each slab) and
//   conv_direct_tc_kernel (WMMA 16x16x16, 64 x 64 tile, a staged epilogue).
// At a stride > 1 the kernel route computes the conv in one fp32
// accumulation and one rounding, where laser_tpu rounds each phase conv to
// the dtype and adds the phases in it: the same in f32 up to summation
// order, closer to the exact result in bf16/f16 (a few roundings of max
// from laser_tpu's; ROADMAP.md queue 3, settled on purpose).
// The wgmma form of the 16-bit kernel (gathering warpgroups writing the B
// tile, as csrc/w4_gemm.cu's mma route does) is later work.
#include <mma.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace nvcuda;
using ltt::from_f32;
using ltt::to_f32;
using ltt::hp::cp_async16;
using ltt::hp::cp_async_commit;
using ltt::hp::cp_async_wait;
using ltt::hp::ldsm_x4;
using ltt::hp::ldsm_x4_trans;
using ltt::hp::mma16816;
using ltt::hp::pack2;
using ltt::hp::smem_u32;
using ltt::hp::swz;

struct ConvArgs {
  const void* x;  // (N, C, H, W) in T
  const void* w;  // (c_out, ldw), the first C*kh*kw of a row used: fp32 for planewise, T else
  void* out;      // (N, c_out, oh, ow) in T
  int N, C, H, W, c_out, kh, kw, ph, pw, sh, sw, oh, ow;
  int ldw;        // elements between weight rows
};

enum Route { kRouteAuto = 0, kRouteClassic = 1, kRouteFfma = 2, kRouteMma = 3 };

// ---------------------------------------------------------------------------
// planewise
// ---------------------------------------------------------------------------
constexpr int PW_TH = 8, PW_TW = 32, PW_THREADS = PW_TH * PW_TW, PW_CO = 32;

template <int KT>
size_t planewise_smem(const ConvArgs& p) {
  const int ih = PW_TH + p.kh - 1, iw = PW_TW + p.kw - 1;
  return (static_cast<size_t>(PW_CO) * KT + static_cast<size_t>(p.C) * ih * iw) * sizeof(float) +
         KT * sizeof(int);
}

template <typename T, int KT>
__global__ void __launch_bounds__(PW_THREADS) conv_planewise_kernel(ConvArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int taps = p.C * p.kh * p.kw;
  const int ih = PW_TH + p.kh - 1, iw = PW_TW + p.kw - 1;
  float* ws = smem;              // PW_CO x KT weights, zero past `taps`
  float* xs = ws + PW_CO * KT;   // C x ih x iw input window
  int* toff = reinterpret_cast<int*>(xs + p.C * ih * iw);  // tap -> offset in xs

  const int groups = (p.c_out + PW_CO - 1) / PW_CO;
  const int n = blockIdx.z / groups;
  const int co0 = (blockIdx.z % groups) * PW_CO;
  const int nco = min(PW_CO, p.c_out - co0);
  const int oy0 = blockIdx.y * PW_TH, ox0 = blockIdx.x * PW_TW;
  const float* w = static_cast<const float*>(p.w);
  const T* x = static_cast<const T*>(p.x) + static_cast<size_t>(n) * p.C * p.H * p.W;

  for (int i = threadIdx.x; i < PW_CO * KT; i += PW_THREADS) {
    const int co = i / KT, t = i % KT;
    ws[i] = (co < nco && t < taps) ? w[static_cast<size_t>(co0 + co) * taps + t] : 0.f;
  }
  for (int t = threadIdx.x; t < KT; t += PW_THREADS) {
    const int khw = p.kh * p.kw;
    const int c = t / khw, r = t % khw;
    toff[t] = t < taps ? (c * ih + r / p.kw) * iw + r % p.kw : 0;
  }
  for (int i = threadIdx.x; i < p.C * ih * iw; i += PW_THREADS) {
    const int c = i / (ih * iw), r = i % (ih * iw);
    const int iy = oy0 + r / iw - p.ph, ix = ox0 + r % iw - p.pw;
    xs[i] = (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W)
                ? to_f32(x[(static_cast<size_t>(c) * p.H + iy) * p.W + ix])
                : 0.f;
  }
  __syncthreads();

  const int ty = threadIdx.x / PW_TW, tx = threadIdx.x % PW_TW;
  const int oy = oy0 + ty, ox = ox0 + tx;
  if (oy >= p.oh || ox >= p.ow) return;  // no barrier follows
  const int base = ty * iw + tx;
  float v[KT];
#pragma unroll
  for (int t = 0; t < KT; ++t) v[t] = t < taps ? xs[toff[t] + base] : 0.f;

  const size_t plane = static_cast<size_t>(p.oh) * p.ow;
  T* out = static_cast<T*>(p.out) + (static_cast<size_t>(n) * p.c_out + co0) * plane +
           static_cast<size_t>(oy) * p.ow + ox;
  for (int co = 0; co < nco; ++co) {
    const float4* w4 = reinterpret_cast<const float4*>(ws + co * KT);
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < KT / 4; ++t) {
      const float4 q = w4[t];
      acc = fmaf(q.x, v[4 * t], acc);
      acc = fmaf(q.y, v[4 * t + 1], acc);
      acc = fmaf(q.z, v[4 * t + 2], acc);
      acc = fmaf(q.w, v[4 * t + 3], acc);
    }
    out[co * plane] = from_f32<T>(acc);
  }
}

template <typename T, int KT>
int launch_planewise(const ConvArgs& p, cudaStream_t s) {
  const size_t smem = planewise_smem<KT>(p);
  const int st = ltt::allow_smem(conv_planewise_kernel<T, KT>, smem);
  if (st) return st;
  const int groups = (p.c_out + PW_CO - 1) / PW_CO;
  dim3 grid((p.ow + PW_TW - 1) / PW_TW, (p.oh + PW_TH - 1) / PW_TH, p.N * groups);
  conv_planewise_kernel<T, KT><<<grid, PW_THREADS, smem, s>>>(p);
  return ltt::launch_status();
}

// KT: the taps rounded up to a register array the compiler unrolls
template <typename T>
int planewise(const ConvArgs& p, cudaStream_t s) {
  const int taps = p.C * p.kh * p.kw;
  if (taps <= 16) return launch_planewise<T, 16>(p, s);
  if (taps <= 32) return launch_planewise<T, 32>(p, s);
  return launch_planewise<T, 64>(p, s);
}

// ---------------------------------------------------------------------------
// direct, classic (stride 1): shared pieces
// ---------------------------------------------------------------------------

// Per-slab decode of k = (c * kh + i) * kw + j: the channel's plane offset in
// the image, and the tap's shift (i - ph, j - pw); off < 0 past K.
struct KTable {
  int off, dy, dx;
};

__device__ __forceinline__ KTable decode_k(const ConvArgs& p, int k, int K) {
  if (k >= K) return {-1, 0, 0};
  const int khw = p.kh * p.kw;
  const int c = k / khw, r = k % khw;
  return {c * p.H * p.W, r / p.kw - p.ph, r % p.kw - p.pw};
}

// One patch element: x at (channel of kt, oy + dy, ox + dx), 0 outside.
template <typename T>
__device__ __forceinline__ T patch(const ConvArgs& p, const T* x, const KTable& kt, bool pv,
                                   int oy, int ox) {
  const int iy = oy + kt.dy, ix = ox + kt.dx;
  if (!pv || kt.off < 0 || iy < 0 || iy >= p.H || ix < 0 || ix >= p.W) return from_f32<T>(0.f);
  return x[kt.off + iy * p.W + ix];
}

__device__ __forceinline__ void store_out(void* out, size_t i, float v, int dt) {
  if (dt == ltt::kF32)
    static_cast<float*>(out)[i] = v;
  else if (dt == ltt::kBF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  else
    static_cast<__half*>(out)[i] = __float2half(v);
}

// ---------------------------------------------------------------------------
// direct, classic f32: full-precision FFMA
// ---------------------------------------------------------------------------
constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_THREADS = 256;

__global__ void __launch_bounds__(F_THREADS) conv_direct_f32_kernel(ConvArgs p) {
  __shared__ __align__(16) float As[F_BK][F_BM + 4];  // weights, k-major
  __shared__ __align__(16) float Bs[F_BK][F_BN + 4];  // patches, k-major
  __shared__ KTable kt[F_BK];

  const int K = p.C * p.kh * p.kw;
  const int P = p.oh * p.ow;
  const int n = blockIdx.z;
  const int co0 = blockIdx.y * F_BM;
  const int p0 = blockIdx.x * F_BN;
  const float* w = static_cast<const float*>(p.w);
  const float* x = static_cast<const float*>(p.x) + static_cast<size_t>(n) * p.C * p.H * p.W;

  // this thread's patch column (pixel) for every slab
  const int pn = threadIdx.x % F_BN;
  const int pix = p0 + pn;
  const bool pv = pix < P;
  const int oy = pv ? pix / p.ow : 0, ox = pv ? pix % p.ow : 0;

  const int tx = threadIdx.x % 16;  // 4 pixels each
  const int ty = threadIdx.x / 16;  // 4 output channels each
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += F_BK) {
    if (threadIdx.x < F_BK) kt[threadIdx.x] = decode_k(p, k0 + threadIdx.x, K);
#pragma unroll
    for (int t = 0; t < F_BM * F_BK / F_THREADS; ++t) {
      const int i = threadIdx.x + t * F_THREADS;
      const int m = i / F_BK, kk = i % F_BK;
      const int co = co0 + m, k = k0 + kk;
      As[kk][m] = (co < p.c_out && k < K) ? w[static_cast<size_t>(co) * p.ldw + k] : 0.f;
    }
    __syncthreads();  // kt
#pragma unroll
    for (int t = 0; t < F_BK * F_BN / F_THREADS; ++t) {
      const int kk = threadIdx.x / F_BN + t * (F_THREADS / F_BN);
      Bs[kk][pn] = patch(p, x, kt[kk], pv, oy, ox);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = co0 + ty * 4 + i;
    if (co >= p.c_out) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pp = p0 + tx * 4 + j;
      if (pp < P) out[(static_cast<size_t>(n) * p.c_out + co) * P + pp] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// direct, classic bf16 / f16: tensor cores through WMMA
// ---------------------------------------------------------------------------
constexpr int TC_BM = 64, TC_BN = 64, TC_BK = 32, TC_THREADS = 128;
constexpr int TC_LDA = TC_BK + 8;  // 16-bit ldm must be a multiple of 8
constexpr int TC_LDB = TC_BN + 8;
constexpr int TC_LDC = TC_BN + 4;  // fp32 ldm must be a multiple of 4

template <typename T>
__global__ void __launch_bounds__(TC_THREADS) conv_direct_tc_kernel(ConvArgs p, int dtype) {
  __shared__ __align__(128) T As[TC_BM * TC_LDA];    // weights (co, k)
  __shared__ __align__(128) T Bs[TC_BK * TC_LDB];    // patches (k, pixel)
  __shared__ __align__(128) float Cs[TC_BM * TC_LDC];
  __shared__ KTable kt[TC_BK];

  const int K = p.C * p.kh * p.kw;
  const int P = p.oh * p.ow;
  const int n = blockIdx.z;
  const int co0 = blockIdx.y * TC_BM;
  const int p0 = blockIdx.x * TC_BN;
  const T* w = static_cast<const T*>(p.w);
  const T* x = static_cast<const T*>(p.x) + static_cast<size_t>(n) * p.C * p.H * p.W;

  const int pn = threadIdx.x % TC_BN;
  const int pix = p0 + pn;
  const bool pv = pix < P;
  const int oy = pv ? pix / p.ow : 0, ox = pv ? pix % p.ow : 0;

  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32;  // 2x2 warps, 32x32 each
  const int wn = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += TC_BK) {
    if (threadIdx.x < TC_BK) kt[threadIdx.x] = decode_k(p, k0 + threadIdx.x, K);
    for (int i = threadIdx.x; i < TC_BM * TC_BK; i += TC_THREADS) {
      const int m = i / TC_BK, kk = i % TC_BK;
      const int co = co0 + m, k = k0 + kk;
      As[m * TC_LDA + kk] =
          (co < p.c_out && k < K) ? w[static_cast<size_t>(co) * p.ldw + k] : from_f32<T>(0.f);
    }
    __syncthreads();  // kt
    for (int kk = threadIdx.x / TC_BN; kk < TC_BK; kk += TC_THREADS / TC_BN)
      Bs[kk * TC_LDB + pn] = patch(p, x, kt[kk], pv, oy, ox);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm + i * 16) * TC_LDA + kk, TC_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * TC_LDB + wn + j * 16, TC_LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * TC_LDC + wn + j * 16, acc[i][j], TC_LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < TC_BM * TC_BN; i += TC_THREADS) {
    const int r = i / TC_BN, c = i % TC_BN;
    const int co = co0 + r, pp = p0 + c;
    if (co < p.c_out && pp < P)
      store_out(p.out, (static_cast<size_t>(n) * p.c_out + co) * P + pp, Cs[r * TC_LDC + c],
                dtype);
  }
}

// ---------------------------------------------------------------------------
// direct, any stride: the tap table and the register-buffered patch gather
// shared by the ffma and mma routes
// ---------------------------------------------------------------------------

// a block tile: 64 output channels x 128 pixels of the batch's pixels in
// order (image by image), so that the last tile of one image runs on into
// the next and the grid has no ragged tiles but the very last
constexpr int D_BM = 64, D_BN = 128;
// taps decoded into shared memory at once (a multiple of both slab depths)
constexpr int TBL = 1024;
// tap rows past K: an i no pixel's row reaches (the launcher keeps H + ph
// below it)
constexpr int TAP_NONE = 0x4000;
constexpr int DIM_MAX = 0x2000;

// Tap k = (c * kh + i) * kw + j of the conv as {c*H*W + i*W + j, i << 16 | j}.
__device__ __forceinline__ int2 decode_tap(const ConvArgs& p, int k, int K) {
  if (k >= K) return make_int2(0, TAP_NONE << 16);
  const int khw = p.kh * p.kw;
  const int c = k / khw, r = k - c * khw;
  const int i = r / p.kw, j = r - i * p.kw;
  return make_int2(c * p.H * p.W + i * p.W + j, (i << 16) | j);
}

// Decode taps [k0, k0 + n) into tbl (n a multiple of the caller's slab).
__device__ __forceinline__ void decode_taps(int2* tbl, const ConvArgs& p, int k0, int n, int K) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) tbl[e] = decode_tap(p, k0 + e, K);
}

// One output pixel's gather state (pixel gp of the batch, gp = n * P +
// oy * ow + ox): the top-left corner (by, bx) of its window in the unpadded
// image and x at that corner of image n (an address that may lie outside
// the image: only taps inside it are read). A pixel past the batch reads 0.
template <typename T>
struct PixelWindow {
  const T* origin;
  int by, bx;

  __device__ __forceinline__ PixelWindow(const ConvArgs& p, const T* x, int gp) {
    const int P = p.oh * p.ow;
    if (gp < p.N * P) {
      const int n = gp / P, pix = gp - n * P;
      const int oy = pix / p.ow, ox = pix - oy * p.ow;
      by = oy * p.sh - p.ph;
      bx = ox * p.sw - p.pw;
      origin = x + static_cast<size_t>(n) * p.C * p.H * p.W + (by * p.W + bx);
    } else {
      by = -2 * TAP_NONE;
      bx = 0;
      origin = x;
    }
  }

  // tap t of the window, 0 outside the image (zero padding)
  __device__ __forceinline__ T at(const ConvArgs& p, int2 t) const {
    const int iy = by + (t.y >> 16), ix = bx + (t.y & 0xFFFF);
    return (unsigned)iy < (unsigned)p.H && (unsigned)ix < (unsigned)p.W ? __ldg(origin + t.x)
                                                                        : T(0);
  }
};

// component k of v (k a constant once the caller's loop is unrolled)
__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// ffma: f32, 8 x 8 outputs a thread
// ---------------------------------------------------------------------------
constexpr int FF_BK = 16, FF_THREADS = 128;
constexpr int FF_A = D_BM * FF_BK;  // floats of a weight stage: [co][k]
constexpr int FF_B = FF_BK * D_BN;  // floats of a patch stage: [k][pixel]

size_t ffma_smem(int K) {
  const int taps = K < TBL ? (K + FF_BK - 1) / FF_BK * FF_BK : TBL;
  return (2 * FF_A + 2 * FF_B) * sizeof(float) + taps * sizeof(int2);
}

__global__ void __launch_bounds__(FF_THREADS) conv_direct_ffma_kernel(ConvArgs p) {
  extern __shared__ __align__(16) float ff_smem[];
  float* As = ff_smem;                                    // 2 stages
  float* Bs = As + 2 * FF_A;                              // 2 stages
  int2* tbl = reinterpret_cast<int2*>(Bs + 2 * FF_B);

  const int K = p.C * p.kh * p.kw, P = p.oh * p.ow;
  const int co0 = blockIdx.y * D_BM, p0 = blockIdx.x * D_BN;
  const float* w = static_cast<const float*>(p.w);
  const int tid = threadIdx.x;
  const PixelWindow<float> win(p, static_cast<const float*>(p.x), p0 + tid);  // gathered here
  const int ty = tid >> 4, tx = tid & 15;  // channels 8 ty.., pixels 4 tx.. and 64 + 4 tx..

  // weights: 64 rows x 4 chunks of 4 floats, two chunks a thread
  auto load_a = [&](float* dst, int k0) {
#pragma unroll
    for (int it = 0; it < D_BM * FF_BK / 4 / FF_THREADS; ++it) {
      const int q = tid + it * FF_THREADS;
      const int r = q >> 2, c = (q & 3) * 4;
      const bool ok = co0 + r < p.c_out && k0 + c < p.ldw;
      cp_async16(smem_u32(dst + r * FF_BK + c),
                 ok ? w + static_cast<size_t>(co0 + r) * p.ldw + k0 + c : w, ok);
    }
    cp_async_commit();
  };
  float pre[FF_BK];
  auto gather = [&](const int2* taps) {
#pragma unroll
    for (int kk = 0; kk < FF_BK; ++kk) pre[kk] = win.at(p, taps[kk]);
  };
  auto store_b = [&](float* dst) {
#pragma unroll
    for (int kk = 0; kk < FF_BK; ++kk) dst[kk * D_BN + tid] = pre[kk];
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kc = 0; kc < K; kc += TBL) {
    const int slabs = (min(TBL, K - kc) + FF_BK - 1) / FF_BK;
    __syncthreads();  // the last chunk's slabs have been multiplied
    decode_taps(tbl, p, kc, slabs * FF_BK, K);
    __syncthreads();
    load_a(As, kc);
    gather(tbl);
    store_b(Bs);
    for (int s = 0; s < slabs; ++s) {
      cp_async_wait<0>();
      __syncthreads();  // slab s staged; slab s - 1's buffers free
      const int st = s & 1;
      const bool next = s + 1 < slabs;
      if (next) {
        load_a(As + (st ^ 1) * FF_A, kc + (s + 1) * FF_BK);
        gather(tbl + (s + 1) * FF_BK);
      }
      const float* as = As + st * FF_A + ty * 8 * FF_BK;
      const float* bs = Bs + st * FF_B + tx * 4;
#pragma unroll
      for (int kq = 0; kq < FF_BK / 4; ++kq) {
        float4 a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = *reinterpret_cast<const float4*>(as + i * FF_BK + kq * 4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 b0 = *reinterpret_cast<const float4*>(bs + (kq * 4 + kk) * D_BN);
          const float4 b1 = *reinterpret_cast<const float4*>(bs + (kq * 4 + kk) * D_BN + 64);
          const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float av = lane_of(a[i], kk);
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
          }
        }
      }
      if (next) store_b(Bs + (st ^ 1) * FF_B);
    }
  }

  // pixels gp .. gp + 3 of each half: one image's when P % 4 == 0, so one
  // aligned float4 a channel; else each pixel on its own
  float* out = static_cast<float*>(p.out);
  const int NP = p.N * P;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gp = p0 + 64 * h + tx * 4;
    if (gp >= NP) continue;
    const int n = gp / P, pix = gp - n * P;
    float* o = out + static_cast<size_t>(n) * p.c_out * P + pix;
    if ((P & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int co = co0 + ty * 8 + i;
        if (co < p.c_out)
          *reinterpret_cast<float4*>(o + static_cast<size_t>(co) * P) = make_float4(
              acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int g = gp + j;
        if (g >= NP) break;
        const int nj = g / P;
        float* oj = out + static_cast<size_t>(nj) * p.c_out * P + (g - nj * P);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int co = co0 + ty * 8 + i;
          if (co < p.c_out) oj[static_cast<size_t>(co) * P] = acc[i][4 * h + j];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// mma: bf16 / f16 on the tensor cores, mma.sync m16n8k16
// ---------------------------------------------------------------------------
constexpr int MM_BK = 64, MM_THREADS = 256;
constexpr int MM_A = D_BM * MM_BK;  // elements of a weight stage: [co][k], swz<64>
constexpr int MM_B = MM_BK * D_BN;  // elements of a patch stage: [k][pixel], swz<128>
constexpr int MM_ROWS = MM_BK * D_BN / MM_THREADS / 2;  // pixel pairs a thread gathers

size_t mma_smem(int K) {
  const int taps = K < TBL ? (K + MM_BK - 1) / MM_BK * MM_BK : TBL;
  return (2 * MM_A + 2 * MM_B) * 2 + taps * sizeof(int2);
}

template <typename T>
__global__ void __launch_bounds__(MM_THREADS, 2) conv_direct_mma_kernel(ConvArgs p) {
  extern __shared__ __align__(128) uint8_t mm_smem[];
  T* As = reinterpret_cast<T*>(mm_smem);                  // 2 stages
  T* Bs = As + 2 * MM_A;                                  // 2 stages
  int2* tbl = reinterpret_cast<int2*>(Bs + 2 * MM_B);

  const int K = p.C * p.kh * p.kw, P = p.oh * p.ow;
  const int co0 = blockIdx.y * D_BM, p0 = blockIdx.x * D_BN;
  const uint16_t* x = static_cast<const uint16_t*>(p.x);
  const T* w = static_cast<const T*>(p.w);
  const int tid = threadIdx.x;
  // gathers pixels px and px + 1, tap rows kr + 4 r, as one 32-bit pair
  const int px = 2 * (tid % (D_BN / 2)), kr = tid / (D_BN / 2);
  const PixelWindow<uint16_t> win0(p, x, p0 + px), win1(p, x, p0 + px + 1);
  uint32_t* bcol = reinterpret_cast<uint32_t*>(reinterpret_cast<uint16_t*>(Bs) + (px & 7));

  auto load_a = [&](T* dst, int k0) {
#pragma unroll
    for (int it = 0; it < D_BM * (MM_BK / 8) / MM_THREADS; ++it) {
      const int q = tid + it * MM_THREADS;
      const int r = q >> 3, c = q & 7;
      const bool ok = co0 + r < p.c_out && k0 + 8 * c < p.ldw;
      cp_async16(smem_u32(dst + swz<MM_BK>(r, c)),
                 ok ? w + static_cast<size_t>(co0 + r) * p.ldw + k0 + 8 * c : w, ok);
    }
    cp_async_commit();
  };
  uint32_t pre[MM_ROWS];
  auto gather = [&](const int2* taps) {
#pragma unroll
    for (int r = 0; r < MM_ROWS; ++r) {
      const int2 t = taps[kr + 4 * r];
      pre[r] = uint32_t(win0.at(p, t)) | uint32_t(win1.at(p, t)) << 16;
    }
  };
  auto store_b = [&](int stage) {
    uint32_t* dst = bcol + stage * (MM_B / 2);
#pragma unroll
    for (int r = 0; r < MM_ROWS; ++r) dst[swz<D_BN>(kr + 4 * r, px >> 3) / 2] = pre[r];
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: which matrix, which row of it
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;  // the warp's 32 x 32 outputs
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int kc = 0; kc < K; kc += TBL) {
    const int slabs = (min(TBL, K - kc) + MM_BK - 1) / MM_BK;
    __syncthreads();  // the last chunk's slabs have been multiplied
    decode_taps(tbl, p, kc, slabs * MM_BK, K);
    __syncthreads();
    load_a(As, kc);
    gather(tbl);
    store_b(0);
    for (int s = 0; s < slabs; ++s) {
      cp_async_wait<0>();
      __syncthreads();  // slab s staged; slab s - 1's buffers free
      const int st = s & 1;
      const bool next = s + 1 < slabs;
      if (next) {
        load_a(As + (st ^ 1) * MM_A, kc + (s + 1) * MM_BK);
        gather(tbl + (s + 1) * MM_BK);
      }
      const T* as = As + st * MM_A;
      const T* bs = Bs + st * MM_B;
#pragma unroll
      for (int kk = 0; kk < MM_BK / 16; ++kk) {
        // A: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15) of each 16-row tile
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4(a[i], smem_u32(as + swz<MM_BK>(wm + 16 * i + mr + 8 * (mi & 1),
                                                 2 * kk + (mi >> 1))));
        // B, transposed: matrices (k 0-7 | 8-15) x (pixels 0-7 | 8-15) of
        // each 16-pixel pair, b0 b1 of blocks 2 np and 2 np + 1
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          ldsm_x4_trans(b, smem_u32(bs + swz<D_BN>(16 * kk + mr + 8 * (mi & 1),
                                                   (wn >> 3) + 2 * np + (mi >> 1))));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma16816<T>(acc[i][2 * np], a[i], b[0], b[1]);
            mma16816<T>(acc[i][2 * np + 1], a[i], b[2], b[3]);
          }
        }
      }
      if (next) store_b(st ^ 1);
    }
  }

  // acc[i][j][2 h + e]: channel wm + 16 i + g + 8 h, pixel wn + 8 j + 2 q4
  // + e; a pixel pair is one image's when P is even (one 32-bit store)
  T* out = static_cast<T*>(p.out);
  const int NP = p.N * P;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gp = p0 + wn + 8 * j + 2 * q4;
    if (gp >= NP) continue;
    const int n = gp / P, pix = gp - n * P;
    T* o = out + static_cast<size_t>(n) * p.c_out * P + pix;
    const bool pair = (P & 1) == 0;
    const int n1 = pair ? n : (gp + 1) / P;
    T* o1 = pair ? o + 1 : out + static_cast<size_t>(n1) * p.c_out * P + (gp + 1 - n1 * P);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = co0 + wm + 16 * i + g + 8 * h;
        if (co >= p.c_out) continue;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        const size_t c = static_cast<size_t>(co) * P;
        if (pair) {
          *reinterpret_cast<uint32_t*>(o + c) = pack2<T>(v0, v1);
        } else {
          o[c] = from_f32<T>(v0);
          if (gp + 1 < NP) o1[c] = from_f32<T>(v1);
        }
      }
  }
}

ConvArgs make_args(const void* x, const void* w, void* out, int N, int C, int H, int W,
                   int c_out, int kh, int kw, int ph, int pw, int sh, int sw, int ldw) {
  return ConvArgs{x, w, out, N, C, H, W, c_out, kh, kw, ph, pw, sh, sw,
                  (H + 2 * ph - kh) / sh + 1, (W + 2 * pw - kw) / sw + 1, ldw};
}

// The ffma and mma routes take any stride, with the weight rows and base
// 16-byte aligned and the image and kernel within the tap table's range.
bool gather_fits(const ConvArgs& p, int dtype) {
  const int vec = dtype == ltt::kF32 ? 4 : 8;
  return p.ldw % vec == 0 && ltt::hp::aligned16(p.w) && p.H + p.ph < DIM_MAX &&
         p.W + p.pw < DIM_MAX && p.kh < DIM_MAX && p.kw < DIM_MAX &&
         (long long)p.N * p.oh * p.ow <= 0x7fffffff;
}

// The route a conv takes, or -1 where the route asked for does not fit.
// kRouteAuto: ffma for f32, mma for bf16/f16, where they fit; else the
// classic kernels at stride 1.
int pick_route(const ConvArgs& p, int dtype, int route) {
  const bool f32 = dtype == ltt::kF32;
  const bool stride1 = p.sh == 1 && p.sw == 1;
  switch (route) {
    case kRouteAuto:
      if (gather_fits(p, dtype)) return f32 ? kRouteFfma : kRouteMma;
      return stride1 ? kRouteClassic : -1;
    case kRouteClassic:
      return stride1 ? kRouteClassic : -1;
    case kRouteFfma:
      return f32 && gather_fits(p, dtype) ? kRouteFfma : -1;
    case kRouteMma:
      return !f32 && gather_fits(p, dtype) ? kRouteMma : -1;
    default:
      return -1;
  }
}

// the ffma and mma routes' grid: the batch's pixels in tiles of D_BN (x),
// channel tiles (y)
dim3 gather_grid(const ConvArgs& p) {
  const long long pixels = (long long)p.N * p.oh * p.ow;
  return dim3(static_cast<unsigned>((pixels + D_BN - 1) / D_BN), (p.c_out + D_BM - 1) / D_BM);
}

int launch_direct(const ConvArgs& p, int dtype, int route, cudaStream_t s) {
  const int P = p.oh * p.ow;
  const int K = p.C * p.kh * p.kw;
  if (route == kRouteFfma) {
    const size_t smem = ffma_smem(K);
    const int st = ltt::allow_smem(conv_direct_ffma_kernel, smem);
    if (st) return st;
    conv_direct_ffma_kernel<<<gather_grid(p), FF_THREADS, smem, s>>>(p);
  } else if (route == kRouteMma) {
    const size_t smem = mma_smem(K);
    if (dtype == ltt::kBF16) {
      const int st = ltt::allow_smem(conv_direct_mma_kernel<__nv_bfloat16>, smem);
      if (st) return st;
      conv_direct_mma_kernel<__nv_bfloat16><<<gather_grid(p), MM_THREADS, smem, s>>>(p);
    } else {
      const int st = ltt::allow_smem(conv_direct_mma_kernel<__half>, smem);
      if (st) return st;
      conv_direct_mma_kernel<__half><<<gather_grid(p), MM_THREADS, smem, s>>>(p);
    }
  } else if (dtype == ltt::kF32) {
    dim3 grid((P + F_BN - 1) / F_BN, (p.c_out + F_BM - 1) / F_BM, p.N);
    conv_direct_f32_kernel<<<grid, F_THREADS, 0, s>>>(p);
  } else {
    dim3 grid((P + TC_BN - 1) / TC_BN, (p.c_out + TC_BM - 1) / TC_BM, p.N);
    if (dtype == ltt::kBF16)
      conv_direct_tc_kernel<__nv_bfloat16><<<grid, TC_THREADS, 0, s>>>(p, dtype);
    else
      conv_direct_tc_kernel<__half><<<grid, TC_THREADS, 0, s>>>(p, dtype);
  }
  return ltt::launch_status();
}

}  // namespace

// x: (N, C, H, W) contiguous in dtype; w: (c_out, C, kh, kw) contiguous
// fp32, C * kh * kw <= 64; out: (N, c_out, oh, ow) in dtype, oh = H + 2 ph -
// kh + 1, ow = W + 2 pw - kw + 1 (both > 0).
LTT_API int ltt_conv_planewise(const void* x, const void* w, void* out, int N, int C, int H,
                               int W, int c_out, int kh, int kw, int ph, int pw, int dtype,
                               void* stream) {
  const ConvArgs p = make_args(x, w, out, N, C, H, W, c_out, kh, kw, ph, pw, 1, 1, C * kh * kw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ltt::kF32) return planewise<float>(p, s);
  if (dtype == ltt::kBF16) return planewise<__nv_bfloat16>(p, s);
  return planewise<__half>(p, s);
}

// As ltt_conv_planewise at strides (sh, sw) (oh = (H + 2 ph - kh) / sh + 1),
// with w in dtype as (c_out, ldw) rows, the first C * kh * kw of each used
// (ldw a multiple of 4 for f32, 8 for bf16/f16 on the ffma and mma routes)
// and no limit on C * kh * kw. route: 0 picks, 1 the classic kernels
// (stride 1), 2 ffma (f32), 3 mma (bf16/f16); *taken gets the route that
// launched.
LTT_API int ltt_conv_direct(const void* x, const void* w, void* out, int N, int C, int H, int W,
                            int c_out, int kh, int kw, int ph, int pw, int sh, int sw, int ldw,
                            int dtype, int route, int* taken, void* stream) {
  const ConvArgs p = make_args(x, w, out, N, C, H, W, c_out, kh, kw, ph, pw, sh, sw, ldw);
  *taken = pick_route(p, dtype, route);
  if (*taken < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_direct(p, dtype, *taken, static_cast<cudaStream_t>(stream));
}
