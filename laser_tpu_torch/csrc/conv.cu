// Direct 2-D convolution, stride 1: NCHW activations, OIHW weights, NCHW out,
// zero padding (ph, pw) applied while loading (no padded copy of x).
//
// conv_planewise_kernel replaces laser_tpu/ops/conv.py:95
// _build_planewise_conv (pallas_call at :128): the small-channel conv,
// C * kh * kw <= 64, as per-tap FMAs of shifted input planes with scalar
// fp32 weights (the TPU kernel's SMEM scalars, :134 and :314).
//
// conv_direct_f32_kernel and conv_direct_tc_kernel (one kernel, an fp32 FFMA
// and a bf16/f16 tensor-core variant) replace both kernels of
// laser_tpu/ops/conv.py:152 _build_direct_conv: kernel_patch (:177-195,
// pallas_call at :211), which builds an (oh*ow, taps*C) patch in VMEM and
// writes (N, c_out, oh*ow) with one transposed dot (:224, :341-342), and
// kernel_taps (:197-207, pallas_call at :232), which accumulates one dot per
// tap and writes NHWC for an XLA transpose (:243, :343-344). laser_tpu picks
// between them by a VMEM budget; here one implicit GEMM covers both: per
// image, out (c_out, oh*ow) = W (c_out, K) x patches (K, oh*ow), K = C*kh*kw
// in OIHW order, with each patch tile gathered from x (NCHW, read directly:
// no NHWC transpose) into shared memory as it is consumed, and the result
// written straight into the NCHW plane.
//
// What bounds them on the H100 (f32 at the CNN path's shapes): conv 1 of
// the path (N16, 3->20, 224^2) reads 9.6 MB and writes 64.2 MB for 0.87
// GFLOP, so bytes (22 us at 3.35 TB/s); convs 2 and 3 (20->64 at 112^2,
// 64->64 at 56^2) do 4.6 and 3.7 GFLOP against 68 and 26 MB, so fp32 FFMA
// (69 and 55 us at 67 TFLOP/s).
//
// Design, planewise: one block per (image, 8 x 32 output tile, up to 32
// output channels). It stages the tile's input window (with its halo, zero
// outside the image) as fp32 and the block's weights, zero-padded to KT taps,
// in shared memory. Each thread keeps its pixel's KT input taps in registers
// and runs one fp32 dot per output channel against weights read four at a
// time as broadcasts; a warp writes 32 neighbouring pixels of one plane.
// Design, direct: 64 output channels x 64 pixels per block, K walked in slabs
// (16 for FFMA, 32 for WMMA). A small per-slab table turns each k into the
// channel's plane offset and the tap's (dy, dx), so a patch load is an add,
// two bounds tests and one read, neighbouring threads on neighbouring
// pixels. f32 runs full-fp32 FFMA (config.matmul_precision "highest", as
// laser_tpu's Precision.HIGHEST at conv.py:174), 4 x 4 outputs per thread;
// bf16/f16 run WMMA 16x16x16 with fp32 accumulators. Simple first: no
// cp.async, TMA or wgmma yet.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using ltt::from_f32;
using ltt::to_f32;

struct ConvArgs {
  const void* x;  // (N, C, H, W) in T
  const void* w;  // (c_out, C*kh*kw): fp32 for planewise, T for direct
  void* out;      // (N, c_out, oh, ow) in T
  int N, C, H, W, c_out, kh, kw, ph, pw, oh, ow;
};

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
// direct (implicit GEMM): shared pieces
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
// direct, f32: full-precision FFMA
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
      As[kk][m] = (co < p.c_out && k < K) ? w[static_cast<size_t>(co) * K + k] : 0.f;
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
// direct, bf16 / f16: tensor cores through WMMA
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
          (co < p.c_out && k < K) ? w[static_cast<size_t>(co) * K + k] : from_f32<T>(0.f);
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

ConvArgs make_args(const void* x, const void* w, void* out, int N, int C, int H, int W,
                   int c_out, int kh, int kw, int ph, int pw) {
  return ConvArgs{x, w, out, N, C, H, W, c_out, kh, kw, ph, pw,
                  H + 2 * ph - kh + 1, W + 2 * pw - kw + 1};
}

}  // namespace

// x: (N, C, H, W) contiguous in dtype; w: (c_out, C, kh, kw) contiguous
// fp32, C * kh * kw <= 64; out: (N, c_out, oh, ow) in dtype, oh = H + 2 ph -
// kh + 1, ow = W + 2 pw - kw + 1 (both > 0).
LTT_API int ltt_conv_planewise(const void* x, const void* w, void* out, int N, int C, int H,
                               int W, int c_out, int kh, int kw, int ph, int pw, int dtype,
                               void* stream) {
  const ConvArgs p = make_args(x, w, out, N, C, H, W, c_out, kh, kw, ph, pw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ltt::kF32) return planewise<float>(p, s);
  if (dtype == ltt::kBF16) return planewise<__nv_bfloat16>(p, s);
  return planewise<__half>(p, s);
}

// As ltt_conv_planewise, with w in dtype and no limit on C * kh * kw.
LTT_API int ltt_conv_direct(const void* x, const void* w, void* out, int N, int C, int H, int W,
                            int c_out, int kh, int kw, int ph, int pw, int dtype, void* stream) {
  const ConvArgs p = make_args(x, w, out, N, C, H, W, c_out, kh, kw, ph, pw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int P = p.oh * p.ow;
  if (dtype == ltt::kF32) {
    dim3 grid((P + F_BN - 1) / F_BN, (c_out + F_BM - 1) / F_BM, N);
    conv_direct_f32_kernel<<<grid, F_THREADS, 0, s>>>(p);
  } else {
    dim3 grid((P + TC_BN - 1) / TC_BN, (c_out + TC_BM - 1) / TC_BM, N);
    if (dtype == ltt::kBF16)
      conv_direct_tc_kernel<__nv_bfloat16><<<grid, TC_THREADS, 0, s>>>(p, dtype);
    else
      conv_direct_tc_kernel<__half><<<grid, TC_THREADS, 0, s>>>(p, dtype);
  }
  return ltt::launch_status();
}
