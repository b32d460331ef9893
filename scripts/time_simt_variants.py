#!/usr/bin/env python3
"""Time the f32 FFMA skeleton (laser_tpu_torch/csrc/simt_gemm.cuh) against
variants of its constants, in turns on one CUDA card.

    python3 scripts/time_simt_variants.py

Each variant is the header with a few lines replaced (``VARIANTS``: the
slab depth and ring stages, single-buffered fragments, one block an SM's
register budget), compiled with a minimal policy (A (M, K) and B (K, N)
row-major, a plain f32 store) into a shared library of its own, one nvcc
each, all at once, under ``build/simt_variants/``. Prints each variant's
ptxas registers and spills and its blocks an SM; the base's SASS opcode
counts (``cuobjdump``); the SM clock and power while the base runs (one
``nvidia-smi`` sample every 100 ms); and, at M4096 K2048 N2048 (row 1's f32
product) and 4096^3 (row 32's), each variant's and ``torch.matmul``'s
(TF32 off) milliseconds a call, 20 calls between two CUDA events (median
of 5), in two turns (the list, then reversed), with its share of the FFMA
bound (67 TFLOP/s) and whether its bits equal the base's.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "laser_tpu_torch" / "csrc"
OUT = ROOT / "build" / "simt_variants"
NVCC = "/usr/local/cuda/bin/nvcc"
FFMA_TFLOPS = 67.0

HARNESS = r'''
#include "simt_gemm.cuh"
namespace simt = ltt::simt;
struct Policy {
  static constexpr bool kAKMajor = false, kBKMajor = true;
  const float* A; const float* B; float* C; int M, N, K, ktiles, m0, n0;
  __device__ __forceinline__ const float* a(int kt, int x, int y, bool& ok) const {
    const int k = kt * simt::kBK + y, m = m0 + x;
    ok = k < K && m < M;
    return ok ? A + (size_t)m * K + k : A;
  }
  __device__ __forceinline__ const float* b(int kt, int x, int y, bool& ok) const {
    const int k = kt * simt::kBK + x, n = n0 + y;
    ok = k < K && n < N;
    return ok ? B + (size_t)k * N + n : B;
  }
  __device__ __forceinline__ void store4(int row, int col, float4 v) const {
    *reinterpret_cast<float4*>(C + (size_t)row * N + col) = v;
  }
};
__global__ void __launch_bounds__(simt::kThreads, simt::kBlocksPerSm)
    kern(const float* A, const float* B, float* C, int M, int N, int K) {
  extern __shared__ __align__(16) float smem[];
  const Policy p{A, B, C, M, N, K, (K + simt::kBK - 1) / simt::kBK,
                 (int)blockIdx.y * simt::kBM, (int)blockIdx.x * simt::kBN};
  simt::gemm_tile(p, p.m0, p.n0, smem);
}
static void opt_in() {
  if (simt::kSmemBytes > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, simt::kSmemBytes);
}
extern "C" int blocks_per_sm() {
  int n = 0;
  opt_in();
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, simt::kThreads, simt::kSmemBytes);
  return n;
}
extern "C" int run(const float* A, const float* B, float* C, int M, int N, int K, void* s) {
  opt_in();
  dim3 grid((N + simt::kBN - 1) / simt::kBN, (M + simt::kBM - 1) / simt::kBM);
  kern<<<grid, simt::kThreads, simt::kSmemBytes, (cudaStream_t)s>>>(A, B, C, M, N, K);
  return (int)cudaGetLastError();
}
'''

CONST = "constexpr int kBM = 128, kBN = 128, kBK = 16, kThreads = 256, kStages = 3;"
BLOCKS = "constexpr int kBlocksPerSm = 2;"
DOUBLE_BUFFERED = """      const int cur = k & 1, nxt = cur ^ 1;
      if (k + 1 < kBK) {
        fa[nxt][0] = *reinterpret_cast<const float4*>(as + (k + 1) * kBM);
        fa[nxt][1] = *reinterpret_cast<const float4*>(as + (k + 1) * kBM + 32);
        fb[nxt][0] = *reinterpret_cast<const float4*>(bs + (k + 1) * kBM);
        fb[nxt][1] = *reinterpret_cast<const float4*>(bs + (k + 1) * kBM + 16);
      }"""
SINGLE_BUFFERED = """      const int cur = 0;
      {
        fa[0][0] = *reinterpret_cast<const float4*>(as + k * kBM);
        fa[0][1] = *reinterpret_cast<const float4*>(as + k * kBM + 32);
        fb[0][0] = *reinterpret_cast<const float4*>(bs + k * kBM);
        fb[0][1] = *reinterpret_cast<const float4*>(bs + k * kBM + 16);
      }"""


def stages(bk, n):
    return CONST.replace("kBK = 16", f"kBK = {bk}").replace("kStages = 3", f"kStages = {n}")


VARIANTS = {
    "base": [],
    "stages4": [(CONST, stages(16, 4))],
    "bk8_stages3": [(CONST, stages(8, 3))],
    "bk8_stages4": [(CONST, stages(8, 4))],
    "bk32_stages3": [(CONST, stages(32, 3))],
    "single_buffered": [(DOUBLE_BUFFERED, SINGLE_BUFFERED)],
    "one_block_an_sm": [(BLOCKS, "constexpr int kBlocksPerSm = 1;")],
}
SHAPES = ((4096, 2048, 2048), (4096, 4096, 4096))


def build(name):
    text = (CSRC / "simt_gemm.cuh").read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            sys.exit(f"variant {name}: the header no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "simt_gemm.cuh").write_text(text)
    (d / "harness.cu").write_text(HARNESS)
    cmd = [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(d), "-I", str(CSRC),
           "-o", str(d / "lib.so"), str(d / "harness.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        sys.exit(f"variant {name}: nvcc failed\n{r.stderr[-3000:]}")
    regs = re.findall(r"Used (\d+) registers", r.stderr)
    spills = re.findall(r"(\d+) bytes spill stores", r.stderr)
    return name, regs, spills


def sass_opcodes(lib: Path) -> dict:
    sass = subprocess.run([str(Path(NVCC).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    ops = {}
    for line in sass.splitlines():
        m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m:
            op = m.group(2).split(".")[0]
            ops[op] = ops.get(op, 0) + 1
    return dict(sorted(ops.items(), key=lambda t: -t[1]))


def per_call_ms(fn, n=20, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return sorted(times)[len(times) // 2]


def main():
    if not torch.cuda.is_available():
        sys.exit("time_simt_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip(), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = list(ex.map(build, VARIANTS))
    libs = {}
    for name, regs, spills in built:
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.run.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.blocks_per_sm.argtypes, lib.blocks_per_sm.restype = [], ctypes.c_int
        print(f"{name}: {regs} registers, {spills} bytes of spill stores, "
              f"{lib.blocks_per_sm()} blocks an SM", flush=True)
        libs[name] = lib
    print(f"base SASS opcodes: {sass_opcodes(OUT / 'base' / 'lib.so')}", flush=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for M, K, N in SHAPES:
        A = torch.randn(M, K, generator=g, device="cuda")
        B = torch.randn(K, N, generator=g, device="cuda") * K ** -0.5
        outs = {name: torch.empty(M, N, device="cuda") for name in libs}
        fns = {name: (lambda lib=lib, o=outs[name]: lib.run(A.data_ptr(), B.data_ptr(),
                                                            o.data_ptr(), M, N, K, stream))
               for name, lib in libs.items()}
        fns["torch.matmul"] = lambda: torch.matmul(A, B)
        sampler = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                    "--format=csv,noheader", "-lms", "100"],
                                   stdout=subprocess.PIPE, text=True)
        for _ in range(500):
            fns["base"]()
        torch.cuda.synchronize()
        sampler.terminate()
        samples = [s for s in sampler.communicate()[0].splitlines() if s]
        print(f"M{M} K{K} N{N}: SM clock, power while the base runs: {samples}", flush=True)
        times = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                times[name].append(per_call_ms(fns[name]))
        torch.cuda.synchronize()
        bound = 2 * M * K * N / (FFMA_TFLOPS * 1e12) * 1e3
        for name, (t0, t1) in times.items():
            same = "" if name not in outs else f", bits equal the base's: " \
                f"{torch.equal(outs[name], outs['base'])}"
            print(f"M{M} K{K} N{N} {name}: {t0:.4f} / {t1:.4f} ms "
                  f"({bound / min(t0, t1):.3f} of the FFMA bound {bound:.4f}){same}", flush=True)


if __name__ == "__main__":
    main()
