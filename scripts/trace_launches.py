#!/usr/bin/env python3
"""Which kernel launches torch.profiler's trace keeps.

    python3 scripts/trace_launches.py

chip_smoke.py phase 16 found that the trace keeps none of
``sgdm_multi_kernel``'s launches (csrc/optim.cu: the leaf table is one
~30 KB ``__grid_constant__`` parameter, which CUDA 12.1+ allows on Hopper;
the limit was 4 KB before). This script profiles, each in its own session
of device activity only (as chip_smoke.py's ``profile_step``) after one
warm-up launch outside it, 10 launches of:

- ``touch<4000>`` and ``touch<32000>``: two one-block kernels that differ
  only in the size of their one ``__grid_constant__`` parameter (built with
  nvcc, sm_90a, into ``build/trace_launches/``);
- ``sgdm_multi_kernel`` through ``ops.optim.sgdm_update`` on one bf16 leaf
  of 4096 elements and on one of 2^26 (a long kernel over 8192 blocks);
- the per-leaf ``sgdm_kernel`` (``route="classic"``) on the 2^26 leaf.

It prints one JSON line: the launches of each case the trace kept, beside
the card's name and power limit and the torch and CUDA versions. Needs a
CUDA card and nvcc (the library is built on first use).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from laser_tpu_torch import registry  # noqa: E402
from laser_tpu_torch.ops import optim  # noqa: E402

SIZES = (4000, 32000)
LAUNCHES = 10
BIG = 1 << 26
SOURCE = r"""
#include <cuda_runtime.h>
template <int B> struct Params { float* p; char pad[B - 8]; };
template <int B> __global__ void touch(const __grid_constant__ Params<B> a) {
  if (threadIdx.x == 0) a.p[blockIdx.x] += static_cast<float>(a.pad[B - 9]);
}
template <int B> int run(float* p, void* s) {
  Params<B> a{};
  a.p = p;
  touch<B><<<1, 32, 0, static_cast<cudaStream_t>(s)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
""" + "".join(f'extern "C" int touch_{b}(float* p, void* s) {{ return run<{b}>(p, s); }}\n'
              for b in SIZES)


def build_touch() -> ctypes.CDLL:
    out = registry.BUILD_ROOT.parent / "trace_launches"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "touch.cu", out / "libtouch.so"
    src.write_text(SOURCE)
    nvcc = registry.find_nvcc()
    if nvcc is None:
        raise registry.KernelBuildError("nvcc not found")
    subprocess.run([nvcc, *registry.NVCC_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                    "-shared", str(src), "-o", str(lib)], check=True)
    dll = ctypes.CDLL(str(lib))
    for b in SIZES:
        getattr(dll, f"touch_{b}").argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return dll


def kept_launches(fn, kernel: str) -> int:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(LAUNCHES):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if kernel in e.key)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    dll = build_touch()
    registry.load_library()
    p = torch.zeros(1, device="cuda")
    lr = torch.tensor(1e-3, device="cuda")

    def touch(b):
        return lambda: registry.check_launch(
            getattr(dll, f"touch_{b}")(p.data_ptr(), registry.stream_handle(p)), f"touch<{b}>")

    def sgd(n, route=None):
        p_, g_, m_ = (torch.randn(n, device="cuda").to(torch.bfloat16) for _ in range(3))
        return lambda: optim.sgdm_update(p_, g_, m_, lr=lr, mu=0.9, nesterov=False, route=route)

    cases = {f"touch<{b}>": (touch(b), f"touch<{b}>") for b in SIZES}
    cases["sgdm_multi_kernel 4096"] = (sgd(4096), "sgdm_multi_kernel")
    cases["sgdm_multi_kernel 2^26"] = (sgd(BIG), "sgdm_multi_kernel")
    cases["sgdm_kernel 2^26"] = (sgd(BIG, "classic"), "sgdm_kernel")
    kept = {name: kept_launches(fn, kernel) for name, (fn, kernel) in cases.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip(), "torch": torch.__version__,
                      "cuda": torch.version.cuda, "launches": LAUNCHES, "kept": kept}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
