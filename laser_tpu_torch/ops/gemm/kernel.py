"""Fused GEMM: the CUDA kernel wrapper and its plain PyTorch version.

Port of laser_tpu/ops/gemm/kernel.py. The kernel (csrc/gemm.cu) computes
``act(alpha * op(A) @ op(B) + beta * C + bias)`` with fp32 accumulation:
bf16/f16 inputs on the tensor cores (WMMA), f32 inputs as full-fp32 FFMA.
Transposed operands are read in place; M/N/K tails are masked.

Replaces laser_tpu/ops/gemm/kernel.py:62 build_gemm. Bound on the H100:
tensor-core throughput at prefill (M up to 4096), weight bytes from HBM at
decode (M = 8). Design: one 64x64 output tile per block, K walked through
shared memory, fp32 epilogue before one cast (details in csrc/gemm.cu).

``gemm_fused`` launches the kernel for CUDA tensors and runs
``gemm_plain`` for CPU tensors; there is no other fallback.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ... import registry
from ...config import check_f32_precision, pin_fp32_matmul

GEMM = registry.kernel("gemm", "laser_tpu_torch/csrc/gemm.cu",
                       "laser_tpu/ops/gemm/kernel.py:62 build_gemm")

# epilogue codes shared with csrc/gemm.cu (enum Epilogue)
EPILOGUES = {None: 0, "none": 0, "relu": 1, "tanh": 2, "sigmoid": 3, "gelu": 4}

_ACT = {
    0: lambda r: r,
    1: torch.relu,
    2: torch.tanh,
    3: torch.sigmoid,
    # jax.nn.gelu defaults to the tanh approximation; so does the kernel
    4: lambda r: F.gelu(r, approximate="tanh"),
}

FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def epilogue_names():
    return [k for k in EPILOGUES if k]


def _epilogue_code(epilogue: Optional[str]) -> int:
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; have {epilogue_names()}")
    return EPILOGUES[epilogue]


def gemm_plain(a, b, *, alpha=1.0, beta=0.0, c=None, bias=None,
               epilogue=None, out_dtype=None, transpose_a=False,
               transpose_b=False):
    """The kernel's function in plain PyTorch: the products in fp32 (exact
    for bf16/f16 inputs, TF32 off for f32), the epilogue in fp32, one cast."""
    GEMM.plain_calls += 1
    pin_fp32_matmul()
    act = _ACT[_epilogue_code(epilogue)]
    out_dtype = out_dtype or a.dtype
    A = a.t() if transpose_a else a
    B = b.t() if transpose_b else b
    r = torch.matmul(A.float(), B.float()) * alpha
    if c is not None:
        r = r + beta * c.float()
    if bias is not None:
        r = r + bias.float().reshape(1, -1)
    return act(r).to(out_dtype)


def _gemm_cuda(a, b, *, alpha, beta, c, bias, epilogue, out_dtype,
               transpose_a, transpose_b):
    if a.dtype == torch.float32:
        check_f32_precision()
    M = a.shape[1] if transpose_a else a.shape[0]
    K = a.shape[0] if transpose_a else a.shape[1]
    N = b.shape[0] if transpose_b else b.shape[1]
    for name, t in (("a", a), ("b", b), ("c", c), ("bias", bias)):
        if t is not None and t.device != a.device:
            raise ValueError(f"gemm: {name} is on {t.device}, a on {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gemm kernel: a and b must be contiguous (pass a "
                         "transposed operand with transpose_a/transpose_b)")
    if c is not None and tuple(c.shape) != (M, N):
        raise ValueError(f"gemm: c shape {tuple(c.shape)} != {(M, N)}")
    if bias is not None and bias.numel() != N:
        raise ValueError(f"gemm: bias has {bias.numel()} elements, N = {N}")
    if b.dtype != a.dtype:
        raise TypeError(f"gemm kernel: a {a.dtype} and b {b.dtype} differ")
    if a.dtype not in registry.DTYPE_CODES or out_dtype not in registry.DTYPE_CODES:
        raise TypeError(f"gemm kernel: unsupported dtypes {a.dtype} -> {out_dtype}")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    # C and the bias enter the fp32 epilogue; their fp32 copies are exact
    c32 = c.float().contiguous() if c is not None else None
    bias32 = bias.float().reshape(-1).contiguous() if bias is not None else None
    lib = registry.load_library()
    status = lib.ltt_gemm(
        a.data_ptr(), b.data_ptr(),
        None if c32 is None else c32.data_ptr(),
        None if bias32 is None else bias32.data_ptr(),
        out.data_ptr(), M, N, K, int(transpose_a), int(transpose_b),
        float(alpha), float(beta), _epilogue_code(epilogue),
        registry.DTYPE_CODES[a.dtype], registry.DTYPE_CODES[out_dtype],
        registry.stream_handle(a))
    registry.check_launch(status, "gemm")
    GEMM.launches += 1
    return out


def gemm_fused(a, b, *, alpha=1.0, beta=0.0, c=None, bias=None,
               epilogue=None, out_dtype=None, transpose_a=False,
               transpose_b=False):
    """The hand kernel for a CUDA tensor, its plain version for a CPU one.
    a, b share one float dtype; c is (M, N); bias is (N,)."""
    kw = dict(alpha=alpha, beta=beta, c=c, bias=bias, epilogue=epilogue,
              out_dtype=out_dtype or a.dtype, transpose_a=transpose_a,
              transpose_b=transpose_b)
    if registry.on_cuda(a):
        return _gemm_cuda(a, b, **kw)
    return gemm_plain(a, b, **kw)
