"""Fused GEMM: the CUDA kernel wrapper and its plain PyTorch version.

Port of laser_tpu/ops/gemm/kernel.py. The kernel (csrc/gemm.cu) computes
``act(alpha * op(A) @ op(B) + beta * C + bias)`` with fp32 accumulation:
bf16/f16 inputs on the tensor cores (WMMA), f32 inputs as full-fp32 FFMA;
int8 inputs on the int8 tensor cores with an int32 accumulator that wraps
mod 2^32, the epilogue in int32 (alpha and beta cast to int32 first, as
laser_tpu casts them to the accumulator type: alpha = 0.5 is 0), relu on
the int and any other activation in fp32 on its value, then one cast to
the output dtype (int32 by default). Transposed operands are read in
place; M/N/K tails are masked.

Replaces laser_tpu/ops/gemm/kernel.py:62 build_gemm. Bound on the H100:
tensor-core throughput at prefill and training (M up to 8192), the weight
bytes from HBM at decode (M = 1..40); int8 at 4096^3, the int8 tensor-core
rate; f32, the FFMA rate (67 TFLOP/s). Four routes, each with its own
launch counter, the kernel library picking one from the shape and
alignment: ``gemm_i8_wgmma`` (int8 with K % 16 == 0, at any M: wgmma s8 fed
by a TMA ring on the 16-bit route's skeleton, int32 accumulators that wrap;
the 8-bit wgmma reads only K-major operands, so where the route may be
taken (None or "wgmma") a transposed A or a row-major B is first copied
K-major by csrc/transpose.cu, a ``transpose`` launch; the int32 epilogue as the
classic kernel's), ``gemm_splitk`` (bf16/f16 with M <= 40, f32 with M <= 64,
neither operand transposed, N % 8 == 0 (f32: N % 4), 16-byte-aligned
bases: the weight streamed through a cp.async ring over (column tile, K
split) blocks, mma.sync (FFMA for f32), partials summed in a fixed order by
a second kernel, so two calls give the same bits; its fp32 workspace
allocated here), ``gemm_wgmma`` (bf16/f16 with M > 40, K and each
operand's contiguous dimension multiples of 8, 16-byte-aligned bases:
wgmma fed by a TMA ring, a 128 x 128 tile, transposed operands read in
place), ``gemm_simt`` (f32 products split-K does not take, each operand's
contiguous dimension a multiple of 4, 16-byte-aligned bases: the FFMA
skeleton of csrc/simt_gemm.cuh, a 128 x 128 tile, 8 x 8 outputs a thread,
both operands staged k-major through a 3-stage ring; the same bits as the
classic FFMA kernel) and ``gemm`` (every other product: WMMA bf16/f16 and
s8 on a 64 x 64 tile, f32 FFMA). The M thresholds come from chip_smoke.py's
crossover (csrc/gemm.cu). Each applies the epilogue in the accumulator type
before one cast. ``route="classic"``, ``"wgmma"``, ``"splitk"`` or
``"simt"`` on a CUDA tensor asks for one (wgmma and simt at any M, split-K
up to 64 rows; int8 takes "classic" and "wgmma"; an error where it does not
fit), to time them against each other.

``gemm_fused`` launches the kernel for CUDA tensors and runs
``gemm_plain`` for CPU tensors; there is no other fallback. torch has no
integer product on the card, so the plain int8 version multiplies in f64,
exact for every integer sum below 2^53 (|a b| <= 2^14, so any K below
2^39), and wraps the sum to int32 without relying on int32 overflow.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ... import registry
from ...config import check_f32_precision, pin_fp32_matmul
from ..transpose import transpose2d

GEMM = registry.kernel("gemm", "laser_tpu_torch/csrc/gemm.cu",
                       "laser_tpu/ops/gemm/kernel.py:62 build_gemm")
GEMM_WGMMA = registry.kernel("gemm_wgmma", "laser_tpu_torch/csrc/gemm.cu",
                             "laser_tpu/ops/gemm/kernel.py:62 build_gemm")
GEMM_SPLITK = registry.kernel("gemm_splitk", "laser_tpu_torch/csrc/gemm.cu",
                              "laser_tpu/ops/gemm/kernel.py:62 build_gemm")
GEMM_SIMT = registry.kernel("gemm_simt", "laser_tpu_torch/csrc/gemm.cu",
                            "laser_tpu/ops/gemm/kernel.py:62 build_gemm")
GEMM_I8_WGMMA = registry.kernel("gemm_i8_wgmma", "laser_tpu_torch/csrc/gemm.cu",
                                "laser_tpu/ops/gemm/kernel.py:62 build_gemm")
# route codes shared with csrc/gemm.cu (enum Route), and the counter of each
ROUTES = {None: 0, "classic": 1, "wgmma": 2, "splitk": 3, "simt": 4}
ROUTE_KERNELS = {1: GEMM, 2: GEMM_WGMMA, 3: GEMM_SPLITK, 4: GEMM_SIMT}
# int8 inputs: the WMMA s8 kernel or the int8 wgmma route
I8_ROUTE_KERNELS = {1: GEMM, 2: GEMM_I8_WGMMA}

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
# the int8 path's output types in the kernel (any other: cast outside)
INT8_OUT_DTYPES = (torch.int32, *FLOAT_DTYPES)
_M32 = 0xFFFFFFFF


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with the same value mod 2^32, by masks on int64
    values below 2^33 (no int32 overflow)."""
    return (((x & _M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def int32_scalar(v) -> int:
    """A scalar cast to int32 as ``jnp.asarray(v, jnp.int32)``: truncated
    toward zero (then wrapped to 32 bits)."""
    return ((int(v) + 2**31) % 2**32) - 2**31


def exact_int_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of integer tensors as int64, through one f64 product: exact
    while every partial sum stays below 2^53 (torch has no integer product
    on the card)."""
    return torch.matmul(a.double(), b.double()).to(torch.int64)


def int_epilogue(acc, *, alpha, beta, c, bias, epilogue, out_dtype):
    """The int8 path's epilogue on an int64 ``acc`` (values mod 2^32):
    alpha * acc + beta * C + bias mod 2^32 by masked int64 products, relu on
    the int32 value, another activation in fp32 on it, one cast."""
    r = ((acc & _M32) * int32_scalar(alpha)) & _M32
    if c is not None:
        r = r + ((c.to(torch.int32).long() * int32_scalar(beta)) & _M32)
    if bias is not None:
        r = r + (bias.to(torch.int32).long().reshape(1, -1) & _M32)
    v = wrap32(r)
    code = _epilogue_code(epilogue)
    if code == 1:
        v = torch.clamp_min(v, 0)
    elif code:
        return _ACT[code](v.float()).to(out_dtype)
    return v.to(out_dtype)


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
    for bf16/f16 inputs, TF32 off for f32), the epilogue in fp32, one cast;
    int8 inputs: the exact product wrapped mod 2^32, the int32 epilogue."""
    GEMM.plain_calls += 1
    A = a.t() if transpose_a else a
    B = b.t() if transpose_b else b
    if a.dtype == torch.int8:
        return int_epilogue(exact_int_product(A, B), alpha=alpha, beta=beta, c=c, bias=bias,
                            epilogue=epilogue, out_dtype=out_dtype or torch.int32)
    pin_fp32_matmul()
    act = _ACT[_epilogue_code(epilogue)]
    out_dtype = out_dtype or a.dtype
    r = torch.matmul(A.float(), B.float()) * alpha
    if c is not None:
        r = r + beta * c.float()
    if bias is not None:
        r = r + bias.float().reshape(1, -1)
    return act(r).to(out_dtype)


def _gemm_cuda(a, b, *, alpha, beta, c, bias, epilogue, out_dtype,
               transpose_a, transpose_b, route=None):
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
    int8 = a.dtype == torch.int8
    if not (a.dtype in registry.DTYPE_CODES and out_dtype in registry.DTYPE_CODES
            or int8 and out_dtype in INT8_OUT_DTYPES):
        raise TypeError(f"gemm kernel: unsupported dtypes {a.dtype} -> {out_dtype}")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    # C and the bias enter the epilogue in the accumulator type (fp32, or
    # int32 for int8 inputs), as laser_tpu casts them
    acc_t = torch.int32 if int8 else torch.float32
    c_acc = c.to(acc_t).contiguous() if c is not None else None
    bias_acc = bias.to(acc_t).reshape(-1).contiguous() if bias is not None else None
    code, in_code = registry.route_code(ROUTES, route), registry.GEMM_DTYPE_CODES[a.dtype]
    if int8:
        alpha, beta = int32_scalar(alpha), int32_scalar(beta)
        if code in (ROUTES[None], ROUTES["wgmma"]):
            # the int8 wgmma route reads only K-major operands, (M, K) and
            # (N, K): one copy of each other operand (the WMMA kernel, where
            # the launcher still takes it, reads the copies alike)
            if transpose_a:
                a, transpose_a = transpose2d(a), False
            if not transpose_b:
                b, transpose_b = transpose2d(b), True
    ws = registry.scratch(registry.workspace(
        "ltt_gemm_workspace",
        ("gemm", M, N, K, transpose_a, transpose_b, in_code, code, a.data_ptr() % 16 == 0,
         b.data_ptr() % 16 == 0, a.device.index),
        a.data_ptr(), b.data_ptr(), M, N, K, int(transpose_a), int(transpose_b), in_code, code),
        a.device)
    taken = ctypes.c_int(0)
    status = registry.load_library().ltt_gemm(
        a.data_ptr(), b.data_ptr(),
        None if c_acc is None else c_acc.data_ptr(),
        None if bias_acc is None else bias_acc.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(), M, N, K, int(transpose_a),
        int(transpose_b), float(alpha), float(beta), _epilogue_code(epilogue), in_code,
        registry.GEMM_DTYPE_CODES[out_dtype], code, ctypes.byref(taken),
        registry.stream_handle(a))
    registry.check_launch(status, "gemm")
    (I8_ROUTE_KERNELS if int8 else ROUTE_KERNELS)[taken.value].launches += 1
    return out


def gemm_fused(a, b, *, alpha=1.0, beta=0.0, c=None, bias=None,
               epilogue=None, out_dtype=None, transpose_a=False,
               transpose_b=False, route=None):
    """The hand kernel for a CUDA tensor, its plain version for a CPU one.
    a, b share one float dtype or int8; c is (M, N); bias is (N,). ``route``:
    None lets the library pick, "classic", "wgmma", "splitk" or "simt" asks
    for one
    (a CUDA tensor's; a CPU tensor runs the plain version whatever the
    route, but an unknown name raises on both)."""
    default_out = torch.int32 if a.dtype == torch.int8 else a.dtype
    kw = dict(alpha=alpha, beta=beta, c=c, bias=bias, epilogue=epilogue,
              out_dtype=out_dtype or default_out, transpose_a=transpose_a,
              transpose_b=transpose_b)
    if registry.on_cuda(a):
        return _gemm_cuda(a, b, **kw, route=route)
    registry.route_code(ROUTES, route)
    return gemm_plain(a, b, **kw)
