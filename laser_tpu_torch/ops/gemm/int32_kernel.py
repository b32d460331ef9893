"""Exact int32 GEMM, mod 2^32 (port of laser_tpu/ops/gemm/int32_kernel.py:
``int32_limbs``, ``gemm_int32``).

Each int32 operand splits into 4 signed base-256 digits (limbs) in
[-128, 127], x = sum_i d_i 2^(8i) mod 2^32, and

    A @ B = sum_{i+j<=3} (A_i @ B_j) << 8(i+j)      (mod 2^32):

10 int8 products, every step exact mod 2^32, so the result is the
wrapping int32 product bit for bit, overflow included. uint32 rides the
same kernel through ``Tensor.view``: the product mod 2^32 is sign-agnostic
on the bits.

``int32_limbs`` runs once per operand on the device as a torch pass. Its
recurrence avoids int32 overflow (laser_tpu's ``x + 128`` and ``x - d``
wrap at the extremes and rely on it): d = (x & 255) - 2 (x & 128) and
x' = (x >> 8) + ((x >> 7) & 1) are the same digits and the same exact
division by 256. ``gemm_int32`` launches the hand-written kernel for a
CUDA tensor (csrc/limb_gemm.cu: the limb product's main loop on the int8
tensor cores with an epilogue that adds the buckets shifted by 8s and
applies alpha * acc + beta * C in uint32) and runs the plain version for a
CPU tensor: the 4 bucket sums as exact f64 products, the combine and the
epilogue in int64 with masks, never overflowing.

Replaces laser_tpu/ops/gemm/int32_kernel.py:65 build_gemm_int32. Bound on
the H100: 10 int8 products at the int8 tensor-core rate.
"""

from __future__ import annotations

from typing import Optional

import torch

from ... import registry
from .kernel import exact_int_product, int32_scalar, wrap32
from .limb_kernel import bucket_pairs

GEMM_INT32 = registry.kernel("gemm_int32", "laser_tpu_torch/csrc/limb_gemm.cu",
                             "laser_tpu/ops/gemm/int32_kernel.py:65 build_gemm_int32")

N_LIMBS = 4
_M32 = 0xFFFFFFFF


def signed_limbs(x: torch.Tensor, n: int) -> torch.Tensor:
    """(..., R, C) integer -> (n, ..., R, C) int8 signed base-256 digits,
    sum_i limbs[i] 2^(8i) == x mod 2^(8n), with no overflow on the way."""
    ls = []
    for i in range(n):
        low = x & 255
        ls.append((low - ((low & 128) << 1)).to(torch.int8))
        if i < n - 1:
            x = (x >> 8) + ((x >> 7) & 1)
    return torch.stack(ls)


def int32_limbs(x: torch.Tensor) -> torch.Tensor:
    """(..., R, C) int32 -> (4, ..., R, C) int8 limbs (laser_tpu's digits)."""
    return signed_limbs(x, N_LIMBS)


def _check(a_limbs, b_limbs, c):
    if a_limbs.dtype != torch.int8 or b_limbs.dtype != torch.int8 or \
            a_limbs.shape[0] != N_LIMBS or b_limbs.shape[0] != N_LIMBS:
        raise TypeError("gemm_int32 kernel: (4, M, K) and (4, K, N) int8 limbs")
    if a_limbs.ndim != 3 or b_limbs.ndim != 3 or a_limbs.shape[2] != b_limbs.shape[1]:
        raise ValueError(f"gemm_int32 shapes: {tuple(a_limbs.shape)} x {tuple(b_limbs.shape)}")
    M, N = a_limbs.shape[1], b_limbs.shape[2]
    if c is not None and (tuple(c.shape) != (M, N) or c.dtype != torch.int32):
        raise ValueError(f"gemm_int32: c must be ({M}, {N}) int32, got {tuple(c.shape)} {c.dtype}")
    return M, N, a_limbs.shape[2]


def gemm_int32_limbs_plain(a_limbs, b_limbs, alpha: int = 1, beta: int = 0,
                           c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the 4 bucket sums as exact
    f64 products, sum_s (S_s << 8s) and alpha * acc + beta * C mod 2^32 in
    int64 with masks."""
    GEMM_INT32.plain_calls += 1
    _check(a_limbs, b_limbs, c)
    acc = None
    for s, pairs in enumerate(bucket_pairs(N_LIMBS, N_LIMBS, N_LIMBS)):
        a = torch.cat([a_limbs[p] for p, _ in pairs], dim=1)
        b = torch.cat([b_limbs[q] for _, q in pairs], dim=0)
        term = (exact_int_product(a, b) & _M32) << (8 * s)
        acc = term if acc is None else acc + term
    r = ((acc & _M32) * int32_scalar(alpha)) & _M32
    if c is not None:
        r = r + ((c.long() * int32_scalar(beta)) & _M32)
    return wrap32(r)


def _gemm_int32_cuda(a_limbs, b_limbs, alpha, beta, c):
    M, N, K = _check(a_limbs, b_limbs, c)
    for name, t in (("b", b_limbs), ("c", c)):
        if t is not None and t.device != a_limbs.device:
            raise ValueError(f"gemm_int32: {name} on {t.device}, a on {a_limbs.device}")
    a_limbs, b_limbs = a_limbs.contiguous(), b_limbs.contiguous()
    c = c.contiguous() if c is not None else None
    out = torch.empty((M, N), dtype=torch.int32, device=a_limbs.device)
    if M == 0 or N == 0:
        return out
    status = registry.load_library().ltt_gemm_int32(
        a_limbs.data_ptr(), b_limbs.data_ptr(), None if c is None else c.data_ptr(),
        out.data_ptr(), M, N, K, int32_scalar(alpha), int32_scalar(beta),
        registry.stream_handle(a_limbs))
    registry.check_launch(status, "gemm_int32")
    GEMM_INT32.launches += 1
    return out


def gemm_int32_limbs(a_limbs, b_limbs, alpha=1, beta=0, c=None) -> torch.Tensor:
    """alpha * (A @ B) + beta * C mod 2^32 from (4, M, K) and (4, K, N)
    limbs: the kernel for a CUDA tensor, the plain version for a CPU one."""
    if registry.on_cuda(a_limbs):
        return _gemm_int32_cuda(a_limbs, b_limbs, alpha, beta, c)
    return gemm_int32_limbs_plain(a_limbs, b_limbs, alpha, beta, c)


def gemm_int32(a: torch.Tensor, b: torch.Tensor, *, alpha: int = 1, beta: int = 0,
               c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """alpha * (a @ b) + beta * c, exact mod 2^32; int32 or uint32 in and
    out. alpha and beta are cast to int32 as laser_tpu casts them (a float
    truncates toward zero)."""
    was_uint = a.dtype == torch.uint32
    if was_uint:
        a, b = a.view(torch.int32), b.view(torch.int32)
        if c is not None:
            c = c.view(torch.int32)
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"gemm_int32: int32 or uint32 operands, got {a.dtype}, {b.dtype}")
    out = gemm_int32_limbs(int32_limbs(a), int32_limbs(b), alpha, beta, c)
    return out.view(torch.uint32) if was_uint else out
