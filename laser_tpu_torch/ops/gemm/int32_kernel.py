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
division by 256. ``gemm_int32`` splits A and ``b.t()``, so B's limbs come
K-major, (4, N, K), the one layout the kernels read, with no copy.
``gemm_int32_limbs_kmajor`` takes such limbs; ``gemm_int32_limbs`` takes
laser_tpu's (4, K, N) and, on a CUDA tensor, copies them K-major first
(csrc/transpose.cu, a ``transpose`` launch). For a CUDA tensor they launch
a hand-written kernel (csrc/limb_gemm.cu, two routes with their own
counters: ``gemm_int32_wgmma``, wgmma s8 on a TMA ring, the 4 buckets from
s = 3 down in one accumulator shifted left by 8 between them, for K % 16
== 0 and 16-byte bases; ``gemm_int32``, the WMMA limb product with an
epilogue that adds the buckets shifted by 8s, every other call; both apply
alpha * acc + beta * C in uint32; ``route=`` asks for one) and for a CPU
tensor run the plain version: the 4 bucket sums as exact f64 products, the
combine and the epilogue in int64 with masks, never overflowing.

Replaces laser_tpu/ops/gemm/int32_kernel.py:65 build_gemm_int32. Bound on
the H100: 10 int8 products at the int8 tensor-core rate.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ... import registry
from ..transpose import transpose2d_batched
from . import limb_kernel
from .kernel import exact_int_product, int32_scalar, wrap32
from .limb_kernel import bucket_pairs, kmajor_view

GEMM_INT32 = registry.kernel("gemm_int32", "laser_tpu_torch/csrc/limb_gemm.cu",
                             "laser_tpu/ops/gemm/int32_kernel.py:65 build_gemm_int32")
GEMM_INT32_WGMMA = registry.kernel("gemm_int32_wgmma", "laser_tpu_torch/csrc/limb_gemm.cu",
                                   "laser_tpu/ops/gemm/int32_kernel.py:65 build_gemm_int32")
# route codes shared with csrc/limb_gemm.cu (enum Route), as limb_kernel.ROUTES
ROUTES = limb_kernel.ROUTES
ROUTE_KERNELS = {1: GEMM_INT32, 2: GEMM_INT32_WGMMA}

N_LIMBS = 4
_M32 = 0xFFFFFFFF


def signed_limbs(x: torch.Tensor, n: int) -> torch.Tensor:
    """(..., R, C) integer -> (n, ..., R, C) int8 signed base-256 digits,
    sum_i limbs[i] 2^(8i) == x mod 2^(8n), with no overflow on the way.
    The result is contiguous, whatever x's strides (of ``b.t()``: B's
    digits K-major)."""
    ls = []
    for i in range(n):
        low = x & 255
        ls.append((low - ((low & 128) << 1)).to(torch.int8))
        if i < n - 1:
            x = (x >> 8) + ((x >> 7) & 1)
    return torch.stack(ls).contiguous()


def int32_limbs(x: torch.Tensor) -> torch.Tensor:
    """(..., R, C) int32 -> (4, ..., R, C) int8 limbs (laser_tpu's digits)."""
    return signed_limbs(x, N_LIMBS)


def _check(a_limbs, bt_limbs, c):
    """(4, M, K) and K-major (4, N, K) int8 limbs, C (M, N) -> M, N, K."""
    if a_limbs.dtype != torch.int8 or bt_limbs.dtype != torch.int8 or \
            a_limbs.shape[0] != N_LIMBS or bt_limbs.shape[0] != N_LIMBS:
        raise TypeError("gemm_int32 kernel: (4, M, K) and (4, N, K) int8 limbs")
    if a_limbs.ndim != 3 or bt_limbs.ndim != 3 or a_limbs.shape[2] != bt_limbs.shape[2]:
        raise ValueError(f"gemm_int32 shapes: {tuple(a_limbs.shape)} x "
                         f"{tuple(bt_limbs.shape)} (B K-major)")
    M, N = a_limbs.shape[1], bt_limbs.shape[1]
    if c is not None and (tuple(c.shape) != (M, N) or c.dtype != torch.int32):
        raise ValueError(f"gemm_int32: c must be ({M}, {N}) int32, got {tuple(c.shape)} {c.dtype}")
    return M, N, a_limbs.shape[2]


def gemm_int32_limbs_kmajor_plain(a_limbs, bt_limbs, alpha: int = 1, beta: int = 0,
                                  c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernels' function in plain PyTorch, on K-major B limbs: the 4
    bucket sums as exact f64 products, sum_s (S_s << 8s) and alpha * acc +
    beta * C mod 2^32 in int64 with masks."""
    GEMM_INT32.plain_calls += 1
    _check(a_limbs, bt_limbs, c)
    b_limbs = bt_limbs.transpose(1, 2)
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


def gemm_int32_limbs_plain(a_limbs, b_limbs, alpha: int = 1, beta: int = 0,
                           c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``gemm_int32_limbs_kmajor_plain`` on laser_tpu's (4, K, N) B limbs."""
    return gemm_int32_limbs_kmajor_plain(a_limbs, kmajor_view(b_limbs), alpha, beta, c)


def gemm_int32_limbs_kmajor(a_limbs, bt_limbs, alpha=1, beta=0, c=None, *, route=None
                            ) -> torch.Tensor:
    """alpha * (A @ B) + beta * C mod 2^32 from (4, M, K) limbs and K-major
    (4, N, K) ones, as ``gemm_int32`` splits them from ``b.t()``: the
    kernel for a CUDA tensor, the plain version for a CPU one. ``route``:
    None lets the launcher pick, "classic" or "wgmma" asks."""
    code = registry.route_code(ROUTES, route)
    if not registry.on_cuda(a_limbs):
        return gemm_int32_limbs_kmajor_plain(a_limbs, bt_limbs, alpha, beta, c)
    M, N, K = _check(a_limbs, bt_limbs, c)
    for name, t in (("b", bt_limbs), ("c", c)):
        if t is not None and t.device != a_limbs.device:
            raise ValueError(f"gemm_int32: {name} on {t.device}, a on {a_limbs.device}")
    a_limbs, bt_limbs = a_limbs.contiguous(), bt_limbs.contiguous()
    c = c.contiguous() if c is not None else None
    out = torch.empty((M, N), dtype=torch.int32, device=a_limbs.device)
    if M == 0 or N == 0:
        return out
    taken = ctypes.c_int(0)
    status = registry.load_library().ltt_gemm_int32(
        a_limbs.data_ptr(), bt_limbs.data_ptr(), None if c is None else c.data_ptr(),
        out.data_ptr(), M, N, K, int32_scalar(alpha), int32_scalar(beta), code,
        ctypes.byref(taken), registry.stream_handle(a_limbs))
    registry.check_launch(status, "gemm_int32")
    ROUTE_KERNELS[taken.value].launches += 1
    return out


def gemm_int32_limbs(a_limbs, b_limbs, alpha=1, beta=0, c=None, *, route=None) -> torch.Tensor:
    """laser_tpu's signature: alpha * (A @ B) + beta * C mod 2^32 from (4,
    M, K) and (4, K, N) limbs. For a CUDA tensor, one K-major copy of b's
    limbs (csrc/transpose.cu, a ``transpose`` launch), then
    ``gemm_int32_limbs_kmajor``'s kernel."""
    if registry.on_cuda(a_limbs):
        _check(a_limbs, kmajor_view(b_limbs), c)
        registry.route_code(ROUTES, route)
        return gemm_int32_limbs_kmajor(a_limbs, transpose2d_batched(b_limbs), alpha, beta, c,
                                       route=route)
    return gemm_int32_limbs_kmajor(a_limbs, kmajor_view(b_limbs), alpha, beta, c, route=route)


def gemm_int32(a: torch.Tensor, b: torch.Tensor, *, alpha: int = 1, beta: int = 0,
               c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """alpha * (a @ b) + beta * c, exact mod 2^32; int32 or uint32 in and
    out. alpha and beta are cast to int32 as laser_tpu casts them (a float
    truncates toward zero). B's limbs are split from ``b.t()``, K-major."""
    was_uint = a.dtype == torch.uint32
    if was_uint:
        a, b = a.view(torch.int32), b.view(torch.int32)
        if c is not None:
            c = c.view(torch.int32)
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"gemm_int32: int32 or uint32 operands, got {a.dtype}, {b.dtype}")
    out = gemm_int32_limbs_kmajor(int32_limbs(a), int32_limbs(b.t()), alpha, beta, c)
    return out.view(torch.uint32) if was_uint else out
