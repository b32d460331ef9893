"""Exact int64 GEMM, mod 2^64 (port of laser_tpu/ops/gemm/int64_kernel.py:
``int64_limbs``, ``_combine_mod64``, ``gemm_int64``).

The int32 GEMM's digit split widened to 8 limbs: A @ B = sum_{i+j<8}
(A_i @ B_j) << 8(i+j) mod 2^64, 36 int8 products. The 64-bit combine needs
carries an int32 accumulator cannot hold, so the limb kernel
(``gemm_limbs_kmajor``, csrc/limb_gemm.cu) emits the 8 exact bucket planes
and the combine sum_s int64(S_s) << 8s runs as a torch pass. B's limbs are
split from ``b.t()``, so they come K-major, (8, N, K), as the kernel's
wgmma route reads them. Each bucket sums
at most 8 K products of magnitude <= 2^14, so K is chunked at 8192
(``max_k_for(8)``) and chunk results add mod 2^64. The combine, alpha and
beta * C are int64 tensor arithmetic, which wraps in two's complement in
torch on the CPU and the card alike (as XLA's does in laser_tpu); the digit
split itself does not rely on it (``signed_limbs``). uint64 rides the same
path through ``Tensor.view``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .int32_kernel import signed_limbs
from .limb_kernel import gemm_limbs_kmajor, max_k_for

N_LIMBS = 8
K_CHUNK = max_k_for(N_LIMBS)  # 8192


def int64_limbs(x: torch.Tensor) -> torch.Tensor:
    """(..., R, C) int64 -> (8, ..., R, C) int8 limbs, sum_i limbs[i]
    2^(8i) == x mod 2^64 (laser_tpu's digits)."""
    return signed_limbs(x, N_LIMBS)


def combine_mod64(buckets: torch.Tensor) -> torch.Tensor:
    """(8, M, N) int32 bucket planes -> (M, N) int64, exact mod 2^64."""
    out = buckets[0].long()
    for s in range(1, N_LIMBS):
        out = out + (buckets[s].long() << (8 * s))
    return out


def int64_scalar(v) -> int:
    """A scalar cast to int64 as ``jnp.int64(v)`` (truncated toward zero),
    wrapped to 64 bits."""
    return ((int(v) + 2**63) % 2**64) - 2**63


def gemm_int64(a: torch.Tensor, b: torch.Tensor, *, alpha: int = 1, beta: int = 0,
               c: Optional[torch.Tensor] = None, limbs=gemm_limbs_kmajor) -> torch.Tensor:
    """alpha * (a @ b) + beta * c, exact mod 2^64; int64 or uint64 in and
    out. ``limbs`` is the bucket product on K-major B planes
    (``gemm_limbs_kmajor_plain``: the plain route on any device)."""
    was_uint = a.dtype == torch.uint64
    if was_uint:
        a, b = a.view(torch.int64), b.view(torch.int64)
        if c is not None:
            c = c.view(torch.int64)
    if a.dtype != torch.int64 or b.dtype != torch.int64:
        raise TypeError(f"gemm_int64: int64 or uint64 operands, got {a.dtype}, {b.dtype}")
    M, K = a.shape
    N = b.shape[1]
    out = torch.zeros((M, N), dtype=torch.int64, device=a.device)
    for k0 in range(0, K, K_CHUNK):
        k1 = min(k0 + K_CHUNK, K)
        buckets = limbs(int64_limbs(a[:, k0:k1]), int64_limbs(b[k0:k1, :].t()), N_LIMBS)
        out = out + combine_mod64(buckets)
    out = out * int64_scalar(alpha)
    if c is not None:
        out = out + int64_scalar(beta) * c
    return out.view(torch.uint64) if was_uint else out
