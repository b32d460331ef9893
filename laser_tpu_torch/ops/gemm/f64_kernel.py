"""float64 GEMM through int8 digit slices, the Ozaki scheme (port of
laser_tpu/ops/gemm/f64_kernel.py: ``f64_digits``, ``_bucket_weights``,
``gemm_f64``).

Each row of A and column of B gets a power-of-two scale, and its values
split into ``slices`` signed 7-bit digits of the scaled mantissa:

    A[i,:] = 2^(sa_i) sum_p dA_p[i,:] 128^-(p+1)     dA in [-64, 64]
    C[i,j] = 2^(sa_i + sb_j) sum_s S_s[i,j] 128^-(s+2),  S_s = sum_{p+q=s} dA_p @ dB_q

The bucket planes S_s come from the limb kernel (``gemm_limbs_kmajor``,
csrc/limb_gemm.cu), exact in int32; everything else is f64 torch on the
same device. B's digits are split from ``b.t()`` (one scale a row of it, a
column of b), so they come K-major, (slices, N, K), as the kernel's wgmma
route reads them: the same digits as ``f64_digits(b, 0, slices)``,
transposed. This is laser_tpu's ``_gemm_f64_jax`` route, the one JAX takes
where f64 is IEEE: the H100 holds f64, so laser_tpu's host route (digit
extraction on the host, the triple-f32 combine) exists only for the TPU
and is not ported. ``slices`` 8 (36 digit products) matches the classical
f64 inner-product bound; 4 (10 products) is the fast tier, about 2^-28
relative. K is chunked at ``max_k_for(slices, 64)`` (32768 for 8 slices).
Finite inputs only, as in laser_tpu; a zero row or column gives exact zeros
(the ``amax > 0`` guard).

``ldexp`` here multiplies by exact powers of two built from their bits, in
steps of at most 2^1000, so no step overflows where the result does not.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernel import _ACT, _epilogue_code
from .limb_kernel import gemm_limbs_kmajor, max_k_for

DEFAULT_SLICES = 8


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2.0 ** k exactly, for integer k in [-1022, 1023], from its bits."""
    return ((k.long() + 1023) << 52).view(torch.float64)


def ldexp(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """x * 2^n for f64 x and integer n (|n| <= 3000), exact wherever the
    result is a normal number."""
    n = n.long()
    for _ in range(3):
        k = n.clamp(-1000, 1000)
        x = x * _pow2(k)
        n = n - k
    return x


def f64_digits(x: torch.Tensor, axis: int, slices: int):
    """(R, C) f64 -> ((slices, R, C) int8 digits, int32 scales along the
    other axis). ``axis`` is the contraction axis (1 for A, 0 for B): one
    power-of-two scale per row of A or column of B, so that sum_p
    digits[p] 128^-(p+1) == ldexp(x, -scale) up to 2^(-7 slices)."""
    amax = x.abs().amax(dim=axis, keepdim=True)
    # amax = m 2^e with m in [0.5, 1); scale = e + 1 puts |t| <= 0.5, so
    # every digit fits [-64, 64]
    _, e = torch.frexp(torch.where(amax > 0, amax, torch.ones_like(amax)))
    scale = (e + 1).to(torch.int32)
    t = ldexp(x, -scale)
    digits = []
    for _ in range(slices):
        t = t * 128.0
        d = torch.round(t)  # half to even, as jnp.round
        t = t - d
        digits.append(d.to(torch.int8))
    return torch.stack(digits).contiguous(), scale.squeeze(axis)


def bucket_weights(n_buckets: int):
    return [2.0 ** (-7 * (s + 2)) for s in range(n_buckets)]


def gemm_f64(a: torch.Tensor, b: torch.Tensor, *, alpha=1.0, beta=0.0,
             c: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
             epilogue: Optional[str] = None, slices: int = DEFAULT_SLICES,
             limbs=gemm_limbs_kmajor) -> torch.Tensor:
    """epilogue(alpha * (a @ b) + beta * c + bias) in f64 through int8 digit
    products; a (M, K), b (K, N) f64. ``limbs`` is the bucket product on
    K-major B planes (``gemm_limbs_kmajor_plain``: the plain route on any
    device)."""
    act = _ACT[_epilogue_code(epilogue)]
    a, b = a.double(), b.double()
    M, K = a.shape
    N = b.shape[1]
    k_chunk = max_k_for(slices, digit_max=64)
    w = bucket_weights(slices)
    out = torch.zeros((M, N), dtype=torch.float64, device=a.device)
    for k0 in range(0, K, k_chunk):
        k1 = min(k0 + k_chunk, K)
        da, sa = f64_digits(a[:, k0:k1], 1, slices)
        db, sb = f64_digits(b[k0:k1, :].t(), 1, slices)
        buckets = limbs(da, db, slices)
        part = buckets[0].double() * w[0]
        for s in range(1, slices):
            part = part + buckets[s].double() * w[s]
        part = ldexp(part, sa[:, None] + sb[None, :])
        out = part if k0 == 0 else out + part
    out = out * float(alpha)
    if c is not None:
        out = out + float(beta) * c.double()
    if bias is not None:
        out = out + bias.double().reshape(1, -1)
    return act(out)
