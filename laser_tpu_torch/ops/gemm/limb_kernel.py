"""Bucketed int8 digit-plane products: the substrate of the int64 and f64
GEMMs (port of laser_tpu/ops/gemm/limb_kernel.py: ``max_k_for``,
``gemm_limbs``).

Both wide GEMMs split each operand into int8 digit planes, so the product
is a sum over digit pairs (p, q) grouped by bucket s = p + q:

    out[s] = sum_{p+q=s} A_p @ B_q      (int8 x int8 -> int32, exact)

``gemm_limbs`` computes every bucket plane s < n_buckets in one pass over
K. For a CUDA tensor it launches the hand-written kernel
(csrc/limb_gemm.cu: WMMA s8 on the tensor cores, all planes of a tile
staged once); for a CPU tensor it runs the plain version. torch has no
integer product on the card, so the plain version sums each bucket's pairs
as one f64 product over the planes laid side by side along K: exact, since
a bucket's sum stays below 8 K 2^14 < 2^53.

Replaces laser_tpu/ops/gemm/limb_kernel.py:75 build_gemm_limbs. Bound on
the H100: the int8 tensor-core rate times the number of digit products
(36 for 8 planes and 8 buckets). laser_tpu's VMEM tile planner
(``plan_limb_tiles``) and its padding to Mosaic's (32, 128) int8 tiling are
not ported: the kernel picks its own tile and masks the tails.

Exactness: |S_s| <= n K 2^14 must fit int32; callers chunk K at
``max_k_for`` (beyond it the kernel's int32 accumulator wraps, and the
plain version wraps its exact sum the same way).
"""

from __future__ import annotations

import torch

from ... import registry
from .kernel import exact_int_product, wrap32

GEMM_LIMBS = registry.kernel("gemm_limbs", "laser_tpu_torch/csrc/limb_gemm.cu",
                             "laser_tpu/ops/gemm/limb_kernel.py:75 build_gemm_limbs")

# digit planes a side and buckets the kernel holds (the int64 and f64 GEMMs
# use at most 8)
MAX_PLANES = 8


def max_k_for(n_limbs: int, digit_max: int = 128) -> int:
    """Largest K whose bucket sums provably fit an int32 accumulator
    (|S_s| <= n_limbs * K * digit_max^2, with a 2x margin)."""
    return int(2**30 // (n_limbs * digit_max * digit_max))


def bucket_pairs(n_a: int, n_b: int, n_buckets: int):
    """[(p, q), ...] for each bucket s < n_buckets: p + q = s, p < n_a, q < n_b."""
    return [[(p, s - p) for p in range(n_a) if 0 <= s - p < n_b] for s in range(n_buckets)]


def _check(a_digits, b_digits, n_buckets):
    if a_digits.dtype != torch.int8 or b_digits.dtype != torch.int8:
        raise TypeError(f"gemm_limbs: int8 digit planes, got {a_digits.dtype}, {b_digits.dtype}")
    if a_digits.ndim != 3 or b_digits.ndim != 3 or a_digits.shape[2] != b_digits.shape[1]:
        raise ValueError(f"gemm_limbs shapes: {tuple(a_digits.shape)} x {tuple(b_digits.shape)}")
    if n_buckets < 1:
        raise ValueError(f"gemm_limbs: n_buckets {n_buckets} < 1")
    nA, M, K = a_digits.shape
    nB, _, N = b_digits.shape
    return nA, nB, M, N, K


def gemm_limbs_plain(a_digits, b_digits, n_buckets: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: each bucket as one f64
    product of its A planes side by side along K with its B planes stacked
    along K, wrapped to int32 as the kernel's accumulator."""
    GEMM_LIMBS.plain_calls += 1
    nA, nB, M, N, K = _check(a_digits, b_digits, n_buckets)
    out = torch.zeros((n_buckets, M, N), dtype=torch.int32, device=a_digits.device)
    for s, pairs in enumerate(bucket_pairs(nA, nB, n_buckets)):
        if pairs:
            a = torch.cat([a_digits[p] for p, _ in pairs], dim=1)
            b = torch.cat([b_digits[q] for _, q in pairs], dim=0)
            out[s] = wrap32(exact_int_product(a, b))
    return out


def _gemm_limbs_cuda(a_digits, b_digits, n_buckets):
    nA, nB, M, N, K = _check(a_digits, b_digits, n_buckets)
    if max(nA, nB, n_buckets) > MAX_PLANES:
        raise NotImplementedError(
            f"gemm_limbs kernel: at most {MAX_PLANES} planes a side and buckets, got "
            f"{nA}, {nB}, {n_buckets}")
    if b_digits.device != a_digits.device:
        raise ValueError(f"gemm_limbs: b on {b_digits.device}, a on {a_digits.device}")
    a_digits, b_digits = a_digits.contiguous(), b_digits.contiguous()
    out = torch.empty((n_buckets, M, N), dtype=torch.int32, device=a_digits.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    status = registry.load_library().ltt_gemm_limbs(
        a_digits.data_ptr(), b_digits.data_ptr(), out.data_ptr(), nA, nB, n_buckets, M, N, K,
        registry.stream_handle(a_digits))
    registry.check_launch(status, "gemm_limbs")
    GEMM_LIMBS.launches += 1
    return out


def gemm_limbs(a_digits: torch.Tensor, b_digits: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """(nA, M, K) x (nB, K, N) int8 digit planes -> (n_buckets, M, N) int32
    bucket planes, out[s] = sum_{p+q=s} a[p] @ b[q]. The kernel for a CUDA
    tensor, the plain version for a CPU one."""
    if registry.on_cuda(a_digits):
        return _gemm_limbs_cuda(a_digits, b_digits, n_buckets)
    return gemm_limbs_plain(a_digits, b_digits, n_buckets)
