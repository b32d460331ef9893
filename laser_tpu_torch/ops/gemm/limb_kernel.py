"""Bucketed int8 digit-plane products: the substrate of the int64 and f64
GEMMs (port of laser_tpu/ops/gemm/limb_kernel.py: ``max_k_for``,
``gemm_limbs``).

Both wide GEMMs split each operand into int8 digit planes, so the product
is a sum over digit pairs (p, q) grouped by bucket s = p + q:

    out[s] = sum_{p+q=s} A_p @ B_q      (int8 x int8 -> int32, exact)

``gemm_limbs`` computes every bucket plane s < n_buckets. For a CUDA tensor
it launches a hand-written kernel (csrc/limb_gemm.cu), for a CPU tensor it
runs the plain version. Both kernels read B's planes K-major, (nB, N, K),
since the 8-bit wgmma forms read only K-major operands: the port's int64
and f64 GEMMs split ``b.t()`` to get them so and call
``gemm_limbs_kmajor``; ``gemm_limbs`` keeps laser_tpu's (nB, K, N) and, on
a CUDA tensor, first copies them K-major with csrc/transpose.cu's 1-byte
kernel (a ``transpose`` launch). Two routes, each with its own launch
counter: ``gemm_limbs_wgmma`` (wgmma s8 fed by a TMA ring, the skeleton of
csrc/wgmma_gemm.cuh: a 128 x 128 tile walks its buckets, each bucket's
pairs one after another along K, the bucket written at its last step; K a
multiple of 16, 16-byte bases) and ``gemm_limbs`` (WMMA s8, all planes of
a 32 x 64 tile staged once, every other call). ``route="classic"`` or
``"wgmma"`` asks for one (an error where it does not fit; an unknown name
raises ``ValueError`` on any device). torch has no integer product on the
card, so the plain version sums each bucket's pairs as one f64 product over
the planes laid side by side along K: exact, since a bucket's sum stays
below 8 K 2^14 < 2^53.

Replaces laser_tpu/ops/gemm/limb_kernel.py:75 build_gemm_limbs. Bound on
the H100: the int8 tensor-core rate times the number of digit products
(36 for 8 planes and 8 buckets). laser_tpu's VMEM tile planner
(``plan_limb_tiles``) and its padding to Mosaic's (32, 128) int8 tiling are
not ported: the kernels pick their own tiles and mask the tails.

Exactness: |S_s| <= n K 2^14 must fit int32; callers chunk K at
``max_k_for`` (beyond it the kernel's int32 accumulator wraps, and the
plain version wraps its exact sum the same way).
"""

from __future__ import annotations

import ctypes

import torch

from ... import registry
from ..transpose import transpose2d_batched
from .kernel import exact_int_product, wrap32

GEMM_LIMBS = registry.kernel("gemm_limbs", "laser_tpu_torch/csrc/limb_gemm.cu",
                             "laser_tpu/ops/gemm/limb_kernel.py:75 build_gemm_limbs")
GEMM_LIMBS_WGMMA = registry.kernel("gemm_limbs_wgmma", "laser_tpu_torch/csrc/limb_gemm.cu",
                                   "laser_tpu/ops/gemm/limb_kernel.py:75 build_gemm_limbs")
# route codes shared with csrc/limb_gemm.cu (enum Route), and the counter of each
ROUTES = {None: 0, "classic": 1, "wgmma": 2}
ROUTE_KERNELS = {1: GEMM_LIMBS, 2: GEMM_LIMBS_WGMMA}

# digit planes a side and buckets the kernels hold (the int64 and f64 GEMMs
# use at most 8)
MAX_PLANES = 8


def max_k_for(n_limbs: int, digit_max: int = 128) -> int:
    """Largest K whose bucket sums provably fit an int32 accumulator
    (|S_s| <= n_limbs * K * digit_max^2, with a 2x margin)."""
    return int(2**30 // (n_limbs * digit_max * digit_max))


def bucket_pairs(n_a: int, n_b: int, n_buckets: int):
    """[(p, q), ...] for each bucket s < n_buckets: p + q = s, p < n_a, q < n_b."""
    return [[(p, s - p) for p in range(n_a) if 0 <= s - p < n_b] for s in range(n_buckets)]


def _check(a_digits, bt_digits, n_buckets):
    """(nA, M, K) and K-major (nB, N, K) int8 planes -> nA, nB, M, N, K."""
    if a_digits.dtype != torch.int8 or bt_digits.dtype != torch.int8:
        raise TypeError(f"gemm_limbs: int8 digit planes, got {a_digits.dtype}, {bt_digits.dtype}")
    if a_digits.ndim != 3 or bt_digits.ndim != 3 or a_digits.shape[2] != bt_digits.shape[2]:
        raise ValueError(f"gemm_limbs shapes: {tuple(a_digits.shape)} x "
                         f"{tuple(bt_digits.shape)} (B K-major)")
    if n_buckets < 1:
        raise ValueError(f"gemm_limbs: n_buckets {n_buckets} < 1")
    nA, M, K = a_digits.shape
    nB, N = bt_digits.shape[:2]
    return nA, nB, M, N, K


def kmajor_view(b_planes: torch.Tensor) -> torch.Tensor:
    """laser_tpu's (n, K, N) planes seen K-major, (n, N, K), without a copy."""
    return b_planes.transpose(1, 2) if b_planes.ndim == 3 else b_planes


def gemm_limbs_kmajor_plain(a_digits, bt_digits, n_buckets: int) -> torch.Tensor:
    """The kernels' function in plain PyTorch, on K-major B planes (the
    plain route of the int64 and f64 GEMMs on any device): each bucket as
    one f64 product of its A planes side by side along K with its B planes
    stacked along K, wrapped to int32 as the kernels' accumulator."""
    GEMM_LIMBS.plain_calls += 1
    nA, nB, M, N, K = _check(a_digits, bt_digits, n_buckets)
    b_digits = bt_digits.transpose(1, 2)
    out = torch.zeros((n_buckets, M, N), dtype=torch.int32, device=a_digits.device)
    for s, pairs in enumerate(bucket_pairs(nA, nB, n_buckets)):
        if pairs:
            a = torch.cat([a_digits[p] for p, _ in pairs], dim=1)
            b = torch.cat([b_digits[q] for _, q in pairs], dim=0)
            out[s] = wrap32(exact_int_product(a, b))
    return out


def gemm_limbs_plain(a_digits, b_digits, n_buckets: int) -> torch.Tensor:
    """``gemm_limbs_kmajor_plain`` on laser_tpu's (nB, K, N) B planes."""
    return gemm_limbs_kmajor_plain(a_digits, kmajor_view(b_digits), n_buckets)


def gemm_limbs_kmajor(a_digits: torch.Tensor, bt_digits: torch.Tensor, n_buckets: int, *,
                      route=None) -> torch.Tensor:
    """(nA, M, K) x K-major (nB, N, K) int8 digit planes -> (n_buckets, M,
    N) int32 bucket planes, as the port's int64 and f64 GEMMs split them
    from ``b.t()``: the kernel for a CUDA tensor, the plain version for a
    CPU one. ``route``: None lets the launcher pick, "classic" or "wgmma"
    asks."""
    code = registry.route_code(ROUTES, route)
    if not registry.on_cuda(a_digits):
        return gemm_limbs_kmajor_plain(a_digits, bt_digits, n_buckets)
    nA, nB, M, N, K = _check(a_digits, bt_digits, n_buckets)
    if max(nA, nB, n_buckets) > MAX_PLANES:
        raise NotImplementedError(
            f"gemm_limbs kernel: at most {MAX_PLANES} planes a side and buckets, got "
            f"{nA}, {nB}, {n_buckets}")
    if bt_digits.device != a_digits.device:
        raise ValueError(f"gemm_limbs: b on {bt_digits.device}, a on {a_digits.device}")
    a_digits, bt_digits = a_digits.contiguous(), bt_digits.contiguous()
    out = torch.empty((n_buckets, M, N), dtype=torch.int32, device=a_digits.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    taken = ctypes.c_int(0)
    status = registry.load_library().ltt_gemm_limbs(
        a_digits.data_ptr(), bt_digits.data_ptr(), out.data_ptr(), nA, nB, n_buckets, M, N, K,
        code, ctypes.byref(taken), registry.stream_handle(a_digits))
    registry.check_launch(status, "gemm_limbs")
    ROUTE_KERNELS[taken.value].launches += 1
    return out


def gemm_limbs(a_digits: torch.Tensor, b_digits: torch.Tensor, n_buckets: int, *,
               route=None) -> torch.Tensor:
    """laser_tpu's signature: (nA, M, K) x (nB, K, N) int8 digit planes ->
    (n_buckets, M, N) int32 bucket planes, out[s] = sum_{p+q=s} a[p] @
    b[q]. For a CUDA tensor, one K-major copy of b (csrc/transpose.cu, a
    ``transpose`` launch), then ``gemm_limbs_kmajor``'s kernel."""
    if registry.on_cuda(a_digits):
        _check(a_digits, kmajor_view(b_digits), n_buckets)
        registry.route_code(ROUTES, route)
        return gemm_limbs_kmajor(a_digits, transpose2d_batched(b_digits), n_buckets,
                                 route=route)
    return gemm_limbs_kmajor(a_digits, kmajor_view(b_digits), n_buckets, route=route)
