"""Public GEMM API (port of laser_tpu/ops/gemm/api.py: ``gemm``).

Dispatch follows laser_tpu (api.py:195-216): any fused case (bias, epilogue
or C) runs the hand-written kernel; a plain float product goes to
``torch.matmul``, as laser_tpu hands it to XLA. Inputs are f32, bf16 or f16
with fp32 accumulation; the result is the input dtype unless ``out_dtype``
says otherwise. Integer and f64 GEMMs, ``gemm_strided``, the tile planner
and the autotuner are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...config import pin_fp32_matmul
from .kernel import FLOAT_DTYPES, gemm_fused, gemm_plain


def _operands(a, b, transpose_a, transpose_b):
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"gemm expects 2-D operands, got {tuple(a.shape)} x {tuple(b.shape)}")
    ka = a.shape[0] if transpose_a else a.shape[1]
    kb = b.shape[1] if transpose_b else b.shape[0]
    if ka != kb:
        raise ValueError(f"gemm shape mismatch: {tuple(a.shape)} x {tuple(b.shape)} "
                         f"(transpose_a={transpose_a}, transpose_b={transpose_b})")
    dt = torch.result_type(a, b)
    if dt not in FLOAT_DTYPES:
        raise NotImplementedError(
            f"gemm: {dt} is not ported (int8/int32/int64 and f64 GEMMs wait "
            "for later work); f32, bf16 and f16 are")
    return a.to(dt), b.to(dt), dt


def gemm(a: torch.Tensor, b: torch.Tensor, *, alpha=1.0, beta=0.0,
         c: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
         epilogue: Optional[str] = None, out_dtype=None,
         transpose_a: bool = False, transpose_b: bool = False) -> torch.Tensor:
    """out = epilogue(alpha * (op(a) @ op(b)) + beta * c + bias).

    a: (M, K), or (K, M) with ``transpose_a``; b: (K, N), or (N, K) with
    ``transpose_b``; c: (M, N); bias: (N,)."""
    a, b, dt = _operands(a, b, transpose_a, transpose_b)
    out_dtype = out_dtype or dt
    if epilogue is not None or bias is not None or c is not None:
        return gemm_fused(a.contiguous(), b.contiguous(), alpha=alpha,
                          beta=beta, c=c, bias=bias, epilogue=epilogue,
                          out_dtype=out_dtype, transpose_a=transpose_a,
                          transpose_b=transpose_b)
    if dt == torch.float32:
        pin_fp32_matmul()
    r = torch.matmul(a.t() if transpose_a else a, b.t() if transpose_b else b)
    if alpha != 1.0:
        r = r * alpha
    return r.to(out_dtype)


def gemm_reference(a, b, **kwargs) -> torch.Tensor:
    """``gemm`` through the fused kernel's plain version on any device."""
    a, b, dt = _operands(a, b, kwargs.get("transpose_a", False),
                         kwargs.get("transpose_b", False))
    return gemm_plain(a, b, **kwargs)
