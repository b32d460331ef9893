"""``linear`` and ``gemm_ad`` (port of laser_tpu/ops/gemm/autodiff.py),
forward only. The ``torch.autograd.Function``s with kernel backwards come
with the training slice."""

from __future__ import annotations

from typing import Optional

import torch

from .api import gemm, gemm_reference


def gemm_ad(a: torch.Tensor, b: torch.Tensor, out_dtype=None,
            transpose_a: bool = False, transpose_b: bool = False) -> torch.Tensor:
    """C = op(A) @ op(B). A plain float product: ``torch.matmul``."""
    return gemm(a, b, out_dtype=out_dtype, transpose_a=transpose_a,
                transpose_b=transpose_b)


def _bias(w, bias):
    # laser_tpu always passes a bias (zeros when absent), so every linear
    # runs the fused kernel
    return torch.zeros((w.shape[1],), dtype=w.dtype, device=w.device) \
        if bias is None else bias


def linear(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
           activation: Optional[str] = None) -> torch.Tensor:
    """Fused linear layer x @ w + bias, then the activation: ONE kernel."""
    return gemm(x, w, bias=_bias(w, bias), epilogue=activation)


def linear_reference(x, w, bias=None, activation=None) -> torch.Tensor:
    """``linear`` through the kernel's plain version, on any device."""
    return gemm_reference(x, w, bias=_bias(w, bias), epilogue=activation)
