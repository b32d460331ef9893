"""Differentiable ``linear`` and ``gemm_ad`` (port of
laser_tpu/ops/gemm/autodiff.py).

Both are ``torch.autograd.Function``s with laser_tpu's VJPs:

- ``gemm_ad``: C = op(A) @ op(B); the backward is two more products in the
  orientation laser_tpu picks (autodiff.py:34-49). All go through ``gemm``'s
  dispatch: plain float products run ``torch.matmul``, as laser_tpu leaves
  them to XLA.
- ``linear``: without a gradient, ONE fused kernel (bias and activation in
  the epilogue). Under autograd the forward runs the fused kernel with the
  bias and no epilogue, keeps the pre-activation ``z`` and applies the
  activation in torch (autodiff.py:84-87), so bf16 rounds ``z`` where
  laser_tpu rounds it. The backward is the activation's derivative from the
  ``_ACT`` table (gelu: the tanh form), dx = gz.w^T, dw = x^T.gz (plain
  products) and db = sum(gz).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .api import gemm, gemm_reference


def _gemm_ad_bwd(a, b, g, transpose_a, transpose_b):
    if not transpose_a:
        da = gemm(g, b, transpose_b=not transpose_b, out_dtype=a.dtype)
    else:  # C = A^T B: dA = B G^T
        da = gemm(b, g, transpose_a=transpose_b, transpose_b=True, out_dtype=a.dtype)
    if not transpose_b:
        db = gemm(a, g, transpose_a=not transpose_a, out_dtype=b.dtype)
    else:  # C = A B^T: dB = G^T A
        db = gemm(g, a, transpose_a=True, transpose_b=transpose_a, out_dtype=b.dtype)
    return da, db


class _GemmAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, out_dtype, transpose_a, transpose_b):
        ctx.save_for_backward(a, b)
        ctx.trans = (transpose_a, transpose_b)
        return gemm(a, b, out_dtype=out_dtype, transpose_a=transpose_a,
                    transpose_b=transpose_b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da, db = _gemm_ad_bwd(a, b, g.contiguous(), *ctx.trans)
        return da, db, None, None, None


def gemm_ad(a: torch.Tensor, b: torch.Tensor, out_dtype=None,
            transpose_a: bool = False, transpose_b: bool = False) -> torch.Tensor:
    """Differentiable C = op(A) @ op(B). A plain float product:
    ``torch.matmul``, forward and backward."""
    return _GemmAD.apply(a, b, out_dtype, transpose_a, transpose_b)


def _bias(w, bias):
    # laser_tpu always passes a bias (zeros when absent), so every linear
    # runs the fused kernel
    return torch.zeros((w.shape[1],), dtype=w.dtype, device=w.device) \
        if bias is None else bias


def _gelu_tanh(z):
    return F.gelu(z, approximate="tanh")


# activation and its derivative at the pre-activation z (autodiff.py:74-81);
# gelu's derivative comes from autograd of the tanh form, as jax.vjp there
_ACT = {
    None: (lambda z: z, lambda z: torch.ones_like(z)),
    "none": (lambda z: z, lambda z: torch.ones_like(z)),
    "relu": (torch.relu, lambda z: (z > 0).to(z.dtype)),
    "tanh": (torch.tanh, lambda z: 1 - torch.tanh(z) ** 2),
    "sigmoid": (torch.sigmoid, lambda z: torch.sigmoid(z) * (1 - torch.sigmoid(z))),
    "gelu": (_gelu_tanh, None),
}


def _act_table(activation):
    if activation not in _ACT:
        raise ValueError(f"unknown activation {activation!r}; have "
                         f"{[k for k in _ACT if k]}")
    return _ACT[activation]


class _Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, activation):
        act, _ = _act_table(activation)
        z = gemm(x, w, bias=bias)  # the pre-activation is the residual
        ctx.save_for_backward(x, w, z)
        ctx.activation = activation
        return act(z)

    @staticmethod
    def backward(ctx, g):
        x, w, z = ctx.saved_tensors
        act, dact = _act_table(ctx.activation)
        if dact is None:
            with torch.enable_grad():
                zz = z.detach().requires_grad_(True)
                gz, = torch.autograd.grad(act(zz), zz, g)
        else:
            gz = g * dact(z)
        gz = gz.contiguous()
        dx = gemm(gz, w, transpose_b=True)
        dw = gemm(x, gz, transpose_a=True)
        return dx, dw, gz.sum(dim=0), None


def linear(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
           activation: Optional[str] = None) -> torch.Tensor:
    """Fused linear layer act(x @ w + bias). Without a gradient: one kernel
    with the activation in its epilogue; under autograd: the kernel without
    the epilogue, then the activation, with laser_tpu's backward."""
    bias = _bias(w, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, bias)):
        return _Linear.apply(x, w, bias, activation)
    return gemm(x, w, bias=bias, epilogue=activation)


def linear_reference(x, w, bias=None, activation=None) -> torch.Tensor:
    """``linear`` through the kernel's plain version, on any device;
    differentiable by autograd."""
    return gemm_reference(x, w, bias=_bias(w, bias), epilogue=activation)
