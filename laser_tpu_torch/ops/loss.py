"""Fused cross-entropy over logits (port of laser_tpu/ops/loss.py:
``cross_entropy`` and ``lm_cross_entropy``).

Per row, with label smoothing eps and the target distribution
q = (1 - eps) onehot(t) + eps / V:

    lse = log sum_c exp(x_c),   loss = lse - (1 - eps) x_t - (eps / V) sum_c x_c

Two CUDA kernels (csrc/cross_entropy.cu), routed as laser_tpu routes them:

- a value-only call (no gradient needed) runs ``ce_fwd``, replacing
  laser_tpu/ops/loss.py:41 _build_ce_fwd: one online max/sum pass per row,
  the per-row loss and lse out;
- under autograd, when ``fused_grad_bt(T, V)`` is not None, ``ce_fused_grad``
  (replacing laser_tpu/ops/loss.py:180 _build_ce_fused_grad) writes the
  per-row loss and the unit gradient dxu = softmax(x) - q in one kernel; the
  backward scales dxu by each row's cotangent (loss.py:301-307). laser_tpu's
  kernel writes dxu over the dead logits (``input_output_aliases``); the
  port writes a fresh (T, V) buffer, so the training step holds T x V x
  itemsize more bytes at its peak.
- past that threshold (padded V > 131072) laser_tpu runs its two-kernel
  online VJP (``_build_ce_bwd``), which is not ported: that case raises.

Bound on the H100: bytes (read the logits once; the fused kernel also writes
dxu). The routing threshold is laser_tpu's, derived from a TPU's 16 MB VMEM
working budget; on Hopper it is a placeholder to measure again.

``plain=True`` runs the kernels' plain PyTorch version, differentiable by
autograd; it is also what CPU tensors run.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import registry
from ..utils import round_step_up

CE_FWD = registry.kernel("ce_fwd", "laser_tpu_torch/csrc/cross_entropy.cu",
                         "laser_tpu/ops/loss.py:41 _build_ce_fwd")
CE_FUSED_GRAD = registry.kernel("ce_fused_grad", "laser_tpu_torch/csrc/cross_entropy.cu",
                                "laser_tpu/ops/loss.py:180 _build_ce_fused_grad")

REDUCTIONS = ("mean", "sum", "none")


def fused_grad_bt(T: int, V: int) -> Optional[int]:
    """laser_tpu's row-block height for the one-pass value+grad kernel
    (loss.py:266-273), or None when a (bt, V) f32 block would not fit its
    4 MB share of VMEM: the port keeps the rule only to route the same
    shapes to the same kernels."""
    Vp = round_step_up(V, 128)
    bt = min(round_step_up(T, 8), ((4 * 1024 * 1024) // (4 * Vp)) // 8 * 8)
    return bt if bt >= 8 else None


def ce_rows_plain(x: torch.Tensor, targets: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-row loss in fp32 from (T, V) logits: the kernels' function in
    plain PyTorch (no launch counting; differentiable by autograd)."""
    xf = x.float()
    V = xf.shape[-1]
    m = xf.amax(dim=-1, keepdim=True).detach()
    lse = (m + torch.log(torch.exp(xf - m).sum(dim=-1, keepdim=True))).squeeze(-1)
    hit = torch.arange(V, device=x.device)[None, :] == targets.long()[:, None]
    tv = torch.where(hit, xf, 0.0).sum(dim=-1)
    if eps:
        return lse - (1.0 - eps) * tv - (eps / V) * xf.sum(dim=-1)
    return lse - tv


def _checked(x, targets):
    if x.dtype not in registry.DTYPE_CODES:
        raise TypeError(f"cross-entropy kernel: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("cross-entropy kernel: logits must be contiguous")
    if targets.device != x.device:
        raise ValueError(f"cross-entropy kernel: targets on {targets.device}, "
                         f"logits on {x.device}")
    return targets.to(torch.int32).contiguous()


def ce_fwd_plain(x: torch.Tensor, targets: torch.Tensor, eps: float):
    """The ``ce_fwd`` kernel's function in plain PyTorch: (loss, lse)."""
    CE_FWD.plain_calls += 1
    return ce_rows_plain(x, targets, eps), torch.logsumexp(x.float(), dim=-1)


def ce_fwd(x: torch.Tensor, targets: torch.Tensor, eps: float):
    """(loss, lse), both (T,) fp32, from (T, V) logits: the ``ce_fwd``
    kernel for a CUDA tensor, its plain version for a CPU tensor."""
    if not registry.on_cuda(x):
        return ce_fwd_plain(x, targets, eps)
    t32 = _checked(x, targets)
    T, V = x.shape
    loss = torch.empty((T,), dtype=torch.float32, device=x.device)
    lse = torch.empty((T,), dtype=torch.float32, device=x.device)
    if T and V:
        status = registry.load_library().ltt_ce_fwd(
            x.data_ptr(), t32.data_ptr(), loss.data_ptr(), lse.data_ptr(), T, V,
            float(eps), registry.DTYPE_CODES[x.dtype], registry.stream_handle(x))
        registry.check_launch(status, "ce_fwd")
        CE_FWD.launches += 1
    return loss, lse


def ce_fused_grad_plain(x: torch.Tensor, targets: torch.Tensor, eps: float):
    """The ``ce_fused_grad`` kernel's function in plain PyTorch: (loss (T,)
    fp32, dxu = softmax(x) - q in x's dtype)."""
    CE_FUSED_GRAD.plain_calls += 1
    xf = x.float()
    V = x.shape[-1]
    loss = ce_rows_plain(x, targets, eps)
    m = xf.amax(dim=-1, keepdim=True)
    e = torch.exp(xf - m)
    q = (torch.arange(V, device=x.device)[None, :] == targets.long()[:, None]).float()
    if eps:
        q = (1.0 - eps) * q + eps / V
    return loss, (e / e.sum(dim=-1, keepdim=True) - q).to(x.dtype)


def ce_fused_grad(x: torch.Tensor, targets: torch.Tensor, eps: float):
    """(loss, dxu): the ``ce_fused_grad`` kernel for a CUDA tensor, its plain
    version for a CPU tensor. dxu is a new buffer, not the logits."""
    if not registry.on_cuda(x):
        return ce_fused_grad_plain(x, targets, eps)
    t32 = _checked(x, targets)
    T, V = x.shape
    loss = torch.empty((T,), dtype=torch.float32, device=x.device)
    dxu = torch.empty_like(x)
    if T and V:
        status = registry.load_library().ltt_ce_fused_grad(
            x.data_ptr(), t32.data_ptr(), loss.data_ptr(), dxu.data_ptr(), T, V,
            float(eps), registry.DTYPE_CODES[x.dtype], registry.stream_handle(x))
        registry.check_launch(status, "ce_fused_grad")
        CE_FUSED_GRAD.launches += 1
    return loss, dxu


class _CERows(torch.autograd.Function):
    """Per-row loss with the unit gradient kept as the residual
    (laser_tpu/ops/loss.py:276-307, _ce_fwd_vjp/_ce_bwd_vjp)."""

    @staticmethod
    def forward(ctx, x, targets, eps):
        T, V = x.shape
        if fused_grad_bt(T, V) is None:
            raise NotImplementedError(
                f"cross_entropy gradient at V={V} (padded > 131072) runs "
                "laser_tpu's two-kernel online VJP (_build_ce_bwd), which is "
                "not ported")
        loss, dxu = ce_fused_grad(x, targets, eps)
        ctx.save_for_backward(dxu)
        return loss

    @staticmethod
    def backward(ctx, g):
        dxu, = ctx.saved_tensors
        return (g.float()[:, None] * dxu.float()).to(dxu.dtype), None, None


def _ce_rows(x, targets, eps, plain):
    grad = torch.is_grad_enabled() and x.requires_grad
    if plain:  # counted as the kernel this call stands in for
        (CE_FUSED_GRAD if grad else CE_FWD).plain_calls += 1
        return ce_rows_plain(x, targets, eps)
    if grad:
        return _CERows.apply(x, targets, eps)
    return ce_fwd(x, targets, eps)[0]


def _check_args(reduction, label_smoothing):
    if reduction not in REDUCTIONS:
        raise ValueError(f"unknown reduction {reduction!r}")
    eps = float(label_smoothing)
    if not 0.0 <= eps < 1.0:
        raise ValueError(f"label_smoothing must be in [0, 1); got {eps}")
    return eps


def _reduce_rows(loss, valid, reduction, lead):
    if valid is not None:
        # zeroing the row also zeroes its cotangent, so its dx row vanishes
        loss = torch.where(valid, loss, 0.0)
    if reduction == "none":
        return loss.reshape(*lead) if lead else loss[0]
    if reduction == "sum":
        return loss.sum()
    if valid is not None:  # mean over the contributing rows only
        return loss.sum() / valid.sum().clamp(min=1)
    return loss.mean()


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, *,
                  reduction: str = "mean", label_smoothing: float = 0.0,
                  ignore_index: Optional[int] = None,
                  plain: bool = False) -> torch.Tensor:
    """Cross-entropy from raw logits: loss_t = lse(x_t) - x_t[y_t].

    logits (..., V) float, targets (...) int; leading dims flatten into
    rows. ``reduction``: "mean" | "sum" | "none" (per-row fp32 losses in the
    leading shape). Rows whose target equals ``ignore_index`` contribute
    zero loss and zero gradient; "mean" divides by the count of
    contributing rows."""
    eps = _check_args(reduction, label_smoothing)
    *lead, V = logits.shape
    if tuple(targets.shape) != tuple(lead):
        raise ValueError(f"targets shape {tuple(targets.shape)} != logits leading "
                         f"dims {tuple(lead)}")
    T = math.prod(lead)
    targets = targets.reshape(T)
    valid = None
    if ignore_index is not None:
        valid = targets != ignore_index
        targets = torch.where(valid, targets, 0)  # any in-range stand-in
    loss = _ce_rows(logits.reshape(T, V).contiguous(), targets, eps, plain)
    return _reduce_rows(loss, valid, reduction, lead)


def lm_cross_entropy(hidden: torch.Tensor, embed: torch.Tensor,
                     targets: torch.Tensor, *, transb: bool = True,
                     reduction: str = "mean", label_smoothing: float = 0.0,
                     ignore_index: Optional[int] = None,
                     memory_budget_bytes: Optional[int] = 1024 ** 3,
                     plain: bool = False) -> torch.Tensor:
    """Cross-entropy of the unembedding projection: logits = hidden @
    embed.T (``transb``, the tied (V, D) layout) or hidden @ embed ((D, V)).

    Only laser_tpu's materialized branch is ported: when 2 x T x Vp x
    itemsize fits ``memory_budget_bytes`` the logits are made by ``gemm_ad``
    in the hidden dtype (bf16 logits for bf16 hidden states, as laser_tpu
    makes them) and go through :func:`cross_entropy`. The chunked-vocabulary
    branch (``memory_budget_bytes=None`` or the budget exceeded) is not
    ported and raises; so is its ``block_v`` option."""
    from .gemm.autodiff import gemm_ad

    eps = _check_args(reduction, label_smoothing)
    *lead, D = hidden.shape
    V, De = embed.shape if transb else embed.shape[::-1]
    if De != D:
        raise ValueError(f"embed shape {tuple(embed.shape)} does not match hidden "
                         f"width {D} (transb={transb})")
    if tuple(targets.shape) != tuple(lead):
        raise ValueError(f"targets shape {tuple(targets.shape)} != hidden leading "
                         f"dims {tuple(lead)}")
    T = math.prod(lead)
    Vp = round_step_up(V, 128)
    if memory_budget_bytes is None or \
            2 * T * Vp * hidden.element_size() > memory_budget_bytes:
        raise NotImplementedError(
            "lm_cross_entropy: the chunked-vocabulary branch (logits past "
            "memory_budget_bytes, or memory_budget_bytes=None) is not ported")
    logits = gemm_ad(hidden.reshape(T, D), embed, None, False, bool(transb))
    loss = cross_entropy(logits, targets.reshape(T), reduction=reduction,
                         label_smoothing=eps, ignore_index=ignore_index, plain=plain)
    return loss.reshape(*lead) if reduction == "none" else loss
