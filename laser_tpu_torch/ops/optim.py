"""AdamW, gradient clipping, LR schedules and microbatch accumulation
(port of laser_tpu/ops/optim.py).

Parameter trees are nested dicts, lists and tuples of tensors, as
laser_tpu's pytrees; ``tree_leaves``/``tree_map`` walk them in one order
(dict keys sorted, as JAX flattens them).

``adamw_step``'s default backend is laser_tpu's: the plain fp32 expression
of optim.py:147-168, line for line, run by PyTorch. Unlike laser_tpu it
updates ``p``, ``m`` and ``v`` IN PLACE (and returns the same trees), so
the caller's tensors change. ``backend="pallas"`` would be the fused kernel
``_build_adamw`` (optim.py:38), which is not ported yet and raises.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of ``tree`` and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def adamw_init(params):
    """Zero first/second-moment trees matching ``params`` (their dtype, as
    laser_tpu's ``zeros_like``)."""
    return tree_map(torch.zeros_like, params), tree_map(torch.zeros_like, params)


@torch.no_grad()
def adamw_step(params, grads, m, v, step, *, lr, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0, backend: Optional[str] = None):
    """One AdamW update over a parameter tree, in place; returns
    (params, m, v). ``step`` is the 1-based step count; ``lr`` a float or a
    0-d tensor (a schedule's value). Bias corrections are fp32, as
    laser_tpu's ``jnp.float32`` scalars."""
    if backend not in (None, "xla"):
        if backend == "pallas":
            raise NotImplementedError(
                "adamw_step(backend='pallas'): the fused AdamW kernel "
                "(laser_tpu/ops/optim.py:38 _build_adamw) is not ported yet")
        raise ValueError(f"unknown adamw backend {backend!r}")
    step_f = _f32(step)
    bc1 = (1.0 / (1.0 - _f32(b1) ** step_f)).item()
    bc2 = (1.0 / (1.0 - _f32(b2) ** step_f)).item()
    lr = lr.float() if torch.is_tensor(lr) else lr

    for p, g, mm, vv in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(m), tree_leaves(v)):
        g32 = g.float()
        m2 = b1 * mm.float() + (1.0 - b1) * g32
        v2 = b2 * vv.float() + (1.0 - b2) * (g32 * g32)
        u = (m2 * bc1) / (torch.sqrt(v2 * bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p.float()
        p.copy_(p.float() - lr * u)
        mm.copy_(m2)
        vv.copy_(v2)
    return params, m, v


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every leaf of a tree, accumulated in fp32."""
    sq = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``.

    Returns (clipped_grads, pre_clip_norm): new tensors, leaf dtypes kept,
    the norm and the scale in fp32. The scale is exactly 1 when the norm is
    already within bound."""
    norm = global_norm(grads)
    scale = max_norm / torch.clamp(norm, min=max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def warmup_cosine_lr(step, *, peak_lr: float, warmup_steps: int,
                     total_steps: int, end_lr: float = 0.0) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then cosine decay
    to ``end_lr`` at ``total_steps``; an fp32 0-d tensor of the (1-based)
    step."""
    s = _f32(step)
    w = float(max(warmup_steps, 1))
    warm = peak_lr * s / w
    t = torch.clamp((s - w) / float(max(total_steps - w, 1.0)), 0.0, 1.0)
    decay = end_lr + 0.5 * (peak_lr - end_lr) * (1.0 + torch.cos(math.pi * t))
    return torch.where(s < w, warm, decay)


def inverse_sqrt_lr(step, *, peak_lr: float, warmup_steps: int) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` then 1/sqrt(step) decay (continuous at
    the warmup boundary)."""
    s = torch.clamp(_f32(step), min=1.0)
    w = float(max(warmup_steps, 1))
    return peak_lr * torch.minimum(s / w, math.sqrt(w) / torch.sqrt(s))


def value_and_grad(loss_fn: Callable) -> Callable:
    """``vg(params, *batch) -> (loss, grads)``: the loss (detached) and its
    gradient tree with respect to every leaf of ``params``. The caller's
    tensors are not modified and need not require grad."""

    def vg(params, *batch):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        it = iter(live)
        loss = loss_fn(tree_map(lambda _: next(it), params), *batch)
        grads = iter(torch.autograd.grad(loss, live))
        return loss.detach(), tree_map(lambda _: next(grads), params)

    return vg


def accumulated_value_and_grad(loss_fn: Callable, accum: int) -> Callable:
    """``value_and_grad`` with microbatch gradient accumulation.

    Every tensor in ``batch`` has a leading dim divisible by ``accum``; the
    batch is split into ``accum`` microbatches run one after another (only
    one microbatch's activations are alive at a time), with gradients summed
    in fp32 and then cast to each parameter's dtype. For a mean-reduced loss
    this is the full-batch value_and_grad up to summation order."""
    vg1 = value_and_grad(loss_fn)
    if accum <= 1:
        return vg1

    def vg(params, *batch):
        for a in batch:
            if a.shape[0] % accum:
                raise ValueError(f"batch dim {a.shape[0]} not divisible by "
                                 f"accum={accum}")
        micro = [a.chunk(accum, dim=0) for a in batch]
        acc_l = torch.zeros((), dtype=torch.float32)
        acc_g = None
        for i in range(accum):
            loss, grads = vg1(params, *(mb[i] for mb in micro))
            acc_l = acc_l.to(loss.device) + loss.float()
            acc_g = tree_map(lambda g: g.float(), grads) if acc_g is None else \
                tree_map(lambda a, g: a + g.float(), acc_g, grads)
        inv = 1.0 / accum
        return acc_l * inv, tree_map(lambda g, p: (g * inv).to(p.dtype), acc_g, params)

    return vg
