"""AdamW, SGD with momentum, gradient clipping, LR schedules and
microbatch accumulation (port of laser_tpu/ops/optim.py).

Parameter trees are nested dicts, lists and tuples of tensors, as
laser_tpu's pytrees; ``tree_leaves``/``tree_map`` walk them in one order
(dict keys sorted, as JAX flattens them).

``adamw_step`` and ``sgd_momentum_step`` keep laser_tpu's ``backend``
names. The default (``None`` or ``"xla"``) is laser_tpu's plain fp32
expression (optim.py:147-168, :296-309), line for line, run by PyTorch.
``backend="pallas"`` runs the fused kernels of csrc/optim.cu
(``adamw_update``, ``sgdm_update``: replace optim.py:38 ``_build_adamw``
and :80 ``_build_sgdm``), one launch per leaf, on CUDA tensors, and their
plain versions ``adamw_update_plain`` / ``sgdm_update_plain`` (the same
arithmetic, one rounding per op) on CPU tensors. As the Pallas route, that
backend casts the gradient to the parameter's dtype, computes in fp32 and
stores the moments in the parameter's dtype.

Unlike laser_tpu, both backends update ``p``, ``m`` and ``v`` IN PLACE
(laser_tpu's Pallas route donates them) and return the same trees, so the
caller's tensors change. The one exception: on ``backend="pallas"`` a
moment leaf whose dtype differs from its parameter's is replaced by a new
tensor of the parameter's dtype in the returned tree, as laser_tpu returns
it. ``lr`` may be a 0-d tensor (a schedule's value); on the card the
kernels read it through its pointer, so a step reads nothing back to the
host.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch

from .. import registry

ADAMW = registry.kernel("adamw_update", "laser_tpu_torch/csrc/optim.cu",
                        "laser_tpu/ops/optim.py:38 _build_adamw")
SGDM = registry.kernel("sgdm_update", "laser_tpu_torch/csrc/optim.cu",
                       "laser_tpu/ops/optim.py:80 _build_sgdm")


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


def _backend(backend: Optional[str], what: str) -> bool:
    """True for the kernel route ("pallas"), False for the default."""
    if backend in (None, "xla"):
        return False
    if backend == "pallas":
        return True
    raise ValueError(f"unknown {what} backend {backend!r}")


def _bias_corrections(step, b1: float, b2: float):
    """1 / (1 - b^step) for b1 and b2 as fp32 0-d tensors, on the step's
    device (the host for a Python step), as laser_tpu's jnp.float32
    scalars."""
    step_f = step.float() if torch.is_tensor(step) else _f32(step)
    one = torch.ones((), dtype=torch.float32, device=step_f.device)
    bc1 = one / (one - _f32(b1).to(step_f.device) ** step_f)
    bc2 = one / (one - _f32(b2).to(step_f.device) ** step_f)
    return bc1, bc2


@torch.no_grad()
def adamw_step(params, grads, m, v, step, *, lr, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0, backend: Optional[str] = None):
    """One AdamW update over a parameter tree, in place; returns
    (params, m, v). ``step`` is the 1-based step count; ``lr`` a float or a
    0-d tensor (a schedule's value). Bias corrections are fp32, as
    laser_tpu's ``jnp.float32`` scalars. ``backend="pallas"``: the fused
    kernel, one launch per leaf (see the module docstring)."""
    if _backend(backend, "adamw"):
        return _adamw_fused(params, grads, m, v, step, lr=lr, b1=b1, b2=b2, eps=eps,
                            weight_decay=weight_decay)
    bc1, bc2 = (bc.item() for bc in _bias_corrections(step, b1, b2))
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


def _rebuild(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _state_leaf(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A moment leaf in the parameter's dtype: the leaf itself (updated in
    place) or, for another dtype, a new tensor."""
    return x if x.dtype == p.dtype else x.to(p.dtype)


def _adamw_fused(params, grads, m, v, step, *, lr, b1, b2, eps, weight_decay):
    bc1, bc2 = _bias_corrections(step, b1, b2)
    hyper = dict(lr=lr, b1=b1, b2=b2, omb1=float(1.0 - b1), omb2=float(1.0 - b2), eps=eps,
                 wd=weight_decay, bc1=bc1, bc2=bc2,
                 # laser_tpu applies the decay unless it is the float 0.0 (optim.py:177)
                 has_wd=not (isinstance(weight_decay, float) and weight_decay == 0.0))
    new_m, new_v = [], []
    for p, g, mm, vv in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(m),
                            tree_leaves(v), strict=True):
        mm, vv = _state_leaf(mm, p), _state_leaf(vv, p)
        adamw_update(p, g.to(p.dtype), mm, vv, **hyper)
        new_m.append(mm)
        new_v.append(vv)
    return params, _rebuild(m, new_m), _rebuild(v, new_v)


def _f(x) -> torch.Tensor:
    """``x`` (a float or a 0-d tensor) as an fp32 0-d tensor; a float's on
    the host, which PyTorch takes as a scalar of the op (no upload)."""
    if torch.is_tensor(x):
        return x.float()
    return torch.tensor(x, dtype=torch.float32)


def adamw_update_plain(p, g, m, v, *, lr, b1, b2, omb1, omb2, eps, wd, bc1, bc2, has_wd):
    """The kernel's function on one leaf in plain PyTorch, in place: fp32
    tensors and fp32 0-d scalars, one rounding per operation, in
    laser_tpu's order (optim.py:44-60); p, m, v stored in p's dtype."""
    ADAMW.plain_calls += 1
    g32 = g.to(p.dtype).float()
    m2 = m.float() * _f(b1) + _f(omb1) * g32
    v2 = v.float() * _f(b2) + _f(omb2) * (g32 * g32)
    p32 = p.float()
    upd = (m2 * _f(bc1)) / (torch.sqrt(v2 * _f(bc2)) + _f(eps))
    if has_wd:
        upd = upd + _f(wd) * p32
    p.copy_(p32 - _f(lr) * upd)
    m.copy_(m2)
    v.copy_(v2)


def _lr_args(lr, device):
    """(device pointer or None, host value, tensor to keep alive) of lr:
    a 0-d CUDA tensor is read by the kernel; a host tensor or a float is
    passed by value (no device read on the host)."""
    if torch.is_tensor(lr):
        if lr.numel() != 1:
            raise ValueError(f"lr must be a scalar, got shape {tuple(lr.shape)}")
        if lr.device.type == "cuda":
            if lr.device != device:
                raise ValueError(f"lr is on {lr.device}, the parameters on {device}")
            t = lr.reshape(()).float().contiguous()
            return t.data_ptr(), 0.0, t
        return None, float(lr.item()), None
    return None, float(lr), None


def _check_leaf(name, x, p):
    if x.device != p.device or x.dtype != p.dtype or x.shape != p.shape:
        raise ValueError(f"{name}: {x.device} {x.dtype} {tuple(x.shape)} against the "
                         f"parameter's {p.device} {p.dtype} {tuple(p.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the kernel updates contiguous tensors in place")


def _kernel_dtype(p):
    if p.dtype not in registry.DTYPE_CODES:
        raise NotImplementedError(f"optimizer kernels: {p.dtype} parameters (f32, bf16, f16)")
    return registry.DTYPE_CODES[p.dtype]


def adamw_update(p, g, m, v, *, lr, b1, b2, omb1, omb2, eps, wd, bc1, bc2, has_wd):
    """One leaf's AdamW update in place: the kernel for a CUDA tensor, the
    plain version for a CPU one. g, m, v share p's shape and dtype; bc1 and
    bc2 are fp32 0-d tensors (on the host, or on p's card)."""
    if not registry.on_cuda(p):
        return adamw_update_plain(p, g, m, v, lr=lr, b1=b1, b2=b2, omb1=omb1, omb2=omb2,
                                  eps=eps, wd=wd, bc1=bc1, bc2=bc2, has_wd=has_wd)
    code = _kernel_dtype(p)
    for name, x in (("p", p), ("m", m), ("v", v)):
        _check_leaf(name, x, p)
    g = g.contiguous()
    _check_leaf("g", g, p)
    if p.numel() == 0:
        return None
    lr_ptr, lr_val, _lr = _lr_args(lr, p.device)
    if bc1.device.type == "cuda":
        bc = torch.stack([bc1, bc2]).to(p.device)
        bc_ptr, bc1_v, bc2_v = bc.data_ptr(), 0.0, 0.0
    else:
        bc, bc_ptr, bc1_v, bc2_v = None, None, float(bc1), float(bc2)
    lib = registry.load_library()
    status = lib.ltt_adamw(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
                           lr_ptr, lr_val, b1, b2, omb1, omb2, eps, float(wd), bc_ptr, bc1_v,
                           bc2_v, int(has_wd), code, registry.stream_handle(p))
    registry.check_launch(status, "adamw_update")
    ADAMW.launches += 1
    return None


def sgdm_update_plain(p, g, m, *, lr, mu, nesterov):
    """The kernel's function on one leaf in plain PyTorch, in place
    (optim.py:86-90): fp32, one rounding per operation, p and m stored in
    p's dtype."""
    SGDM.plain_calls += 1
    g32 = g.to(p.dtype).float()
    m2 = m.float() * _f(mu) + g32
    upd = g32 + _f(mu) * m2 if nesterov else m2
    p.copy_(p.float() - _f(lr) * upd)
    m.copy_(m2)


def sgdm_update(p, g, m, *, lr, mu, nesterov):
    """One leaf's SGD-momentum update in place: the kernel for a CUDA
    tensor, the plain version for a CPU one."""
    if not registry.on_cuda(p):
        return sgdm_update_plain(p, g, m, lr=lr, mu=mu, nesterov=nesterov)
    code = _kernel_dtype(p)
    for name, x in (("p", p), ("m", m)):
        _check_leaf(name, x, p)
    g = g.contiguous()
    _check_leaf("g", g, p)
    if p.numel() == 0:
        return None
    lr_ptr, lr_val, _lr = _lr_args(lr, p.device)
    lib = registry.load_library()
    status = lib.ltt_sgdm(p.data_ptr(), g.data_ptr(), m.data_ptr(), p.numel(), lr_ptr, lr_val,
                          float(mu), int(nesterov), code, registry.stream_handle(p))
    registry.check_launch(status, "sgdm_update")
    SGDM.launches += 1
    return None


@torch.no_grad()
def sgd_momentum_step(params, grads, momentum, *, lr, mu: float = 0.9,
                      nesterov: bool = False, backend: Optional[str] = None):
    """One SGD-with-momentum update over a parameter tree, in place;
    returns (params, momentum). Default backend: laser_tpu's expression
    (optim.py:296-309), the momentum kept in its own dtype;
    ``backend="pallas"``: the fused kernel, one launch per leaf, the
    momentum in the parameter's dtype."""
    if _backend(backend, "sgd_momentum"):
        new_m = []
        for p, g, mm in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(momentum),
                            strict=True):
            mm = _state_leaf(mm, p)
            sgdm_update(p, g.to(p.dtype), mm, lr=lr, mu=mu, nesterov=nesterov)
            new_m.append(mm)
        return params, _rebuild(momentum, new_m)
    lr = lr.float() if torch.is_tensor(lr) else lr
    for p, g, mm in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(momentum)):
        g32 = g.float()
        m2 = mu * mm.float() + g32
        u = g32 + mu * m2 if nesterov else m2
        p.copy_(p.float() - lr * u)
        mm.copy_(m2)
    return params, momentum


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
