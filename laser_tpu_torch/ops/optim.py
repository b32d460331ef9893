"""AdamW, SGD with momentum, gradient clipping, LR schedules and
microbatch accumulation (port of laser_tpu/ops/optim.py).

Parameter trees are nested dicts, lists and tuples of tensors, as
laser_tpu's pytrees; ``tree_leaves``/``tree_map`` walk them in one order
(dict keys sorted, as JAX flattens them).

``adamw_step`` and ``sgd_momentum_step`` keep laser_tpu's ``backend``
names. The default (``None`` or ``"xla"``) is laser_tpu's plain fp32
expression (optim.py:147-168, :296-309), line for line, run by PyTorch.
``backend="pallas"`` runs the fused kernels of csrc/optim.cu on CUDA
tensors (they replace optim.py:38 ``_build_adamw`` and :80 ``_build_sgdm``)
and their plain versions ``adamw_update_plain`` / ``sgdm_update_plain``
(the same arithmetic, one rounding per op) on CPU tensors:

- AdamW: ``adamw_update``, one launch per leaf;
- SGD with momentum: ``sgd_momentum_step``, one multi-tensor launch for
  every leaf of one dtype (counter ``sgdm_multi``; ``sgdm_tables`` groups
  the leaves by dtype and cuts a group past ``SGDM_TABLE_LEAVES`` into a
  few launches); ``sgdm_update`` is the same kernel on one leaf.
  ``route="classic"`` asks for the per-leaf kernel (counter
  ``sgdm_update``), kept for comparison.

As the Pallas route, that backend casts the gradient to the parameter's
dtype, computes in fp32 and stores the moments in the parameter's dtype.

Unlike laser_tpu, both backends update ``p``, ``m`` and ``v`` IN PLACE
(laser_tpu's Pallas route donates them) and return the same trees, so the
caller's tensors change. The one exception: on ``backend="pallas"`` a
moment leaf whose dtype differs from its parameter's is replaced by a new
tensor of the parameter's dtype in the returned tree, as laser_tpu returns
it. ``lr`` may be a 0-d tensor (a schedule's value); on the card the
kernels read it through its pointer, so a step reads nothing back to the
host and can be captured in a CUDA graph.
"""

from __future__ import annotations

import array
import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .. import registry

ADAMW = registry.kernel("adamw_update", "laser_tpu_torch/csrc/optim.cu",
                        "laser_tpu/ops/optim.py:38 _build_adamw")
SGDM = registry.kernel("sgdm_update", "laser_tpu_torch/csrc/optim.cu",
                       "laser_tpu/ops/optim.py:80 _build_sgdm")
SGDM_MULTI = registry.kernel("sgdm_multi", "laser_tpu_torch/csrc/optim.cu",
                             "laser_tpu/ops/optim.py:80 _build_sgdm")
# leaves one sgdm_multi launch's table holds (csrc/optim.cu kMultiLeaves:
# the table is the kernel's parameter, at most 32 KB)
SGDM_TABLE_LEAVES = 768
SGDM_ROUTES = (None, "classic")


def tree_leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _collect_leaves(tree, out)
    return out


def _collect_leaves(tree, out: list) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _collect_leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _collect_leaves(t, out)
    else:
        out.append(tree)


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


def sgdm_update_classic(p, g, m, *, lr, mu, nesterov):
    """One leaf's SGD-momentum update in place on the per-leaf kernel
    (route "classic"): the kernel for a CUDA tensor, the plain version for a
    CPU one."""
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


def sgdm_tables(leaves: Sequence[tuple], capacity: int = SGDM_TABLE_LEAVES
                ) -> List[Tuple[torch.dtype, list]]:
    """The launches of one multi-tensor step: the ``leaves`` ((p, g, m),
    or any tuple whose first item is the parameter) grouped by p's dtype (in
    the order each dtype first appears), empty leaves dropped, each group
    cut in order into tables of at most ``capacity`` leaves. Returns
    [(dtype, [leaf, ...]), ...]."""
    groups = {}
    for leaf in leaves:
        if leaf[0].numel():
            groups.setdefault(leaf[0].dtype, []).append(leaf)
    return [(dt, grp[i:i + capacity]) for dt, grp in groups.items()
            for i in range(0, len(grp), capacity)]


def _sgdm_multi_cuda(leaves, lr, mu, nesterov, cast: bool = False):
    """Check the CUDA leaves in one pass (g and m each against p's device,
    dtype and shape, every tensor contiguous; a non-contiguous g is copied)
    and launch each of ``sgdm_tables``' tables. With ``cast`` a g or m of
    another dtype is first cast to p's; returns the momentum leaves when a
    cast replaced one, else None."""
    p0 = leaves[0][0]
    dev = p0.get_device()
    ready, new_m = [], None
    for i, (p, g, m) in enumerate(leaves):
        dt, shape, gdt, mdt = p.dtype, p.shape, g.dtype, m.dtype
        if cast and gdt != dt:
            g, gdt = g.to(dt), dt
        if cast and mdt != dt:
            if new_m is None:
                new_m = [leaf[2] for leaf in leaves]
            m = new_m[i] = m.to(dt)
            mdt = dt
        if not g.is_contiguous():
            g = g.contiguous()
        if (gdt != dt or mdt != dt or g.shape != shape or m.shape != shape
                or p.get_device() != dev or g.get_device() != dev or m.get_device() != dev):
            bad = next(x for x in (p, g, m) if x.dtype != dt or x.shape != shape
                       or x.get_device() != dev)
            raise ValueError(f"sgd_momentum: a leaf on {bad.device} {bad.dtype} "
                             f"{tuple(bad.shape)} against its parameter's {p.device} {dt} "
                             f"{tuple(shape)} (the leaves on {p0.device})")
        if not (p.is_contiguous() and m.is_contiguous()):
            raise ValueError("sgd_momentum: the kernel updates contiguous tensors in place")
        if dt not in registry.DTYPE_CODES:
            _kernel_dtype(p)  # raises, naming the dtypes the kernels take
        # g and m stay referenced here until the launch: a cast or copy freed
        # earlier could be handed to the next one before the kernel reads it
        ready.append((p, g, m, (p.data_ptr(), g.data_ptr(), m.data_ptr(), p.numel())))
    tables = sgdm_tables(ready)
    if tables:
        lr_ptr, lr_val, _lr = _lr_args(lr, p0.device)
        launch, stream = registry.entry("ltt_sgdm_multi"), registry.stream_handle(p0)
        for dt, table in tables:
            rows = array.array("q", [v for leaf in table for v in leaf[3]])
            status = launch(rows.buffer_info()[0], len(table), lr_ptr, lr_val, float(mu),
                                  int(nesterov), registry.DTYPE_CODES[dt], stream)
            registry.check_launch(status, "sgdm_multi")
            SGDM_MULTI.launches += 1
        if len(tables) > len({dt for dt, _ in tables}):
            registry.logger.debug("sgdm_multi: %d leaves in %d launches (%d leaves a table)",
                                  len(ready), len(tables), SGDM_TABLE_LEAVES)
    return new_m


def _sgdm(leaves, lr, mu, nesterov, route, cast):
    """The updates of ``leaves`` ((p, g, m) each): one ``sgdm_multi``
    launch a dtype on CUDA tensors, the per-leaf kernel with
    ``route="classic"``, the plain version on CPU tensors. With ``cast`` a
    g or m of another dtype is first cast to p's; returns the momentum
    leaves when a cast replaced one, else None."""
    if route not in SGDM_ROUTES:
        raise ValueError(f"unknown route {route!r}; have {[r for r in SGDM_ROUTES if r]}")
    if not leaves:
        return None
    if route != "classic" and registry.on_cuda(leaves[0][0]):
        return _sgdm_multi_cuda(leaves, lr, mu, nesterov, cast)
    new_m = None
    for i, (p, g, m) in enumerate(leaves):
        dt = p.dtype
        if cast and m.dtype != dt:
            if new_m is None:
                new_m = [leaf[2] for leaf in leaves]
            m = new_m[i] = m.to(dt)
        sgdm_update_classic(p, g.to(dt) if cast else g, m, lr=lr, mu=mu, nesterov=nesterov)
    return new_m


def sgdm_update(p, g, m, *, lr, mu, nesterov, route: Optional[str] = None):
    """One leaf's SGD-momentum update in place: the multi-tensor kernel on
    a one-leaf table (``route="classic"``: the per-leaf kernel) for a CUDA
    tensor, the plain version for a CPU one."""
    _sgdm([(p, g, m)], lr, mu, nesterov, route, cast=False)


def _zip_leaves(params, grads, momentum) -> list:
    """(p, g, m) of each leaf, walking the three trees together in
    ``tree_leaves``' order; their structures must match."""
    out: list = []
    _collect_zip(params, grads, momentum, out)
    return out


def _collect_zip(a, b, c, out: list) -> None:
    if isinstance(a, dict):
        if len(b) != len(a) or len(c) != len(a):
            raise ValueError(f"trees differ: keys {sorted(a)}, {sorted(b)}, {sorted(c)}")
        for k in sorted(a):
            _collect_zip(a[k], b[k], c[k], out)
    elif isinstance(a, (list, tuple)):
        for x, y, z in zip(a, b, c, strict=True):
            _collect_zip(x, y, z, out)
    else:
        out.append((a, b, c))


@torch.no_grad()
def sgd_momentum_step(params, grads, momentum, *, lr, mu: float = 0.9,
                      nesterov: bool = False, backend: Optional[str] = None,
                      route: Optional[str] = None):
    """One SGD-with-momentum update over a parameter tree, in place;
    returns (params, momentum). Default backend: laser_tpu's expression
    (optim.py:296-309), the momentum kept in its own dtype;
    ``backend="pallas"``: the fused kernel, one launch a dtype (``route=
    "classic"``: the per-leaf kernel; the trees' structures must match), the
    gradient cast and the momentum kept in the parameter's dtype."""
    if _backend(backend, "sgd_momentum"):
        new_m = _sgdm(_zip_leaves(params, grads, momentum), lr, mu, nesterov, route, cast=True)
        # a tree whose every moment was updated in place is returned as it is
        return params, momentum if new_m is None else _rebuild(momentum, new_m)
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
