"""Row normalisation: layer_norm and rms_norm (port of laser_tpu/ops/norm.py).

The CUDA kernels (csrc/norm.cu) serve both through a ``kind`` switch:
statistics in fp32 over the logical columns, two-pass centred variance, an
optional affine with gamma / beta read in their own dtype (f32, bf16 or
f16: no cast, so a call is one launch), the output in the input dtype. The
default ``eps`` is 1e-6, as in laser_tpu, not PyTorch's 1e-5.
``layer_norm`` and ``rms_norm`` are differentiable: the forward is the
kernel, the backward differentiates the plain fp32 expression
(laser_tpu/ops/norm.py:145-169 takes ``jax.vjp`` of its reference the same
way; there is no backward kernel to port).

Replaces laser_tpu/ops/norm.py:28 _build_norm. Bound on the H100: HBM bytes
(one read, one write per row). Two routes, each with its own launch
counter: ``norm_vec`` (the row read once into registers by 16-byte loads, a
warp a row up to 1024 bf16 columns, a block a row up to 8192; rows whose
width is a whole number of 16-byte vectors at 16-byte-aligned bases) and
``norm`` (the classic kernel: one block per row, scalar loads, for the
rest). ``route="classic"`` or ``"vec"`` asks for one; a route that does not
fit raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import registry

NORM = registry.kernel("norm", "laser_tpu_torch/csrc/norm.cu",
                       "laser_tpu/ops/norm.py:28 _build_norm")
NORM_VEC = registry.kernel("norm_vec", "laser_tpu_torch/csrc/norm.cu",
                           "laser_tpu/ops/norm.py:28 _build_norm")
# route codes shared with csrc/norm.cu (enum Route), and the counter of each
ROUTES = {None: 0, "classic": 1, "vec": 2}
ROUTE_KERNELS = {1: NORM, 2: NORM_VEC}

_KINDS = {"layer": 0, "rms": 1}
INVALID_VALUE = 1  # cudaErrorInvalidValue


def _norm_math(x2, gamma, beta, kind: str, eps: float):
    """The kernel's function in plain PyTorch on (rows, cols), in fp32
    with one cast at the end; differentiable by autograd."""
    xf = x2.float()
    if kind == "layer":
        centered = xf - xf.mean(dim=-1, keepdim=True)
    else:
        centered = xf
    y = centered * torch.rsqrt((centered * centered).mean(dim=-1, keepdim=True) + eps)
    if gamma is not None:
        y = y * gamma.float()
    if beta is not None:
        y = y + beta.float()
    return y.to(x2.dtype)


def _norm_plain(x2, gamma, beta, kind: str, eps: float):
    NORM.plain_calls += 1
    return _norm_math(x2, gamma, beta, kind, eps)


def _norm_cuda(x2, gamma, beta, kind: str, eps: float, route=None):
    if x2.dtype not in registry.DTYPE_CODES:
        raise TypeError(f"norm kernel: unsupported dtype {x2.dtype}")
    rows, cols = x2.shape
    # the kernels read f32/bf16/f16 gains as they are: a contiguous gain in
    # one of those dtypes (every model's) costs no launch here
    gains = []
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t is None:
            gains += [None, 0]
            continue
        if t.device != x2.device or t.numel() != cols:
            raise ValueError(f"norm: {name} must hold {cols} values on {x2.device}")
        if t.dtype not in registry.DTYPE_CODES:
            t = t.float()
        t = t.contiguous()
        gains += [t, registry.DTYPE_CODES[t.dtype]]
    (g, gcode), (b, bcode) = gains[:2], gains[2:]
    y = torch.empty_like(x2)
    if rows == 0 or cols == 0:
        return y
    taken = ctypes.c_int(0)
    status = registry.load_library().ltt_norm(
        x2.data_ptr(), None if g is None else g.data_ptr(), None if b is None else b.data_ptr(),
        y.data_ptr(), rows, cols, _KINDS[kind], eps, registry.DTYPE_CODES[x2.dtype], gcode,
        bcode, ROUTES[route], ctypes.byref(taken), registry.stream_handle(x2))
    if status == INVALID_VALUE and route == "vec":  # the launcher's answer to a misfit
        raise ValueError(f"norm: route 'vec' does not fit {cols} {x2.dtype} columns at "
                         "these alignments")
    registry.check_launch(status, "norm")
    ROUTE_KERNELS[taken.value].launches += 1
    return y


def _norm_forward(x2, gamma, beta, kind: str, eps: float, route=None):
    if registry.on_cuda(x2):
        return _norm_cuda(x2, gamma, beta, kind, eps, route)
    return _norm_plain(x2, gamma, beta, kind, eps)


class _Norm(torch.autograd.Function):
    """Kernel forward; backward = autograd of ``_norm_math`` on the saved
    inputs (laser_tpu/ops/norm.py:145-169)."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, kind, eps, route):
        ctx.save_for_backward(x2, gamma, beta)
        ctx.kind, ctx.eps = kind, eps
        return _norm_forward(x2, gamma, beta, kind, eps, route)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(True)
                      for t in saved]
            y = _norm_math(*leaves, ctx.kind, ctx.eps)
            want = [t for t in leaves if t is not None]
            grads = iter(torch.autograd.grad(y, want, g))
        return (*(None if t is None else next(grads) for t in leaves), None, None, None)


def _norm(x, gamma, beta, kind: str, axis: int, eps: float, plain: bool, route=None):
    registry.route_code(ROUTES, route)  # an unknown name raises on any device
    if axis not in (-1, x.ndim - 1):
        x = x.movedim(axis, -1)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).contiguous()
    if plain:
        y = _norm_plain(x2, gamma, beta, kind, eps)
    elif torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x2, gamma, beta)):
        y = _Norm.apply(x2, gamma, beta, kind, eps, route)
    else:
        y = _norm_forward(x2, gamma, beta, kind, eps, route)
    y = y.reshape(shape)
    if axis not in (-1, len(shape) - 1):
        y = y.movedim(-1, axis)
    return y


def layer_norm(x, gamma=None, beta=None, *, axis: int = -1,
               eps: float = 1e-6, route=None) -> torch.Tensor:
    """Fused LayerNorm over ``axis``: mean/variance and scale/shift in one
    kernel pass. ``route`` (a CUDA tensor's): None lets the library pick,
    "classic" or "vec" asks for one."""
    return _norm(x, gamma, beta, "layer", axis, eps, plain=False, route=route)


def rms_norm(x, gamma=None, *, axis: int = -1, eps: float = 1e-6,
             route=None) -> torch.Tensor:
    """Fused RMSNorm over ``axis``; ``route`` as in ``layer_norm``."""
    return _norm(x, gamma, None, "rms", axis, eps, plain=False, route=route)


def layer_norm_reference(x, gamma=None, beta=None, *, axis: int = -1,
                         eps: float = 1e-6) -> torch.Tensor:
    """``layer_norm`` through the kernel's plain version, on any device."""
    return _norm(x, gamma, beta, "layer", axis, eps, plain=True)


def rms_norm_reference(x, gamma=None, *, axis: int = -1,
                       eps: float = 1e-6) -> torch.Tensor:
    return _norm(x, gamma, None, "rms", axis, eps, plain=True)
