"""Fused elementwise over strided views in one pass (port of
laser_tpu/ops/strided.py).

``strided_for_each(fn, views, out_dtype)`` applies a traced torch body to
``TensorView``s (or torch tensors of any strides) without materialising
them, and writes a dense result in the views' logical shape. On a CUDA
tensor it runs the strided template of csrc/foreach.cuh
(``for_each_strided_kernel``), which replaces laser_tpu/ops/strided.py:222
``build_strided_foreach`` (pallas_call at :305); on a CPU tensor its plain
version, ``strided_for_each_reference`` (materialise each view, then the
body in torch). ``ops.foreach.for_each`` routes here whenever an operand is
a view or a non-contiguous tensor, as laser_tpu's does (foreach.py:132-140).

The plan (``plan``): drop extent-1 dims, then merge each pair of adjacent
dims that are contiguous with each other on every operand (the output is
dense, so it merges wherever they do). The kernel walks the merged space
with one divmod per thread and then an odometer of adds and carries. Where
every operand has stride 1 on the innermost merged dim, that dim is whole
16-byte vectors, and every row starts 16-byte aligned, each thread moves
16-byte vectors along the rows; otherwise it loads element by element.

It takes every view laser_tpu's two strided classes take (``plan_xla_view``,
its default, and ``plan_embedding``, ``backend="pallas"``): offsets,
every k-th row or column, negative strides on any axis, 1-D strided views,
strided and contiguous operands mixed. It takes transposed and stride-0
(broadcast) views in the same pass too; laser_tpu materialises those and
runs its contiguous kernel, which computes the same function.

Not ported: ``plan_embedding`` and ``_fold_skipfull`` (ROADMAP, "code not
to port"): they exist to fit Mosaic's (8, 128) tiling. ``backend`` is
accepted and has one route on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, Sequence, Tuple

import torch

from .. import registry
from ..config import LASER_MAXRANK
from ..tensor import TensorView, as_view
from . import codegen

FOR_EACH_STRIDED = registry.kernel("for_each_strided", "laser_tpu_torch/csrc/foreach.cuh",
                                   "laser_tpu/ops/strided.py:222 build_strided_foreach")
BACKENDS = ("xla", "pallas")


@dataclasses.dataclass(frozen=True)
class StridedPlan:
    """The merged iteration space: ``shape`` outermost first, and for each
    operand its element ``offset`` and ``strides`` over it."""

    shape: Tuple[int, ...]
    offsets: Tuple[int, ...]
    strides: Tuple[Tuple[int, ...], ...]


def plan(views: Sequence[TensorView]) -> StridedPlan:
    """Merge the views' common logical shape: extent-1 dims go, and dim k
    merges into dim k + 1 where stride[k] == stride[k + 1] * shape[k + 1]
    on every operand."""
    shape = views[0].shape
    keep = [d for d, n in enumerate(shape) if n != 1]
    dims = [shape[d] for d in keep]
    strides = [[v.strides[d] for d in keep] for v in views]
    k = len(dims) - 2
    while k >= 0:
        if all(st[k] == st[k + 1] * dims[k + 1] for st in strides):
            dims[k:k + 2] = [dims[k] * dims[k + 1]]
            for st in strides:
                st[k:k + 2] = [st[k + 1]]
        k -= 1
    return StridedPlan(tuple(dims), tuple(v.offset for v in views),
                       tuple(tuple(st) for st in strides))


def _views(operands) -> list:
    views = [as_view(o) for o in operands]
    if not views:
        raise ValueError("strided_for_each needs at least one operand")
    for v in views[1:]:
        if v.shape != views[0].shape:
            raise ValueError(f"operand shape mismatch: {v.shape} vs {views[0].shape}")
        if v.device != views[0].device:
            raise ValueError(f"strided_for_each: operands on {v.device} and {views[0].device}")
    return views


def strided_for_each_reference(fn: Callable, views, out_dtype=None) -> torch.Tensor:
    """Materialise each view, then the body in torch, cast to ``out_dtype``
    (default: the operands' promoted dtype)."""
    FOR_EACH_STRIDED.plain_calls += 1
    mats = [as_view(v).materialize() for v in views]
    out_dtype = out_dtype or functools.reduce(torch.promote_types, [m.dtype for m in mats])
    return fn(*mats).to(out_dtype)


@functools.lru_cache(maxsize=512)
def _source(traced: codegen.Traced, out_dtype: torch.dtype) -> str:
    return codegen.emit_for_each(traced, (out_dtype,), strided=True)


def strided_for_each_source(fn: Callable, dtypes: Sequence[torch.dtype], out_dtype) -> str:
    """The generated source the strided kernel builds for ``fn`` over
    operands of ``dtypes``."""
    return _source(codegen.trace(fn, tuple(dtypes)), out_dtype)


def _geometry(p: StridedPlan, views, out_dtype) -> Tuple[ctypes.Array, int, int]:
    """(packed geometry, items, vector width or 1) for the kernel."""
    isz = [v.buffer.element_size() for v in views]
    V = codegen.vec_width([v.dtype for v in views] + [out_dtype])
    n = math.prod(p.shape)
    vec = bool(p.shape) and p.shape[-1] % V == 0 and all(
        st[-1] == 1 and (v.buffer.data_ptr() + off * s) % 16 == 0
        and all(x * s % 16 == 0 for x in st[:-1])
        for v, off, st, s in zip(views, p.offsets, p.strides, isz))
    shape = list(p.shape)
    strides = [list(st) for st in p.strides]
    if vec:
        shape[-1] //= V
        for st in strides:
            st[-1] = V
    pad = LASER_MAXRANK - len(shape)
    packed = [1] * pad + shape
    for off, st in zip(p.offsets, strides):
        packed += [off] + [0] * pad + st
    return (ctypes.c_int64 * len(packed))(*packed), n // V if vec else n, V if vec else 1


def strided_for_each(fn: Callable, views, out_dtype=None, backend: str = "xla"
                     ) -> torch.Tensor:
    """``fn`` over the strided views in one kernel: a dense tensor of the
    views' logical shape in ``out_dtype`` (default: the operands' promoted
    dtype). ``backend`` is laser_tpu's strategy switch, accepted; the card
    has one route."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    views = _views(views)
    traced = codegen.trace(fn, tuple(v.dtype for v in views))
    out_dtype = out_dtype or functools.reduce(torch.promote_types, traced.in_dtypes)
    src = _source(traced, out_dtype)
    if not registry.on_cuda(views[0].buffer):
        return strided_for_each_reference(fn, views, out_dtype)
    out = torch.empty(views[0].shape, dtype=out_dtype, device=views[0].device)
    if out.numel() == 0:
        return out
    geom, items, vec = _geometry(plan(views), views, out_dtype)
    lib = registry.load_generated(src)
    bufs = (ctypes.c_void_p * len(views))(*[v.buffer.data_ptr() for v in views])
    outs = (ctypes.c_void_p * 1)(out.data_ptr())
    status = lib.ltt_gen_for_each_strided(bufs, outs, geom, items, vec,
                                          registry.stream_handle(views[0].buffer))
    registry.check_launch(status, FOR_EACH_STRIDED.name)
    FOR_EACH_STRIDED.launches += 1
    return out


def needs_strided(operands) -> bool:
    """True where an operand is a TensorView or a non-contiguous tensor."""
    return any(isinstance(o, TensorView) or (isinstance(o, torch.Tensor)
                                             and not o.is_contiguous()) for o in operands)


def materialized(operands) -> list:
    """Each operand as a contiguous tensor: a view materialised (torch's
    gather, as laser_tpu's ``_prepare_flat`` materialises), a tensor made
    contiguous."""
    return [o.materialize() if isinstance(o, TensorView) else
            (o.contiguous() if isinstance(o, torch.Tensor) else o) for o in operands]

