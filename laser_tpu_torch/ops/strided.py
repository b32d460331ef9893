"""Fused elementwise over strided views in one pass (port of
laser_tpu/ops/strided.py).

``strided_for_each(fn, views, out_dtype)`` applies a traced torch body to
``TensorView``s (or torch tensors of any strides) without materialising
them, and writes a dense result in the views' logical shape. On a CUDA
tensor it runs the strided template of csrc/foreach.cuh, which replaces
laser_tpu/ops/strided.py:222 ``build_strided_foreach`` (pallas_call at
:305); on a CPU tensor its plain version, ``strided_for_each_reference``
(materialise each view, then the body in torch). ``ops.foreach.for_each``
routes here whenever an operand is a view or a non-contiguous tensor, as
laser_tpu's does (foreach.py:132-140).

The plan (``plan``): drop extent-1 dims, then merge each pair of adjacent
dims that are contiguous with each other on every operand (the output is
dense, so it merges wherever they do). Two kernels walk the merged space,
each with its own launch counter (``route=``):

- the tiled kernel (``for_each_rows_kernel``, the default; counter
  ``for_each_strided_tiled``): rows of the innermost merged dim, a block a
  (row group, column chunk) tile, each thread's row turned into the
  operands' base offsets once, specialised on the merged rank, 32-bit
  offsets wherever every operand's span fits, several 16-byte items of a
  row loaded before the body runs on any;
- the classic kernel (``for_each_strided_kernel``, route "classic"; counter
  ``for_each_strided``): a grid-stride loop over the items, one divmod a
  thread over six padded dims, then an odometer of adds and carries.

Both move 16-byte vectors along the rows where every operand has stride 1
on the innermost merged dim, that dim is whole vectors and every row
starts 16-byte aligned, and elements otherwise (ragged or unaligned rows,
negative or zero strides, transposed views). Elementwise work has no order,
so the two give the same bits, the plain version's.

The host path, before the launch: the body's plan (its generated source
and library) is memoised on ``codegen.body_key`` (its code and the values
of every closure cell, default, global and module attribute it can read;
a body that reads anything else, or calls a Python function of its own, is
traced on every call), so a changed closure or global constant is this
call's value; the packed geometry is memoised on the operands' shapes and
strides; a torch tensor is read through its ``data_ptr`` and strides (no
``TensorView``); the launcher picks the vector path and the index width.

Not ported: ``plan_embedding`` and ``_fold_skipfull`` (ROADMAP, "code not
to port"): they exist to fit Mosaic's (8, 128) tiling. ``backend`` is
accepted and chooses nothing on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from .. import registry
from ..tensor import TensorView, as_view
from . import codegen

FOR_EACH_STRIDED = registry.kernel("for_each_strided", "laser_tpu_torch/csrc/foreach.cuh",
                                   "laser_tpu/ops/strided.py:222 build_strided_foreach")
FOR_EACH_STRIDED_TILED = registry.kernel("for_each_strided_tiled",
                                         "laser_tpu_torch/csrc/foreach.cuh",
                                         "laser_tpu/ops/strided.py:222 build_strided_foreach")
BACKENDS = ("xla", "pallas")
# route codes shared with csrc/foreach.cuh (StridedRoute): None the tiled
# kernel, "classic" the classic one; the launcher reports the kernel it took
ROUTES = {None: 0, "classic": 1}
ROUTE_KERNELS = {1: FOR_EACH_STRIDED, 2: FOR_EACH_STRIDED_TILED}


@dataclasses.dataclass(frozen=True)
class StridedPlan:
    """The merged iteration space: ``shape`` outermost first, and for each
    operand its element ``offset`` and ``strides`` over it."""

    shape: Tuple[int, ...]
    offsets: Tuple[int, ...]
    strides: Tuple[Tuple[int, ...], ...]


def _merge(shape, strides_of) -> Tuple[list, list]:
    keep = [d for d, n in enumerate(shape) if n != 1]
    dims = [shape[d] for d in keep]
    strides = [[st[d] for d in keep] for st in strides_of]
    k = len(dims) - 2
    while k >= 0:
        if all(st[k] == st[k + 1] * dims[k + 1] for st in strides):
            dims[k:k + 2] = [dims[k] * dims[k + 1]]
            for st in strides:
                st[k:k + 2] = [st[k + 1]]
        k -= 1
    return dims, strides


def plan(views: Sequence[TensorView]) -> StridedPlan:
    """Merge the views' common logical shape: extent-1 dims go, and dim k
    merges into dim k + 1 where stride[k] == stride[k + 1] * shape[k + 1]
    on every operand."""
    dims, strides = _merge(views[0].shape, [v.strides for v in views])
    return StridedPlan(tuple(dims), tuple(v.offset for v in views),
                       tuple(tuple(st) for st in strides))


def strided_for_each_reference(fn: Callable, views, out_dtype=None) -> torch.Tensor:
    """Materialise each view, then the body in torch, cast to ``out_dtype``
    (default: the operands' promoted dtype)."""
    FOR_EACH_STRIDED.plain_calls += 1
    mats = [as_view(v).materialize() for v in views]
    out_dtype = out_dtype or functools.reduce(torch.promote_types, [m.dtype for m in mats])
    return fn(*mats).to(out_dtype)


class _Body:
    """A body's plan over operand dtypes: its generated source, the output
    dtype, and the library once a CUDA call has loaded it."""

    __slots__ = ("source", "out_dtype", "lib")

    def __init__(self, source: str, out_dtype: torch.dtype):
        self.source, self.out_dtype, self.lib = source, out_dtype, None


@functools.lru_cache(maxsize=512)
def _body_of_trace(traced: codegen.Traced, out_dtype: torch.dtype) -> _Body:
    return _Body(codegen.emit_for_each(traced, (out_dtype,), strided=True), out_dtype)


# Only the strided path memoises on the body's key: the host work before
# its launch was measured as the larger part of a call (PERF.md §6, row 23);
# the contiguous for_each traces every call and memoises on the trace
# (ops/foreach.py).
@functools.lru_cache(maxsize=1024)
def _slot(key: tuple) -> list:
    """The memo's slot for the plan of the bodies whose (body_key, operand
    dtypes, output dtype) is ``key``: empty until a call traces one (the
    body is not part of the key, so the caller fills the slot)."""
    return []


def _body(fn: Callable, dtypes: Tuple[torch.dtype, ...], out_dtype) -> _Body:
    """The plan of ``fn`` over ``dtypes``: memoised on what the body can
    read (``codegen.body_key``), else traced now."""
    bk = codegen.body_key(fn)
    slot = [] if bk is None else _slot((bk, dtypes, out_dtype))
    if not slot:
        traced = codegen.trace(fn, dtypes)
        slot.append(_body_of_trace(traced,
                                   out_dtype or functools.reduce(torch.promote_types, dtypes)))
    return slot[0]


def strided_for_each_source(fn: Callable, dtypes: Sequence[torch.dtype], out_dtype) -> str:
    """The generated source the strided kernels build for ``fn`` over
    operands of ``dtypes``."""
    return _body(fn, tuple(dtypes), out_dtype).source


@functools.lru_cache(maxsize=1024)
def _geometry(key) -> tuple:
    """The packed geometry (int64: the merged rank, shape, each operand's
    strides), the output shape and its size, of operands whose (shape,
    strides) are ``key``."""
    shape = tuple(key[0][0])
    for sh, _ in key[1:]:
        if tuple(sh) != shape:
            raise ValueError(f"operand shape mismatch: {tuple(sh)} vs {shape}")
    dims, strides = _merge(shape, [st for _, st in key])
    if not dims:  # one element
        dims, strides = [1], [[0] for _ in key]
    packed = [len(dims), *dims, *(x for st in strides for x in st)]
    return (ctypes.c_int64 * len(packed))(*packed), shape, math.prod(shape)


def _operand(o) -> tuple:
    """(dtype, shape, strides, address of logical element 0, tensor whose
    device it lies on) of a TensorView or anything ``as_view`` takes."""
    v = o if isinstance(o, TensorView) else as_view(o)
    b = v.buffer
    return v.dtype, v.shape, v.strides, b.data_ptr() + v.offset * b.element_size(), b


# ctypes arrays of 1 to MAX_IN pointers
_PTRS = [ctypes.c_void_p * k for k in range(codegen.MAX_IN + 1)]


def strided_for_each(fn: Callable, views, out_dtype=None, backend: str = "xla",
                     route: Optional[str] = None) -> torch.Tensor:
    """``fn`` over the strided views (TensorViews or torch tensors) in one
    kernel: a dense tensor of the views' logical shape in ``out_dtype``
    (default: the operands' promoted dtype). ``backend`` is laser_tpu's
    strategy switch, accepted. ``route`` (a CUDA call's): None the tiled
    kernel, "classic" the classic one; an unknown name raises ValueError on
    every device."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    code = ROUTES.get(route)
    if code is None:
        registry.route_code(ROUTES, route)  # raises, naming the routes
    views = list(views)
    # a torch tensor is read as it is: its strides and data_ptr, no view
    ops = [(o.dtype, o.shape, o.stride(), o.data_ptr(), o) if isinstance(o, torch.Tensor)
           else _operand(o) for o in views]
    if not ops:
        raise ValueError("strided_for_each needs at least one operand")
    first = ops[0][4]
    if len(ops) == 1:
        dtypes, gkey = (ops[0][0],), ((ops[0][1], ops[0][2]),)
    else:
        dev = first.get_device()
        for o in ops[1:]:
            if o[4].get_device() != dev:
                raise ValueError(f"strided_for_each: operands on {o[4].device} and "
                                 f"{first.device}")
        dtypes, gkey = tuple(o[0] for o in ops), tuple((o[1], o[2]) for o in ops)
    body = _body(fn, dtypes, out_dtype)
    geom, shape, n = _geometry(gkey)
    if not registry.on_cuda(first):
        return strided_for_each_reference(fn, views, body.out_dtype)
    out = first.new_empty(shape, dtype=body.out_dtype)
    if n == 0:
        return out
    if body.lib is None:
        body.lib = registry.load_generated(body.source)
    taken = ctypes.c_int(0)
    status = body.lib.ltt_gen_for_each_strided(
        _PTRS[len(ops)](*[o[3] for o in ops]), _PTRS[1](out.data_ptr()), geom, code,
        ctypes.byref(taken), registry.stream_handle(first))
    registry.check_launch(status, FOR_EACH_STRIDED.name if code == 1
                          else FOR_EACH_STRIDED_TILED.name)
    ROUTE_KERNELS[taken.value].launches += 1
    return out


def is_strided(operands) -> bool:
    """True where an operand is a non-contiguous tensor or a view that is not
    a contiguous window (one that is is materialised for free)."""
    for o in operands:
        if isinstance(o, torch.Tensor):
            if not o.is_contiguous():
                return True
        elif isinstance(o, TensorView) and not o.is_c_contiguous():
            return True
    return False


def materialized(operands) -> list:
    """Each operand as a contiguous tensor: a view materialised (torch's
    gather, as laser_tpu's ``_prepare_flat`` materialises), a tensor made
    contiguous."""
    return [o.materialize() if isinstance(o, TensorView) else
            (o.contiguous() if isinstance(o, torch.Tensor) else o) for o in operands]

