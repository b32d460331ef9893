"""Strided tensor views over torch buffers (port of laser_tpu/tensor.py).

A ``TensorView`` is a (shape, strides, offset) window over a flat rank-1
torch buffer, strides in elements, as laser_tpu's is over a flat
``jax.Array`` (after the reference's ``Tensor[T]`` and ``MatrixView``:
laser/tensor/datatypes.nim:18-102, gemm_utils.nim:36-60). Strides may be
negative or zero; the rank is at most ``LASER_MAXRANK`` (6). A torch tensor
with any strides is a view already: ``as_view`` wraps its storage, storage
offset and strides without a copy.

Kernels read a view in place: ``ops.foreach.for_each`` over views runs the
strided template (``ops/strided.py``), one pass with no materialisation.
``materialize`` is the plain gather, and as in laser_tpu (an XLA slice,
transpose or gather, tensor.py:131-148) it is no kernel: a contiguous
window is a zero-copy slice of the buffer, and any other view is
``torch.as_strided`` over the buffer with every negative stride made
positive, ``flip`` on those axes, then ``contiguous()``.

Unlike laser_tpu's immutable arrays, a view and its buffer share memory:
``materialize`` of a contiguous window returns a tensor over the same
storage, and ``deep_copy`` is the way to a tensor of one's own.
Constructors that allocate take ``device`` and default to the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .config import LASER_MAXRANK


def row_major_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    """Row-major strides in elements (reference: initialization.nim:24-40)."""
    strides = [0] * len(shape)
    acc = 1
    for i in range(len(shape) - 1, -1, -1):
        strides[i] = acc
        acc *= shape[i]
    return tuple(strides)


@dataclasses.dataclass(frozen=True, eq=False)
class TensorView:
    """A (shape, strides, offset) window over a flat torch buffer.

    ``buffer`` is a rank-1 tensor whose elements are adjacent (stride 1);
    strides and offset are in elements. Every element of the window must lie
    in the buffer, which the constructor checks, since a kernel reads it."""

    buffer: torch.Tensor
    shape: Tuple[int, ...]
    strides: Tuple[int, ...]
    offset: int = 0

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "strides", tuple(int(s) for s in self.strides))
        object.__setattr__(self, "offset", int(self.offset))
        if len(self.shape) != len(self.strides):
            raise ValueError("shape/strides rank mismatch")
        if len(self.shape) > LASER_MAXRANK:
            raise ValueError(f"rank > LASER_MAXRANK={LASER_MAXRANK}")
        if self.buffer.dim() != 1 or (self.buffer.numel() > 1 and self.buffer.stride(0) != 1):
            raise ValueError("a TensorView's buffer is a rank-1 tensor of adjacent elements")
        if any(s < 0 for s in self.shape):
            raise ValueError(f"negative extent in shape {self.shape}")
        if self.size:
            lo = self.offset + sum((n - 1) * s for n, s in zip(self.shape, self.strides) if s < 0)
            hi = self.offset + sum((n - 1) * s for n, s in zip(self.shape, self.strides) if s > 0)
            if lo < 0 or hi >= self.buffer.numel():
                raise ValueError(f"view reaches elements [{lo}, {hi}] of a buffer of "
                                 f"{self.buffer.numel()}")

    # -- metadata (reference: datatypes.nim:32-47) ---------------------------

    @property
    def rank(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.buffer.dtype

    @property
    def device(self) -> torch.device:
        return self.buffer.device

    def is_c_contiguous(self) -> bool:
        """Contiguity ignoring size-1 dims (reference: datatypes.nim:38-47)."""
        z = 1
        for sh, st in zip(reversed(self.shape), reversed(self.strides)):
            if sh != 1:
                if st != z:
                    return False
                z *= sh
        return True

    # -- constructors ----------------------------------------------------------

    @staticmethod
    def from_array(a, device="cuda") -> "TensorView":
        """The row-major view of a contiguous copy of ``a`` (a torch tensor
        keeps its device; anything else goes to ``device``)."""
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a), device=device)
        t = t.contiguous()
        return TensorView(t.reshape(-1), tuple(t.shape), row_major_strides(t.shape), 0)

    @staticmethod
    def matrix(buffer: torch.Tensor, rows: int, cols: int, row_stride: int,
               col_stride: int, offset: int = 0) -> "TensorView":
        """MatrixView analog (reference: gemm_utils.nim:36-46)."""
        return TensorView(buffer.reshape(-1), (rows, cols), (row_stride, col_stride), offset)

    # -- view algebra ----------------------------------------------------------

    def transpose(self, axes: Optional[Sequence[int]] = None) -> "TensorView":
        axes = tuple(axes) if axes is not None else tuple(range(self.rank))[::-1]
        return TensorView(self.buffer, tuple(self.shape[a] for a in axes),
                          tuple(self.strides[a] for a in axes), self.offset)

    def slice(self, *spec: slice) -> "TensorView":
        """Basic (start:stop:step) slicing producing a strided view."""
        shape, strides, offset = [], [], self.offset
        for dim, s in enumerate(spec):
            start, stop, step = s.indices(self.shape[dim])
            n = len(range(start, stop, step))
            if n:
                offset += start * self.strides[dim]
            shape.append(n)
            strides.append(self.strides[dim] * step)
        for dim in range(len(spec), self.rank):
            shape.append(self.shape[dim])
            strides.append(self.strides[dim])
        return TensorView(self.buffer, tuple(shape), tuple(strides), offset)

    # -- materialization ---------------------------------------------------------

    def materialize(self) -> torch.Tensor:
        """A contiguous tensor with this view's logical contents: a zero-copy
        slice of the buffer for a contiguous window, else a torch gather
        (``as_strided``, ``flip`` of the negative-stride axes, ``contiguous``)."""
        if self.size == 0:
            return self.buffer.new_empty(self.shape)
        if self.is_c_contiguous():
            return self.buffer[self.offset:self.offset + self.size].view(self.shape)
        base = self.offset + sum((n - 1) * s for n, s in zip(self.shape, self.strides) if s < 0)
        t = torch.as_strided(self.buffer, self.shape, tuple(abs(s) for s in self.strides), base)
        flips = [d for d, s in enumerate(self.strides) if s < 0]
        return (t.flip(flips) if flips else t).contiguous()

    def to_array(self) -> torch.Tensor:
        return self.materialize()


def as_view(x) -> TensorView:
    """``x`` as a TensorView: a view as it is, a torch tensor of any strides
    as a window over its whole storage (no copy), anything else as the
    row-major view of a new card tensor."""
    if isinstance(x, TensorView):
        return x
    if isinstance(x, torch.Tensor):
        n = x.untyped_storage().nbytes() // x.element_size()
        return TensorView(x.as_strided((n,), (1,), 0), tuple(x.shape), tuple(x.stride()),
                          x.storage_offset())
    return TensorView.from_array(x)


# -- tensor construction (reference: initialization.nim:34-202) ---------------

def zeros(shape, dtype=torch.float32, device="cuda") -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def from_nested(nested, dtype=None, device="cuda") -> torch.Tensor:
    """toTensor analog: nested Python lists -> a tensor on ``device``
    (reference: initialization.nim:168-202)."""
    return torch.as_tensor(np.asarray(nested, dtype=dtype), device=device)


def copy_from_raw(flat, shape, dtype=None, device="cuda") -> torch.Tensor:
    """copyFromRaw analog (reference: initialization.nim:112-128)."""
    a = torch.as_tensor(flat, dtype=dtype, device=device).reshape(-1)
    if a.numel() != math.prod(shape):
        raise ValueError("length mismatch")
    return a.reshape(shape).clone()


def deep_copy(x) -> torch.Tensor:
    """deepCopy analog (reference: initialization.nim:42-75): a contiguous
    tensor of its own whatever the source's strides. A strided view is
    copied by one pass of the strided kernel (ops/strided.py, the
    forEachStrided copy the reference uses, initialization.nim:68)."""
    v = as_view(x)
    if not v.is_c_contiguous():
        from .ops.strided import strided_for_each

        return strided_for_each(lambda b: b, [v], v.dtype)
    return v.materialize().clone()


def set_zero(x) -> torch.Tensor:
    """setZero analog (reference: initialization.nim:130-154): a zeroed
    tensor of the same shape and dtype, on the same device."""
    v = as_view(x)
    return torch.zeros(v.shape, dtype=v.dtype, device=v.device)


def copy_from(dst, src) -> torch.Tensor:
    """copyFrom analog (reference: initialization.nim:77-110): dst's shape
    and dtype filled with src's (materialized) values, as a new tensor."""
    d, s = as_view(dst), as_view(src)
    if d.shape != s.shape:
        raise ValueError(f"copy_from shape mismatch {d.shape} vs {s.shape}")
    return s.materialize().to(d.dtype, copy=True)
