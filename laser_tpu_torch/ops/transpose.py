"""Layout kernels: 2-D transpose out of place and in place, batched
transpose, NCHW <-> NHWC (port of laser_tpu/ops/transpose.py).

Two CUDA kernels (csrc/transpose.cu), templated on the element size, so
every dtype of 1, 2, 4 or 8 bytes goes through them and the result is the
same bits as the plain version:

- ``transpose`` replaces laser_tpu/ops/transpose.py:42 ``_build_transpose``:
  (B, R, C) -> (B, C, R) through 32 x 32 shared-memory tiles. It is what
  ``transpose2d``, ``transpose2d_batched``, ``nchw2nhwc`` and ``nhwc2nchw``
  run, as there.
- ``transpose_inplace`` replaces both in-place TPU kernels, :94
  ``_build_inplace_transpose`` and :151
  ``_build_inplace_transpose_pipelined``: one block per upper-triangular
  tile pair swaps the pair through shared memory.

``transpose2d(x, donate=True)`` routes as laser_tpu does: a square x whose
N is a multiple of 128 is transposed in place (laser_tpu takes N divisible
by 512, 256 or 128, :76-81), anything else out of place. So the same
inputs reach the same kind of kernel in both packages. laser_tpu skips the
in-place kernel in interpret mode; the port's CPU route is the in-place
kernel's plain version, which also writes into x.

``tile`` is accepted for parity with laser_tpu and ignored: the kernels'
tile edge is fixed at 32 (csrc/transpose.cu kTile).

A non-contiguous input is made contiguous by torch first (laser_tpu's
arrays are always dense). On a CPU tensor each wrapper runs its plain
version (``transpose2d_reference``, ``transpose2d_batched_reference``,
``transpose_inplace_reference``); on a CUDA tensor it launches its kernel
or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import registry

SOURCE = "laser_tpu_torch/csrc/transpose.cu"
TRANSPOSE = registry.kernel("transpose", SOURCE, "laser_tpu/ops/transpose.py:42 _build_transpose")
TRANSPOSE_INPLACE = registry.kernel(
    "transpose_inplace", SOURCE,
    "laser_tpu/ops/transpose.py:151 _build_inplace_transpose_pipelined "
    "(and :94 _build_inplace_transpose)")

# laser_tpu's in-place route takes square N divisible by 128 (its tiles are
# 512, 256 or 128)
INPLACE_MULTIPLE = 128
ELEMENT_SIZES = (1, 2, 4, 8)


def _element_size(x: torch.Tensor) -> int:
    size = x.element_size()
    if size not in ELEMENT_SIZES:
        raise TypeError(f"transpose kernels move elements of {ELEMENT_SIZES} bytes, "
                        f"got {x.dtype} ({size} bytes)")
    return size


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def transpose2d_batched_reference(x: torch.Tensor) -> torch.Tensor:
    """(..., R, C) -> (..., C, R) in plain torch: the out-of-place kernel's
    function, batched or not."""
    TRANSPOSE.plain_calls += 1
    return x.transpose(-1, -2).contiguous()


transpose2d_reference = transpose2d_batched_reference


def transpose_inplace_reference(x: torch.Tensor) -> torch.Tensor:
    """The in-place kernel's function: x (N, N) now holds its transpose."""
    TRANSPOSE_INPLACE.plain_calls += 1
    return x.copy_(x.t().contiguous())


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _transpose_cuda(x3: torch.Tensor) -> torch.Tensor:
    B, R, C = x3.shape
    y = torch.empty((B, C, R), dtype=x3.dtype, device=x3.device)
    if y.numel() == 0:
        return y
    status = registry.load_library().ltt_transpose(
        x3.data_ptr(), y.data_ptr(), B, R, C, _element_size(x3), registry.stream_handle(x3))
    registry.check_launch(status, TRANSPOSE.name)
    TRANSPOSE.launches += 1
    return y


def _transpose_inplace_cuda(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    if n == 0:
        return x
    status = registry.load_library().ltt_transpose_inplace(
        x.data_ptr(), n, _element_size(x), registry.stream_handle(x))
    registry.check_launch(status, TRANSPOSE_INPLACE.name)
    TRANSPOSE_INPLACE.launches += 1
    return x


def transpose2d_batched(x: torch.Tensor, *, tile: Optional[Tuple[int, int]] = None
                        ) -> torch.Tensor:
    """(B, R, C) -> (B, C, R) (reference: transpose2D_batched,
    swapaxes.nim:56-84). ``tile`` is ignored (see the module note)."""
    del tile
    if x.dim() != 3:
        raise ValueError(f"transpose2d_batched expects (B, R, C), got {tuple(x.shape)}")
    x = x.contiguous()
    if not registry.on_cuda(x):
        return transpose2d_batched_reference(x)
    return _transpose_cuda(x)


def transpose2d(x: torch.Tensor, *, tile: Optional[Tuple[int, int]] = None,
                donate: bool = False) -> torch.Tensor:
    """(R, C) -> (C, R) (reference: transpose2D_copy, swapaxes.nim:16-54).

    ``donate=True`` on a square contiguous x whose N is a multiple of 128
    transposes in place: the kernel writes into x's storage and returns x,
    so the caller's tensor now holds the transpose. Otherwise, and without
    ``donate``, the result is a new tensor. ``tile`` is ignored."""
    del tile
    if x.dim() != 2:
        raise ValueError(f"transpose2d expects (R, C), got {tuple(x.shape)}")
    R, C = x.shape
    if donate and R == C and R % INPLACE_MULTIPLE == 0 and x.is_contiguous():
        if not registry.on_cuda(x):
            return transpose_inplace_reference(x)
        return _transpose_inplace_cuda(x)
    x = x.contiguous()
    if not registry.on_cuda(x):
        return transpose2d_reference(x)
    return _transpose_cuda(x.unsqueeze(0))[0]


def nchw2nhwc(x: torch.Tensor, **kw) -> torch.Tensor:
    """(N, C, H, W) -> (N, H, W, C) as a batched (C, H*W) transpose
    (reference: swapaxes.nim:86-98)."""
    N, C, H, W = x.shape
    return transpose2d_batched(x.reshape(N, C, H * W), **kw).reshape(N, H, W, C)


def nhwc2nchw(x: torch.Tensor, **kw) -> torch.Tensor:
    """(N, H, W, C) -> (N, C, H, W) (reference: swapaxes.nim:100-112)."""
    N, H, W, C = x.shape
    return transpose2d_batched(x.reshape(N, H * W, C), **kw).reshape(N, C, H, W)
