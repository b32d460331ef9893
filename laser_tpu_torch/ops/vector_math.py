"""Row softmax (port of laser_tpu/ops/vector_math.py: ``softmax`` and
``_softmax_online``).

``softmax(x, axis=-1)`` is max-reduce, exp, sum-reduce and scale in one
kernel, over two CUDA kernels (csrc/softmax.cu), the arithmetic in fp32 and
one cast to x's dtype:

- the row kernel replaces laser_tpu/ops/vector_math.py:276 softmax: one block
  per row holds the row in shared memory as fp32, so the row is read from
  device memory once;
- the online kernel (``softmax_online``, which takes any width) replaces
  laser_tpu/ops/vector_math.py:200 _softmax_online: one block per row
  loops over it twice, a running (m, l) in the first sweep, exp(x - m) / l
  written in the second. laser_tpu
  carries (m, l) in scratch from one grid step to the next; Hopper blocks
  carry nothing, so the loop lives inside the block.

Routing is the port's own rule, by shape: a row of more than
``SOFTMAX_ROW_MAX_COLS`` (16384) columns, whose fp32 copy would take more
than 64 KB of a block's shared memory, goes online. laser_tpu routes by a
VMEM budget instead (vector_math.py:301: 8 rows of padded columns at 32
bytes each over 0.7 of the chip's VMEM), which sends rows past ~350k columns
online on a v5e and past ~46k on its CPU stand-in; the two packages compute
the same function either way.

A row of nothing but -inf comes out as laser_tpu's kernels give it: NaN from
the row kernel (0 / 0) and 0 from the online kernel, which takes an empty
sum as 1 (ROADMAP queue 3).

``donate=True``: laser_tpu aliases its output onto the donated input
(``input_output_aliases``), a TPU bandwidth trick. The port writes the
result into x's own storage and returns a view of it when the rows are x's
memory as it lies (x contiguous, ``axis`` the last); x must not be used
afterwards. Otherwise ``donate`` changes nothing.

Plain versions, in fp32: ``softmax_reference`` (the row kernel's function)
and ``softmax_online_reference`` (the online kernel's). On CPU tensors each
wrapper runs its plain version. exp/log/tanh/sigmoid, which laser_tpu runs
through ``for_each``, are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import registry

SOFTMAX = registry.kernel("softmax", "laser_tpu_torch/csrc/softmax.cu",
                          "laser_tpu/ops/vector_math.py:276 softmax")
SOFTMAX_ONLINE = registry.kernel("softmax_online", "laser_tpu_torch/csrc/softmax.cu",
                                 "laser_tpu/ops/vector_math.py:200 _softmax_online")

# widest row the row kernel holds in shared memory (fp32: 64 KB)
SOFTMAX_ROW_MAX_COLS = 16384


def _exp_shifted(xf: torch.Tensor):
    """exp(x - m) per row, m the row max taken as 0 where it is not finite
    (vector_math.py:321), and exactly 0 at -inf entries."""
    m = xf.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.where(xf == -torch.inf, torch.zeros_like(xf), torch.exp(xf - m))


def softmax_reference(x: torch.Tensor) -> torch.Tensor:
    """The row kernel's function over the last axis in plain PyTorch, fp32:
    e / sum(e), NaN for an all -inf row (vector_math.py:319-327)."""
    SOFTMAX.plain_calls += 1
    e = _exp_shifted(x.float())
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def softmax_online_reference(x: torch.Tensor) -> torch.Tensor:
    """The online kernel's function over the last axis in plain PyTorch,
    fp32: an empty sum is taken as 1, so an all -inf row gives 0
    (vector_math.py:252-253)."""
    SOFTMAX_ONLINE.plain_calls += 1
    e = _exp_shifted(x.float())
    s = e.sum(dim=-1, keepdim=True)
    return (e / torch.where(s > 0, s, torch.ones_like(s))).to(x.dtype)


def _softmax_cuda(x2: torch.Tensor, out: torch.Tensor, online: bool) -> torch.Tensor:
    if x2.dtype not in registry.DTYPE_CODES:
        raise TypeError(f"softmax kernel: unsupported dtype {x2.dtype}")
    rows, cols = x2.shape
    if not online and cols > SOFTMAX_ROW_MAX_COLS:
        raise ValueError(f"softmax row kernel: {cols} columns > {SOFTMAX_ROW_MAX_COLS}")
    if rows == 0 or cols == 0:
        return out
    lib = registry.load_library()
    fn = lib.ltt_softmax_online if online else lib.ltt_softmax_rows
    status = fn(x2.data_ptr(), out.data_ptr(), rows, cols, registry.DTYPE_CODES[x2.dtype],
                registry.stream_handle(x2))
    name = "softmax_online" if online else "softmax"
    registry.check_launch(status, name)
    (SOFTMAX_ONLINE if online else SOFTMAX).launches += 1
    return out


def _run(x2: torch.Tensor, out: Optional[torch.Tensor], online: bool, plain: bool):
    """One route on (rows, cols) contiguous rows, into ``out`` when given."""
    if plain or not registry.on_cuda(x2):
        y = (softmax_online_reference if online else softmax_reference)(x2)
        return y if out is None else out.copy_(y)
    return _softmax_cuda(x2, torch.empty_like(x2) if out is None else out, online)


def softmax(x: torch.Tensor, *, axis: int = -1, donate: bool = False,
            plain: bool = False) -> torch.Tensor:
    """Row softmax over ``axis``: the row kernel for rows of at most
    ``SOFTMAX_ROW_MAX_COLS`` columns, the online kernel for wider ones.
    ``plain=True`` takes the same route through the plain versions."""
    last = axis in (-1, x.ndim - 1)
    xm = x if last else x.movedim(axis, -1)
    shape = xm.shape
    cols = shape[-1] if xm.ndim else 1
    x2 = xm.reshape(-1, cols)
    in_place = donate and last and x.is_contiguous()
    if not in_place:
        x2 = x2.contiguous()
    y = _run(x2, x2 if in_place else None, cols > SOFTMAX_ROW_MAX_COLS, plain)
    y = y.reshape(shape)
    return y if last else y.movedim(-1, axis)


def softmax_online(x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """The online kernel over the last axis at any width (laser_tpu's
    ``_softmax_online``, which ``softmax`` reaches only for wide rows)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1] if x.ndim else 1).contiguous()
    return _run(x2, None, True, plain).reshape(shape)
