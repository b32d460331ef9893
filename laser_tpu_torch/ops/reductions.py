"""Deterministic reductions: sum / min / max / mean (port of
laser_tpu/ops/reductions.py).

Each is ``ops.foreach.map_reduce`` with the identity body, so on a CUDA
tensor it runs the two-launch reduction template of csrc/foreach.cuh
(fixed block ranges, fixed trees, no atomics: the same bits run after run)
and on a CPU tensor its plain version. Integer min and max start from the
type's extremes, as laser_tpu's (reductions.py:36-49).

``mean_var``, ``argmax`` and ``argmin`` run on laser_tpu's
``map_reduce_staged`` (kernel table row 22), not ported yet: they raise.
"""

from __future__ import annotations

import math

import torch

from .foreach import map_reduce


def _identity(x):
    return x


def _row22(name: str):
    raise NotImplementedError(
        f"{name} runs on laser_tpu's map_reduce_staged (laser_tpu/ops/foreach.py:442, "
        "kernel table row 22), which is not ported yet")


def reduce_sum(x: torch.Tensor, *, acc_dtype=None) -> torch.Tensor:
    """Sum of every element (laser_tpu: reductions.py:30), accumulated as
    ``map_reduce`` describes; the result has ``acc_dtype`` (default x's)."""
    return map_reduce(_identity, x, reduce_fn=torch.sum, identity=0.0, acc_dtype=acc_dtype)


def reduce_min(x: torch.Tensor) -> torch.Tensor:
    big = math.inf if x.dtype.is_floating_point else torch.iinfo(x.dtype).max
    return map_reduce(_identity, x, reduce_fn=torch.amin, identity=big)


def reduce_max(x: torch.Tensor) -> torch.Tensor:
    small = -math.inf if x.dtype.is_floating_point else torch.iinfo(x.dtype).min
    return map_reduce(_identity, x, reduce_fn=torch.amax, identity=small)


def reduce_mean(x: torch.Tensor, *, acc_dtype=None) -> torch.Tensor:
    return reduce_sum(x, acc_dtype=acc_dtype) / x.numel()


def mean_var(x: torch.Tensor):
    _row22("mean_var")


def argmax(x: torch.Tensor):
    _row22("argmax")


def argmin(x: torch.Tensor):
    _row22("argmin")
