"""Deterministic reductions: sum / min / max / mean, and mean_var / argmax /
argmin (port of laser_tpu/ops/reductions.py).

Each is ``ops.foreach.map_reduce`` with the identity body, so on a CUDA
tensor it runs the two-launch reduction template of csrc/foreach.cuh
(fixed block ranges, fixed trees, no atomics: the same bits run after run)
and on a CPU tensor its plain version. Integer min and max start from the
type's extremes, as laser_tpu's (reductions.py:36-49).

``mean_var``, ``argmax`` and ``argmin`` are laser_tpu's bodies written in
torch over ``ops.foreach.map_reduce_staged``: on a CUDA tensor its staged
template (one launch, no atomics on the values; ``route="classic"`` the
two-launch template), on a CPU tensor its plain version. Their bodies read
nothing that changes between calls, so their plans are memoised on the
functions (``map_reduce_staged_constant``). ``mean_var``'s division of M2
by the count runs in the kernel's last store (its ``finish``).
"""

from __future__ import annotations

import functools
import math

import torch

from .foreach import map_reduce, map_reduce_staged_constant


def _identity(x):
    return x


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


# ---------------------------------------------------------------------------
# Staged reductions with structured accumulators (laser_tpu:
# reductions.py:64-139), on map_reduce_staged
# ---------------------------------------------------------------------------

def _mean_var_block(ctx, b):
    b = b.float()
    n = ctx.valid.float().sum()
    m = torch.where(ctx.valid, b, 0.0).sum() / n.clamp_min(1.0)
    m2 = torch.where(ctx.valid, (b - m) ** 2, 0.0).sum()
    return {"n": n, "mean": m, "m2": m2}


def _mean_var_combine(a, b):
    n = a["n"] + b["n"]
    nsafe = n.clamp_min(1.0)
    d = b["mean"] - a["mean"]
    mean = a["mean"] + d * b["n"] / nsafe
    m2 = a["m2"] + b["m2"] + d * d * a["n"] * b["n"] / nsafe
    return {"n": n, "mean": mean, "m2": m2}


def _mean_var_finish(a):
    """laser_tpu's ``m2 / max(n, 1)`` (reductions.py:96), on the card in the
    kernel's last store."""
    return {"mean": a["mean"], "var": a["m2"] / a["n"].clamp_min(1.0)}


def mean_var(x, *, route=None):
    """Single-pass mean and population variance, as f32 0-d tensors: per
    block the count, mean and M2 of its valid elements (in f32), across
    blocks Chan's parallel Welford combine (laser_tpu: reductions.py:64).
    ``route``: ``map_reduce_staged``'s."""
    acc = map_reduce_staged_constant(_mean_var_block, x, combine=_mean_var_combine,
                                     finish=_mean_var_finish, route=route)
    return acc["mean"], acc["var"]


_I64_MAX = torch.iinfo(torch.int64).max


@functools.lru_cache(maxsize=None)
def arg_reduce_fns(dt: torch.dtype, take_max: bool):
    """(block_fn, combine) of argmax (``take_max``) or argmin over values
    of dtype ``dt``, laser_tpu's bodies (reductions.py:99-139) in torch."""
    if dt.is_floating_point:
        sentinel = -math.inf if take_max else math.inf
    else:
        info = torch.iinfo(dt)
        sentinel = info.min if take_max else info.max

    def block_fn(ctx, b):
        ids = ctx.flat_indices(b.shape)
        b = torch.where(ctx.valid, b, sentinel)
        # first occurrence: among equal values the smallest index
        best = torch.amax(b) if take_max else torch.amin(b)
        idx = torch.amin(torch.where(b == best, ids, _I64_MAX))
        return {"val": best, "idx": idx}

    def combine(a, b):
        a_wins = (a["val"] > b["val"]) if take_max else (a["val"] < b["val"])
        tie = a["val"] == b["val"]
        val = torch.where(a_wins, a["val"], b["val"])
        idx = torch.where(a_wins, a["idx"],
                          torch.where(tie, torch.minimum(a["idx"], b["idx"]), b["idx"]))
        return {"val": val, "idx": idx}

    return block_fn, combine


def _arg_reduce(x, take_max: bool, route):
    block_fn, combine = arg_reduce_fns(x.dtype, take_max)
    acc = map_reduce_staged_constant(block_fn, x, combine=combine, route=route)
    return acc["idx"], acc["val"]


def argmax(x, *, route=None):
    """(flat index, value) of the maximum, the first on ties (laser_tpu:
    reductions.py:132). The index is int64, as torch.argmax's (laser_tpu's
    is int32); the value has x's dtype. ``route``: ``map_reduce_staged``'s."""
    return _arg_reduce(x, True, route)


def argmin(x, *, route=None):
    """(flat index, value) of the minimum, the first on ties."""
    return _arg_reduce(x, False, route)
