"""Error metrics used as test acceptance thresholds.

Port of the reference's error functions (laser/private/error_functions.nim:6-33);
these define the acceptance bars (1e-5 / 1e-6) used throughout the test suite,
mirroring tests/test_x86_reductions.nim:13-33 and
benchmarks/gemm/gemm_bench_float32.nim:356-367.
"""

from __future__ import annotations

import numpy as np


def absolute_error(y, y_true):
    y, y_true = np.asarray(y, np.float64), np.asarray(y_true, np.float64)
    return np.abs(y - y_true)


def relative_error(y, y_true):
    """|y - y_true| / max(|y|, |y_true|), 0 when both are 0
    (reference: error_functions.nim:10-18)."""
    y, y_true = np.asarray(y, np.float64), np.asarray(y_true, np.float64)
    denom = np.maximum(np.abs(y), np.abs(y_true))
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.abs(y - y_true) / denom
    return np.where(denom == 0, 0.0, out)


def mean_absolute_error(y, y_true) -> float:
    return float(np.mean(absolute_error(y, y_true)))


def mean_relative_error(y, y_true) -> float:
    return float(np.mean(relative_error(y, y_true)))


def max_relative_error(y, y_true) -> float:
    return float(np.max(relative_error(y, y_true)))


def round_step_down(x: int, step: int) -> int:
    """(reference: private/align_unroller.nim:14-20)"""
    return x - x % step


def round_step_up(x: int, step: int) -> int:
    """(reference: private/align_unroller.nim:6-12)"""
    return ((x + step - 1) // step) * step


def cdiv(a: int, b: int) -> int:
    return -(-a // b)
