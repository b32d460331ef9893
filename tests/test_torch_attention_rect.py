"""laser_tpu_torch ``attention_with_stats`` over keys of their own length
against laser_tpu's, same inputs.

Queries (2, Sq, 64) against keys and values (2, Sk, 64), f32, with Sq < Sk
and Sq > Sk, causal and not, and with ``k_valid``: the port's plain route
(CPU tensors) against laser_tpu's flash kernel in interpret mode. Key j is
visible to query i when j < k_valid (default Sk) and, if causal, j <= i.
Tolerance: out within 1e-5 of max |laser_tpu|, m and l within 1e-5
relative (max |d| / max |laser_tpu|): both sides compute in f32 and differ
in summation order only.
"""

import numpy as np
import pytest
import torch

from laser_tpu.ops.attention import attention_with_stats as jattention_with_stats
from laser_tpu_torch.ops.attention import attention_with_stats

REL = 1e-5
# (Sq, Sk, causal, k_valid)
CASES = [(16, 40, False, None), (16, 40, True, None), (40, 16, False, None),
         (40, 16, True, None), (16, 40, True, 23)]


def _inputs(case):
    Sq, Sk, causal, k_valid = case
    rng = np.random.RandomState(Sq * 100 + Sk + 7 * causal)
    q = rng.randn(2, Sq, 64).astype(np.float32)
    k, v = (rng.randn(2, Sk, 64).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.fixture(scope="module")
def laser_tpu_runs():
    """laser_tpu's (out, m, l) of every case, each run once in interpret mode."""
    runs = {}
    for case in CASES:
        _, _, causal, k_valid = case
        out = jattention_with_stats(*_inputs(case), causal=causal, k_valid=k_valid)
        runs[case] = tuple(np.asarray(a, np.float64) for a in out)
    return runs


def _rel_err(got, want):
    got = got.double().numpy()
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"q{c[0]}-k{c[1]}-causal{int(c[2])}"
                         f"{'' if c[3] is None else f'-kvalid{c[3]}'}")
def test_rectangular_stats_vs_laser_tpu(case, laser_tpu_runs):
    _, _, causal, k_valid = case
    got = attention_with_stats(*map(torch.from_numpy, _inputs(case)), causal=causal,
                               k_valid=k_valid)
    for name, g, w in zip(("out", "m", "l"), got, laser_tpu_runs[case]):
        assert _rel_err(g, w) <= REL, name
