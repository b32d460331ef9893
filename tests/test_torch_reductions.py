"""laser_tpu_torch's reduce_sum / reduce_min / reduce_max / reduce_mean (the
plain route, on the CPU) against laser_tpu's in interpret mode, on the same
numpy inputs from a seed.

Tolerances: f32 sums within 1e-6 of sum |x| (the two sides add in
different orders); bf16 sums each against the float64 sum: the port's f32
accumulator rounded once to bf16 (2^-8 of |sum|), laser_tpu's bf16 pairwise
tree rounding at each of its log2(n) levels (ROADMAP queue 3); min and max
exact, integers exact. mean_var, argmax and argmin (kernel table row 22)
run on map_reduce_staged; tests/test_torch_staged.py holds them against
laser_tpu.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from laser_tpu.ops import reductions as jr
from laser_tpu_torch import registry
from laser_tpu_torch.ops import reductions as R

SHAPES = [(37, 300), (1000,), (3, 5, 7), (64, 128)]


def _x(shape, seed, dt):
    rs = np.random.RandomState(seed)
    if dt == "int32":
        return rs.randint(-10 ** 6, 10 ** 6, shape).astype(np.int32)
    x = rs.randn(*shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dt == "bf16" else x


def _t(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).bfloat16()
    return torch.from_numpy(x)


CASES = [(s, d) for s in SHAPES for d in ("f32", "bf16", "int32")]


@pytest.fixture(scope="module")
def ref():
    out = {}
    for i, (shape, dt) in enumerate(CASES):
        x = _x(shape, 80 + i, dt)
        out[(shape, dt)] = (x, [np.asarray(f(x)).astype(np.float64)
                                for f in (jr.reduce_sum, jr.reduce_min, jr.reduce_max)])
    return out


@pytest.mark.parametrize("shape,dt", CASES)
def test_sum_min_max_vs_laser_tpu(ref, shape, dt):
    x, (s, mn, mx) = ref[(shape, dt)]
    xt = _t(x)
    registry.reset_counts()
    got = R.reduce_sum(xt)
    assert registry.counts()["map_reduce"] == {"launches": 0, "plain_calls": 1}
    assert got.dtype == xt.dtype and got.shape == ()
    if dt == "int32":
        assert got.item() == s
    elif dt == "f32":
        assert abs(got.item() - s) <= 1e-6 * np.abs(x.astype(np.float64)).sum()
    else:
        # the port's f32 accumulator rounds once: one bf16 rounding of the
        # float64 sum; laser_tpu's bf16 pairwise tree rounds at each of its
        # log2(n) levels
        x64 = x.astype(np.float64)
        oracle, abs_sum = x64.sum(), np.abs(x64).sum()
        assert abs(got.item() - oracle) <= 2 ** -8 * abs(oracle) + 1e-6 * abs_sum
        assert abs(s - oracle) <= np.ceil(np.log2(x.size)) * 2 ** -8 * abs_sum
    assert R.reduce_min(xt).item() == mn
    assert R.reduce_max(xt).item() == mx


def test_sum_acc_dtype_and_mean():
    x = _x((37, 300), 90, "bf16")
    want = float(np.asarray(jr.reduce_sum(x, acc_dtype=np.float32)))
    got = R.reduce_sum(_t(x), acc_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert abs(got.item() - want) <= 1e-6 * np.abs(x.astype(np.float64)).sum()
    xf = _x((1000,), 91, "f32")
    assert abs(R.reduce_mean(_t(xf)).item() - float(np.asarray(jr.reduce_mean(xf)))) <= 1e-6
    xi = _x((1000,), 92, "int32")
    m = R.reduce_mean(torch.from_numpy(xi))
    assert m.dtype == torch.float32
    assert abs(m.item() - float(np.asarray(jr.reduce_mean(xi)))) <= 1e-6 * abs(m.item())


def test_integer_sentinels():
    """An int8 min/max starts from the type's extremes, as laser_tpu's."""
    x = np.array([5, -7, 3], np.int8)
    assert R.reduce_min(torch.from_numpy(x)).item() == int(np.asarray(jr.reduce_min(x))) == -7
    assert R.reduce_max(torch.from_numpy(x)).item() == int(np.asarray(jr.reduce_max(x))) == 5


@pytest.mark.parametrize("name", ["mean_var", "argmax", "argmin"])
def test_row_22_functions_raise(name):
    """Row 22's functions run now (tests/test_torch_staged.py holds them
    against laser_tpu): on a CPU tensor through map_reduce_staged's plain
    version; an empty input still raises."""
    x = torch.tensor([3.0, -1.0, 3.0, 0.5])
    registry.reset_counts()
    out = getattr(R, name)(x)
    assert registry.counts()["map_reduce_staged"] == {"launches": 0, "plain_calls": 1}
    want = {"mean_var": (1.375, 2.921875), "argmax": (0, 3.0), "argmin": (1, -1.0)}[name]
    assert tuple(v.item() for v in out) == want
    with pytest.raises(ValueError, match="empty"):
        getattr(R, name)(torch.ones(0))
