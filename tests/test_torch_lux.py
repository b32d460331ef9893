"""laser_tpu_torch's Lux against laser_tpu's ``lux.generate`` (interpret
mode), on the same numpy inputs from a seed: each lowering kind (one fused
for_each, map_reduce, row_reduce, the GEMM with its epilogue) on the port's
plain route, with the launches and plain calls counted through
``registry.counts()``.

Tolerances: f32 1e-6 relative and absolute for elementwise results (libm
ulps), sums 1e-6 of sum |x|, the GEMM 1e-5 of max |want| (summation
order).
"""

import numpy as np
import pytest
import torch

from laser_tpu import lux as jlux
from laser_tpu_torch import lux, registry


def _np(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _plain_counts():
    return {k: v["plain_calls"] for k, v in registry.counts().items() if v["plain_calls"]}


def _both(build):
    """The same Lux function on both packages."""
    return jlux.generate(build(jlux)), lux.generate(build(lux))


def test_elementwise_tree_is_one_for_each():
    jf, tf = _both(lambda L: lambda a, b, c: a + b - L.lux_sin(c) * 2.0)
    xs = [_np((37, 300), i) for i in range(3)]
    registry.reset_counts()
    got = tf(*map(torch.from_numpy, xs)).numpy()
    assert _plain_counts() == {"for_each": 1}
    np.testing.assert_allclose(got, np.asarray(jf(*xs)), rtol=1e-6, atol=1e-6)


def test_vector_math_and_schedule():
    sch = dict(algorithm="accurate")
    jf = jlux.generate(lambda a: jlux.lux_tanh(a) + jlux.lux_exp(a * 0.1),
                       schedule=jlux.Schedule(**sch))
    tf = lux.generate(lambda a: lux.lux_tanh(a) + lux.lux_exp(a * 0.1),
                      schedule=lux.Schedule(**sch))
    x = _np((64, 128), 3)
    np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(), np.asarray(jf(x)),
                               rtol=1e-6, atol=1e-6)


def test_full_reduction_is_one_map_reduce():
    jf, tf = _both(lambda L: lambda a, b: L.lux_sum(a * b))
    a, b = _np((32, 128), 4), _np((32, 128), 5)
    registry.reset_counts()
    got = tf(torch.from_numpy(a), torch.from_numpy(b)).item()
    assert _plain_counts() == {"map_reduce": 1}
    assert abs(got - float(np.asarray(jf(a, b)))) <= 1e-6 * np.abs(a * b).sum()
    jm, tm = _both(lambda L: lambda a: L.lux_max(L.lux_abs(a)))
    assert tm(torch.from_numpy(a)).item() == float(np.asarray(jm(a)))


@pytest.mark.parametrize("red", ["sum", "max"])
def test_last_axis_is_one_row_reduce(red):
    jf, tf = _both(lambda L: lambda a, b: getattr(L, f"lux_{red}")(a * b + 1.0, axis=-1))
    a, b = _np((37, 300), 6), _np((37, 300), 7)
    registry.reset_counts()
    got = tf(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert _plain_counts() == {"row_reduce": 1}
    want = np.asarray(jf(a, b))
    bound = 1e-6 * np.abs(a * b + 1).sum(-1) + 1e-6
    assert (np.abs(got - want) <= bound).all()


def test_other_axis_and_broadcast():
    jf, tf = _both(lambda L: lambda a, b: L.lux_sum(a + b, axis=0))
    a, b = _np((6, 40), 8), _np((40,), 9)
    got = tf(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jf(a, b)), rtol=1e-5, atol=1e-5)


def test_bias_activation_rides_the_gemm_epilogue():
    jf, tf = _both(lambda L: lambda x, w, bias: L.lux_sigmoid(x @ w + bias))
    x, w, bias = _np((16, 24), 10), _np((24, 8), 11), _np((8,), 12)
    registry.reset_counts()
    got = tf(*map(torch.from_numpy, (x, w, bias))).numpy()
    c = registry.counts()
    assert c["gemm"]["plain_calls"] == 1 and _plain_counts() == {"gemm": 1}
    want = np.asarray(jf(x, w, bias))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    jr, tr = _both(lambda L: lambda x, w, bias: L.LuxNode("unop", "relu", (x @ w + bias,)))
    np.testing.assert_allclose(tr(*map(torch.from_numpy, (x, w, bias))).numpy(),
                               np.asarray(jr(x, w, bias)), rtol=0, atol=1e-4)


def test_multi_output_is_one_for_each_multi():
    jf, tf = _both(lambda L: lambda a, b: (a + b, a * b - 1.0))
    a, b = _np((5, 9), 13), _np((5, 9), 14)
    registry.reset_counts()
    got = tf(torch.from_numpy(a), torch.from_numpy(b))
    assert _plain_counts() == {"for_each_multi": 1}
    for g, w in zip(got, jf(a, b), strict=True):  # XLA may fuse a * b - 1 into an FMA
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_gemm_tiles_schedule_raises():
    with pytest.raises(NotImplementedError, match="tile planner"):
        lux.generate(lambda a, b: a @ b, schedule=lux.Schedule(gemm_tiles=(128, 128, 128)))
