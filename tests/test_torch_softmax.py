"""laser_tpu_torch's softmax against laser_tpu's, the same numpy inputs, on
both routes: the row kernel against laser_tpu's row-resident ``softmax`` and
the online kernel against its ``_softmax_online`` (each forced), laser_tpu
in interpret mode, the port's plain versions. Tolerance: 1e-6 absolute on
probabilities (laser_tpu's exp is its own polynomial, within 7.9e-8
relative of libm; the port uses expf). A row of nothing but -inf is NaN on
both row routes and 0 on both online routes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_tpu.ops.vector_math import _softmax_online as j_softmax_online
from laser_tpu.ops.vector_math import softmax as jsoftmax
from laser_tpu_torch import registry
from laser_tpu_torch.ops import vector_math as vm

ATOL = 1e-6
SHAPES = [(16, 1000), (5, 3, 130), (3, 7)]


def _x(shape, seed):
    return (np.random.RandomState(seed).randn(*shape) * 4).astype(np.float32)


def _j_online(x):
    rows, cols = int(np.prod(x.shape[:-1])), x.shape[-1]
    return np.asarray(j_softmax_online(jnp.asarray(x.reshape(rows, cols)), rows, cols,
                                       True)).reshape(x.shape)


@pytest.fixture(scope="module")
def ref():
    """laser_tpu's two kernels on every shape, once."""
    return {s: (np.asarray(jsoftmax(_x(s, i))), _j_online(_x(s, i)))
            for i, s in enumerate(SHAPES)}


@pytest.mark.parametrize("shape", SHAPES)
def test_row_route_matches_laser_tpu_softmax(ref, shape):
    registry.reset_counts()
    got = vm.softmax(torch.from_numpy(_x(shape, SHAPES.index(shape)))).numpy()
    assert registry.counts()["softmax"]["plain_calls"] == 1
    np.testing.assert_allclose(got, ref[shape][0], rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_online_route_matches_laser_tpu_online_kernel(ref, shape):
    registry.reset_counts()
    got = vm.softmax_online(torch.from_numpy(_x(shape, SHAPES.index(shape)))).numpy()
    assert registry.counts()["softmax_online"]["plain_calls"] == 1
    np.testing.assert_allclose(got, ref[shape][1], rtol=0, atol=ATOL)


def test_wide_rows_go_online_and_match_laser_tpu():
    """20000 columns: past the port's row limit (online), under laser_tpu's
    CPU budget (row-resident); the function is the same."""
    x = _x((3, vm.SOFTMAX_ROW_MAX_COLS + 3616), 7)
    registry.reset_counts()
    got = vm.softmax(torch.from_numpy(x)).numpy()
    assert registry.counts()["softmax_online"]["plain_calls"] == 1
    np.testing.assert_allclose(got, np.asarray(jsoftmax(x)), rtol=0, atol=ATOL)


def test_axis():
    x = _x((4, 6, 5), 8)
    got = vm.softmax(torch.from_numpy(x), axis=1).numpy()
    np.testing.assert_allclose(got, np.asarray(jsoftmax(x, axis=1)), rtol=0, atol=ATOL)


@pytest.mark.parametrize("route", ["row", "online"])
def test_all_neg_inf_row_as_laser_tpu(route):
    """laser_tpu's row-resident kernel returns NaN for a row of nothing but
    -inf (e / s with s = 0) and its online kernel 0 (an empty sum taken as
    1); the port's two routes keep those traits, and partly -inf rows agree."""
    x = _x((3, 50), 9)
    x[0] = -np.inf
    x[2, ::4] = -np.inf
    if route == "row":
        want, got = np.asarray(jsoftmax(x)), vm.softmax(torch.from_numpy(x)).numpy()
        assert np.isnan(want[0]).all() and np.isnan(got[0]).all()
    else:
        want, got = _j_online(x), vm.softmax_online(torch.from_numpy(x)).numpy()
        assert (want[0] == 0).all() and (got[0] == 0).all()
    np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=ATOL)
    assert (got[2, ::4] == 0).all()


def test_donate_writes_in_place(ref):
    x = torch.from_numpy(_x(SHAPES[0], 0))
    out = vm.softmax(x, donate=True)
    assert out.data_ptr() == x.data_ptr()
    np.testing.assert_allclose(x.numpy(), ref[SHAPES[0]][0], rtol=0, atol=ATOL)
    # a moved axis cannot be written in place: donate changes nothing
    y = torch.from_numpy(_x((4, 6, 5), 8))
    before = y.clone()
    vm.softmax(y, axis=1, donate=True)
    assert torch.equal(y, before)


@pytest.mark.parametrize("scale", [1, 8])
def test_bf16_against_both_laser_tpu_kernels(scale):
    """bf16 rows (ROADMAP queue 3, settled): laser_tpu's row-resident kernel
    computes in bf16 (v - m, e and e / s round to bf16), its online kernel
    and both of the port's routes in fp32 with one cast. On (16, 1000) randn
    rows, seed 0: the port's row route is within 4.7e-3 of max of laser_tpu's
    row kernel (measured 4.63e-3 at x1, 3.94e-3 at x8), bit-identical to its
    online kernel, and its row sums are within 2.2e-3 of 1 (measured 2.9e-4,
    2.11e-3) where laser_tpu's row kernel's miss by up to 4.8e-3 (3.11e-3,
    4.79e-3)."""
    import ml_dtypes

    x = (np.random.RandomState(0).randn(16, 1000) * scale).astype(np.float32)
    xb = x.astype(ml_dtypes.bfloat16)
    row = np.asarray(jsoftmax(xb)).astype(np.float32)
    online = np.asarray(j_softmax_online(jnp.asarray(xb), 16, 1000, True)).astype(np.float32)
    xt = torch.from_numpy(xb.astype(np.float32)).bfloat16()
    got = vm.softmax(xt)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - row).max() <= 4.7e-3 * np.abs(row).max()
    np.testing.assert_array_equal(got, online)
    np.testing.assert_array_equal(vm.softmax_online(xt).float().numpy(), online)
    assert np.abs(got.astype(np.float64).sum(-1) - 1).max() <= 2.2e-3
    assert np.abs(row.astype(np.float64).sum(-1) - 1).max() <= 4.8e-3


@pytest.mark.parametrize("route", [None, "vec", "classic"])
def test_row_routes_run_the_plain_version_on_the_cpu(ref, route):
    """Each row route's name is taken on a CPU tensor, which runs the one
    plain version (counted under ``softmax``) and matches laser_tpu."""
    registry.reset_counts()
    got = vm.softmax(torch.from_numpy(_x(SHAPES[0], 0)), route=route).numpy()
    c = registry.counts()
    assert c["softmax"]["plain_calls"] == 1
    assert c["softmax_vec"] == {"launches": 0, "plain_calls": 0}
    np.testing.assert_allclose(got, ref[SHAPES[0]][0], rtol=0, atol=ATOL)


def test_unknown_route_raises():
    with pytest.raises(ValueError, match="route"):
        vm.softmax(torch.zeros(2, 3), route="shared")


@pytest.mark.parametrize("route", [None, "classic"])
def test_online_routes_run_the_plain_version_on_the_cpu(ref, route):
    """Each online route's name is taken by ``softmax_online`` and, past
    ``SOFTMAX_ROW_MAX_COLS`` columns, by ``softmax``; on a CPU tensor each
    runs the one plain version (counted under ``softmax_online``), and the
    cluster kernel's counter exists."""
    registry.reset_counts()
    got = vm.softmax_online(torch.from_numpy(_x(SHAPES[0], 0)), route=route).numpy()
    wide = torch.from_numpy(_x((2, vm.SOFTMAX_ROW_MAX_COLS + 1), 10))
    vm.softmax(wide, route=route)
    c = registry.counts()
    assert c["softmax_online"]["plain_calls"] == 2
    assert c["softmax_online_cluster"] == {"launches": 0, "plain_calls": 0}
    np.testing.assert_allclose(got, ref[SHAPES[0]][1], rtol=0, atol=ATOL)
    assert vm.SOFTMAX_CLUSTER_MAX_COLS == 16 * 512 * 32


def test_online_unknown_route_raises():
    for bad in ("cluster", "vec"):
        with pytest.raises(ValueError, match="route"):
            vm.softmax_online(torch.zeros(2, 3), route=bad)
