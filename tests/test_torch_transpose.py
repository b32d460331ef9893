"""laser_tpu_torch's transposes (the plain routes, on the CPU) against
laser_tpu's kernels in interpret mode, on the same numpy inputs from a
seed: transpose2d, transpose2d_batched, nchw2nhwc / nhwc2nchw and the
in-place route. A transpose moves elements, so every comparison is bit for
bit.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from laser_tpu.ops import transpose as jt
from laser_tpu_torch import registry
from laser_tpu_torch.ops import transpose as T

DTYPES = {"f32": (np.float32, torch.float32), "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}
SHAPES_2D = [(128, 128), (100, 37), (7, 300), (1, 1)]


def _np(shape, seed, dt=np.float32):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32).astype(dt)


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(x):
    """numpy bits of a torch or jax array, for a bit-for-bit comparison."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16 if x.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.fixture(scope="module")
def ref2d():
    """laser_tpu's transpose2d on every 2-D case, once."""
    out = {}
    for i, shape in enumerate(SHAPES_2D):
        for tag, (ndt, _) in DTYPES.items():
            x = _np(shape, 10 + i, ndt)
            out[(shape, tag)] = (x, jt.transpose2d(jnp.asarray(x)))
    return out


@pytest.mark.parametrize("tag", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES_2D)
def test_transpose2d_vs_laser_tpu(ref2d, shape, tag):
    x, want = ref2d[(shape, tag)]
    registry.reset_counts()
    got = T.transpose2d(_t(x))
    assert registry.counts()["transpose"] == {"launches": 0, "plain_calls": 1}
    assert got.shape == (shape[1], shape[0]) and got.dtype == DTYPES[tag][1]
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_transpose2d_batched_vs_laser_tpu(tag):
    x = _np((3, 100, 50), 20, DTYPES[tag][0])
    want = jt.transpose2d_batched(jnp.asarray(x))
    got = T.transpose2d_batched(_t(x))
    assert got.shape == (3, 50, 100)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("fn", ["nchw2nhwc", "nhwc2nchw"])
def test_layout_conversions_vs_laser_tpu_and_round_trip(fn):
    x = _np((2, 5, 6, 7), 21)
    want = getattr(jt, fn)(jnp.asarray(x))
    got = getattr(T, fn)(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = T.nhwc2nchw(got) if fn == "nchw2nhwc" else T.nchw2nhwc(got)
    np.testing.assert_array_equal(back.numpy(), x)


def test_in_place_route_vs_laser_tpu_pipelined_kernel():
    """N = 256 takes the in-place route in both packages: the port writes
    into x and returns it, as laser_tpu's pipelined kernel (128 tiles,
    interpret mode) aliases its input."""
    x = _np((256, 256), 22)
    want = jt._build_inplace_transpose_pipelined(256, 128, "float32", True)(jnp.asarray(x))
    xt = _t(x.copy())
    registry.reset_counts()
    got = T.transpose2d(xt, donate=True)
    assert registry.counts()["transpose_inplace"] == {"launches": 0, "plain_calls": 1}
    assert got is xt
    np.testing.assert_array_equal(xt.numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.numpy(), x.T)


@pytest.mark.parametrize("shape,donate", [((256, 256), False), ((100, 100), True),
                                          ((256, 128), True)])
def test_out_of_place_routes(shape, donate):
    """Without donate, and for N not a multiple of 128 or a non-square x,
    the result is a new tensor and x is untouched (laser_tpu: the same
    inputs go out of place)."""
    x = _t(_np(shape, 23))
    keep = x.clone()
    registry.reset_counts()
    y = T.transpose2d(x, donate=donate)
    assert registry.counts()["transpose"]["plain_calls"] == 1
    assert y.data_ptr() != x.data_ptr() and torch.equal(x, keep) and torch.equal(y, keep.t())


def test_non_contiguous_input_and_other_dtypes():
    """A strided input is made contiguous first; 1- and 8-byte elements."""
    base = torch.arange(60, dtype=torch.int64).reshape(6, 10)
    assert torch.equal(T.transpose2d(base[:, ::2]), base[:, ::2].t())
    u8 = torch.arange(35, dtype=torch.uint8).reshape(5, 7)
    assert torch.equal(T.transpose2d(u8), u8.t())
    with pytest.raises(ValueError):
        T.transpose2d(torch.ones(2, 3, 4))
