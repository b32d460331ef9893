"""laser_tpu_torch layer_norm / rms_norm against laser_tpu's, same inputs.
Tolerance: max |port - laser_tpu| / max |laser_tpu| <= 1e-5 in f32."""

import numpy as np
import pytest
import torch

from laser_tpu.ops.norm import layer_norm as jlayer_norm, rms_norm as jrms_norm
from laser_tpu_torch.ops.norm import layer_norm, rms_norm

REL = 1e-5


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("shape", [(7, 200), (3, 5, 96), (33, 130)])
@pytest.mark.parametrize("affine", [False, True])
def test_layer_norm(shape, affine):
    rng = np.random.RandomState(10)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    g = rng.randn(shape[-1]).astype(np.float32) if affine else None
    b = rng.randn(shape[-1]).astype(np.float32) if affine else None
    want = jlayer_norm(x, g, b)
    got = layer_norm(torch.from_numpy(x), None if g is None else torch.from_numpy(g),
                     None if b is None else torch.from_numpy(b))
    assert _rel_err(got, want) <= REL


@pytest.mark.parametrize("shape", [(9, 72), (4, 300)])
def test_rms_norm(shape):
    rng = np.random.RandomState(11)
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(shape[-1]).astype(np.float32)
    assert _rel_err(rms_norm(torch.from_numpy(x), torch.from_numpy(g)),
                    jrms_norm(x, g)) <= REL
    assert _rel_err(rms_norm(torch.from_numpy(x)), jrms_norm(x)) <= REL


def test_eps_default_is_1e6():
    # a near-constant row makes eps dominate: 1e-5 would fail this
    x = np.full((2, 64), 3.0, np.float32)
    x[:, 0] += 1e-3
    got = layer_norm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlayer_norm(x)), rtol=1e-5, atol=1e-6)


def test_axis_argument():
    rng = np.random.RandomState(12)
    x = rng.randn(6, 40, 3).astype(np.float32)
    assert _rel_err(layer_norm(torch.from_numpy(x), axis=1), jlayer_norm(x, axis=1)) <= REL
