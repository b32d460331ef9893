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


@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_bf16_with_bf16_gains(kind):
    """bf16 rows with bf16 gamma / beta, as every model keeps its gains:
    laser_tpu casts them to f32 inside its kernel, the port's kernels read
    them in their own dtype. Tolerance 2^-7 of max: one bf16 rounding of the
    output apart."""
    import jax.numpy as jnp

    rng = np.random.RandomState(13)
    x = torch.from_numpy((rng.randn(9, 200) * 3 + 1).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.randn(200).astype(np.float32)).bfloat16()
    b = torch.from_numpy((rng.randn(200) * 0.1).astype(np.float32)).bfloat16()
    jx, jg, jb = (jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in (x, g, b))
    if kind == "layer":
        got, want = layer_norm(x, g, b), jlayer_norm(jx, jg, jb)
    else:
        got, want = rms_norm(x, g), jrms_norm(jx, jg)
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float(), np.asarray(want, np.float32)) <= 2.0 ** -7


def test_unknown_route_raises_on_cpu():
    x = torch.ones(2, 8)
    for fn in (layer_norm, rms_norm):
        with pytest.raises(ValueError, match="unknown route"):
            fn(x, route="wgmma")
        fn(x, route="vec")  # a known name: a CPU tensor runs the plain version
