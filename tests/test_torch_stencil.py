"""laser_tpu_torch's ``stencil_solve`` against laser_tpu's.

The port's wrapper takes its plain version here (CPU tensors); laser_tpu
runs its Pallas sweep kernel in interpret mode. Tolerances: f32 bit for bit
(the same ops in the same order, each rounded once; no multiply-add for XLA
to contract); bf16 within 2^-7 of max |laser_tpu|, because XLA on the CPU
may keep a bf16 expression's intermediates in f32 (ROADMAP.md queue 3)
where the port rounds every op to bf16, as PyTorch's eager ops do.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import laser_tpu as lt
from laser_tpu_torch.ops import stencil

SHAPES = [(12, 16), (33, 65)]
ITERS = [1, 2, 7]
METHODS = ["jacobi", "redblack"]


def _inputs(shape, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return (np.asarray(rng.randn(*shape), dtype), np.asarray(rng.randn(*shape) * 0.5, dtype))


@pytest.fixture(scope="module")
def laser_runs():
    """laser_tpu's result for every (shape, method, iters), one interpret
    run each."""
    out = {}
    for shape in SHAPES:
        u, f = _inputs(shape, shape[0])
        for method in METHODS:
            for iters in ITERS:
                out[shape, method, iters] = np.asarray(
                    lt.stencil_solve(jnp.asarray(u), jnp.asarray(f), iters=iters, method=method))
    return out


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape", SHAPES)
def test_f32_bit_identical_to_laser_tpu(laser_runs, shape, method, iters):
    u, f = _inputs(shape, shape[0])
    tu = torch.from_numpy(u)
    got = stencil.stencil_solve(tu, torch.from_numpy(f), iters=iters, method=method)
    np.testing.assert_array_equal(got.numpy(), laser_runs[shape, method, iters])
    assert torch.equal(tu, torch.from_numpy(u))  # the input is not modified
    # edges fixed
    np.testing.assert_array_equal(got.numpy()[[0, -1]], u[[0, -1]])
    np.testing.assert_array_equal(got.numpy()[:, [0, -1]], u[:, [0, -1]])


@pytest.mark.parametrize("method", METHODS)
def test_bf16_within_one_rounding_of_laser_tpu(method):
    u, f = _inputs((33, 65), 5, ml_dtypes.bfloat16)
    want = np.asarray(lt.stencil_solve(jnp.asarray(u), jnp.asarray(f), iters=3,
                                       method=method)).astype(np.float32)
    got = stencil.stencil_solve(torch.from_numpy(u.astype(np.float32)).bfloat16(),
                                torch.from_numpy(f.astype(np.float32)).bfloat16(),
                                iters=3, method=method)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 2.0 ** -7 * np.abs(want).max()


def test_iters_compose_and_small_grids_unchanged():
    u, f = (torch.from_numpy(x) for x in _inputs((12, 16), 3))
    two = stencil.stencil_solve(u, f, iters=2)
    assert torch.equal(two, stencil.stencil_solve(stencil.stencil_solve(u, f, iters=1), f,
                                                  iters=1))
    for shape in [(2, 5), (5, 2), (1, 1)]:
        small = torch.randn(shape)
        out = stencil.stencil_solve(small, iters=4)
        assert torch.equal(out, small) and out is not small
    zero_iters = stencil.stencil_solve(u, f, iters=0)
    assert torch.equal(zero_iters, u) and zero_iters is not u


def test_converges_to_the_laplace_solution():
    """laser_tpu's convergence property (tests/test_batched_stencil.py):
    zero edges and f = 0 give 0 everywhere."""
    u = np.random.RandomState(0).randn(16, 16).astype(np.float32)
    u[0] = u[-1] = 0
    u[:, 0] = u[:, -1] = 0
    out = stencil.stencil_solve(torch.from_numpy(u), iters=500, method="redblack")
    assert out[1:-1, 1:-1].abs().max().item() < 1e-4


def test_errors_as_laser_tpu():
    with pytest.raises(ValueError, match="method"):
        stencil.stencil_solve(torch.zeros(4, 4), method="wavefront")
    with pytest.raises(ValueError, match="2D"):
        stencil.stencil_solve(torch.zeros(4, 4, 4))
