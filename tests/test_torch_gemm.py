"""laser_tpu_torch GEMM against laser_tpu's, on the same seeded inputs.

The port's wrappers take their plain PyTorch versions here (CPU tensors);
laser_tpu runs its Pallas kernel in interpret mode. Tolerance: max |port -
laser_tpu| / max |laser_tpu| <= 1e-5 in f32 (both accumulate in fp32 at full
precision; they differ only in summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_tpu.ops.gemm.api import gemm as jgemm
from laser_tpu.ops.gemm.autodiff import linear as jlinear
from laser_tpu_torch.ops.gemm import gemm, gemm_ad, linear

from test_gemm_golden import FLOAT_CASES

REL = 1e-5


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("epilogue", [None, "relu", "tanh", "sigmoid", "gelu"])
def test_bias_epilogues_ragged(epilogue):
    rng = np.random.RandomState(1)
    a = rng.randn(37, 45).astype(np.float32)
    b = rng.randn(45, 29).astype(np.float32)
    bias = rng.randn(29).astype(np.float32)
    want = jgemm(a, b, bias=bias, epilogue=epilogue)
    got = gemm(_t(a), _t(b), bias=_t(bias), epilogue=epilogue)
    assert _rel_err(got, want) <= REL


@pytest.mark.parametrize("ta,tb", [(False, True), (True, False), (True, True)])
def test_transposes_in_place(ta, tb):
    rng = np.random.RandomState(2)
    M, K, N = 19, 70, 33
    a = rng.randn(*((K, M) if ta else (M, K))).astype(np.float32)
    b = rng.randn(*((N, K) if tb else (K, N))).astype(np.float32)
    bias = rng.randn(N).astype(np.float32)
    want = jgemm(a, b, bias=bias, transpose_a=ta, transpose_b=tb)
    got = gemm(_t(a), _t(b), bias=_t(bias), transpose_a=ta, transpose_b=tb)
    assert _rel_err(got, want) <= REL


@pytest.mark.parametrize("ta,tb", [(False, False), (False, True), (True, False), (True, True)])
def test_simt_route_matches_laser_tpu(ta, tb):
    """route="simt" (the f32 FFMA skeleton on a card) runs the plain version
    on CPU tensors: laser_tpu's f32 result, with the bias and relu."""
    from laser_tpu_torch.ops.gemm.kernel import gemm_fused

    rng = np.random.RandomState(6)
    M, K, N = 20, 36, 44
    a = rng.randn(*((K, M) if ta else (M, K))).astype(np.float32)
    b = rng.randn(*((N, K) if tb else (K, N))).astype(np.float32)
    bias = rng.randn(N).astype(np.float32)
    want = jgemm(a, b, bias=bias, epilogue="relu", transpose_a=ta, transpose_b=tb)
    got = gemm_fused(_t(a), _t(b), bias=_t(bias), epilogue="relu", transpose_a=ta,
                     transpose_b=tb, route="simt")
    assert _rel_err(got, want) <= REL


def test_alpha_beta_c():
    rng = np.random.RandomState(3)
    a = rng.randn(40, 130).astype(np.float32)
    b = rng.randn(130, 24).astype(np.float32)
    c = rng.randn(40, 24).astype(np.float32)
    want = jgemm(a, b, alpha=0.75, beta=-1.5, c=c, epilogue="tanh")
    got = gemm(_t(a), _t(b), alpha=0.75, beta=-1.5, c=_t(c), epilogue="tanh")
    assert _rel_err(got, want) <= REL


def test_plain_product_and_gemm_ad():
    rng = np.random.RandomState(4)
    x = rng.randn(9, 64).astype(np.float32)
    e = rng.randn(31, 64).astype(np.float32)
    want = jgemm(x, e, transpose_b=True)
    assert _rel_err(gemm_ad(_t(x), _t(e), None, False, True), want) <= REL


def test_linear_matches_laser_tpu():
    rng = np.random.RandomState(5)
    x = rng.randn(12, 48).astype(np.float32)
    w = rng.randn(48, 80).astype(np.float32)
    b = rng.randn(80).astype(np.float32)
    assert _rel_err(linear(_t(x), _t(w), _t(b), "gelu"), jlinear(x, w, b, "gelu")) <= REL
    assert _rel_err(linear(_t(x), _t(w)), jlinear(x, w)) <= REL


@pytest.mark.parametrize("case", FLOAT_CASES[:2], ids=["ones", "3x3"])
def test_golden_float(case):
    a, b, expected = (np.asarray(m, np.float32) for m in case)
    bias = np.zeros((b.shape[1],), np.float32)
    got = gemm(_t(a), _t(b), bias=_t(bias)).numpy()
    np.testing.assert_array_equal(got, expected)
    np.testing.assert_array_equal(got, np.asarray(jgemm(a, b, bias=bias)))


def test_bf16_output_dtype_and_rounding():
    rng = np.random.RandomState(6)
    a = rng.randn(16, 32).astype(np.float32)
    w = rng.randn(32, 8).astype(np.float32)
    got = gemm(_t(a).bfloat16(), _t(w).bfloat16(), bias=torch.zeros(8, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = jgemm(jnp.asarray(a, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                 bias=jnp.zeros((8,), jnp.bfloat16))
    # both round the same fp32 result to bf16 once: at most one bf16 ulp apart
    assert _rel_err(got.float(), np.asarray(want, np.float32)) <= 2 ** -7


def test_unported_dtype_raises():
    """A dtype laser_tpu's ``_dispatch`` refuses too (bool)."""
    with pytest.raises(NotImplementedError):
        gemm(torch.ones(2, 2, dtype=torch.bool), torch.ones(2, 2, dtype=torch.bool))
