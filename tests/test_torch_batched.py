"""laser_tpu_torch's batched GEMM against laser_tpu's.

The port's wrapper takes its plain version here (CPU tensors); laser_tpu
runs its Pallas batched kernel in interpret mode (f32, bf16, int8) or its
XLA route (int32), in this process. Tolerances: f32 within 1e-5 of
max |laser_tpu| (summation order only), bf16 within 2^-7 of it (one bf16
output rounding apart), int8 and int32 bit for bit (exact integer sums,
int32 wrapping mod 2^32).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from laser_tpu.ops.gemm.batched import gemm_batched as jgemm_batched
from laser_tpu_torch.ops.gemm import gemm_batched

SHAPE = (3, 20, 37, 19)  # B, M, K, N: every dimension a tail


def _inputs(dtype, seed):
    B, M, K, N = SHAPE
    rng = np.random.RandomState(seed)
    if np.dtype(dtype).kind == "i":
        info = np.iinfo(dtype)
        return (rng.randint(info.min, info.max, (B, M, K), dtype=dtype),
                rng.randint(info.min, info.max, (B, K, N), dtype=dtype))
    return rng.randn(B, M, K).astype(dtype), rng.randn(B, K, N).astype(dtype)


def _t(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).bfloat16()
    return torch.from_numpy(x)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype,bound", [(np.float32, 1e-5), (ml_dtypes.bfloat16, 2.0 ** -7)])
def test_float_within_bound(dtype, bound):
    a, b = _inputs(dtype, 1)
    want = np.asarray(jgemm_batched(a, b)).astype(np.float32)
    got = gemm_batched(_t(a), _t(b))
    assert got.dtype == (torch.bfloat16 if dtype == ml_dtypes.bfloat16 else torch.float32)
    assert got.shape == want.shape
    assert np.abs(_np(got) - want).max() <= bound * np.abs(want).max()


@pytest.mark.parametrize("dtype,out_dtype", [(np.int8, None), (np.int32, None),
                                             (np.int8, "float32")])
def test_integer_bit_identical(dtype, out_dtype):
    a, b = _inputs(dtype, 2)
    want = np.asarray(jgemm_batched(a, b, out_dtype=None if out_dtype is None
                                    else jnp.dtype(out_dtype)))
    got = gemm_batched(_t(a), _t(b), out_dtype=None if out_dtype is None
                       else getattr(torch, out_dtype)).numpy()
    assert got.dtype == want.dtype == np.dtype(out_dtype or np.int32)
    np.testing.assert_array_equal(got, want)
    # the exact sums, wrapped to 32 bits, are what both computed
    exact = np.einsum("bmk,bkn->bmn", a.astype(object), b.astype(object))
    wrapped = np.vectorize(lambda v: (int(v) + 2**31) % 2**32 - 2**31, otypes=[object])(exact)
    np.testing.assert_array_equal(want, wrapped.astype(want.dtype))


def test_shape_mismatch_raises():
    with pytest.raises(ValueError):
        gemm_batched(torch.ones(2, 3, 4), torch.ones(3, 4, 5))
