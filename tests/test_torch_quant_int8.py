"""laser_tpu_torch's int8 quantization against laser_tpu's.

The port's wrappers take their plain versions here (CPU tensors); laser_tpu
runs its Pallas quantize kernel in interpret mode, in this process (nothing
here needs x64).

- Deterministic ``quantize_int8`` (per row, global, unaligned 10 x 100,
  bf16 input, laser_tpu's multi-block global branch in f32): ``q`` and the
  scales bit-identical.
- Stochastic rounding has no laser_tpu counterpart on the CPU (interpret
  mode rounds to nearest), so it is held to its properties: every q is
  floor or ceil of v / scale, the same seed gives the same bits, and over
  256 seeds each element's mean is within 4 sigma (+ 1/256, one draw) of
  v / scale.
- ``gemm_quantized``: within one f32 rounding of laser_tpu's.
- Settled differences (ROADMAP.md queue 3): laser_tpu's multi-block global
  branch computes a bf16 input's scale in bf16, its kernel and the port in
  f32; and it ignores ``stochastic`` there and in interpret mode. Both
  compute amax / 127 as XLA compiles it, amax * f32(1/127).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from laser_tpu.ops.quant import dequantize_int8 as jdequantize
from laser_tpu.ops.quant import gemm_quantized as jgemm_quantized
from laser_tpu.ops.quant import quantize_int8 as jquantize
from laser_tpu_torch.ops.quant import INV_127, dequantize_int8, gemm_quantized, quantize_int8

CASES = {
    # name: (shape, per_row, dtype)
    "per_row": ((32, 256), True, np.float32),
    "global": ((64, 128), False, np.float32),
    "unaligned_per_row": ((10, 100), True, np.float32),
    "unaligned_global": ((10, 100), False, np.float32),
    "bf16_per_row": ((16, 256), True, ml_dtypes.bfloat16),
    "bf16_global": ((16, 256), False, ml_dtypes.bfloat16),
    # rows > laser_tpu's row block (256 at 2048 columns): its XLA branch
    "multi_block_global": ((264, 2048), False, np.float32),
}


def _x(shape, dtype, seed=1):
    return (np.random.RandomState(seed).randn(*shape) * 5).astype(dtype)


def _t(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).bfloat16()
    return torch.from_numpy(x)


@pytest.mark.parametrize("name", list(CASES))
def test_deterministic_bit_identical(name):
    shape, per_row, dtype = CASES[name]
    x = _x(shape, dtype)
    jq, js = jquantize(x, per_row=per_row)
    q, s = quantize_int8(_t(x), per_row=per_row)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == np.asarray(js).shape == ((shape[0], 1) if per_row else (1, 1))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(jdequantize(jq, js)))


def test_stochastic_floor_or_ceil_and_seeded():
    x = _t(_x((16, 256), np.float32, seed=2))
    q, s = quantize_int8(x, stochastic=True, seed=7)
    scaled = x / s
    lo = torch.clamp(torch.floor(scaled), -127, 127)
    hi = torch.clamp(torch.ceil(scaled), -127, 127)
    assert bool(((q == lo) | (q == hi)).all())
    assert torch.equal(q, quantize_int8(x, stochastic=True, seed=7)[0])
    assert not torch.equal(q, quantize_int8(x, stochastic=True, seed=8)[0])
    assert torch.equal(s, quantize_int8(x)[1])  # the scale is the deterministic one


def test_stochastic_unbiased_over_256_seeds():
    x = _t(_x((8, 64), np.float32, seed=3))
    n = 256
    qs = torch.stack([quantize_int8(x, stochastic=True, seed=k)[0].double() for k in range(n)])
    _, s = quantize_int8(x)
    scaled = (x / s).double()
    frac = scaled - torch.floor(scaled)
    sigma = torch.sqrt(frac * (1 - frac) / n)
    err = (qs.mean(0) - scaled).abs()
    assert bool((err <= 4 * sigma + 1.0 / n).all()), (err - 4 * sigma).max()
    # over all elements at once: the mean error is within 4 sigma of 0
    total = (qs.mean(0) - scaled).sum()
    assert abs(total.item()) <= 4 * torch.sqrt((frac * (1 - frac)).sum() / n).item()


def test_gemm_quantized_within_one_f32_rounding():
    rng = np.random.RandomState(4)
    a = rng.randn(64, 128).astype(np.float32)
    b = rng.randn(128, 48).astype(np.float32)
    want = np.asarray(jgemm_quantized(a, b))
    got = gemm_quantized(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.dtype == np.float32
    assert (np.abs(got - want) <= 2.0 ** -23 * np.abs(want)).all()


def test_laser_tpus_bf16_multi_block_scale_and_stochastic_settled():
    """laser_tpu's multi-block global branch (rows past its row block)
    computes a bf16 input's amax / 127 in bf16; its kernel branch and the
    port compute it in f32 (the port in every branch). And laser_tpu
    rounds to nearest where ``stochastic`` is asked in interpret mode."""
    x = _x((264, 2048), ml_dtypes.bfloat16, seed=5)
    js = float(np.asarray(jquantize(x, per_row=False)[1])[0, 0])
    q, s = quantize_int8(_t(x), per_row=False)
    amax = np.abs(x.astype(np.float32)).max()
    assert s.item() == np.float32(amax) * np.float32(INV_127)
    assert js == np.float32(ml_dtypes.bfloat16(js))  # a bf16 value
    assert abs(js - s.item()) > 2.0 ** -12 * s.item()  # past one f32 rounding
    xs = _x((16, 256), np.float32, seed=6)
    jq_det = np.asarray(jquantize(xs)[0])
    np.testing.assert_array_equal(np.asarray(jquantize(xs, stochastic=True, seed=3)[0]), jq_det)
    assert not np.array_equal(quantize_int8(_t(xs), stochastic=True, seed=3)[0].numpy(), jq_det)
