"""laser_tpu_torch attention against laser_tpu's flash kernel, same inputs.
Tolerance: max |port - laser_tpu| <= 2e-5 in f32 (unit-variance inputs, so
outputs are O(1))."""

import numpy as np
import pytest
import torch

from laser_tpu.ops.attention import attention as jattention
from laser_tpu_torch.ops.attention import attention, attention_reference

TOL = 2e-5


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
def test_vs_laser_tpu(causal, D):
    rng = np.random.RandomState(20)
    q, k, v = (rng.randn(2, 3, 77, D).astype(np.float32) for _ in range(3))
    want = np.asarray(jattention(q, k, v, causal=causal))
    got = attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    assert np.abs(got - want).max() <= TOL


def test_reference_is_the_same_function():
    rng = np.random.RandomState(21)
    q, k, v = (torch.from_numpy(rng.randn(4, 33, 96).astype(np.float32)) for _ in range(3))
    torch.testing.assert_close(attention(q, k, v, causal=True),
                               attention_reference(q, k, v, causal=True), rtol=0, atol=0)


def test_unported_options_raise():
    q = torch.zeros(1, 8, 64)
    with pytest.raises(NotImplementedError):
        attention(q, q, q, causal=True, window=4)
    with pytest.raises(NotImplementedError):
        attention(torch.zeros(1, 8, 320), torch.zeros(1, 8, 320), torch.zeros(1, 8, 320))
