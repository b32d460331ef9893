"""laser_tpu_torch paged decode attention against laser_tpu's kernel, same
inputs. Tolerance: max |port - laser_tpu| <= 1e-5 in f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_tpu.ops.paged_attention import paged_attention as jpaged
from laser_tpu_torch.ops.paged_attention import paged_attention

TOL = 1e-5


def _case(rng, S, Hq, Hkv, hd, ps, P, mp, lengths):
    q = rng.randn(S, Hq, hd).astype(np.float32)
    kp = rng.randn(P, Hkv, ps, hd).astype(np.float32)
    vp = rng.randn(P, Hkv, ps, hd).astype(np.float32)
    tables = rng.permutation(P)[:S * mp].reshape(S, mp).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


def _both(q, kp, vp, tables, lengths):
    want = np.asarray(jpaged(*(jnp.asarray(x) for x in (q, kp, vp, tables, lengths))))
    got = paged_attention(*(torch.from_numpy(x) for x in (q, kp, vp, tables, lengths)))
    return got.numpy(), want


def test_mixed_lengths_with_inactive_slot():
    rng = np.random.RandomState(30)
    got, want = _both(*_case(rng, 4, 8, 8, 64, 16, 32, 6, [0, 1, 37, 96]))
    assert np.abs(got - want).max() <= TOL
    assert np.all(got[0] == 0.0)  # length 0: all zeros


@pytest.mark.parametrize("Hkv", [1, 2])
def test_gqa(Hkv):
    rng = np.random.RandomState(31)
    got, want = _both(*_case(rng, 3, 8, Hkv, 64, 16, 24, 4, [5, 64, 33]))
    assert np.abs(got - want).max() <= TOL


def test_unported_options_raise():
    rng = np.random.RandomState(32)
    q, kp, vp, tables, lengths = (torch.from_numpy(x) for x in
                                  _case(rng, 2, 2, 2, 32, 16, 8, 2, [3, 4]))
    with pytest.raises(NotImplementedError):
        paged_attention(q, kp, vp, tables, lengths, window=8)
    with pytest.raises(NotImplementedError):  # more than 8 query heads per kv head
        paged_attention(q.repeat(1, 8, 1)[:, :9], kp[:, :1], vp[:, :1], tables, lengths)
