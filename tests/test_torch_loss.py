"""laser_tpu_torch cross-entropy against laser_tpu's, same inputs.

``cross_entropy`` value and gradient for each reduction, with and without
label smoothing and ``ignore_index`` (the port's plain versions on CPU
tensors; laser_tpu's CE kernels in interpret mode), and
``lm_cross_entropy``'s materialized branch. Tolerance: max |port -
laser_tpu| <= 1e-5 x max |laser_tpu| in f32 (both take the
logsumexp in fp32 with exact exp/log; they differ in summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_tpu.ops.loss import cross_entropy as jcross_entropy
from laser_tpu.ops.loss import lm_cross_entropy as jlm_cross_entropy
from laser_tpu_torch import registry
from laser_tpu_torch.ops.loss import cross_entropy, fused_grad_bt, lm_cross_entropy

REL = 1e-5


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("ignore_index", [None, 3])
def test_cross_entropy_vs_laser_tpu(reduction, eps, ignore_index):
    rng = np.random.RandomState(50)
    x = (rng.randn(3, 13, 300) * 3).astype(np.float32)
    t = rng.randint(0, 300, (3, 13)).astype(np.int32)
    t[0, :4] = 3  # rows that ignore_index masks
    w = rng.randn(3, 13).astype(np.float32)  # cotangent for reduction="none"
    kw = dict(reduction=reduction, label_smoothing=eps, ignore_index=ignore_index)

    def f(x):
        loss = jcross_entropy(x, t, **kw)
        return jnp.sum(loss * w) if reduction == "none" else loss

    want, wgrad = jax.value_and_grad(f)(x)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = cross_entropy(xt, torch.from_numpy(t), **kw)
    got = (loss * torch.from_numpy(w)).sum() if reduction == "none" else loss
    got.backward()
    assert _rel_err(got.detach(), want) <= REL
    assert _rel_err(xt.grad, wgrad) <= REL
    if reduction == "none":
        assert tuple(loss.shape) == (3, 13)


def test_value_only_call_runs_ce_fwd():
    rng = np.random.RandomState(51)
    x = rng.randn(17, 40).astype(np.float32)
    t = rng.randint(0, 40, 17).astype(np.int32)
    before = registry.counts()
    got = cross_entropy(torch.from_numpy(x), torch.from_numpy(t), reduction="none",
                        label_smoothing=0.2)
    after = registry.counts()
    assert after["ce_fwd"]["plain_calls"] == before["ce_fwd"]["plain_calls"] + 1
    assert after["ce_fused_grad"] == before["ce_fused_grad"]
    want = jcross_entropy(x, t, reduction="none", label_smoothing=0.2)
    assert _rel_err(got, want) <= REL


@pytest.mark.parametrize("requires_grad", [False, True])
def test_plain_route_counts_the_kernel_it_stands_in_for(requires_grad):
    x = torch.zeros(4, 16, requires_grad=requires_grad)
    t = torch.zeros(4, dtype=torch.long)
    ran, idle = ("ce_fused_grad", "ce_fwd") if requires_grad else ("ce_fwd", "ce_fused_grad")
    before = registry.counts()
    cross_entropy(x, t, plain=True)
    after = registry.counts()
    assert after[ran]["plain_calls"] == before[ran]["plain_calls"] + 1
    assert after[idle] == before[idle]


@pytest.mark.parametrize("transb", [True, False])
def test_lm_cross_entropy_vs_laser_tpu(transb):
    rng = np.random.RandomState(52)
    h = rng.randn(2, 9, 32).astype(np.float32)
    emb = (rng.randn(200, 32) * 0.3).astype(np.float32)
    emb = emb if transb else np.ascontiguousarray(emb.T)
    t = rng.randint(0, 200, (2, 9)).astype(np.int32)
    kw = dict(transb=transb, label_smoothing=0.05, ignore_index=7)
    want, (gh, ge) = jax.value_and_grad(
        lambda h, e: jlm_cross_entropy(h, e, t, **kw), argnums=(0, 1))(h, emb)
    ht, et = (torch.from_numpy(a).requires_grad_(True) for a in (h, emb))
    got = lm_cross_entropy(ht, et, torch.from_numpy(t), **kw)
    got.backward()
    assert _rel_err(got.detach(), want) <= REL
    assert _rel_err(ht.grad, gh) <= REL
    assert _rel_err(et.grad, ge) <= REL


def test_routing_threshold():
    # laser_tpu's routing threshold: padded V past 131072 has no fused grad;
    # the two-kernel VJP (tests/test_torch_loss_ce_bwd.py) and the chunked
    # lm_cross_entropy branch (tests/test_torch_lm_chunked.py) take those cases
    assert fused_grad_bt(8184, 8192) == 128
    assert fused_grad_bt(8, 131072) == 8
    assert fused_grad_bt(8, 131073) is None
