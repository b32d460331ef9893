"""``cross_entropy``'s two-kernel VJP (``ce_fwd`` + ``ce_bwd``) against
laser_tpu's, at a vocabulary past the fused-gradient threshold.

T 8 x V 131200 (padded past 131072, so ``fused_grad_bt`` is None and
laser_tpu runs its rows 8 and 9 in interpret mode, ``_build_ce_bwd`` on a
(1, 3) grid with a ragged last block). The port's plain versions run on the
CPU tensors. Tolerance, max |port - laser_tpu| against max |laser_tpu|: the
loss 1e-6; the gradient 1e-6 in f32 (exp and the lse differ by summation
order only) and 2^-7 in bf16 (dx rounds to bf16 on both sides: one
rounding of the largest element apart at most). Rows whose target is
``ignore_index`` get exact zeros.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_tpu.ops.loss import cross_entropy as jcross_entropy
from laser_tpu_torch import registry
from laser_tpu_torch.ops.loss import ce_bwd, ce_bwd_plain, ce_fwd, cross_entropy, fused_grad_bt

T, V = 8, 131200
CASES = [(dt, eps, ii) for dt in ("float32", "bfloat16") for eps in (0.0, 0.1)
         for ii in (None, 5)]
GRAD_REL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _inputs():
    rng = np.random.RandomState(60)
    x = (rng.randn(T, V) * 3).astype(np.float32)
    t = rng.randint(0, V, T).astype(np.int32)
    t[2] = t[6] = 5  # rows that ignore_index masks
    t[3] = V - 1     # a target in the ragged last block
    return x, t


@pytest.fixture(scope="module")
def refs():
    x, t = _inputs()
    out = {}
    for dt, eps, ii in CASES:
        xj = jnp.asarray(x, dtype=dt)
        val, grad = jax.value_and_grad(lambda a: jcross_entropy(
            a, t, label_smoothing=eps, ignore_index=ii))(xj)
        out[dt, eps, ii] = float(val), np.asarray(grad.astype(jnp.float32))
    return x, t, out


def test_threshold_routes_to_the_two_kernels():
    assert fused_grad_bt(T, V) is None and fused_grad_bt(T, 131072) == 8


@pytest.mark.parametrize("dt,eps,ii", CASES)
def test_value_and_grad_vs_laser_tpu(refs, dt, eps, ii):
    x, t, out = refs
    want, wgrad = out[dt, eps, ii]
    xt = torch.from_numpy(x).to(getattr(torch, dt)).requires_grad_(True)
    before = registry.counts()
    loss = cross_entropy(xt, torch.from_numpy(t), label_smoothing=eps, ignore_index=ii)
    loss.backward()
    after = registry.counts()
    for name, n in (("ce_fwd", 1), ("ce_bwd", 1), ("ce_fused_grad", 0)):
        assert after[name]["plain_calls"] == before[name]["plain_calls"] + n, name
    assert xt.grad.dtype == xt.dtype
    assert _err(loss.detach(), want) <= 1e-6
    assert _err(xt.grad.float(), wgrad) <= GRAD_REL[dt]
    if ii is not None:  # ignored rows: exact zeros, smoothing or not
        assert torch.count_nonzero(xt.grad[[2, 6]]) == 0


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_column_offset_matches_a_slice_of_the_full_width(eps):
    rng = np.random.RandomState(61)
    x = torch.from_numpy(rng.randn(5, 700).astype(np.float32) * 2)
    t = torch.tensor([0, 300, 411, 699, 260])
    lse = torch.logsumexp(x, dim=-1)
    g = torch.tensor([0.5, -1.0, 0.0, 2.0, 1.0])
    full = ce_bwd_plain(x, t, lse, g, eps)
    for c0, c1 in ((0, 256), (256, 512), (512, 700), (300, 301)):
        part = ce_bwd(x[:, c0:c1].contiguous(), t, lse, g, eps, c0=c0, V=700)
        assert torch.equal(part, full[:, c0:c1]), (c0, c1)
    assert torch.count_nonzero(full[2]) == 0  # g = 0
    # g (p - q) sums to g (1 - 1) = 0 over a row; the target column carries -g (1 - p_t)
    assert torch.allclose(full.sum(dim=1), torch.zeros(5), atol=1e-5)


def test_ce_bwd_is_the_gradient_of_ce_fwd():
    rng = np.random.RandomState(62)
    x = torch.from_numpy(rng.randn(6, 333).astype(np.float32)).requires_grad_(True)
    t = torch.from_numpy(rng.randint(0, 333, 6))
    g = torch.from_numpy(rng.randn(6).astype(np.float32))
    from laser_tpu_torch.ops.loss import ce_rows_plain

    (ce_rows_plain(x, t, 0.2) * g).sum().backward()
    _, lse = ce_fwd(x.detach(), t, 0.2)
    assert torch.allclose(ce_bwd(x.detach(), t, lse, g, 0.2), x.grad, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        ce_bwd(x.detach()[:, :100].contiguous(), t, lse, g, 0.2, c0=300, V=333)
