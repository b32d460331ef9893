"""``lm_cross_entropy``'s chunked-vocabulary branch against laser_tpu's.

V 300 in chunks of 128 (``block_v=128``: two full chunks and a ragged one of
44), ``memory_budget_bytes=None`` on both sides, both layouts (``transb``),
with and without label smoothing and ``ignore_index``. laser_tpu's branch
is jnp (its chunk products are XLA dot_generals); the port's runs the chunk
products in torch and ``ce_bwd``'s plain version on the CPU. Tolerances,
max |port - laser_tpu| against max |laser_tpu|: the loss and both
gradients 1e-5 in f32 (summation order only). bf16 operands: the chunk
logits are exact products summed in fp32 on both sides, but the port's
backward rounds each chunk's gradient to bf16 before its two products (the
rate of the tensor cores; laser_tpu's CPU interpreter multiplies in fp32):
2^-7, one bf16 rounding of the largest element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_tpu.ops.loss import lm_cross_entropy as jlm_cross_entropy
from laser_tpu_torch import registry
from laser_tpu_torch.ops.loss import lm_cross_entropy

V, D = 300, 32
CASES = [(transb, eps, ii) for transb in (True, False) for eps, ii in ((0.0, None), (0.1, 7))]
CHUNKED = dict(memory_budget_bytes=None, block_v=128)


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _inputs(transb):
    rng = np.random.RandomState(63)
    h = rng.randn(2, 9, D).astype(np.float32)
    emb = (rng.randn(V, D) * 0.3).astype(np.float32)
    t = rng.randint(0, V, (2, 9)).astype(np.int32)
    t[0, :3] = 7           # rows that ignore_index masks
    t[1, :2] = V - 1, 256  # targets in the ragged last chunk
    return h, (emb if transb else np.ascontiguousarray(emb.T)), t


@pytest.fixture(scope="module")
def refs():
    out = {}
    for transb, eps, ii in CASES:
        h, emb, t = _inputs(transb)
        out[transb, eps, ii] = jax.value_and_grad(lambda h, e: jlm_cross_entropy(
            h, e, t, transb=transb, label_smoothing=eps, ignore_index=ii, **CHUNKED),
            argnums=(0, 1))(h, emb)
    return out


def _port(h, emb, t, **kw):
    ht, et = (torch.from_numpy(a).requires_grad_(True) for a in (h, emb))
    loss = lm_cross_entropy(ht, et, torch.from_numpy(t), **kw)
    loss.backward()
    return loss.detach(), ht.grad, et.grad


@pytest.mark.parametrize("transb,eps,ii", CASES)
def test_chunked_vs_laser_tpu(refs, transb, eps, ii):
    want, (gh, ge) = refs[transb, eps, ii]
    h, emb, t = _inputs(transb)
    before = registry.counts()["ce_bwd"]["plain_calls"]
    loss, dh, de = _port(h, emb, t, transb=transb, label_smoothing=eps, ignore_index=ii,
                         **CHUNKED)
    assert registry.counts()["ce_bwd"]["plain_calls"] == before + 3  # one per chunk
    assert _err(loss, want) <= 1e-5
    assert _err(dh, gh) <= 1e-5
    assert _err(de, ge) <= 1e-5


@pytest.mark.parametrize("transb,eps,ii", CASES)
def test_chunked_and_materialized_branches_agree(transb, eps, ii):
    h, emb, t = _inputs(transb)
    kw = dict(transb=transb, label_smoothing=eps, ignore_index=ii, reduction="sum")
    for a, b in zip(_port(h, emb, t, **kw, **CHUNKED), _port(h, emb, t, **kw)):
        assert _err(a, b) <= 1e-5
    # a budget that the logits overflow takes the chunked branch too
    before = registry.counts()["ce_bwd"]["plain_calls"]
    _port(h, emb, t, **kw, memory_budget_bytes=2 * 18 * 384 * 4 - 1)
    assert registry.counts()["ce_bwd"]["plain_calls"] == before + 1  # one chunk of 8192


def test_reduction_none_and_block_rounding():
    h, emb, t = _inputs(True)
    ht, et = torch.from_numpy(h), torch.from_numpy(emb)
    rows = lm_cross_entropy(ht, et, torch.from_numpy(t), reduction="none", **CHUNKED)
    assert rows.shape == (2, 9)
    for bv in (1, 100, 200, 10 ** 6):  # rounded up to 128, at most the padded V
        got = lm_cross_entropy(ht, et, torch.from_numpy(t), reduction="none",
                               memory_budget_bytes=None, block_v=bv)
        assert torch.allclose(got, rows, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def bf16_ref():
    h, emb, t = _inputs(False)
    hb, eb = jnp.asarray(h, jnp.bfloat16), jnp.asarray(emb, jnp.bfloat16)
    return jax.value_and_grad(lambda h, e: jlm_cross_entropy(
        h, e, t, transb=False, label_smoothing=0.1, **CHUNKED), argnums=(0, 1))(hb, eb)


def test_bf16_chunk_products_vs_laser_tpu(bf16_ref):
    want, (gh, ge) = bf16_ref
    h, emb, t = _inputs(False)
    ht, et = (torch.from_numpy(a).bfloat16().requires_grad_(True) for a in (h, emb))
    before = registry.counts()["gemm"]["plain_calls"]
    loss = lm_cross_entropy(ht, et, torch.from_numpy(t), transb=False, label_smoothing=0.1,
                            **CHUNKED)
    loss.backward()
    # 3 chunk products forward, 9 backward: the GEMM kernel's plain version
    assert registry.counts()["gemm"]["plain_calls"] == before + 12
    assert ht.grad.dtype == torch.bfloat16 and et.grad.dtype == torch.bfloat16
    assert _err(loss.detach(), np.float32(want)) <= 1e-5
    assert _err(ht.grad.float(), np.asarray(gh, np.float32)) <= 2.0 ** -7
    assert _err(et.grad.float(), np.asarray(ge, np.float32)) <= 2.0 ** -7
