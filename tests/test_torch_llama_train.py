"""The port's llama training against laser_tpu's, on laser_tpu-made params.

A 2-layer d128 llama (8 query heads over 2 kv heads of 16, d_ff 256, vocab
97), batch 2 x 24 tokens, f32. laser_tpu runs jitted with its kernels in
interpret mode, one module-scoped fixture per call; the port runs its plain
versions (CPU tensors), its loss through ``lm_cross_entropy``'s chunked
branch (a 1-byte ``memory_budget_bytes``) where laser_tpu's, at this size,
takes the materialized one: the two are numerically interchangeable.
Tolerances, each max |port - laser_tpu| against max |laser_tpu| of the same
leaf:

- ``attention_gqa_trainable`` output and gradients 2e-5 (summation order);
- loss 1e-5, gradients 1e-4 (f32, through two layers, the GQA backward by
  K/V expansion and the chunked loss);
- after a step: parameters and masters 1e-4; m and v 1e-4 (0.1 g and
  0.001 g^2 after step 1), 1e-3 after step 2 (they carry step 1's
  parameter differences).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_tpu.models import llama as jllama
from laser_tpu.ops.attention import attention_gqa_trainable as jgqa_trainable
from laser_tpu_torch import registry
from laser_tpu_torch.convert import params_from_numpy, params_to_numpy
from laser_tpu_torch.models import llama
from laser_tpu_torch.ops.attention import attention_gqa_trainable
from laser_tpu_torch.ops.optim import value_and_grad

H, HKV, VOCAB = 8, 2, 97
LR, WD = 1e-3, 0.01
CHUNKED = dict(memory_budget_bytes=1)  # forces lm_cross_entropy's chunked branch
KW = dict(n_heads=H, n_kv_heads=HKV)


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _pairs(got, want):
    return zip(jax.tree_util.tree_leaves(params_to_numpy(got)),
               jax.tree_util.tree_leaves(want), strict=True)


def _assert_tree(got, want, bound):
    for a, b in _pairs(got, want):
        assert _err(a, b) <= bound


@pytest.fixture(scope="module")
def ref():
    params = jllama.init_llama(jax.random.PRNGKey(5), n_layers=2, d_model=128, n_heads=H,
                               n_kv_heads=HKV, d_ff=256, vocab=VOCAB, max_len=64)
    tokens = np.random.RandomState(90).randint(0, VOCAB, (2, 24)).astype(np.int32)
    tokens[1, 5:9] = 3  # targets that ignore_index masks
    out = {"params0": jax.tree.map(np.asarray, params), "tokens": tokens}
    static = {k: params[k] for k in jllama._STATIC_KEYS}
    train = {k: v for k, v in params.items() if k not in jllama._STATIC_KEYS}
    loss_kw = dict(label_smoothing=0.1, ignore_index=3)
    out["loss0"], out["grads0"] = jax.jit(jax.value_and_grad(
        lambda tp, t: jllama.llama_lm_loss({**tp, **static}, t, **KW, **loss_kw)))(
            train, tokens)
    p, o = params, jllama.llama_train_init(params)
    p, o, loss = jax.jit(lambda p, o, t: jllama.llama_train_step(
        p, o, t, 1, **KW, lr=LR, weight_decay=WD))(p, o, tokens)
    out[1] = jax.tree.map(np.asarray, (p, o, loss))
    p, o, loss = jax.jit(lambda p, o, t: jllama.llama_train_step(
        p, o, t, 2, **KW, lr=LR, weight_decay=WD, remat=True, accum=2, clip_norm=0.5))(
            p, o, tokens)
    out[2] = jax.tree.map(np.asarray, (p, o, loss))
    mp = jllama.llama_cast(params, jnp.float32)
    mp1 = jax.jit(lambda p, o, t: jllama.llama_train_step_mp(
        p, o, t, 1, **KW, lr=LR, weight_decay=WD, clip_norm=1.0))(
            mp, jllama.llama_train_init_mp(mp), tokens)
    out["mp"] = jax.tree.map(np.asarray, mp1)
    out["mp2"] = jax.tree.map(np.asarray, jax.jit(lambda p, o, t: jllama.llama_train_step_mp(
        p, o, t, 2, **KW, lr=LR, weight_decay=WD))(mp1[0], mp1[1], tokens))
    return out


@pytest.fixture(scope="module")
def gqa_ref():
    rng = np.random.RandomState(91)
    q = rng.randn(2, 8, 37, 32).astype(np.float32)
    k, v = (rng.randn(2, 2, 37, 32).astype(np.float32) for _ in range(2))
    w = rng.randn(2, 8, 37, 32).astype(np.float32)
    val, grads = jax.value_and_grad(
        lambda q, k, v: jnp.sum(jgqa_trainable(q, k, v, causal=True) * w),
        argnums=(0, 1, 2))(q, k, v)
    return (q, k, v, w), val, grads


def test_attention_gqa_trainable_vs_laser_tpu(gqa_ref):
    (q, k, v, w), val, grads = gqa_ref
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = (attention_gqa_trainable(*ts, causal=True) * torch.from_numpy(w)).sum()
    got.backward()
    assert _err(got.detach(), val) <= 2e-5
    for t, g in zip(ts, grads):
        assert _err(t.grad, g) <= 2e-5


def test_attention_gqa_trainable_runs_the_flash_backward(gqa_ref):
    """The backward re-runs the stats forward and the two backward kernels
    (their plain versions on the CPU) on the expanded K/V; Hq == Hkv is
    attention_trainable."""
    (q, k, v, w), _, _ = gqa_ref
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = attention_gqa_trainable(*ts, causal=True)
    before = registry.counts()
    (out * torch.from_numpy(w)).sum().backward()
    after = registry.counts()
    for name in ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name]["plain_calls"] == before[name]["plain_calls"] + 1, name
    assert ts[1].grad.shape == (2, 2, 37, 32)
    qm = torch.from_numpy(q[:, :2]).requires_grad_(True)
    km, vm = (torch.from_numpy(a).requires_grad_(True) for a in (k, v))
    attention_gqa_trainable(qm, km, vm, causal=True).sum().backward()
    assert km.grad.shape == km.shape


def test_lm_loss_and_grads_chunked(ref):
    params = params_from_numpy(ref["params0"], device="cpu")
    static = {k: params.pop(k) for k in llama._STATIC_KEYS}
    before = registry.counts()["ce_bwd"]["plain_calls"]
    loss, grads = value_and_grad(lambda tp, t: llama.llama_lm_loss(
        {**tp, **static}, t, **KW, label_smoothing=0.1, ignore_index=3, **CHUNKED))(
            params, torch.from_numpy(ref["tokens"]))
    assert registry.counts()["ce_bwd"]["plain_calls"] == before + 1  # one chunk
    assert _err(loss, ref["loss0"]) <= 1e-5
    _assert_tree(grads, ref["grads0"], 1e-4)


def test_two_train_steps_then_remat_accum_clip(ref):
    params = params_from_numpy(ref["params0"], device="cpu")
    opt = llama.llama_train_init(params)
    assert set(opt[0]) == set(params) - set(llama._STATIC_KEYS)
    tokens = torch.from_numpy(ref["tokens"])
    cos = params["rope_cos"].clone()
    for s, mv_bound, kw in ((1, 1e-4, {}),
                            (2, 1e-3, dict(remat=True, accum=2, clip_norm=0.5))):
        params, opt, loss = llama.llama_train_step(params, opt, tokens, s, **KW, lr=LR,
                                                   weight_decay=WD, **CHUNKED, **kw)
        jp, (jm, jv), jloss = ref[s]
        assert _err(loss, jloss) <= 1e-5
        _assert_tree(opt[0], jm, mv_bound)
        _assert_tree(opt[1], jv, mv_bound)
        _assert_tree(params, jp, 1e-4)
    assert torch.equal(params["rope_cos"], cos)  # the tables are not trained


def test_mixed_precision_step(ref):
    params = llama.llama_cast(params_from_numpy(ref["params0"], device="cpu"), torch.float32)
    opt = llama.llama_train_init_mp(params)
    assert opt[2]["embed"].data_ptr() != params["embed"].data_ptr()  # masters are copies
    params, (m, v, master), loss = llama.llama_train_step_mp(
        params, opt, torch.from_numpy(ref["tokens"]), 1, **KW, lr=LR, weight_decay=WD,
        clip_norm=1.0, **CHUNKED)
    jp, (jm, jv, jmaster), jloss = ref["mp"]
    assert _err(loss, jloss) <= 1e-5
    _assert_tree(m, jm, 1e-4)
    _assert_tree(v, jv, 1e-4)
    _assert_tree(master, jmaster, 1e-4)
    _assert_tree(params, jp, 1e-4)
    # laser_tpu's params and (m, v, master) taken across reproduce its step 2
    p2, o2, loss2 = llama.llama_train_step_mp(
        params_from_numpy(jp, device="cpu"), params_from_numpy((jm, jv, jmaster), device="cpu"),
        torch.from_numpy(ref["tokens"]), 2, **KW, lr=LR, weight_decay=WD, **CHUNKED)
    jp2, jo2, jloss2 = ref["mp2"]
    assert _err(loss2, jloss2) <= 1e-5
    _assert_tree(p2, jp2, 1e-4)
    for got, want in zip(o2, jo2, strict=True):
        _assert_tree(got, want, 1e-4)


def test_llama_cast_and_bf16_compute_tree():
    params = llama.init_llama(0, n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                              vocab=50, max_len=16, device="cpu")
    cast = llama.llama_cast(params)
    assert cast["rope_cos"].dtype == torch.bfloat16 and cast["blocks"][0]["wq"].dtype == \
        torch.bfloat16
    assert params["embed"].dtype == torch.float32  # a new tree
    m, v, master = llama.llama_train_init_mp(cast)
    assert master["unembed"].dtype == torch.float32 and m["unembed"].dtype == torch.float32
    tokens = torch.from_numpy(np.random.RandomState(92).randint(0, 50, (2, 9)))
    before = cast["unembed"].clone()
    cast, _, loss = llama.llama_train_step_mp(cast, (m, v, master), tokens, 1, n_heads=4,
                                              n_kv_heads=2, **CHUNKED)
    assert torch.isfinite(loss) and cast["unembed"].dtype == torch.bfloat16
    assert torch.equal(cast["unembed"], master["unembed"].to(torch.bfloat16))
    assert not torch.equal(cast["unembed"], before)
