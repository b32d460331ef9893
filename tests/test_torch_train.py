"""The port's training step against laser_tpu's, on laser_tpu-made params.

A 2-layer d128 transformer (2 heads of 64, d_ff 256, vocab 512), batch 2 x 64
tokens, f32. laser_tpu runs jitted with its kernels in interpret mode; the
port runs its plain versions (CPU tensors). Tolerances, each max |port -
laser_tpu| against max |laser_tpu| of the same leaf unless said otherwise:

- loss 1e-5 and gradients 1e-4 (f32; the two differ only in summation
  order, through two layers, the attention backward and the tied logits);
- m and v after step 1 are 0.1 g and 0.001 g^2, so they carry the gradient
  bound; after step 2 they also carry step 1's parameter differences, 1e-3;
- updated parameters: Adam's first step moves each element by about lr
  whatever the size of its gradient, so an element whose gradient lies
  within the summation error of zero may step the other way. The bound is
  max |delta| <= 2 lr and mean |delta| <= 1e-3 lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_tpu.models import transformer as jtf
from laser_tpu.ops.gemm.autodiff import linear as jlinear
from laser_tpu.ops.norm import layer_norm as jlayer_norm
from laser_tpu_torch.convert import params_from_numpy, params_to_numpy
from laser_tpu_torch.models import transformer as tf
from laser_tpu_torch.ops.gemm import linear
from laser_tpu_torch.ops.norm import layer_norm
from laser_tpu_torch.ops.optim import value_and_grad

N_HEADS = 2
LR, WD = 1e-3, 0.01


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _assert_tree(got, want, bound):
    for a, b in zip(_leaves(params_to_numpy(got)), _leaves(want), strict=True):
        assert _err(a, b) <= bound


def _assert_adam_params(got, want):
    d = np.concatenate([np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
                        for a, b in zip(_leaves(params_to_numpy(got)), _leaves(want),
                                        strict=True)])
    assert d.max() <= 2 * LR and d.mean() <= 1e-3 * LR, (d.max(), d.mean())


@pytest.fixture(scope="module")
def ref():
    params = jtf.init_transformer(jax.random.PRNGKey(0), n_layers=2, d_model=128,
                                  n_heads=N_HEADS, d_ff=256, vocab=512)
    tokens = np.random.RandomState(70).randint(0, 512, (2, 64)).astype(np.int32)
    step = jax.jit(lambda p, o, t, s: jtf.transformer_train_step(
        p, o, t, s, n_heads=N_HEADS, lr=LR, weight_decay=WD))
    vg = jax.jit(jax.value_and_grad(
        lambda p, t: jtf.transformer_lm_loss(p, t, n_heads=N_HEADS)))
    out = {"params0": jax.tree.map(np.asarray, params), "tokens": tokens}
    out["loss0"], out["grads0"] = vg(params, tokens)
    p, o = params, jtf.transformer_train_init(params)
    for s in (1, 2):
        p, o, loss = step(p, o, tokens, s)
        out[s] = jax.tree.map(np.asarray, (p, o, loss))
    accum = jax.jit(lambda p, o, t: jtf.transformer_train_step(
        p, o, t, 1, n_heads=N_HEADS, lr=LR, weight_decay=WD, accum=2, clip_norm=1.0))
    out["accum"] = jax.tree.map(np.asarray, accum(params, jtf.transformer_train_init(params),
                                                  tokens))
    return out


def test_loss_and_grads(ref):
    params = params_from_numpy(ref["params0"], device="cpu")
    loss, grads = value_and_grad(lambda p, t: tf.transformer_lm_loss(p, t, n_heads=N_HEADS))(
        params, torch.from_numpy(ref["tokens"]))
    assert _err(loss, ref["loss0"]) <= 1e-5
    _assert_tree(grads, ref["grads0"], 1e-4)


def test_two_train_steps(ref):
    params = params_from_numpy(ref["params0"], device="cpu")
    opt = tf.transformer_train_init(params)
    tokens = torch.from_numpy(ref["tokens"])
    for s, mv_bound in ((1, 1e-4), (2, 1e-3)):
        params, opt, loss = tf.transformer_train_step(params, opt, tokens, s, n_heads=N_HEADS,
                                                      lr=LR, weight_decay=WD)
        jp, (jm, jv), jloss = ref[s]
        assert _err(loss, jloss) <= 1e-5
        _assert_tree(opt[0], jm, mv_bound)
        _assert_tree(opt[1], jv, mv_bound)
        _assert_adam_params(params, jp)


def test_accumulated_clipped_step(ref):
    params = params_from_numpy(ref["params0"], device="cpu")
    params, opt, loss = tf.transformer_train_step(
        params, tf.transformer_train_init(params), torch.from_numpy(ref["tokens"]), 1,
        n_heads=N_HEADS, lr=LR, weight_decay=WD, accum=2, clip_norm=1.0)
    jp, (jm, jv), jloss = ref["accum"]
    assert _err(loss, jloss) <= 1e-5
    _assert_tree(opt[0], jm, 1e-4)
    _assert_tree(opt[1], jv, 1e-4)
    _assert_adam_params(params, jp)


def test_plain_step_matches_kernel_route_on_cpu(ref):
    """plain=True is the autograd-of-forward reference; on CPU tensors the
    kernel route runs the plain versions and laser_tpu's backward rules."""
    params = params_from_numpy(ref["params0"], device="cpu")
    tokens = torch.from_numpy(ref["tokens"])
    l1, g1 = value_and_grad(lambda p, t: tf.transformer_lm_loss(p, t, n_heads=N_HEADS))(
        params, tokens)
    l2, g2 = value_and_grad(lambda p, t: tf.transformer_lm_loss(
        p, t, n_heads=N_HEADS, plain=True))(params, tokens)
    assert _err(l2, l1) <= 1e-5
    _assert_tree(g2, params_to_numpy(g1), 1e-4)


def test_window_raises(ref):
    params = params_from_numpy(ref["params0"], device="cpu")
    with pytest.raises(NotImplementedError):
        tf.transformer_train_step(params, tf.transformer_train_init(params),
                                  torch.from_numpy(ref["tokens"]), 1, n_heads=N_HEADS,
                                  window=16)


@pytest.mark.parametrize("activation", [None, "relu", "tanh", "sigmoid", "gelu"])
def test_linear_grads(activation):
    rng = np.random.RandomState(71)
    x, w, b, g = (rng.randn(*s).astype(np.float32) for s in ((13, 24), (24, 40), (40,),
                                                             (13, 40)))
    want = jax.grad(lambda x, w, b: jnp.sum(jlinear(x, w, b, activation) * g),
                    argnums=(0, 1, 2))(x, w, b)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    (linear(*ts, activation) * torch.from_numpy(g)).sum().backward()
    for t, wg in zip(ts, want):
        assert _err(t.grad, wg) <= 1e-5


def test_layer_norm_grads():
    rng = np.random.RandomState(72)
    x = (rng.randn(5, 7, 48) * 2 + 1).astype(np.float32)
    gam, bet, g = rng.randn(48).astype(np.float32), rng.randn(48).astype(np.float32), \
        rng.randn(5, 7, 48).astype(np.float32)
    want = jax.grad(lambda x, a, b: jnp.sum(jlayer_norm(x, a, b) * g),
                    argnums=(0, 1, 2))(x, gam, bet)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, gam, bet)]
    (layer_norm(*ts) * torch.from_numpy(g)).sum().backward()
    for t, wg in zip(ts, want):
        assert _err(t.grad, wg) <= 1e-5
