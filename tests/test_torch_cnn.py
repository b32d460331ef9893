"""The port's CNN and MLP against laser_tpu's, on laser_tpu-made params.

CNN: three convs (3->8->16->16) on 16x16 images, batch 2, head 32 -> 10,
f32. On the CPU laser_tpu's three convs reach its three conv kernels in
interpret mode (planewise, the patch kernel, the per-tap kernel at 4x4) and
its softmax the row-resident kernel; the port runs its plain versions.
Logits and probabilities within 1e-4 of max |laser_tpu| (three convs and
two products in another summation order), argmax identical.

MLP: dims [32, 64, 10], batch 8, f32: ``mlp_predict``, then two
``sgd_step``s (lr 0.1) through the port's ``linear`` backward against
laser_tpu's custom VJPs: the losses and every parameter within 1e-5 of max
|laser_tpu| of the same leaf.
"""

import jax
import numpy as np
import pytest
import torch

from laser_tpu.models import cnn as jcnn
from laser_tpu.models import mlp as jmlp
from laser_tpu_torch import registry
from laser_tpu_torch.convert import params_from_numpy, params_to_numpy
from laser_tpu_torch.models import cnn, mlp

CNN_CFG = dict(in_channels=3, conv_channels=(8, 16, 16), hidden=32, num_classes=10,
               image_hw=16)
MLP_DIMS = [32, 64, 10]
LR = 0.1


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def cnn_ref():
    params = _np_tree(jcnn.init_cnn(jax.random.PRNGKey(0), **CNN_CFG))
    x = np.random.RandomState(0).randn(2, 3, 16, 16).astype(np.float32)
    return params, x, np.asarray(jcnn.cnn_forward(params, x)), \
        np.asarray(jcnn.cnn_predict(params, x))


@pytest.fixture(scope="module")
def mlp_ref():
    params = _np_tree(jmlp.init_mlp(jax.random.PRNGKey(1), MLP_DIMS))
    rs = np.random.RandomState(1)
    x = rs.randn(8, MLP_DIMS[0]).astype(np.float32)
    y = rs.randint(0, MLP_DIMS[-1], size=8).astype(np.int32)
    probs = np.asarray(jmlp.mlp_predict(params, x))
    steps, p = [], params
    for _ in range(2):
        p, loss = jmlp.sgd_step(p, x, y, LR)
        steps.append((_np_tree(p), float(loss)))
    return params, x, y, probs, steps


@pytest.mark.parametrize("plain", [False, True])
def test_cnn_forward_and_predict_match_laser_tpu(cnn_ref, plain):
    params, x, logits, probs = cnn_ref
    p = params_from_numpy(params, device="cpu")
    xt = torch.from_numpy(x)
    got = cnn.cnn_forward(p, xt, plain=plain).numpy()
    assert _err(got, logits) <= 1e-4
    assert (got.argmax(-1) == logits.argmax(-1)).all()
    assert _err(cnn.cnn_predict(p, xt, plain=plain).numpy(), probs) <= 1e-4


def test_cnn_routes_through_each_kernel(cnn_ref):
    params, x, _, _ = cnn_ref
    registry.reset_counts()
    cnn.cnn_predict(params_from_numpy(params, device="cpu"), torch.from_numpy(x))
    c = registry.counts()
    assert (c["conv_planewise"]["plain_calls"], c["conv_direct"]["plain_calls"],
            c["gemm"]["plain_calls"], c["softmax"]["plain_calls"]) == (1, 2, 2, 1)


def test_init_cnn_shapes_match_laser_tpu(cnn_ref):
    params = cnn.init_cnn(0, device="cpu", **CNN_CFG)
    want = cnn_ref[0]
    assert [{k: tuple(v.shape) for k, v in layer.items()} for layer in params] == \
        [{k: v.shape for k, v in layer.items()} for layer in want]
    assert all(float(layer["b"].abs().max()) == 0 for layer in params)


def test_mean_pool2x2():
    x = torch.arange(2 * 3 * 4 * 6, dtype=torch.float32).reshape(2, 3, 4, 6)
    np.testing.assert_array_equal(cnn.mean_pool2x2(x).numpy(),
                                  np.asarray(jcnn.mean_pool2x2(x.numpy())))


def test_mlp_predict_matches_laser_tpu(mlp_ref):
    params, x, _, probs, _ = mlp_ref
    got = mlp.mlp_predict(params_from_numpy(params, device="cpu"), torch.from_numpy(x))
    assert _err(got.numpy(), probs) <= 1e-5


def test_two_sgd_steps_match_laser_tpu(mlp_ref):
    params, x, y, _, steps = mlp_ref
    p = params_from_numpy(params, device="cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for want_params, want_loss in steps:
        p, loss = mlp.sgd_step(p, xt, yt, LR)
        assert abs(loss.item() - want_loss) <= 1e-5 * abs(want_loss)
        got = params_to_numpy(p)
        for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want_params),
                        strict=True):
            assert _err(g, w) <= 1e-5


def test_mlp_loss_matches_laser_tpu(mlp_ref):
    params, x, y, _, _ = mlp_ref
    want = float(jmlp.loss_fn(params, x, y))
    got = mlp.loss_fn(params_from_numpy(params, device="cpu"), torch.from_numpy(x),
                      torch.from_numpy(y)).item()
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("which", ["cnn", "mlp"])
def test_params_round_trip_through_convert(cnn_ref, mlp_ref, which):
    tree = cnn_ref[0] if which == "cnn" else mlp_ref[0]
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    assert isinstance(back, list) and [sorted(d) for d in back] == [sorted(d) for d in tree]
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree),
                    strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
