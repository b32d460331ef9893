"""The fused AdamW and SGD-momentum updates (``backend="pallas"``) of
laser_tpu_torch against laser_tpu's Pallas kernels in interpret mode.

The port's wrappers take their plain versions here (CPU tensors): the
kernels' arithmetic, one rounding per op. Three steps on a small tree of
f32 and bf16 leaves (odd sizes, a 0-d leaf), weight decay on and off,
Nesterov on and off; the step-2 gradients of the bf16 leaves arrive in f32
and are cast to the parameter's dtype, as laser_tpu's route casts them.
SGD also over f32, bf16 and f16 leaves whose momentum arrives in another
dtype (one multi-tensor launch a dtype on the card), and the pure-Python
table builder ``sgdm_tables``: its grouping by dtype and its split past
one launch's capacity.
Tolerances: f32 within 1e-6 of each leaf's max |laser_tpu| (XLA may
contract a multiply-add into one FMA, which the port never does); bf16
within one bf16 rounding of each element (2^-7 of its size), f16 within
one f16 rounding (2^-10; the mixed-dtype test's f16 leaf). The moments
come back in the parameter's dtype on both sides.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import laser_tpu as lt
from laser_tpu_torch.convert import params_from_numpy, params_to_numpy
from laser_tpu_torch.ops import optim

F32_REL, BF16_REL, F16_REL = 1e-6, 2.0 ** -7, 2.0 ** -10
STEPS = 3


def _tree(rng, scale=1.0):
    f32 = lambda *s: np.asarray(rng.randn(*s) * scale, np.float32)  # noqa: E731
    bf = lambda *s: np.asarray(rng.randn(*s) * scale, ml_dtypes.bfloat16)  # noqa: E731
    return {"bias": f32(37), "w": f32(3, 5, 7), "scalar": f32(),
            "bf": {"bias": bf(37), "w": bf(3, 5, 7)}}


def _grads(rng, step):
    g = _tree(rng)
    if step == 2:  # f32 gradients of bf16 parameters: cast first, as laser_tpu
        g["bf"] = {k: v.astype(np.float32) for k, v in g["bf"].items()}
    return g


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _check(mine, ref):
    for a, b in zip(_leaves(params_to_numpy(mine)), _leaves(ref), strict=True):
        b_np = np.asarray(b)
        a64, b64 = np.asarray(a, np.float64), b_np.astype(np.float64)
        assert a64.shape == b64.shape
        if b_np.dtype == ml_dtypes.bfloat16:
            assert np.all(np.abs(a64 - b64) <= BF16_REL * np.abs(b64))
        elif b_np.dtype == np.float16:
            assert np.all(np.abs(a64 - b64) <= F16_REL * np.abs(b64))
        else:
            assert np.abs(a64 - b64).max() <= F32_REL * max(np.abs(b64).max(), 1e-30)


def _dtypes(tree):
    return [str(t.dtype) for t in _leaves(tree)]


@pytest.fixture(scope="module")
def adamw_runs():
    """laser_tpu's Pallas AdamW, three steps, per weight decay: the inputs
    and the (p, m, v) after each step."""
    runs = {}
    for wd in (0.0, 0.1):
        rng = np.random.RandomState(90)
        params = _tree(rng)
        grads = [_grads(rng, s) for s in range(1, STEPS + 1)]
        p, (m, v) = params, lt.adamw_init(params)
        states = []
        for step, g in enumerate(grads, 1):
            p, m, v = lt.adamw_step(p, g, m, v, step, lr=1e-2, weight_decay=wd,
                                    backend="pallas")
            states.append(jax.tree_util.tree_map(np.asarray, (p, m, v)))
        runs[wd] = (params, grads, states)
    return runs


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_pallas_three_steps_vs_laser_tpu(adamw_runs, wd):
    params, grads, states = adamw_runs[wd]
    tp = params_from_numpy(params, device="cpu")
    tm, tv = optim.adamw_init(tp)
    for step, (g, want) in enumerate(zip(grads, states, strict=True), 1):
        tp, tm, tv = optim.adamw_step(tp, params_from_numpy(g, device="cpu"), tm, tv, step,
                                      lr=1e-2, weight_decay=wd, backend="pallas")
        for mine, ref in zip((tp, tm, tv), want, strict=True):
            _check(mine, ref)
            assert _dtypes(params_to_numpy(mine)) == _dtypes(params_to_numpy(tp))


@pytest.fixture(scope="module")
def sgd_runs():
    runs = {}
    for nesterov in (False, True):
        rng = np.random.RandomState(91)
        params = _tree(rng)
        grads = [_grads(rng, s) for s in range(1, STEPS + 1)]
        p, m = params, jax.tree_util.tree_map(np.zeros_like, params)
        states = []
        for g in grads:
            p, m = lt.sgd_momentum_step(p, g, m, lr=0.05, mu=0.9, nesterov=nesterov,
                                        backend="pallas")
            states.append(jax.tree_util.tree_map(np.asarray, (p, m)))
        runs[nesterov] = (params, grads, states)
    return runs


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_momentum_pallas_three_steps_vs_laser_tpu(sgd_runs, nesterov):
    params, grads, states = sgd_runs[nesterov]
    tp = params_from_numpy(params, device="cpu")
    tm = optim.tree_map(torch.zeros_like, tp)
    for g, want in zip(grads, states, strict=True):
        tp, tm = optim.sgd_momentum_step(tp, params_from_numpy(g, device="cpu"), tm, lr=0.05,
                                         mu=0.9, nesterov=nesterov, backend="pallas")
        for mine, ref in zip((tp, tm), want, strict=True):
            _check(mine, ref)


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_momentum_default_backend_vs_laser_tpu(nesterov):
    """The default backend is laser_tpu's XLA expression; the momentum keeps
    its own dtype."""
    rng = np.random.RandomState(92)
    params, g = _tree(rng), _tree(rng)
    m = jax.tree_util.tree_map(lambda x: np.ones_like(x, np.float32), params)
    want = lt.sgd_momentum_step(params, g, m, lr=0.05, mu=0.9, nesterov=nesterov)
    tp = params_from_numpy(params, device="cpu")
    got = optim.sgd_momentum_step(tp, params_from_numpy(g, device="cpu"),
                                  params_from_numpy(m, device="cpu"), lr=0.05, mu=0.9,
                                  nesterov=nesterov)
    assert got[0] is tp
    for mine, ref in zip(got, want, strict=True):
        _check(mine, ref)
    assert all(t.dtype == torch.float32 for t in optim.tree_leaves(got[1]))


def test_in_place_and_moments_in_the_parameter_dtype():
    """p, m, v change in place; f32 moments of a bf16 parameter come back as
    new bf16 tensors, as laser_tpu's Pallas route returns them."""
    p = {"a": torch.randn(9), "b": torch.randn(4, 3).bfloat16()}
    g = {"a": torch.randn(9), "b": torch.randn(4, 3)}
    m = {"a": torch.zeros(9), "b": torch.zeros(4, 3)}
    v = {"a": torch.zeros(9), "b": torch.zeros(4, 3)}
    a_before = p["a"].clone()
    p2, m2, v2 = optim.adamw_step(p, g, m, v, 1, lr=0.1, backend="pallas")
    assert p2 is p and not torch.equal(p["a"], a_before)
    assert m2["a"] is m["a"] and v2["a"] is v["a"]
    assert m2["b"].dtype == v2["b"].dtype == torch.bfloat16
    assert torch.count_nonzero(m["b"]) == 0  # the f32 original is not the result


def test_lr_tensor_and_step_tensor_match_floats():
    """A schedule's 0-d lr and a tensor step give the same bits as floats."""
    torch.manual_seed(93)
    p0, g = torch.randn(50), torch.randn(50)
    outs = []
    for lr, step in ((0.01, 2), (torch.tensor(0.01), torch.tensor(2))):
        p, m, v = p0.clone(), torch.full((50,), 0.1), torch.full((50,), 0.2)
        optim.adamw_step({"p": p}, {"p": g}, {"p": m}, {"p": v}, step, lr=lr, backend="pallas")
        outs.append((p, m, v))
    for a, b in zip(*outs, strict=True):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def sgd_mixed_runs():
    """laser_tpu's Pallas SGD, two steps, over f32, bf16 and f16 leaves whose
    momentum arrives in another dtype: laser_tpu's kernel takes m in p's
    dtype, so it gets m cast first (the values are exact in both dtypes);
    plain and Nesterov."""
    runs = {}
    for nesterov in (False, True):
        rng = np.random.RandomState(94)
        params = {"a": np.asarray(rng.randn(37), np.float32),
                  "b": np.asarray(rng.randn(3, 5, 7), ml_dtypes.bfloat16),
                  "c": np.asarray(rng.randn(130), np.float16),
                  "d": np.asarray(rng.randn(2, 9), ml_dtypes.bfloat16)}
        m0 = {"a": np.asarray(rng.randn(37), ml_dtypes.bfloat16),
              "b": np.asarray(rng.randn(3, 5, 7), ml_dtypes.bfloat16).astype(np.float32),
              "c": np.asarray(rng.randn(130), np.float16).astype(np.float32),
              "d": np.asarray(rng.randn(2, 9), ml_dtypes.bfloat16)}
        grads = [_tree_like(params, rng) for _ in range(2)]
        p = params
        m = {k: v.astype(params[k].dtype) for k, v in m0.items()}
        states = []
        for g in grads:
            p, m = lt.sgd_momentum_step(p, g, m, lr=0.05, mu=0.9, nesterov=nesterov,
                                        backend="pallas")
            states.append(jax.tree_util.tree_map(np.asarray, (p, m)))
        runs[nesterov] = (params, m0, grads, states)
    return runs


def _tree_like(params, rng):
    return {k: np.asarray(rng.randn(*v.shape), np.float32) for k, v in params.items()}


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_momentum_pallas_mixed_dtypes_vs_laser_tpu(sgd_mixed_runs, nesterov):
    """Three dtype groups (three launches on the card) and momentum leaves
    of other dtypes: each step matches laser_tpu, the momentum comes back in
    the parameter's dtype, and a momentum leaf already in it is updated in
    place."""
    params, m0, grads, states = sgd_mixed_runs[nesterov]
    tp = params_from_numpy(params, device="cpu")
    tm = params_from_numpy(m0, device="cpu")
    d_in = tm["d"]
    for g, want in zip(grads, states, strict=True):
        tp, tm = optim.sgd_momentum_step(tp, params_from_numpy(g, device="cpu"), tm, lr=0.05,
                                         mu=0.9, nesterov=nesterov, backend="pallas")
        for mine, ref in zip((tp, tm), want, strict=True):
            _check(mine, ref)
        assert _dtypes(params_to_numpy(tm)) == _dtypes(params_to_numpy(tp))
    assert tm["d"] is d_in


class _Leaf:
    """A stand-in for a tensor: the table builder reads dtype and numel."""

    def __init__(self, dtype, n):
        self.dtype, self.n = dtype, n

    def numel(self):
        return self.n


@pytest.mark.parametrize("capacity", [1, 3, optim.SGDM_TABLE_LEAVES])
def test_sgdm_tables_group_and_split(capacity):
    """Every non-empty leaf in exactly one table (so every element in one
    launch), one dtype a table, at most ``capacity`` leaves a table, the
    tree's order kept within a dtype, empty leaves in none."""
    dts = [torch.bfloat16, torch.float32, torch.bfloat16, torch.float16, torch.bfloat16,
           torch.float32, torch.bfloat16, torch.bfloat16, torch.float16]
    sizes = [5, 0, 2048, 1, 0, 7, 3, 1000003, 8]
    leaves = [(_Leaf(dt, n), object(), object()) for dt, n in zip(dts, sizes, strict=True)]
    tables = optim.sgdm_tables(leaves, capacity)
    seen = [leaf for _, table in tables for leaf in table]
    assert sorted(map(id, seen)) == sorted(id(x) for x in leaves if x[0].numel())
    assert sum(x[0].numel() for x in seen) == sum(sizes)
    for dt, table in tables:
        assert 1 <= len(table) <= capacity and all(x[0].dtype == dt for x in table)
    for dt in set(dts):
        group = [x for x in leaves if x[0].dtype == dt and x[0].numel()]
        assert [x for d, t in tables if d == dt for x in t] == group
        assert sum(d == dt for d, _ in tables) == -(-len(group) // capacity)


def test_sgdm_tables_past_one_launch():
    """A tree of more leaves than one table holds takes a few launches."""
    leaves = [(_Leaf(torch.float32, 1), None, None)] * (2 * optim.SGDM_TABLE_LEAVES + 1)
    assert [len(t) for _, t in optim.sgdm_tables(leaves)] == [optim.SGDM_TABLE_LEAVES] * 2 + [1]
    assert optim.sgdm_tables([(_Leaf(torch.float32, 0), None, None)]) == []


def test_sgd_classic_route_and_unknown_route():
    """route="classic" (the per-leaf kernel on the card) runs the same plain
    version on the CPU; an unknown route raises."""
    torch.manual_seed(95)
    p0, g = torch.randn(41), torch.randn(41)
    outs = []
    for route in (None, "classic"):
        p, m = {"w": p0.clone()}, {"w": torch.full((41,), 0.5)}
        optim.sgd_momentum_step(p, {"w": g}, m, lr=0.05, nesterov=True, backend="pallas",
                                route=route)
        outs.append((p["w"], m["w"]))
    for a, b in zip(*outs, strict=True):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="route"):
        optim.sgd_momentum_step(p, {"w": g}, m, lr=0.05, backend="pallas", route="fused")


def test_unknown_backend_raises():
    p = {"w": torch.ones(3)}
    m, v = optim.adamw_init(p)
    with pytest.raises(ValueError, match="backend"):
        optim.adamw_step(p, p, m, v, 1, lr=0.1, backend="triton")
    with pytest.raises(ValueError, match="backend"):
        optim.sgd_momentum_step(p, p, m, lr=0.1, backend="mosaic")
