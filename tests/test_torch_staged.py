"""laser_tpu_torch's map_reduce_staged, mean_var, argmax and argmin (the
plain routes, on the CPU) against laser_tpu's in interpret mode, on the
same numpy inputs from a seed; and the block vocabulary of
ops/codegen.py, translated with no build.

Tolerances: mean and variance within 1e-5 relative of laser_tpu's and of
the float64 oracle (the two packages cut the data into blocks differently,
so their Welford combines round differently); arg-reductions exact, index
and value; the custom pytree body's count exact and its sum within 1e-6
of sum |x|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_tpu.ops import foreach as jfe
from laser_tpu.ops import reductions as jr
from laser_tpu_torch import registry
from laser_tpu_torch.ops import codegen
from laser_tpu_torch.ops import foreach as fe
from laser_tpu_torch.ops import reductions as R

MEAN_VAR_SHAPES = [(1000,), (37, 300)]


def _np(shape, seed, scale=3.0, shift=5.0):
    return (np.random.RandomState(seed).randn(*shape) * scale + shift).astype(np.float32)


def _arg_inputs():
    """name: numpy input with ties (f32 and int32)."""
    tie = np.zeros(10_000, np.float32)
    tie[137] = tie[9000] = 7.0
    tie[4242] = tie[8191] = -3.0
    ints = np.random.RandomState(50).randint(-20, 20, (257, 130)).astype(np.int32)
    return {"f32_ties": tie, "f32_2d": _np((257, 130), 51, 1.0, 0.0), "int32_ties": ints,
            "f32_single": np.asarray([2.5], np.float32)}


ARG_INPUTS = _arg_inputs()


def _jnp_block(ctx, b):
    pos, neg = b > 0, b < 0
    if ctx.valid is not None:
        pos, neg = pos & ctx.valid, neg & ctx.valid
    return {"npos": jnp.sum(pos.astype(jnp.float32)), "sneg": jnp.sum(jnp.where(neg, b, 0.0))}


def _torch_block(ctx, b):
    """count of positives and sum of negatives (tests/test_foreach.py:173)"""
    pos = (b > 0) & ctx.valid
    neg = (b < 0) & ctx.valid
    return {"npos": pos.float().sum(), "sneg": torch.where(neg, b, 0.0).sum()}


def _combine(a, b):
    return {"npos": a["npos"] + b["npos"], "sneg": a["sneg"] + b["sneg"]}


@pytest.fixture(scope="module")
def ref():
    """laser_tpu's results on every case, once."""
    out = {}
    for i, shape in enumerate(MEAN_VAR_SHAPES):
        x = _np(shape, 60 + i)
        out[("mean_var", shape)] = (x, [float(np.asarray(v)) for v in jr.mean_var(x)])
    for name, x in ARG_INPUTS.items():
        for f in ("argmax", "argmin"):
            i, v = getattr(jr, f)(x)
            out[(f, name)] = (int(np.asarray(i)), np.asarray(v).item())
    x = _np((10_000,), 70, 1.0, 0.0)
    acc = jfe.map_reduce_staged(_jnp_block, x, combine=_combine)
    out["custom"] = (x, {k: float(np.asarray(v)) for k, v in acc.items()})
    return out


@pytest.mark.parametrize("shape", MEAN_VAR_SHAPES)
def test_mean_var_vs_laser_tpu_and_float64(ref, shape):
    x, (jm, jv) = ref[("mean_var", shape)]
    registry.reset_counts()
    m, v = R.mean_var(torch.from_numpy(x))
    assert registry.counts()["map_reduce_staged"] == {"launches": 0, "plain_calls": 1}
    assert m.dtype == v.dtype == torch.float32 and m.dim() == v.dim() == 0
    m64, v64 = x.astype(np.float64).mean(), x.astype(np.float64).var()
    for got, want in ((m.item(), jm), (m.item(), m64), (v.item(), jv), (v.item(), v64)):
        assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("fn", ["argmax", "argmin"])
@pytest.mark.parametrize("name", sorted(ARG_INPUTS))
def test_arg_reductions_vs_laser_tpu(ref, name, fn):
    x = ARG_INPUTS[name]
    i, v = getattr(R, fn)(torch.from_numpy(x))
    ji, jv = ref[(fn, name)]
    assert i.dtype == torch.int64 and v.dtype == torch.from_numpy(x).dtype
    assert i.item() == ji == int(getattr(np, fn)(x))
    assert v.item() == jv == x.reshape(-1)[ji].item()


def test_custom_pytree_body_vs_laser_tpu(ref):
    x, want = ref["custom"]
    got = fe.map_reduce_staged(_torch_block, torch.from_numpy(x), combine=_combine)
    assert set(got) == {"npos", "sneg"}
    assert got["npos"].item() == want["npos"] == (x > 0).sum()
    assert abs(got["sneg"].item() - want["sneg"]) <= 1e-6 * np.abs(x).sum()


def test_non_scalar_leaf_raises_value_error_in_both_packages():
    x = np.ones(300, np.float32)
    with pytest.raises(ValueError, match="scalars"):
        jfe.map_reduce_staged(lambda ctx, b: {"b": b}, x, combine=lambda a, b: a)
    with pytest.raises(ValueError, match="scalars"):
        fe.map_reduce_staged(lambda ctx, b: {"b": b * 2}, torch.from_numpy(x),
                             combine=lambda a, b: a)


@pytest.mark.parametrize("body,what", [
    (lambda ctx, b: {"s": torch.sum(b, 0)}, "dim"),
    (lambda ctx, b: {"s": torch.prod(b)}, "prod"),
    (lambda ctx, b: {"s": torch.cumsum(b, 0).sum()}, "cumsum"),
    (lambda ctx, b: {"s": torch.sum(torch.sum(b))}, "block scalar"),
    (lambda ctx, b: {"s": torch.erf(b).sum()}, "erf")])
def test_op_outside_the_block_vocabulary_raises(body, what):
    before = registry.counts()["map_reduce_staged"]["plain_calls"]
    with pytest.raises(NotImplementedError, match=what):
        fe.map_reduce_staged(body, torch.ones(100), combine=lambda a, b: a)
    assert registry.counts()["map_reduce_staged"]["plain_calls"] == before


def test_reductions_stay_outside_the_elementwise_vocabulary():
    with pytest.raises(NotImplementedError, match="sum"):
        fe.for_each(lambda x: x - x.sum(), torch.ones(4))


def test_reduction_depth_and_sweeps():
    """mean_var and argmax are depth 2 (two sweeps over the registers), the
    custom body depth 1; each sweep folds every reduction of its level."""
    f32 = torch.ones(8)
    cases = [(R._mean_var_block, R._mean_var_combine, 2), (_torch_block, _combine, 1)]
    for block, comb, depth in cases:
        src = fe.map_reduce_staged_source(block, f32, combine=comb)
        assert "LTT_STAGED_ENTRY(Body)" in src and f"// sweep {depth}:" in src
        assert f"// sweep {depth + 1}:" not in src
    src = fe.map_reduce_staged_source(lambda ctx, b: {"i": torch.amin(ctx.flat_indices(b.shape)),
                                                     "o": ctx.offset + ctx.width},
                                      f32, combine=lambda a, b: a)
    assert "kStagedGrain" in src and "const int64_t v" in src


def test_plain_version_blocks_and_determinism():
    """The plain version cuts the kernel's blocks: a mean over the block
    counts its padding, ctx.offset steps by STAGED_GRAIN, and two runs
    give the same bits."""
    n = fe.STAGED_GRAIN + 5
    x = torch.ones(n)
    got = fe.map_reduce_staged(lambda ctx, b: {"m": torch.mean(b), "o": ctx.offset.float()},
                               x, combine=lambda a, b: {"m": a["m"] + b["m"],
                                                        "o": torch.maximum(a["o"], b["o"])})
    assert fe.staged_blocks(n) == 2
    assert got["m"].item() == 1.0 + 5 / fe.STAGED_GRAIN
    assert got["o"].item() == fe.STAGED_GRAIN
    y = torch.from_numpy(_np((9001,), 71))
    a, b = R.mean_var(y), R.mean_var(y)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    with pytest.raises(ValueError, match="empty"):
        R.mean_var(torch.ones(0))


def test_strided_operand_is_materialised():
    x = torch.from_numpy(_np((64, 40), 72))
    i, v = R.argmax(x[::2, 1:])
    assert i.item() == x[::2, 1:].argmax().item() and v.item() == x[::2, 1:].max().item()


def test_library_bodies_trace_once_user_bodies_every_call(monkeypatch):
    """mean_var's and argmax's bodies read nothing that changes, so their
    plan is memoised on the functions; a user's body is traced on every
    call and sees its closure's current value."""
    calls = []
    real = codegen.trace_staged
    monkeypatch.setattr(codegen, "trace_staged", lambda *a: calls.append(1) or real(*a))
    x = torch.from_numpy(_np((5000,), 73))
    R.mean_var(x)
    R.argmax(x)
    before = len(calls)
    R.mean_var(x), R.argmax(x), R.mean_var(x)
    assert len(calls) == before
    scale = [2.0]

    def block(ctx, b):
        return {"s": torch.where(ctx.valid, b * scale[0], 0.0).sum()}

    comb = lambda a, b: {"s": a["s"] + b["s"]}  # noqa: E731
    first = fe.map_reduce_staged(block, x, combine=comb)["s"].item()
    scale[0] = 4.0
    second = fe.map_reduce_staged(block, x, combine=comb)["s"].item()
    assert len(calls) == before + 2 and second == 2 * first


@pytest.mark.parametrize("n", [1, 4095, 4097, 3 * 4096 + 5])
def test_classic_and_default_routes_agree_on_the_cpu(n):
    """route="classic" and the default route run the plain version on CPU
    tensors: the same bits for mean_var, argmax, argmin and the custom
    body, on ragged tails; only the plain counter moves."""
    x = torch.from_numpy(_np((n,), 80 + n % 7))
    before = registry.counts()
    for route in ("classic", None):
        got = [R.mean_var(x, route=route), R.argmax(x, route=route), R.argmin(x, route=route),
               tuple(fe.map_reduce_staged(_torch_block, x, combine=_combine,
                                          route=route).values())]
        if route == "classic":
            want = got
        else:
            assert all(torch.equal(g, w) for gs, ws in zip(got, want) for g, w in zip(gs, ws))
    after = registry.counts()
    assert after["map_reduce_staged"]["plain_calls"] == \
        before["map_reduce_staged"]["plain_calls"] + 8
    for k in ("map_reduce_staged", "map_reduce_staged_one"):
        assert after[k]["launches"] == before[k]["launches"]


def test_unknown_route_raises_on_the_cpu():
    with pytest.raises(ValueError, match="unknown route"):
        R.mean_var(torch.ones(10), route="two")
    with pytest.raises(ValueError, match="unknown route"):
        fe.map_reduce_staged(_torch_block, torch.ones(10), combine=_combine, route="fused")


def test_mean_var_finish_in_the_kernel_source():
    """mean_var's M2 / max(n, 1) is the body's finish, emitted into the
    kernel's last store (two results from three accumulator leaves); the
    block returns its leaves and store_partial writes them (the one launch
    writes none); the library exports both routes' entries."""
    f32 = torch.ones(8)
    src = fe.map_reduce_staged_source(R._mean_var_block, f32, combine=R._mean_var_combine,
                                      finish=R._mean_var_finish)
    assert "kLeaves = 3, kOut = 2" in src and "static void finish(" in src
    assert "__fdiv_rn" in src.split("static void finish(")[1]
    assert "static Acc block(" in src and "static void store_partial(" in src
    assert "LTT_STAGED_ENTRY(Body)" in src
    plain = fe.map_reduce_staged_source(_torch_block, f32, combine=_combine)
    assert "kLeaves = 2, kOut = 2" in plain and "finish(" not in plain
    x = torch.from_numpy(_np((9001,), 74))
    acc = fe.map_reduce_staged_reference(R._mean_var_block, x, combine=R._mean_var_combine)
    m, v = R.mean_var(x)
    assert torch.equal(m, acc["mean"]) and torch.equal(v, acc["m2"] / acc["n"].clamp_min(1.0))


def test_one_launch_workspace_fits_every_plan():
    """csrc/foreach.cuh's workspace: the counter slot (kStagedAccOffset), then
    the fold's T accumulators, at most 1024 of 16 leaves of 8 bytes."""
    assert fe.STAGED_WORK_BYTES == 16 + 1024 * 8 * codegen.MAX_LEAVES
