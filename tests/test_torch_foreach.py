"""laser_tpu_torch's for_each / for_each_multi / row_reduce / map_reduce
(their plain routes, on the CPU) against laser_tpu's kernels in interpret
mode, on the same numpy inputs from a seed; and ops/codegen.py's
translation of bodies, with no build.

Tolerances: f32 1e-6 relative and absolute (the two sides' libm may differ
by an ulp in sin/cos/exp); bf16 one bf16 rounding, 2^-7 relative, as both
sides round after every op; integers and min/max exact; sums 1e-6 of
sum |x| (order only).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from laser_tpu.ops import foreach as jfe
from laser_tpu_torch import registry
from laser_tpu_torch.ops import codegen
from laser_tpu_torch.ops import foreach as fe

SHAPES = [(37, 300), (1000,), (3, 5, 7), (64, 128)]
DTYPES = {"f32": (np.float32, torch.float32), "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}
# one body per vocabulary group: (torch body, jnp body)
BODIES = {
    "arith": (lambda x, y: (x + y) * x - y / (x.abs() + 1.0) ** 2,
              lambda x, y: (x + y) * x - y / (jnp.abs(x) + 1.0) ** 2),
    "bench": (lambda x, y: x + y - torch.sin(y),
              lambda x, y: x + y - jnp.sin(y)),
    "transcendental": (lambda x, y: torch.cos(x) * torch.exp(-x.abs()) + torch.sqrt(y.abs()),
                       lambda x, y: jnp.cos(x) * jnp.exp(-jnp.abs(x)) + jnp.sqrt(jnp.abs(y))),
    "select": (lambda x, y: torch.where(x > y, torch.maximum(x, y), torch.relu(-y)),
               lambda x, y: jnp.where(x > y, jnp.maximum(x, y), jnp.maximum(-y, 0))),
}


def _np(shape, seed, dt=np.float32):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32).astype(dt)


def _t(a):
    """numpy (f32 or bfloat16) -> torch, exactly."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.ascontiguousarray(a))


def _f(x):
    return np.asarray(x).astype(np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _close(got, want, tag):
    if tag == "bf16":
        scale = np.abs(want).max() if want.size else 1.0
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -8 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


CASES = [(s, d, b) for s in SHAPES for d in DTYPES for b in BODIES]


@pytest.fixture(scope="module")
def ref():
    """laser_tpu's for_each on every case, once."""
    out = {}
    for i, (shape, tag, body) in enumerate(CASES):
        x, y = _np(shape, 2 * i, DTYPES[tag][0]), _np(shape, 2 * i + 1, DTYPES[tag][0])
        out[(shape, tag, body)] = (x, y, _f(jfe.for_each(BODIES[body][1], x, y)))
    return out


@pytest.mark.parametrize("shape,tag,body", CASES)
def test_for_each_vs_laser_tpu(ref, shape, tag, body):
    x, y, want = ref[(shape, tag, body)]
    registry.reset_counts()
    got = fe.for_each(BODIES[body][0], _t(x), _t(y))
    assert registry.counts()["for_each"] == {"launches": 0, "plain_calls": 1}
    assert got.dtype == DTYPES[tag][1] and tuple(got.shape) == shape
    _close(_f(got), want, tag)


def test_for_each_donate_writes_operand_0():
    x, y = _np((37, 300), 50), _np((37, 300), 51)
    want = _f(jfe.for_each(lambda a, b: a * 2 - b, x, y, donate=True))
    xt = _t(x.copy())
    out = fe.for_each(lambda a, b: a * 2 - b, xt, _t(y), donate=True)
    assert out.data_ptr() == xt.data_ptr()
    np.testing.assert_array_equal(xt.numpy(), want)
    # dtypes differ: donate changes nothing
    xi = torch.arange(6, dtype=torch.int32)
    before = xi.clone()
    out = fe.for_each(lambda a: a * 0.5, xi, out_dtype=torch.float32, donate=True)
    assert out.dtype == torch.float32
    assert torch.equal(xi, before)


@pytest.mark.parametrize("dts", [("int32", "float32"), ("bfloat16", "float16"),
                                 ("int8", "int8"), ("bool", "int32"), ("int32", "int32")])
def test_out_dtype_promotion_as_jnp_result_type(dts):
    rs = np.random.RandomState(52)
    arrs = []
    for d in dts:
        a = rs.randn(5, 7) * 4
        arrs.append((a > 0) if d == "bool" else a.astype(np.float32).astype(
            ml_dtypes.bfloat16 if d == "bfloat16" else np.dtype(d)))
    want = jfe.for_each(lambda a, b: a * 3 + b, *arrs)
    ts = [torch.from_numpy(a.astype(np.float32)).bfloat16() if a.dtype == ml_dtypes.bfloat16
          else torch.from_numpy(a) for a in arrs]
    got = fe.for_each(lambda a, b: a * 3 + b, *ts)
    assert str(got.dtype).split(".")[-1] == str(jnp.dtype(want.dtype))
    if dts[0] != "bfloat16":
        np.testing.assert_array_equal(_f(got), _f(want))
        return
    # bf16 * 3 + f16: the port rounds a * 3 to bf16 as eager jnp and torch
    # do; laser_tpu's kernel, under XLA's excess precision on the CPU, keeps
    # it in f32 (ROADMAP queue 3): one bf16 rounding of the largest value
    eager = np.asarray(jnp.asarray(arrs[0]) * 3 + jnp.asarray(arrs[1]))
    np.testing.assert_array_equal(_f(got), eager)
    _close(_f(got), _f(want), "bf16")


def test_for_each_multi_vs_laser_tpu():
    x, y = _np((37, 300), 53), _np((37, 300), 54)
    want = jfe.for_each_multi(lambda a, b: (a + b, a - b, a > b), x, y)
    registry.reset_counts()
    got = fe.for_each_multi(lambda a, b: (a + b, a - b, a > b), _t(x), _t(y))
    assert registry.counts()["for_each_multi"]["plain_calls"] == 1
    assert [g.dtype for g in got] == [torch.float32, torch.float32, torch.bool]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


RR_CASES = [("sum", jnp.sum, torch.sum, 0.0), ("min", jnp.min, torch.amin, np.inf),
            ("max", jnp.max, torch.amax, -np.inf)]


@pytest.mark.parametrize("name,jred,tred,ident", RR_CASES)
def test_row_reduce_tail_and_mapped_identity(name, jred, tred, ident):
    """300 columns (a tail past laser_tpu's 128-lane blocks) and exp(x) - 1,
    whose value at 0 is not the identity of max: laser_tpu masks the mapped
    tail, so both sides reduce real elements only."""
    x = _np((37, 300), 55)
    y = _np((37, 300), 56)
    jfn = lambda a, b: jnp.exp(a) * b - 1.0  # noqa: E731
    tfn = lambda a, b: torch.exp(a) * b - 1.0  # noqa: E731
    want = np.asarray(jfe.row_reduce(jfn, x, y, reduce_fn=jred, identity=ident))
    registry.reset_counts()
    got = fe.row_reduce(tfn, _t(x), _t(y), reduce_fn=tred, identity=ident).numpy()
    assert registry.counts()["row_reduce"]["plain_calls"] == 1
    if name == "sum":
        bound = 1e-6 * np.abs(np.exp(x.astype(np.float64)) * y - 1).sum(-1) + 1e-6
        assert (np.abs(got - want) <= bound).all()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_row_reduce_int32_exact():
    x = np.random.RandomState(57).randint(-100, 100, (9, 130)).astype(np.int32)
    for jred, tred in ((jnp.sum, torch.sum), (jnp.max, torch.amax)):
        want = np.asarray(jfe.row_reduce(lambda a: a * 3, x, reduce_fn=jred,
                                         identity=0 if jred is jnp.sum else -2 ** 31))
        got = fe.row_reduce(lambda a: a * 3, torch.from_numpy(x), reduce_fn=tred,
                            identity=0 if tred is torch.sum else -2 ** 31)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


# map_reduce where map(identity) == identity or the size is aligned (4096
# elements: laser_tpu pads nothing), so laser_tpu's padding maps to nothing
MR_CASES = [
    ("sum", (37, 300), lambda a: a * a, lambda a: a * a, jnp.sum, torch.sum, 0.0),
    ("sum_exp_aligned", (32, 128), jnp.exp, torch.exp, jnp.sum, torch.sum, 0.0),
    ("min", (1000,), lambda a: a * 2, lambda a: a * 2, jnp.min, torch.amin, np.inf),
    ("max", (3, 5, 7), lambda a: a * 2, lambda a: a * 2, jnp.max, torch.amax, -np.inf),
]


@pytest.fixture(scope="module")
def mr_ref():
    return {c[0]: (_np(c[1], 60 + i), np.asarray(jfe.map_reduce(
        c[2], _np(c[1], 60 + i), reduce_fn=c[4], identity=c[6])))
        for i, c in enumerate(MR_CASES)}


@pytest.mark.parametrize("case", MR_CASES, ids=[c[0] for c in MR_CASES])
def test_map_reduce_vs_laser_tpu(mr_ref, case):
    name, _, _, tfn, _, tred, ident = case
    x, want = mr_ref[name]
    registry.reset_counts()
    got = fe.map_reduce(tfn, _t(x), reduce_fn=tred, identity=ident)
    assert registry.counts()["map_reduce"]["plain_calls"] == 1
    assert got.shape == () and got.dtype == torch.float32
    if tred is torch.sum:
        mapped = np.asarray(jnp.exp(x) if "exp" in name else x.astype(np.float64) ** 2)
        assert abs(got.item() - want) <= 1e-6 * np.abs(mapped).sum()
    else:
        assert got.item() == want


def test_map_reduce_acc_dtype_and_int32():
    x = _np((37, 300), 70, ml_dtypes.bfloat16)
    want = np.asarray(jfe.map_reduce(lambda a: a, x, acc_dtype=jnp.float32))
    got = fe.map_reduce(lambda a: a, _t(x), acc_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert abs(got.item() - want) <= 1e-6 * np.abs(x.astype(np.float64)).sum()
    xi = np.random.RandomState(71).randint(-1000, 1000, (1000,)).astype(np.int32)
    for jred, tred, ident in ((jnp.sum, torch.sum, 0), (jnp.min, torch.amin, 2 ** 31 - 1),
                              (jnp.max, torch.amax, -2 ** 31)):
        w = np.asarray(jfe.map_reduce(lambda a: a * 3, xi, reduce_fn=jred, identity=ident))
        g = fe.map_reduce(lambda a: a * 3, torch.from_numpy(xi), reduce_fn=tred,
                          identity=ident)
        assert g.dtype == torch.int32 and g.item() == w


def test_map_reduce_custom_combine_fn():
    """A combine_fn outside {sum, min, max}: laser_tpu hands it its
    (blocks, 8, width) partials, the port its per-block partials; a max of
    partial maxima equals the max either way, and 2 * sum of partial sums
    twice the sum."""
    x = _np((37, 300), 72)
    want = np.asarray(jfe.map_reduce(lambda a: a * a, x, combine_fn=lambda p: 2 * jnp.sum(p)))
    registry.reset_counts()
    got = fe.map_reduce(lambda a: a * a, _t(x), combine_fn=lambda p: 2 * p.sum())
    assert registry.counts()["map_reduce"]["plain_calls"] == 1
    assert abs(got.item() - want) <= 2e-6 * (x.astype(np.float64) ** 2).sum()
    wmax = np.asarray(jfe.map_reduce(lambda a: a, x, reduce_fn=jnp.max, identity=-np.inf,
                                     combine_fn=lambda p: jnp.max(p) + 1))
    gmax = fe.map_reduce(lambda a: a, _t(x), reduce_fn=torch.amax, identity=-np.inf,
                         combine_fn=lambda p: p.max() + 1)
    assert gmax.item() == wmax


def test_map_reduce_padding_vs_laser_tpu():
    """ROADMAP queue 3: laser_tpu's map_reduce pads the flattened operand
    with ``identity`` and maps the padding, so exp summed over 1000 values
    gains n_pad * exp(0): 4096 - 1000 = 3096 padded ones (a 32 x 128
    block). The port maps real elements only and equals the float64
    oracle."""
    x = np.random.RandomState(0).randn(1000).astype(np.float32)
    oracle = np.exp(x.astype(np.float64)).sum()
    j = float(np.asarray(jfe.map_reduce(jnp.exp, x, identity=0.0)))
    n_pad = 32 * 128 - x.size
    assert n_pad == 3096
    assert abs(j - (oracle + n_pad * 1.0)) <= 1e-6 * (oracle + n_pad)
    got = fe.map_reduce(torch.exp, torch.from_numpy(x), identity=0.0).item()
    assert abs(got - oracle) <= 1e-6 * oracle


def test_reduce_fn_outside_the_vocabulary_raises():
    x = torch.ones(4, 4)
    for call in (lambda: fe.row_reduce(lambda a: a, x, reduce_fn=torch.prod),
                 lambda: fe.map_reduce(lambda a: a, x, reduce_fn=torch.mean)):
        with pytest.raises(NotImplementedError, match="reduction vocabulary"):
            call()
    # a strided operand and map_reduce_staged run now; an op outside their
    # vocabularies still raises
    with pytest.raises(NotImplementedError, match="cumsum"):
        fe.for_each(lambda a: torch.cumsum(a, 0), torch.ones(4, 6)[:, ::2])
    with pytest.raises(NotImplementedError, match="prod"):
        fe.map_reduce_staged(lambda ctx, b: {"p": torch.prod(b)}, x, combine=lambda a, b: a)
    with pytest.raises(ValueError, match="shape mismatch"):
        fe.for_each(lambda a, b: a + b, torch.ones(3), torch.ones(4))


def test_for_each_staged_is_map_reduce():
    x = torch.from_numpy(_np((5, 9), 73))
    assert fe.for_each_staged(x, in_loop=lambda a: a * a).item() == \
        fe.map_reduce(lambda a: a * a, x).item()


# ---------------------------------------------------------------------------
# codegen: translation alone
# ---------------------------------------------------------------------------

VOCAB = {
    "add": lambda x, y: x + y, "sub": lambda x, y: x - y, "mul": lambda x, y: x * y,
    "div": lambda x, y: x / y, "pow": lambda x, y: x ** y, "pow2": lambda x, y: x ** 2,
    "rpow": lambda x, y: 2.0 ** x,
    "maximum": lambda x, y: torch.maximum(x, y), "minimum": lambda x, y: torch.minimum(x, y),
    "neg": lambda x, y: -x, "abs": lambda x, y: torch.abs(x), "relu": lambda x, y: x.relu(),
    "sin": lambda x, y: torch.sin(x), "cos": lambda x, y: x.cos(),
    "exp": lambda x, y: torch.exp(x), "log": lambda x, y: torch.log(x),
    "tanh": lambda x, y: torch.tanh(x), "sigmoid": lambda x, y: torch.sigmoid(x),
    "sqrt": lambda x, y: torch.sqrt(x), "rsqrt": lambda x, y: torch.rsqrt(x),
    "where": lambda x, y: torch.where(x < y, x, 0.5),
    "compare": lambda x, y: (x == y) | (x != y) & (x <= y) ^ (x >= y),
    "not": lambda x, y: ~(x > y), "isnan": lambda x, y: torch.isnan(x) | torch.isinf(y),
    "clamp": lambda x, y: x.clamp(-1, 1) + torch.clamp_min(y, 0),
    "cast": lambda x, y: x.to(torch.bfloat16).float() + y.int(),
    "floor": lambda x, y: torch.floor(x) + torch.ceil(y) + torch.round(x) + torch.trunc(y),
    "const": lambda x, y: x * 3 + 0.25,
}


@pytest.mark.parametrize("op", sorted(VOCAB))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_vocabulary_op_emits_source(op, dtype):
    fn = VOCAB[op]
    x = torch.tensor([0.5, -2.0, 3.0], dtype=dtype)
    y = torch.tensor([1.5, -2.0, 0.25], dtype=dtype)
    src = fe.for_each_source(fn, x, y)
    assert "LTT_FOR_EACH_ENTRY(Body)" in src and "elem(" in src
    # the plain route evaluates the same body
    want = fn(x, y)
    torch.testing.assert_close(fe.for_each(fn, x, y), want.to(fe.result_type([dtype, dtype])),
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("fn,what", [
    (lambda x: torch.erf(x), "erf"), (lambda x: x // 2, "floordiv"),
    (lambda x: x % 2, "mod"), (lambda x: torch.cumsum(x, 0), "cumsum"),
    (lambda x: x.sum(), "sum"), (lambda x: x @ x, "matmul")])
def test_op_outside_the_vocabulary_raises_on_the_cpu(fn, what):
    before = registry.counts()["for_each"]["plain_calls"]
    with pytest.raises(NotImplementedError, match=what):
        fe.for_each(fn, torch.ones(4))
    assert registry.counts()["for_each"]["plain_calls"] == before


def test_bf16_body_rounds_per_node():
    """Each node of a bf16 body is rounded to bf16, as eager PyTorch rounds
    after every op: x * 3 + 1 is two roundings, not one f32 FMA."""
    t = codegen.trace(lambda x: x * 3.0 + 1.0, [torch.bfloat16])
    src = codegen.emit_for_each(t, [torch.bfloat16])
    assert src.count("ltt::round_through<__nv_bfloat16>(__f") == 2
    assert "__fmul_rn" in src and "__fadd_rn" in src
    f32 = codegen.emit_for_each(codegen.trace(lambda x: x * 3.0 + 1.0, [torch.float32]),
                                [torch.float32])
    assert "round_through" not in f32
    # the plain route agrees: (x * 3) rounded, then + 1 rounded
    x = torch.tensor([1.0 + 2 ** -7], dtype=torch.bfloat16)
    assert fe.for_each(lambda v: v * 3.0 + 1.0, x).item() == ((x * 3.0) + 1.0).item()


def test_reduce_source_kinds():
    x = torch.ones(4, 8)
    assert "LTT_ROW_REDUCE_ENTRY" in fe.row_reduce_source(torch.exp, x)
    src = fe.map_reduce_source(lambda a: a, x.int(), reduce_fn=torch.amin, identity=2 ** 31 - 1)
    assert "LTT_MAP_REDUCE_ENTRY" in src and "using acc_t = int32_t" in src
    assert "kOp = 1" in src


def test_body_constants_are_read_on_every_call():
    """A body is traced on every call, so a scalar it reads from its closure
    is this call's value (on the card too, see tests/test_torch_cuda.py);
    the plan is memoised on the trace, and holds no reference to the body."""
    import gc
    import weakref

    x = torch.from_numpy(_np((4, 9), 74))
    scale = 2.0
    body = lambda t: t * scale  # noqa: E731
    first = fe.for_each_source(body, x)
    assert torch.equal(fe.for_each(body, x), x * 2.0)
    scale = 3.0
    second = fe.for_each_source(body, x)
    assert second != first and float.hex(3.0) in second
    assert torch.equal(fe.for_each(body, x), x * 3.0)
    assert fe.map_reduce_source(body, x) != fe.map_reduce_source(lambda t: t * 2.0, x)
    # another body that traces the same shares the plan
    assert fe.for_each_source(lambda t: t * 3.0, x) is second
    # 0.0 and -0.0, 1 and 1.0 are different constants
    assert fe.for_each_source(lambda t: t + 0.0, x) != fe.for_each_source(lambda t: t + -0.0, x)
    ref = weakref.ref(body)
    fe.row_reduce(body, x)
    del body
    gc.collect()
    assert ref() is None
