"""laser_tpu_torch's TensorView and for_each over strided views (the plain
routes, on the CPU) against laser_tpu's in interpret mode, on the same
numpy buffers from a seed: windows with offsets, every k-th row or column,
a negative stride on each axis, 1-D strided views, strided and contiguous
operands mixed (laser_tpu's tests/test_foreach.py:23-130), and torch's own
``x[1::2]`` and ``x.t()``.

Tolerances: bit for bit for bodies of + - x (both sides round each op to
f32; the bodies end in their product, so XLA has no add to fuse into an
FMA); sin within 1e-6 of max(|laser_tpu|, 1) (the two libms may differ by
an ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import laser_tpu as lt
from laser_tpu.tensor import TensorView as JView
from laser_tpu_torch import registry
from laser_tpu_torch import tensor as tv
from laser_tpu_torch.ops import foreach as fe
from laser_tpu_torch.ops import strided as S

BASE_2D = (64, 256)
BASE_3D = (4, 32, 128)
# name: (base shape, view shape, strides, offset)
VIEWS = {
    "every2row": (BASE_2D, (32, 256), (512, 1), 0),
    "every2row_offset": (BASE_2D, (32, 256), (512, 1), 256),
    "every4row_offset2": (BASE_2D, (16, 256), (1024, 1), 512),
    "every2col": (BASE_2D, (64, 128), (256, 2), 0),
    "every3col_offset1": (BASE_2D, (64, 85), (256, 3), 1),
    "flip_lead": (BASE_3D, BASE_3D, (-4096, 128, 1), 3 * 4096),
    "flip_mid": (BASE_3D, BASE_3D, (4096, -128, 1), 31 * 128),
    "flip_last": (BASE_3D, BASE_3D, (4096, 128, -1), 127),
    "flip_lead_mid_skip": (BASE_3D, (4, 16, 128), (-4096, 256, 1), 3 * 4096),
    "strided_1d": ((1000,), (300,), (3,), 2),
    "window": (BASE_3D, (2, 20, 100), (4096, 128, 1), 4096 + 5 * 128 + 3),
}
BODIES = {  # (torch body, jnp body, exact)
    "mul2": (lambda x: x * 2.0, lambda x: x * 2.0, True),
    "arith": (lambda x: (x + 1.5) * (x - 0.25), lambda x: (x + 1.5) * (x - 0.25), True),
    "sin": (lambda x: torch.sin(x) + x, lambda x: jnp.sin(x) + x, False),
}


def _np(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _views(name, seed):
    base_shape, shape, strides, offset = VIEWS[name]
    base = _np(base_shape, seed)
    jv = JView(jnp.asarray(base).reshape(-1), shape, strides, offset)
    tvw = tv.TensorView(torch.from_numpy(base.copy()).reshape(-1), shape, strides, offset)
    return base, jv, tvw


def _close(got, want, exact):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        assert (np.abs(got - want) <= 1e-6 * np.maximum(np.abs(want), 1)).all()


@pytest.fixture(scope="module")
def ref():
    """laser_tpu's for_each on every (view, body) case, once."""
    out = {}
    for i, name in enumerate(VIEWS):
        _, jv, _ = _views(name, 30 + i)
        for body, (_, jfn, _) in BODIES.items():
            out[(name, body)] = np.asarray(lt.for_each(jfn, jv))
    return out


@pytest.mark.parametrize("body", sorted(BODIES))
@pytest.mark.parametrize("name", sorted(VIEWS))
def test_for_each_over_view_vs_laser_tpu(ref, name, body):
    i = list(VIEWS).index(name)
    _, _, tvw = _views(name, 30 + i)
    registry.reset_counts()
    got = fe.for_each(BODIES[body][0], tvw)
    assert registry.counts()["for_each_strided"] == {"launches": 0, "plain_calls": 1}
    _close(got.numpy(), ref[(name, body)], BODIES[body][2])


def test_mixed_strided_and_contiguous_vs_laser_tpu():
    base, b = _np(BASE_2D, 40), _np((32, 256), 41)
    jv = JView(jnp.asarray(base).reshape(-1), (32, 256), (512, 1), 0)
    want = np.asarray(lt.for_each(lambda x, y: (x + y) * (x - y), jv, b))
    got = fe.for_each(lambda x, y: (x + y) * (x - y), torch.from_numpy(base)[::2],
                      torch.from_numpy(b))
    _close(got.numpy(), want, True)
    want = np.asarray(lt.for_each(lambda x, y: x + jnp.sin(y), jv, b))
    got = fe.for_each(lambda x, y: x + torch.sin(y), torch.from_numpy(base)[::2],
                      torch.from_numpy(b))
    _close(got.numpy(), want, False)


@pytest.mark.parametrize("which", ["every2row", "transposed"])
def test_torch_views_vs_laser_tpu(which):
    """torch's own x[1::2] and x.t() against the same windows as laser_tpu
    views (the transposed one laser_tpu materialises first)."""
    base = _np(BASE_2D, 42)
    jv = JView.from_array(jnp.asarray(base))
    x = torch.from_numpy(base)
    if which == "every2row":
        jv, xv = jv.slice(slice(1, None, 2)), x[1::2]
    else:
        jv, xv = jv.transpose(), x.t()
    want = np.asarray(lt.for_each(lambda p: (p - 1.0) * 3.0, jv))
    got = fe.for_each(lambda p: (p - 1.0) * 3.0, xv)
    _close(got.numpy(), want, True)


def test_view_algebra_and_materialize_vs_laser_tpu():
    base = _np(BASE_3D, 43)
    jv = JView.from_array(jnp.asarray(base))
    t = tv.TensorView.from_array(torch.from_numpy(base))
    assert t.strides == jv.strides == tv.row_major_strides(BASE_3D)
    for f in (lambda v: v.slice(slice(1, 4, 2), slice(None, None, -3)),
              lambda v: v.transpose((2, 0, 1)).slice(slice(5, 90, 7)),
              lambda v: v.transpose(), lambda v: v.slice(slice(2, 3))):
        a, b = f(jv), f(t)
        assert (a.shape, a.strides, a.offset) == (b.shape, b.strides, b.offset)
        assert a.is_c_contiguous() == b.is_c_contiguous() and a.size == b.size
        np.testing.assert_array_equal(b.materialize().numpy(), np.asarray(a.materialize()))
    m = tv.TensorView.matrix(torch.from_numpy(base), 10, 12, 128, 2, 7)
    jm = JView.matrix(jnp.asarray(base), 10, 12, 128, 2, 7)
    np.testing.assert_array_equal(m.to_array().numpy(), np.asarray(jm.to_array()))
    assert m.rank == 2 and m.dtype == torch.float32


def test_as_view_of_torch_tensors_and_helpers():
    x = torch.arange(120, dtype=torch.float32).reshape(10, 12)
    v = tv.as_view(x[2:, 1::3])
    assert (v.shape, v.strides, v.offset) == ((8, 4), (12, 3), 25)
    assert torch.equal(v.materialize(), x[2:, 1::3])
    d = tv.deep_copy(x[:, ::2])
    assert d.is_contiguous() and torch.equal(d, x[:, ::2])
    c = tv.deep_copy(x)
    assert torch.equal(c, x) and c.data_ptr() != x.data_ptr()
    assert torch.equal(tv.set_zero(x[::2]), torch.zeros(5, 12))
    assert tv.copy_from(torch.zeros(5, 12, dtype=torch.int32), x[::2]).dtype == torch.int32
    assert tv.zeros((2, 3), device="cpu").shape == (2, 3)
    assert tv.from_nested([[1, 2], [3, 4]], device="cpu").tolist() == [[1, 2], [3, 4]]
    assert tv.copy_from_raw(list(range(6)), (2, 3), device="cpu").shape == (2, 3)
    with pytest.raises(ValueError, match="reaches"):
        tv.TensorView(torch.zeros(10), (4,), (3,), 2)
    with pytest.raises(ValueError, match="LASER_MAXRANK"):
        tv.TensorView(torch.zeros(1), (1,) * 7, (1,) * 7)


def test_plan_merges_contiguous_dims():
    base = torch.zeros(24, 40, 36)
    assert S.plan([tv.as_view(base[1::2])]) == S.StridedPlan((12, 1440), (1440,), ((2880, 1),))
    assert S.plan([tv.as_view(base[:, :, ::2])]).shape == (24 * 40 * 18,)
    p = S.plan([tv.as_view(base[1::2]), tv.as_view(torch.zeros(12, 40, 36))])
    assert p.shape == (12, 1440) and p.strides == ((2880, 1), (1440, 1))
    assert S.plan([tv.as_view(base.transpose(0, 2))]).shape == (36, 40, 24)


def test_strided_donate_returns_a_new_tensor_and_backend_is_accepted():
    base = torch.from_numpy(_np(BASE_2D, 44))
    keep = base.clone()
    out = fe.for_each(lambda p: p + 1.0, base[::2], donate=True)
    assert torch.equal(base, keep) and torch.equal(out, keep[::2] + 1.0)
    got = S.strided_for_each(lambda p: p * 2.0, [base[1::2]], backend="pallas")
    assert torch.equal(got, keep[1::2] * 2.0)
    with pytest.raises(ValueError, match="backend"):
        S.strided_for_each(lambda p: p, [base[1::2]], backend="mosaic")


def test_strided_operands_materialise_for_the_other_templates():
    """for_each_multi, row_reduce and map_reduce take a view as laser_tpu's
    _prepare_flat does: materialised, then the contiguous kernel."""
    base = torch.from_numpy(_np(BASE_2D, 45))
    v = tv.as_view(base[1::2])
    a, b = fe.for_each_multi(lambda x: (x + 1.0, x * x), v)
    assert torch.equal(a, base[1::2] + 1.0) and torch.equal(b, base[1::2] * base[1::2])
    assert torch.equal(fe.row_reduce(lambda x: x, base[:, ::2]),
                       fe.row_reduce(lambda x: x, base[:, ::2].contiguous()))
    assert fe.map_reduce(lambda x: x * x, v).item() == \
        fe.map_reduce(lambda x: x * x, base[1::2].contiguous()).item()


def test_strided_source_and_vocabulary():
    src = S.strided_for_each_source(lambda p, q: p * q, [torch.float32, torch.bfloat16],
                                    torch.float32)
    assert "LTT_FOR_EACH_STRIDED_ENTRY(Body)" in src and "off[1]" in src
    with pytest.raises(NotImplementedError, match="cumsum"):
        fe.for_each(lambda p: torch.cumsum(p, 0), torch.zeros(4, 6)[:, ::2])


@pytest.mark.parametrize("route", [None, "classic"])
def test_strided_routes_run_the_plain_version_on_the_cpu(route):
    """Each route's name is taken; on a CPU tensor each runs the one plain
    version (counted under ``for_each_strided``), and both kernels' counters
    exist."""
    base = torch.from_numpy(_np(BASE_2D, 46))
    registry.reset_counts()
    got = S.strided_for_each(lambda p: p * 2.0 - 1.0, [base[1::2]], route=route)
    c = registry.counts()
    assert c["for_each_strided"] == {"launches": 0, "plain_calls": 1}
    assert c["for_each_strided_tiled"] == {"launches": 0, "plain_calls": 0}
    assert torch.equal(got, base[1::2] * 2.0 - 1.0)


def test_strided_unknown_route_raises():
    with pytest.raises(ValueError, match="route"):
        S.strided_for_each(lambda p: p, [torch.zeros(4, 6)[::2]], route="rows")


_SCALE = 2.0


def test_strided_plan_reads_closure_and_globals_on_every_call(monkeypatch):
    """The strided plan is memoised on what the body reads
    (``codegen.body_key``): a changed global, closure cell, default or a
    global read by a function the body calls gives a new plan; an unchanged
    body is not traced again; a body that reads a mutable object is traced
    on every call."""
    from laser_tpu_torch.ops import codegen

    global _SCALE
    traces = []
    real = codegen.trace
    monkeypatch.setattr(codegen, "trace", lambda *a, **k: traces.append(1) or real(*a, **k))
    f32 = [torch.float32]
    shift = 1.0

    def helper(p):
        return p * _SCALE

    body = lambda p: p * _SCALE + shift  # noqa: E731
    called = lambda p: helper(p) - 1.0  # noqa: E731
    srcs = []
    for scale, sh in ((2.0, 1.0), (3.0, 1.0), (3.0, -2.0), (3.0, -2.0)):
        _SCALE, shift = scale, sh
        srcs.append(S.strided_for_each_source(body, f32, torch.float32))
        assert float.hex(scale) in srcs[-1] and float.hex(sh) in srcs[-1]
        srcs.append(S.strided_for_each_source(called, f32, torch.float32))
        assert float.hex(scale) in srcs[-1]
    assert len(set(srcs)) == 5 and srcs[-4:] == srcs[-2:] * 2
    n = len(traces)
    S.strided_for_each_source(body, f32, torch.float32)
    assert len(traces) == n  # memoised
    dflt = lambda p, s=0.5: p * s  # noqa: E731
    assert float.hex(0.5) in S.strided_for_each_source(dflt, f32, torch.float32)
    dflt.__defaults__ = (0.25,)
    assert float.hex(0.25) in S.strided_for_each_source(dflt, f32, torch.float32)
    cfg = {"s": 5.0}
    mutable = lambda p: p * cfg["s"]  # noqa: E731
    assert codegen.body_key(mutable) is None
    S.strided_for_each_source(mutable, f32, torch.float32)
    cfg["s"] = 7.0
    n = len(traces)
    assert float.hex(7.0) in S.strided_for_each_source(mutable, f32, torch.float32)
    assert len(traces) == n + 1
    _SCALE = 2.0
    x = torch.from_numpy(_np(BASE_2D, 47))[::2]
    assert torch.equal(fe.for_each(body, x), x * 2.0 + shift)


class _Base:
    SCALE = 2.0


class _Sub(_Base):
    pass


_CFG_NAME = "ltt_strided_body_cfg"


def _module_body(case, cfg):
    """A body that reads ``cfg.SCALE`` (or ``cfg.sub.SCALE``) the way
    ``case`` names, and whether ``body_key`` keys it."""
    if case == "module_in_closure":
        def make():
            import ltt_strided_body_cfg
            return lambda p: p * ltt_strided_body_cfg.SCALE
        return make(), True
    if case == "module_in_default":
        return (lambda p, m=cfg: p * m.SCALE), True
    if case == "module_of_a_module":
        return (lambda p, m=cfg: p * m.sub.SCALE), True
    if case == "local_import":
        def body(p):
            import ltt_strided_body_cfg
            return p * ltt_strided_body_cfg.SCALE
        return body, False
    if case == "attribute_by_name":
        return (lambda p, m=cfg: p * getattr(m, "SCALE")), False
    if case == "bound_method":
        return (lambda p, get=cfg.table.get: p * get("SCALE")), False
    if case == "inherited_class_attribute":
        return (lambda p: p * _Sub.SCALE), False
    if case == "stores_its_closure":
        def make():
            k = 0.0

            def body(p):
                nonlocal k
                k = cfg.SCALE
                return p * k
            return body
        return make(), False
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["module_in_closure", "module_in_default",
                                  "module_of_a_module", "local_import", "attribute_by_name",
                                  "bound_method", "inherited_class_attribute",
                                  "stores_its_closure"])
def test_strided_plan_reads_modules_and_classes_on_every_call(monkeypatch, case):
    """A module the body reaches through a closure cell, a default or
    another module is searched for the attributes the body names, so a
    changed module constant gives a new plan from the memo; a body that
    imports, looks an attribute up by a string, calls a bound method,
    reads a class of its own or stores to its closure is not keyed and is
    traced on every call."""
    import types

    from laser_tpu_torch.ops import codegen

    cfg = types.ModuleType(_CFG_NAME)
    cfg.sub = types.ModuleType(_CFG_NAME + ".sub")
    cfg.table = {}
    monkeypatch.setitem(__import__("sys").modules, _CFG_NAME, cfg)
    monkeypatch.setattr(_Base, "SCALE", 2.0)
    body, keyed = _module_body(case, cfg)
    f32 = [torch.float32]
    for scale in (2.0, 3.0, 3.0, -0.5):
        cfg.SCALE = cfg.sub.SCALE = cfg.table["SCALE"] = scale
        _Base.SCALE = scale
        assert (codegen.body_key(body) is not None) == keyed
        assert float.hex(scale) in S.strided_for_each_source(body, f32, torch.float32)


def test_strided_plan_keys_body_ops():
    """A body op (the package's vector-math cores) is kept by identity, so a
    body that calls one and reads a global is memoised and still sees the
    global's current value; a Python function of the caller's is not."""
    from laser_tpu_torch.ops import codegen
    from laser_tpu_torch.ops import vector_math as vm

    global _SCALE
    f32 = [torch.float32]
    body = lambda p: vm.exp_acc(p) * _SCALE  # noqa: E731
    helper = lambda p: body(p) + 1.0  # noqa: E731
    assert codegen.body_key(body) is not None and codegen.body_key(helper) is None
    try:
        for scale in (2.0, 3.0):
            _SCALE = scale
            for fn in (body, helper):
                src = S.strided_for_each_source(fn, f32, torch.float32)
                assert "exp_acc" in src and float.hex(scale) in src
    finally:
        _SCALE = 2.0
