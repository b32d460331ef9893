"""Lux: a small tensor-expression layer lowered onto the port's kernels
(port of laser_tpu/lux/dsl.py).

``generate`` runs the user's function once over ``LuxNode`` placeholders,
which records the expression tree, and lowers the tree as laser_tpu does
(dsl.py:291-395), onto the port's kernels:

- a maximal elementwise tree -> one ``ops.foreach.for_each`` (a tuple of
  such trees -> one ``for_each_multi``);
- a full reduction of an elementwise tree -> one ``map_reduce``; over the
  last axis of 2-D operands -> one ``row_reduce``; over another axis ->
  ``for_each``, then ``row_reduce`` on the axis moved last;
- ``act(A @ B + bias)`` / ``A @ B + bias`` / ``act(A @ B)`` ->
  ``ops.gemm.gemm`` with the bias and activation in the kernel's epilogue
  (a plain product goes to ``torch.matmul``, as laser_tpu hands it to XLA);
  a 2-D addend -> the product, then one ``for_each`` of add + activation;
- anything else: each child lowered, the op as one more ``for_each``;
- a bare input: the array itself, where laser_tpu copies it through an
  identity ``for_each`` (as the operand of a matmul, say).

The elementwise body is a torch callable traced by ``ops/codegen.py``;
``lux_exp``/``lux_log``/``lux_tanh``/``lux_sigmoid`` become the vector-math
core of the configured tier (``Schedule(algorithm=...)``). Operands of
different shapes are broadcast and materialised first (laser_tpu pays the
same copy). ``Schedule.gemm_tiles`` and ``gemm_backend`` name laser_tpu's
VMEM tile planner and its XLA dispatch, which the port does not have: a
matmul lowered with either raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..config import config_override


def _maximum(a, b):
    if isinstance(b, (int, float)):
        return torch.clamp_min(a, b)
    if isinstance(a, (int, float)):
        return torch.clamp_min(b, a)
    return torch.maximum(a, b)


def _minimum(a, b):
    if isinstance(b, (int, float)):
        return torch.clamp_max(a, b)
    if isinstance(a, (int, float)):
        return torch.clamp_max(b, a)
    return torch.minimum(a, b)


_BINOPS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "pow": lambda a, b: a ** b,
    "max": _maximum,
    "min": _minimum,
}

_UNOPS = {
    "neg": lambda a: -a,
    "sin": torch.sin,
    "cos": torch.cos,
    "abs": torch.abs,
    "relu": torch.relu,
}
_VECTOR_MATH = ("tanh", "sigmoid", "exp", "log")

# unops that exist as fused GEMM epilogues (csrc/gemm.cu)
_EPILOGUE_ACTS = {"relu", "tanh", "sigmoid", "gelu"}


@dataclasses.dataclass(frozen=True)
class LuxNode:
    """Expression node: input | const | binop | unop | matmul | reduce."""

    kind: str
    op: Optional[str] = None
    args: Tuple["LuxNode", ...] = ()
    value: Any = None  # input index or const value
    axis: Optional[int] = None  # for reduce

    def _bin(self, op, other, rev=False):
        o = other if isinstance(other, LuxNode) else LuxNode("const", value=other)
        return (LuxNode("binop", op, (o, self)) if rev
                else LuxNode("binop", op, (self, o)))

    def __add__(self, o):
        return self._bin("add", o)

    def __radd__(self, o):
        return self._bin("add", o, rev=True)

    def __sub__(self, o):
        return self._bin("sub", o)

    def __rsub__(self, o):
        return self._bin("sub", o, rev=True)

    def __mul__(self, o):
        return self._bin("mul", o)

    def __rmul__(self, o):
        return self._bin("mul", o, rev=True)

    def __truediv__(self, o):
        return self._bin("div", o)

    def __rtruediv__(self, o):
        return self._bin("div", o, rev=True)

    def __pow__(self, o):
        return self._bin("pow", o)

    def __neg__(self):
        return LuxNode("unop", "neg", (self,))

    def __matmul__(self, o):
        if not isinstance(o, LuxNode):
            raise TypeError("matmul operand must be a LuxNode")
        return LuxNode("matmul", None, (self, o))

    def is_elementwise_tree(self) -> bool:
        if self.kind in ("input", "const"):
            return True
        if self.kind in ("matmul", "reduce"):
            return False
        return all(a.is_elementwise_tree() for a in self.args)

    def leaves(self, acc: Optional[List[int]] = None) -> List[int]:
        """Distinct input indices in first-use order."""
        acc = [] if acc is None else acc
        if self.kind == "input":
            if self.value not in acc:
                acc.append(self.value)
        for a in self.args:
            a.leaves(acc)
        return acc


def _unop(name):
    def f(x):
        if not isinstance(x, LuxNode):
            raise TypeError(f"lux_{name} takes a LuxNode")
        return LuxNode("unop", name, (x,))
    f.__name__ = f"lux_{name}"
    return f


lux_sin = _unop("sin")
lux_exp = _unop("exp")
lux_log = _unop("log")
lux_tanh = _unop("tanh")
lux_sigmoid = _unop("sigmoid")
lux_abs = _unop("abs")
# in laser_tpu's unop table without a constructor there (LuxNode("unop",
# "relu", (x,)) builds the same node)
lux_cos = _unop("cos")
lux_relu = _unop("relu")


def lux_sum(x: LuxNode, axis: Optional[int] = None) -> LuxNode:
    """Reduction fused with its elementwise operand: ``axis=None`` to a
    scalar (map_reduce), ``axis=-1`` row by row (row_reduce)."""
    return LuxNode("reduce", "sum", (x,), axis=axis)


def lux_max(x: LuxNode, axis: Optional[int] = None) -> LuxNode:
    return LuxNode("reduce", "max", (x,), axis=axis)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Schedule hints for the lowering (laser_tpu's ``Schedule``):

      donate            write a for_each result into its first operand
      grain             laser_tpu's VMEM block sizes: accepted, unused
      reduction_grain   (the port's block sizing is fixed, csrc/foreach.cuh)
      gemm_tiles        laser_tpu's VMEM tile shape: not ported, raises
      gemm_backend      laser_tpu's "pallas" / "xla" dispatch: not ported
      precision         config.matmul_precision
      algorithm         vector-math tier: "accurate" | "fast"
    """

    donate: bool = False
    grain: Optional[int] = None
    reduction_grain: Optional[int] = None
    gemm_tiles: Optional[Tuple[int, int, int]] = None
    gemm_backend: Optional[str] = None
    precision: Optional[str] = None
    algorithm: Optional[str] = None

    def _config_overrides(self) -> Dict[str, Any]:
        o: Dict[str, Any] = {}
        if self.precision is not None:
            o["matmul_precision"] = self.precision
        if self.algorithm is not None:
            o["vector_math_algorithm"] = self.algorithm
        return o

    def _check_gemm(self):
        if self.gemm_tiles is not None or self.gemm_backend is not None:
            raise NotImplementedError(
                "Schedule.gemm_tiles / gemm_backend select laser_tpu's VMEM tile planner "
                "and XLA dispatch, which are not ported")


_DEFAULT_SCHEDULE = Schedule()


def _eval_elementwise(node: LuxNode, env: Dict[int, Any]):
    """The fused torch expression over the body's values in ``env``."""
    if node.kind == "input":
        return env[node.value]
    if node.kind == "const":
        return node.value
    if node.kind == "binop":
        return _BINOPS[node.op](_eval_elementwise(node.args[0], env),
                                _eval_elementwise(node.args[1], env))
    if node.kind == "unop":
        v = _eval_elementwise(node.args[0], env)
        if node.op in _VECTOR_MATH:
            from ..ops import vector_math as vm

            return vm.pick(node.op)(v)  # the configured tier, in the kernel
        return _UNOPS[node.op](v)
    raise AssertionError(f"not elementwise: {node.kind}")


def _match_gemm_epilogue(node: LuxNode):
    """(lhs, rhs, bias node or None, act or None) for act(A@B [+ bias]) /
    A@B [+ bias], else None."""
    act = None
    n = node
    if n.kind == "unop" and n.op in _EPILOGUE_ACTS:
        act = n.op
        n = n.args[0]
    bias = None
    if n.kind == "binop" and n.op == "add":
        a, b = n.args
        if a.kind == "matmul":
            n, bias = a, b
        elif b.kind == "matmul":
            n, bias = b, a
    if n.kind != "matmul":
        return None
    lhs, rhs = n.args
    return lhs, rhs, bias, act


def _broadcast_operands(ops):
    """Broadcast mixed-shape operands to one shape and materialise them,
    so the kernel sees same-shaped contiguous operands."""
    shapes = {tuple(o.shape) for o in ops}
    if len(shapes) == 1:
        return ops
    target = torch.broadcast_shapes(*[o.shape for o in ops])
    return [o if tuple(o.shape) == tuple(target) else o.expand(target).contiguous()
            for o in ops]


_REDUCE = {"sum": (torch.sum, 0.0), "max": (torch.amax, -float("inf"))}


def _reduce_along(fn, ops, red, ident, axis):
    """reduce(fn(*ops)) over ``axis`` on the kernels."""
    from ..ops.foreach import for_each, map_reduce, row_reduce

    if axis is None:
        return map_reduce(fn, *ops, reduce_fn=red, identity=ident)
    nd = ops[0].ndim
    ax = axis if axis >= 0 else nd + axis
    if ax == nd - 1 and nd == 2:
        return row_reduce(fn, *ops, reduce_fn=red, identity=ident)
    # another axis: the fused map, then rows of the axis moved last
    v = for_each(fn, *ops)
    vm = v.movedim(ax, -1).contiguous()
    rows = vm.reshape(-1, vm.shape[-1])
    return row_reduce(_same, rows, reduce_fn=red, identity=ident).reshape(vm.shape[:-1])


def _same(t):
    return t


def _body(node: LuxNode, idxs):
    """The torch body of an elementwise tree over the leaves ``idxs``."""
    return lambda *blocks: _eval_elementwise(node, dict(zip(idxs, blocks)))


def _lower(node: LuxNode, sch: Schedule = _DEFAULT_SCHEDULE) -> Callable:
    """run(arrays: dict idx -> tensor) -> tensor."""
    from ..ops.foreach import for_each
    from ..ops.gemm import gemm

    if node.kind == "input":
        # the array itself (laser_tpu runs an identity for_each over it)
        return lambda arrays: arrays[node.value]
    # each body is made once here; for_each traces it on every call
    if node.is_elementwise_tree():
        idxs = node.leaves()
        fn = _body(node, idxs)

        def run(arrays):
            ops = _broadcast_operands([arrays[i] for i in idxs])
            return for_each(fn, *ops, donate=sch.donate)

        return run

    if node.kind == "reduce":
        operand = node.args[0]
        red, ident = _REDUCE[node.op]
        if not operand.is_elementwise_tree():
            inner = _lower(operand, sch)
            return lambda arrays: _reduce_along(_same, [inner(arrays)], red, ident, node.axis)
        idxs = operand.leaves()
        fn = _body(operand, idxs)

        def run(arrays):
            ops = _broadcast_operands([arrays[i] for i in idxs])
            return _reduce_along(fn, ops, red, ident, node.axis)

        return run

    m = _match_gemm_epilogue(node)
    if m is not None:
        sch._check_gemm()
        lhs, rhs, bias, act = m
        run_l, run_r = _lower(lhs, sch), _lower(rhs, sch)
        run_bias = _lower(bias, sch) if bias is not None else None
        from ..ops import vector_math as vm

        actf = {None: _same, "relu": torch.relu, "tanh": vm.tanh_acc,
                "sigmoid": vm.sigmoid_acc}.get(act)

        def add_act(u, v):
            return actf(u + v)

        def run(arrays):
            a, b = run_l(arrays), run_r(arrays)
            bb = run_bias(arrays) if run_bias is not None else None
            if bb is not None and bb.ndim != 1:
                # act(A@B + X): X cannot ride the bias slot; the activation
                # must see A@B + X, so add and activate in one for_each
                return for_each(add_act, *_broadcast_operands([gemm(a, b), bb]))
            return gemm(a, b, bias=bb, epilogue=act)

        return run

    # anything else: lower the children, apply the op as one more kernel
    runs = [_lower(a, sch) for a in node.args]
    if node.kind == "binop":
        def run(arrays):
            ops = _broadcast_operands([r(arrays) for r in runs])
            return for_each(_BINOPS[node.op], *ops)
        return run
    if node.kind == "unop":
        def run(arrays):
            from ..ops import vector_math as vm

            v = runs[0](arrays)
            if node.op in _VECTOR_MATH:
                return getattr(vm, node.op)(v)
            return for_each(_UNOPS[node.op], v)
        return run
    raise NotImplementedError(f"cannot lower node kind {node.kind}")


def generate(f: Optional[Callable] = None, *, schedule: Optional[Schedule] = None) -> Callable:
    """Symbolically execute ``f`` over ``LuxNode`` placeholders and return
    the lowered callable; ``@lux.generate`` or
    ``@lux.generate(schedule=lux.Schedule(donate=True))``."""
    if f is None:
        return functools.partial(generate, schedule=schedule)

    sch = schedule if schedule is not None else _DEFAULT_SCHEDULE
    overrides = sch._config_overrides()

    def _with_overrides(run):
        if not overrides:
            return run

        def wrapped(arrays):
            with config_override(**overrides):
                return run(arrays)

        return wrapped

    nparams = len(inspect.signature(f).parameters)
    graph = f(*[LuxNode("input", value=i) for i in range(nparams)])

    if isinstance(graph, tuple):
        if not all(isinstance(g, LuxNode) for g in graph):
            raise TypeError("lux function must return LuxNode expression(s)")
        if all(g.is_elementwise_tree() for g in graph):
            all_idxs: List[int] = []
            for g in graph:
                g.leaves(all_idxs)

            def run_multi(arrays):
                from ..ops.foreach import for_each_multi

                ops = _broadcast_operands([arrays[i] for i in all_idxs])

                def fn(*blocks):
                    env = dict(zip(all_idxs, blocks))
                    return tuple(_eval_elementwise(g, env) for g in graph)

                return for_each_multi(fn, *ops)
        else:
            runs = [_lower(g, sch) for g in graph]

            def run_multi(arrays):
                return tuple(r(arrays) for r in runs)

        run_multi = _with_overrides(run_multi)

        @functools.wraps(f)
        def compiled_multi(*arrays):
            if len(arrays) != nparams:
                raise TypeError(f"{f.__name__} expects {nparams} arrays")
            return run_multi(dict(enumerate(arrays)))

        compiled_multi.lux_graph = graph
        compiled_multi.lux_schedule = sch
        return compiled_multi

    if not isinstance(graph, LuxNode):
        raise TypeError("lux function must return a LuxNode expression")
    run = _with_overrides(_lower(graph, sch))

    @functools.wraps(f)
    def compiled(*arrays):
        if len(arrays) != nparams:
            raise TypeError(f"{f.__name__} expects {nparams} arrays")
        return run(dict(enumerate(arrays)))

    compiled.lux_graph = graph
    compiled.lux_schedule = sch
    return compiled
