"""Turn a torch elementwise body into CUDA C++ for the foreach templates.

laser_tpu has no counterpart: there Pallas traces the jnp body into the
kernel itself. Here ``trace`` runs the user's callable once over symbolic
values (``Sym``) and records every operation into a typed graph; ``emit``
writes that graph out as a ``struct Body`` for one of the five templates
in ``csrc/foreach.cuh``, which ``registry.load_generated`` builds with nvcc
(``emit_for_each`` with ``strided``: the strided template's loads;
``emit_staged``: a map_reduce_staged block, its combine and its finish).

Why a ``__torch_function__`` recorder and not ``torch.fx.symbolic_trace``:
a body may call the port's own vector-math cores (``vector_math.exp`` with
the accurate tier reaches ``_exp_core``), which must stay one node rather
than be traced into their bit operations. With the recorder such a core is
an ordinary function that checks for a ``Sym``; fx would need each one
registered as a leaf from the module that traces. The recorder also learns
each node's dtype by calling the same torch function on a one-element
``meta`` tensor, so type promotion (Python scalars are weak, bf16 + f32 is
f32, a comparison is bool, ``/`` of ints is f32) is PyTorch's own.

The vocabulary (anything else raises ``NotImplementedError`` naming the
op, on every device, since the wrappers trace on the CPU too):

- arithmetic: add, sub, mul, div (true), pow, neg, abs, maximum, minimum,
  clamp / clamp_min / clamp_max, relu;
- comparisons (eq, ne, lt, le, gt, ge), where, isnan / isinf / isfinite,
  logical and bitwise and / or / xor / not;
- sin, cos, exp, log, tanh, sigmoid, sqrt, rsqrt, floor, ceil, round,
  trunc: CUDA's accurate functions (sinf, expf, ...: 1-2 ulp), as
  PyTorch's own CUDA kernels use;
- the vector-math tiers of ``ops.vector_math``: ``exp_acc`` / ``log_acc`` /
  ``tanh_acc`` / ``sigmoid_acc`` (laser_tpu's polynomials) and ``*_fast``
  (CUDA's intrinsics), see ``csrc/vector_math.cuh``;
- scalar constants, ``.to(dtype)`` and ``.float()`` / ``.half()`` /
  ``.bfloat16()`` / ``.int()`` / ``.long()`` / ``.bool()``.

The block vocabulary of a ``map_reduce_staged`` body (``trace_staged``)
adds to it:

- whole-block reductions: ``torch.sum``, ``torch.mean`` (floats),
  ``torch.amax`` / ``torch.max``, ``torch.amin`` / ``torch.min`` with no
  ``dim``: an element node in, a *block scalar* out (floats fold in f32,
  integer sums in int64); element nodes may read block scalars, which
  broadcasts them (``b - m``);
- the context: ``ctx.valid`` (a bool element node), ``ctx.flat_indices(
  b.shape)`` (the element's global flat index, int64), ``ctx.offset`` and
  ``ctx.width`` (int64 block scalars), ``b.shape``;
- accumulator leaves must be block scalars; ``combine(a, b)`` is traced
  over scalar nodes with the elementwise ops (``trace_combine``).

A node's reduction depth is the number of reductions on its longest path;
the emitted block runs one sweep over its registers per depth level
(``mean_var`` and ``argmax`` take two).

Each node's result is rounded to the dtype its plain evaluation has, so a
bf16 body rounds after every op as eager PyTorch (and laser_tpu's jnp block
math) does; a float value is held in an f32 register, rounded. f32 adds,
multiplies and divides are emitted as ``__fadd_rn`` / ``__fmul_rn`` /
``__fdiv_rn`` so nvcc contracts nothing into an FMA that eager PyTorch
would round twice. Dtypes: float32, bfloat16, float16, bool, int8, uint8,
int16, int32, int64.
"""

from __future__ import annotations

import dataclasses
import dis
import functools
import math
import types
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

# storage C type, value C type held in registers, itemsize
_CTYPES = {
    torch.float32: ("float", "float"),
    torch.bfloat16: ("__nv_bfloat16", "float"),
    torch.float16: ("__half", "float"),
    torch.bool: ("uint8_t", "bool"),
    torch.int8: ("int8_t", "int8_t"),
    torch.uint8: ("uint8_t", "uint8_t"),
    torch.int16: ("int16_t", "int16_t"),
    torch.int32: ("int32_t", "int32_t"),
    torch.int64: ("int64_t", "int64_t"),
}
DTYPES = tuple(_CTYPES)
FLOATS = (torch.float32, torch.bfloat16, torch.float16)
MAX_IN, MAX_OUT = 16, 8  # csrc/foreach.cuh kMaxIn, kMaxOut

# vector-math cores; the templated ones round every step to the storage type
SPECIALS = {"exp_acc": False, "log_acc": False, "tanh_acc": True, "sigmoid_acc": True,
            "exp_fast": False, "log_fast": False, "tanh_fast": False, "sigmoid_fast": False}

_UNARY_F = {  # float functions: C expression of the f32 value `a`
    "sin": "sinf({a})", "cos": "cosf({a})", "exp": "expf({a})", "log": "logf({a})",
    "tanh": "tanhf({a})", "sigmoid": "__fdiv_rn(1.f, __fadd_rn(1.f, expf(-{a})))",
    "sqrt": "__fsqrt_rn({a})", "rsqrt": "__fdiv_rn(1.f, __fsqrt_rn({a}))",
    "floor": "floorf({a})", "ceil": "ceilf({a})", "round": "rintf({a})",
    "trunc": "truncf({a})",
}
_COMPARE = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">", "ge": ">="}


def _table():
    T = torch.Tensor
    t = {}
    for names, op in [
        ((torch.add, T.add, T.__add__, T.__radd__), "add"),
        ((torch.sub, torch.subtract, T.sub, T.__sub__, T.__rsub__), "sub"),
        ((torch.mul, torch.multiply, T.mul, T.__mul__, T.__rmul__), "mul"),
        ((torch.div, torch.true_divide, torch.divide, T.div, T.__truediv__,
          T.__rtruediv__), "div"),
        ((torch.pow, T.pow, T.__pow__, T.__rpow__), "pow"),
        ((torch.maximum, T.maximum), "maximum"),
        ((torch.minimum, T.minimum), "minimum"),
        ((torch.neg, torch.negative, T.neg, T.__neg__), "neg"),
        ((torch.abs, T.abs, T.__abs__), "abs"),
        ((torch.relu, F.relu, T.relu), "relu"),
        ((torch.clamp, torch.clip, T.clamp, T.clip), "clamp"),
        ((torch.clamp_min, T.clamp_min), "clamp_min"),
        ((torch.clamp_max, T.clamp_max), "clamp_max"),
        ((torch.where,), "where"),
        ((torch.isnan, T.isnan), "isnan"), ((torch.isinf, T.isinf), "isinf"),
        ((torch.isfinite, T.isfinite), "isfinite"),
        ((torch.logical_and, torch.bitwise_and, T.__and__, T.__rand__), "and"),
        ((torch.logical_or, torch.bitwise_or, T.__or__, T.__ror__), "or"),
        ((torch.logical_xor, torch.bitwise_xor, T.__xor__, T.__rxor__), "xor"),
        ((torch.logical_not, torch.bitwise_not, T.__invert__), "not"),
        ((torch.sigmoid, F.sigmoid, T.sigmoid), "sigmoid"),
        ((torch.tanh, F.tanh, T.tanh), "tanh"),
        ((T.to,), "to"),
    ]:
        for f in names:
            t[f] = op
    for op in ("eq", "ne", "lt", "le", "gt", "ge"):
        t[getattr(torch, op)] = op
        t[getattr(T, op)] = op
        t[getattr(T, f"__{op}__")] = op
    for op in ("sin", "cos", "exp", "log", "sqrt", "rsqrt", "floor", "ceil", "round",
               "trunc"):
        t[getattr(torch, op)] = op
        t[getattr(T, op)] = op
    return t


_FUNCS = _table()
# whole-block reductions of a map_reduce_staged body; torch.max / torch.min
# of two tensors are maximum / minimum
_REDUCTIONS = {torch.sum: "rsum", torch.Tensor.sum: "rsum",
               torch.mean: "rmean", torch.Tensor.mean: "rmean",
               torch.amax: "rmax", torch.Tensor.amax: "rmax",
               torch.amin: "rmin", torch.Tensor.amin: "rmin",
               torch.max: "max", torch.Tensor.max: "max",
               torch.min: "min", torch.Tensor.min: "min"}
_REVERSED = {torch.Tensor.__rsub__, torch.Tensor.__rtruediv__, torch.Tensor.__rpow__}
_CASTS = {"float": torch.float32, "half": torch.float16, "bfloat16": torch.bfloat16,
          "int": torch.int32, "long": torch.int64, "bool": torch.bool}


@dataclasses.dataclass
class Node:
    op: str                 # "input", a vocabulary op, "cast", a SPECIALS name, a
    #                         REDUCTIONS op, or a staged block's context: "valid",
    #                         "flat_index", "offset", "width"
    args: Tuple[Any, ...]   # node ids (int) or ("c", python scalar)
    dtype: torch.dtype      # the dtype the plain evaluation gives
    compute: torch.dtype    # the dtype the op computes in (promotion of args)
    scalar: bool = False    # a block scalar (one value per block), else per element


class Graph:
    """The recorded nodes. ``block_shape`` is set for a map_reduce_staged
    block body, which may reduce the whole block; elsewhere a reduction is
    outside the vocabulary."""

    def __init__(self, block_shape=None):
        self.nodes: List[Node] = []
        self.block_shape = block_shape

    def add(self, node: Node) -> "Sym":
        self.nodes.append(node)
        return Sym(self, len(self.nodes) - 1)


class Sym:
    """A traced value: node ``idx`` of ``graph``. Supports the operators and
    the methods of the vocabulary; any torch function reaches
    ``__torch_function__``."""

    __slots__ = ("graph", "idx")

    def __init__(self, graph: Graph, idx: int):
        self.graph, self.idx = graph, idx

    @property
    def dtype(self) -> torch.dtype:
        return self.graph.nodes[self.idx].dtype

    @property
    def shape(self) -> Tuple[int, ...]:
        """A staged block's shape (a block scalar's is ()); elementwise
        bodies have none."""
        if self.graph.block_shape is None:
            raise NotImplementedError("for_each body: .shape is outside the elementwise "
                                      "vocabulary (a body sees one element)")
        return () if self.graph.nodes[self.idx].scalar else self.graph.block_shape

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _record(func, args, kwargs or {})

    def to(self, *args, **kwargs):
        return _record(torch.Tensor.to, (self, *args), kwargs)

    def __bool__(self):
        raise NotImplementedError(
            "a traced body cannot branch on a tensor value (use torch.where)")

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        if name in _CASTS:
            return lambda: _record(torch.Tensor.to, (self, _CASTS[name]), {})
        f = getattr(torch.Tensor, name, None)
        if f is None or (f not in _FUNCS and f not in _REDUCTIONS):
            raise NotImplementedError(f"for_each body: Tensor.{name} is outside the "
                                      "elementwise vocabulary (ops/codegen.py)")
        return lambda *a, **k: _record(f, (self, *a), k)


for _name, _meth in [("__add__", torch.Tensor.__add__), ("__radd__", torch.Tensor.__radd__),
                     ("__sub__", torch.Tensor.__sub__), ("__rsub__", torch.Tensor.__rsub__),
                     ("__mul__", torch.Tensor.__mul__), ("__rmul__", torch.Tensor.__rmul__),
                     ("__truediv__", torch.Tensor.__truediv__),
                     ("__rtruediv__", torch.Tensor.__rtruediv__),
                     ("__pow__", torch.Tensor.__pow__), ("__rpow__", torch.Tensor.__rpow__),
                     ("__neg__", torch.Tensor.__neg__), ("__abs__", torch.Tensor.__abs__),
                     ("__and__", torch.Tensor.__and__), ("__or__", torch.Tensor.__or__),
                     ("__xor__", torch.Tensor.__xor__), ("__invert__", torch.Tensor.__invert__),
                     ("__rand__", torch.Tensor.__rand__), ("__ror__", torch.Tensor.__ror__),
                     ("__rxor__", torch.Tensor.__rxor__),
                     ("__eq__", torch.Tensor.__eq__), ("__ne__", torch.Tensor.__ne__),
                     ("__lt__", torch.Tensor.__lt__), ("__le__", torch.Tensor.__le__),
                     ("__gt__", torch.Tensor.__gt__), ("__ge__", torch.Tensor.__ge__),
                     ("__floordiv__", torch.Tensor.__floordiv__),
                     ("__mod__", torch.Tensor.__mod__), ("__matmul__", torch.Tensor.__matmul__)]:
    setattr(Sym, _name, (lambda m: lambda self, *a: _record(m, (self, *a), {}))(_meth))


def _meta(x):
    if isinstance(x, Sym):
        return torch.empty((1,), dtype=x.dtype, device="meta")
    return x


def _arg(x):
    if isinstance(x, Sym):
        return x.idx
    if isinstance(x, (bool, int, float)):
        return ("c", x)
    if isinstance(x, torch.Tensor):
        raise NotImplementedError(
            "for_each body: a tensor captured from outside the body cannot be "
            "traced; pass it as an operand")
    raise NotImplementedError(f"for_each body: argument {x!r} is outside the vocabulary")


def _name(func) -> str:
    q = getattr(func, "__qualname__", "") or ""
    if q.startswith(("Tensor.", "TensorBase.", "_TensorBase.")):
        return "Tensor." + q.split(".", 1)[1]
    return f"torch.{func.__name__}" if hasattr(func, "__name__") else repr(func)


def _record(func, args, kwargs) -> Sym:
    if func in _REDUCTIONS:
        return _reduction(func, args, kwargs)
    op = _FUNCS.get(func)
    if op is None:
        raise NotImplementedError(f"for_each body: op {_name(func)} is outside the "
                                  "elementwise vocabulary (ops/codegen.py)")
    graph = next(a.graph for a in list(args) + list(kwargs.values()) if isinstance(a, Sym))
    if op == "to":
        dtype = kwargs.pop("dtype", None)
        rest = [a for a in args[1:] if not isinstance(a, torch.dtype)]
        dt = [a for a in args[1:] if isinstance(a, torch.dtype)]
        if rest or kwargs or (dtype is None and len(dt) != 1):
            raise NotImplementedError("for_each body: only .to(dtype) is in the vocabulary")
        return _cast(args[0], dtype or dt[0])
    if op in ("clamp", "clamp_min", "clamp_max"):
        lo = kwargs.pop("min", args[1] if len(args) > 1 else None)
        hi = kwargs.pop("max", args[2] if len(args) > 2 else None)
        if op == "clamp_max":
            lo, hi = None, lo
        args = (args[0], lo, hi)
        if any(isinstance(v, Sym) for v in (lo, hi)):
            raise NotImplementedError("for_each body: clamp takes scalar bounds "
                                      "(use torch.maximum / torch.minimum)")
        op = "clamp"
    if kwargs:
        raise NotImplementedError(f"for_each body: {_name(func)} with keyword arguments "
                                  f"{sorted(kwargs)} is outside the vocabulary")
    dtype, compute = _result_dtypes(func, op, args)
    if op == "clamp":
        nargs = (args[0].idx, *[None if v is None else _arg(v) for v in args[1:]])
    else:
        if func in _REVERSED:  # x.__rsub__(y) is y - x
            args = (args[1], args[0])
        nargs = tuple(_arg(a) for a in args)
    _check_dtype(dtype, op)
    _check_dtype(compute, op)
    if op == "pow" and compute not in FLOATS:
        raise NotImplementedError("for_each body: integer pow is outside the vocabulary")
    scalar = all(graph.nodes[a].scalar for a in nargs if isinstance(a, int))
    return graph.add(Node(op, nargs, dtype, compute, scalar))


def _reduction(func, args, kwargs) -> Sym:
    """A whole-block reduction of a staged body: an element node in, a
    block scalar out (sum and mean of floats in f32, of integers in int64;
    min and max in the value's type)."""
    red = _REDUCTIONS[func]
    if red in ("max", "min"):
        if len(args) == 2 and not kwargs and all(isinstance(a, Sym) for a in args):
            return _record(torch.maximum if red == "max" else torch.minimum, args, {})
        red = "r" + red
    x = args[0] if args else None
    graph = x.graph if isinstance(x, Sym) else None
    if graph is None or graph.block_shape is None:
        raise NotImplementedError(f"for_each body: op {_name(func)} is outside the "
                                  "elementwise vocabulary (ops/codegen.py)")
    if len(args) != 1 or kwargs:
        raise NotImplementedError(
            f"map_reduce_staged body: {_name(func)} reduces the whole block; a dim, keepdim "
            "or dtype argument is outside the block vocabulary (ops/codegen.py)")
    if graph.nodes[x.idx].scalar:
        raise NotImplementedError(f"map_reduce_staged body: {_name(func)} of a block scalar "
                                  "is outside the block vocabulary")
    dtype = _reduction_dtype(func, x.dtype)
    _check_dtype(dtype, red)
    if red == "rmean" and x.dtype not in FLOATS:
        raise NotImplementedError("map_reduce_staged body: mean of a non-float block")
    return graph.add(Node(red, (x.idx,), dtype, x.dtype, True))


@functools.lru_cache(maxsize=None)
def _reduction_dtype(func, dtype) -> torch.dtype:
    """The dtype of a whole-block reduction ``func`` of a ``dtype`` block,
    from PyTorch's meta kernels."""
    try:
        return func(torch.empty((1,), dtype=dtype, device="meta")).dtype
    except RuntimeError as e:
        raise NotImplementedError(f"map_reduce_staged body: {_name(func)} of {dtype}: "
                                  f"{e}") from None


# (func, op, each argument's dtype or Python type) -> (dtype, compute dtype)
_RESULT_DTYPES: dict = {}


def _result_dtypes(func, op, args) -> Tuple[torch.dtype, torch.dtype]:
    """The dtype of ``func`` on ``args`` and the dtype it computes in, from
    PyTorch's meta kernels; memoised on the argument dtypes and scalar types,
    since a scalar's value never changes a result type."""
    key = (func, op, tuple(a.dtype if isinstance(a, Sym) else type(a) for a in args))
    hit = _RESULT_DTYPES.get(key)
    if hit is None:
        metas = [_meta(a) for a in args]
        dtype = (torch.clamp(*metas) if op == "clamp" else func(*metas)).dtype
        compute = dtype
        if op in _COMPARE or op in ("and", "or", "xor"):
            compute = torch.result_type(*metas)
        hit = _RESULT_DTYPES[key] = (dtype, compute)
    return hit


def _check_dtype(dt, what):
    if dt not in _CTYPES:
        raise NotImplementedError(f"for_each body: dtype {dt} (from {what}) is outside the "
                                  f"vocabulary; have {[str(d) for d in DTYPES]}")


def _cast(x, dtype):
    _check_dtype(dtype, "cast")
    if isinstance(x, Sym):
        return x.graph.add(Node("cast", (x.idx,), dtype, dtype,
                                x.graph.nodes[x.idx].scalar))
    raise NotImplementedError("for_each body: cast of a non-traced value")


def special(name: str, x):
    """A vector-math core as one node (``SPECIALS``): the result has x's
    float dtype."""
    if name not in SPECIALS:
        raise NotImplementedError(f"unknown vector-math core {name}")
    if x.dtype not in FLOATS:
        raise TypeError(f"{name}: takes a float tensor, got {x.dtype}")
    return x.graph.add(Node(name, (x.idx,), x.dtype, x.dtype, x.graph.nodes[x.idx].scalar))


def is_traced(x) -> bool:
    return isinstance(x, Sym)


def _key_arg(a):
    if isinstance(a, tuple):  # ("c", scalar): 1, 1.0 and True, or 0.0 and -0.0, differ
        v = a[1]
        return ("c", type(v).__name__, v.hex() if isinstance(v, float) else v)
    return a


@dataclasses.dataclass(eq=False)
class Traced:
    """A traced body. Two traces are equal when their graphs are: the
    same ops on the same dtypes with the same constants, so a plan memoised
    on a trace is the plan of every body that traces the same."""

    graph: Graph
    in_dtypes: Tuple[torch.dtype, ...]
    outputs: Tuple[int, ...]           # node ids

    def __post_init__(self):
        self.key = (tuple((n.op, tuple(_key_arg(a) for a in n.args), n.dtype, n.compute,
                           n.scalar) for n in self.graph.nodes), self.outputs)

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, Traced) and self.key == other.key

    @property
    def out_dtypes(self) -> Tuple[torch.dtype, ...]:
        return tuple(self.graph.nodes[i].dtype for i in self.outputs)


def trace(fn: Callable, in_dtypes: Sequence[torch.dtype], multi: bool = False) -> Traced:
    """Run ``fn`` over one symbolic value per operand; ``multi``: fn returns
    a tuple of values (for_each_multi), else one value."""
    if not 1 <= len(in_dtypes) <= MAX_IN:
        raise ValueError(f"for_each takes 1 to {MAX_IN} operands, got {len(in_dtypes)}")
    g = Graph()
    syms = []
    for dt in in_dtypes:
        _check_dtype(dt, "an operand")
        syms.append(g.add(Node("input", (len(syms),), dt, dt)))
    out = fn(*syms)
    if multi:
        if not isinstance(out, (tuple, list)):
            raise TypeError("for_each_multi fn must return a tuple of blocks")
        outs = tuple(out)
        if not 1 <= len(outs) <= MAX_OUT:
            raise ValueError(f"for_each_multi: 1 to {MAX_OUT} outputs, got {len(outs)}")
    else:
        outs = (out,)
    for o in outs:
        if not isinstance(o, Sym):
            raise TypeError("the body must return values computed from its operands, "
                            f"got {type(o).__name__}")
    return Traced(g, tuple(in_dtypes), tuple(o.idx for o in outs))


# -- what a body can read: a key for memoising its trace -----------------------

class _Unkeyable(Exception):
    """A body reads a value ``body_key`` cannot key (one whose state may
    change between calls unseen)."""


# opcodes that look a name up as a global (or builtin), and as an attribute
_GLOBAL_OPS = frozenset({"LOAD_GLOBAL", "LOAD_NAME", "LOAD_FROM_DICT_OR_GLOBALS"})
_ATTR_OPS = frozenset({"LOAD_ATTR", "LOAD_METHOD", "LOAD_SUPER_ATTR"})
# opcodes after which a key cannot say what the body reads: an import (a
# module the key has not seen), a store to a global, an attribute, a name or
# a cell (a memoised call would skip the store)
_UNKEYED_OPS = frozenset({"IMPORT_NAME", "IMPORT_FROM", "STORE_GLOBAL", "DELETE_GLOBAL",
                          "STORE_ATTR", "DELETE_ATTR", "STORE_NAME", "DELETE_NAME",
                          "STORE_DEREF", "DELETE_DEREF"})
# packages whose functions and classes are kept by identity, as this
# recorder's own functions and the body ops marked by ``body_op`` are
# (their behaviour is the vocabulary); any other Python function or class
# makes the body unkeyable, since what it reads is not searched
_FIXED_PACKAGES = ("builtins", "torch", "numpy")
# compiled callables kept by identity where not bound to an object
_COMPILED = (types.BuiltinFunctionType, types.MethodDescriptorType,
             types.WrapperDescriptorType, types.MethodWrapperType)
# builtins that look a value up by a name the code does not hold
_DYNAMIC = frozenset(map(id, (getattr, hasattr, setattr, delattr, vars, globals, locals,
                              eval, exec, compile, __import__, dir)))
_SCALARS = (bool, int, str, bytes, type(None), torch.dtype, torch.device)
_MISSING = object()


@functools.lru_cache(maxsize=1024)
def _code_reads(code: types.CodeType) -> Optional[Tuple[Tuple[str, ...], Tuple[str, ...]]]:
    """(the global names, the attribute names) a code object and the code
    nested in it (lambdas, comprehensions) look up; None where it imports
    or stores a global, an attribute, a name or a cell."""
    glob, attr = set(), set()
    for ins in dis.get_instructions(code):
        if ins.opname in _GLOBAL_OPS:
            glob.add(ins.argval)
        elif ins.opname in _ATTR_OPS:
            attr.add(ins.argval)
        elif ins.opname in _UNKEYED_OPS:
            return None
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            inner = _code_reads(c)
            if inner is None:
                return None
            glob.update(inner[0])
            attr.update(inner[1])
    return tuple(sorted(glob)), tuple(sorted(attr))


def body_op(f: Callable) -> Callable:
    """Mark ``f`` a body op: what it records depends on its operands only,
    so ``body_key`` keeps it by identity."""
    f._ltt_body_op = True
    return f


def _fixed(v) -> bool:
    """A function or class of this recorder, torch, numpy or the builtins,
    or a body op."""
    mod = getattr(v, "__module__", None) or ""
    return (mod == __name__ or mod.split(".")[0] in _FIXED_PACKAGES
            or getattr(v, "_ltt_body_op", False) is True)


def _value_key(v, spaces: list):
    """The key of a value the body reads; a module is kept by identity and
    put on ``spaces``, for its attributes to be keyed."""
    t = type(v)
    if t is float:  # 0.0 and -0.0 differ, and 1.0 and 1
        return ("f", v.hex())
    if t is complex:
        return ("c", v.real.hex(), v.imag.hex())
    if t in _SCALARS:
        return (t, v)
    if t is tuple:
        return ("t",) + tuple(_value_key(x, spaces) for x in v)
    if t is types.ModuleType:
        spaces.append(v)
        return ("o", v)
    if isinstance(v, _COMPILED):
        if id(v) in _DYNAMIC or not isinstance(getattr(v, "__self__", None),
                                              (types.ModuleType, type(None))):
            raise _Unkeyable
        return ("o", v)
    if isinstance(v, (types.FunctionType, type)) and _fixed(v):
        return ("o", v)
    raise _Unkeyable


def _fn_key(fn: types.FunctionType, reads) -> tuple:
    glob, attr = reads
    spaces: list = []
    try:
        cells = tuple(_value_key(c.cell_contents, spaces) for c in fn.__closure__ or ())
    except ValueError:  # an empty cell
        raise _Unkeyable from None
    dflt = _value_key(fn.__defaults__ or (), spaces)
    kw = tuple(sorted((k, _value_key(v, spaces)) for k, v in (fn.__kwdefaults__ or {}).items()))
    found = []
    for name in glob:
        v = fn.__globals__.get(name, _MISSING)
        if v is _MISSING:
            v = fn.__builtins__.get(name, _MISSING)
        if v is _MISSING:
            raise _Unkeyable  # defined later, or the trace raises NameError
        found.append((name, _value_key(v, spaces)))
    # the attributes the code may read of the modules it reaches (a
    # module's constant), and of the modules among those, in turn
    seen = set()
    while spaces:
        ns = spaces.pop()
        if id(ns) in seen:
            continue
        seen.add(id(ns))
        for name in attr:
            v = getattr(ns, name, _MISSING)
            if v is not _MISSING:
                found.append((ns, name, _value_key(v, spaces)))
    return (fn.__code__, cells, dflt, kw, tuple(found))


def body_key(fn: Callable) -> Optional[tuple]:
    """A hashable key of everything the trace of ``fn`` can depend on
    besides its operands' dtypes: its code, the values in its closure cells
    and defaults, the values of the globals and builtins its code names, and
    of the attributes it names of the modules it reaches. None (the body is
    then traced on every call) where it reads anything else: an object, a
    list, a dict, a bound method, a class or Python function of its own
    (what those read is not searched), or where it imports or stores a
    global, an attribute or a cell. Two calls with equal keys trace the same, so a
    plan memoised on the key is this call's plan, a changed global or
    closure constant included."""
    if not isinstance(fn, types.FunctionType):
        return None
    code = fn.__code__
    reads = _code_reads(code)
    if reads is None:
        return None
    if (fn.__closure__ is None and fn.__defaults__ is None and fn.__kwdefaults__ is None
            and reads == ((), ())):
        return code  # reads nothing but its operands and constants
    try:
        return _fn_key(fn, reads)
    except _Unkeyable:
        return None


REDUCTIONS = ("rsum", "rmean", "rmax", "rmin")
MAX_LEAVES = 16  # csrc/foreach.cuh kMaxLeaves


def _leaf_syms(leaves, what: str) -> Tuple[int, ...]:
    if not 1 <= len(leaves) <= MAX_LEAVES:
        raise ValueError(f"{what}: 1 to {MAX_LEAVES} accumulator leaves, got {len(leaves)}")
    for leaf in leaves:
        if not isinstance(leaf, Sym):
            raise TypeError(f"{what}: every accumulator leaf is a value computed from the "
                            f"block, got {type(leaf).__name__}")
    return tuple(leaf.idx for leaf in leaves)


def trace_staged(block_fn: Callable, in_dtypes: Sequence[torch.dtype], block_shape,
                 make_ctx: Callable):
    """Run a map_reduce_staged ``block_fn(ctx, *blocks)`` over one symbolic
    block of ``block_shape``; ``make_ctx(valid, offset, width, flat_index)``
    builds its context from those four nodes. Returns (the trace,
    whose outputs are the accumulator's leaves, and the pytree spec)."""
    if not 1 <= len(in_dtypes) <= MAX_IN:
        raise ValueError(f"map_reduce_staged takes 1 to {MAX_IN} operands, got {len(in_dtypes)}")
    g = Graph(block_shape=tuple(block_shape))
    syms = []
    for dt in in_dtypes:
        _check_dtype(dt, "an operand")
        syms.append(g.add(Node("input", (len(syms),), dt, dt)))
    i64 = torch.int64
    valid = g.add(Node("valid", (), torch.bool, torch.bool))
    ids = g.add(Node("flat_index", (), i64, i64))
    offset = g.add(Node("offset", (), i64, i64, True))
    width = g.add(Node("width", (), i64, i64, True))
    out = block_fn(make_ctx(valid, offset, width, ids), *syms)
    leaves, spec = pytree.tree_flatten(out)
    idx = _leaf_syms(leaves, "map_reduce_staged block_fn")
    for leaf in leaves:
        if not g.nodes[leaf.idx].scalar:
            raise ValueError("map_reduce_staged accumulator leaves must be scalars, got "
                             f"shape {tuple(leaf.shape)}")
    return Traced(g, tuple(in_dtypes), idx), spec


def trace_combine(combine: Callable, spec, leaf_dtypes: Sequence[torch.dtype]) -> Traced:
    """Run ``combine(a, b)`` over two accumulators of symbolic scalars with
    the pytree ``spec``; inputs 0..L-1 are a's leaves, L..2L-1 b's."""
    g = Graph()
    syms = [g.add(Node("input", (k,), dt, dt, True))
            for k, dt in enumerate(tuple(leaf_dtypes) * 2)]
    n = len(leaf_dtypes)
    out = combine(pytree.tree_unflatten(syms[:n], spec), pytree.tree_unflatten(syms[n:], spec))
    leaves, out_spec = pytree.tree_flatten(out)
    if out_spec != spec:
        raise ValueError(f"map_reduce_staged combine returned {out_spec}, the accumulator "
                         f"is {spec}")
    return Traced(g, tuple(leaf_dtypes) * 2, _leaf_syms(leaves, "map_reduce_staged combine"))


def trace_finish(finish: Callable, spec, leaf_dtypes: Sequence[torch.dtype]):
    """Run ``finish(acc)`` over one accumulator of symbolic scalars with the
    pytree ``spec`` (inputs 0..L-1 its leaves). Returns (the trace, whose
    outputs are the result's leaves, and the result's pytree spec)."""
    g = Graph()
    syms = [g.add(Node("input", (k,), dt, dt, True)) for k, dt in enumerate(leaf_dtypes)]
    leaves, out_spec = pytree.tree_flatten(finish(pytree.tree_unflatten(syms, spec)))
    return Traced(g, tuple(leaf_dtypes), _leaf_syms(leaves, "map_reduce_staged finish")), out_spec


# ---------------------------------------------------------------------------
# Emission
# ---------------------------------------------------------------------------

def _vtype(dt):
    return _CTYPES[dt][1]


def _lit(value, dt) -> str:
    """A Python scalar as a C literal of dtype ``dt``'s value type."""
    if dt in FLOATS:
        v = float(torch.tensor(float(value), dtype=torch.float32).item())
        if math.isnan(v):
            return "NAN"
        if math.isinf(v):
            return "INFINITY" if v > 0 else "(-INFINITY)"
        return f"{v.hex()}f"
    if dt == torch.bool:
        return "true" if value else "false"
    return f"static_cast<{_vtype(dt)}>({int(value)}LL)"


def _round(expr: str, dt) -> str:
    """Round an f32 expression to dtype ``dt`` (bf16/f16), held as float."""
    if dt == torch.bfloat16:
        return f"ltt::round_through<__nv_bfloat16>({expr})"
    if dt == torch.float16:
        return f"ltt::round_through<__half>({expr})"
    return expr


def _conv(expr: str, src, dst) -> str:
    """Convert a value of dtype ``src`` to dtype ``dst`` (PyTorch's cast)."""
    if src == dst:
        return expr
    if dst in FLOATS:
        if src in FLOATS:
            return _round(expr, dst)  # f32 value to bf16/f16, or exact widening
        return _round(f"static_cast<float>({expr})", dst)
    if dst == torch.bool:
        return f"({expr} != 0)"
    return f"static_cast<{_vtype(dst)}>({expr})"


class _Emitter:
    def __init__(self, traced: Traced):
        self.t = traced
        self.nodes = traced.graph.nodes

    def val(self, a, dt) -> str:
        """Argument ``a`` (node id or constant) as a value of dtype ``dt``."""
        if isinstance(a, tuple):
            return _lit(a[1], dt)
        return _conv(f"v{a}", self.nodes[a].dtype, dt)

    def expr(self, n: Node) -> str:
        op, a, dt, c = n.op, n.args, n.dtype, n.compute
        if op == "cast":
            return _conv(f"v{a[0]}", self.nodes[a[0]].dtype, dt)
        if op in SPECIALS:
            x = self.val(a[0], torch.float32)
            st = _CTYPES[dt][0]
            f = f"ltt::vm::{op}<{st}>({x})" if SPECIALS[op] else f"ltt::vm::{op}({x})"
            return _round(f, dt)
        if op in _COMPARE:
            return f"({self.val(a[0], c)} {_COMPARE[op]} {self.val(a[1], c)})"
        if op in ("isnan", "isinf", "isfinite"):
            src = self.nodes[a[0]].dtype
            if src not in FLOATS:
                return "true" if op == "isfinite" else "false"
            return f"{op}({self.val(a[0], torch.float32)})"
        if op == "where":
            return (f"({self.val(a[0], torch.bool)} ? {self.val(a[1], dt)} : "
                    f"{self.val(a[2], dt)})")
        if op == "not":
            x = self.val(a[0], dt)
            return f"(!{x})" if dt == torch.bool else f"static_cast<{_vtype(dt)}>(~{x})"
        if op in ("and", "or", "xor"):
            sym = {"and": "&", "or": "|", "xor": "^"}[op]
            return f"static_cast<{_vtype(dt)}>({self.val(a[0], c)} {sym} {self.val(a[1], c)})"
        if c in FLOATS:
            return _round(self.float_expr(op, a, c), dt)
        return self.int_expr(op, a, dt)

    def float_expr(self, op, a, c) -> str:
        if op in _UNARY_F:
            return _UNARY_F[op].format(a=self.val(a[0], torch.float32))
        x = self.val(a[0], c)
        if op == "neg":
            return f"(-{x})"
        if op == "abs":
            return f"fabsf({x})"
        if op == "relu":
            return f"ltt::max_nan({x}, 0.f)"
        if op == "clamp":
            e = x
            if a[1] is not None:
                e = f"ltt::max_nan({e}, {self.val(a[1], c)})"
            if a[2] is not None:
                e = f"ltt::min_nan({e}, {self.val(a[2], c)})"
            return e
        y = self.val(a[1], c)
        if op == "add":
            return f"__fadd_rn({x}, {y})"
        if op == "sub":
            return f"__fsub_rn({x}, {y})"
        if op == "mul":
            return f"__fmul_rn({x}, {y})"
        if op == "div":
            return f"__fdiv_rn({x}, {y})"
        if op == "maximum":
            return f"ltt::max_nan({x}, {y})"
        if op == "minimum":
            return f"ltt::min_nan({x}, {y})"
        if op == "pow":
            # PyTorch's own shortcuts for these scalar exponents
            if isinstance(a[1], tuple) and not isinstance(a[0], tuple):
                e = float(a[1][1])
                special = {2.0: f"__fmul_rn({x}, {x})",
                           3.0: f"__fmul_rn(__fmul_rn({x}, {x}), {x})",
                           0.5: f"__fsqrt_rn({x})", -0.5: f"__fdiv_rn(1.f, __fsqrt_rn({x}))",
                           -1.0: f"__fdiv_rn(1.f, {x})",
                           -2.0: f"__fdiv_rn(1.f, __fmul_rn({x}, {x}))",
                           1.0: x, 0.0: "1.f"}
                if e in special:
                    return special[e]
            return f"powf({x}, {y})"
        raise NotImplementedError(f"for_each body: {op} on floats")

    def int_expr(self, op, a, dt) -> str:
        vt = _vtype(dt)
        x = self.val(a[0], dt)
        if op == "neg":
            return f"static_cast<{vt}>(-static_cast<int64_t>({x}))"
        if op == "abs":
            return f"static_cast<{vt}>({x} < 0 ? -static_cast<int64_t>({x}) : {x})"
        if op == "relu":
            return f"({x} > 0 ? {x} : static_cast<{vt}>(0))"
        if op in ("floor", "ceil", "round", "trunc"):
            return x
        if op == "clamp":
            e = x
            if a[1] is not None:
                e = f"ltt::max_nan<{vt}>({e}, {self.val(a[1], dt)})"
            if a[2] is not None:
                e = f"ltt::min_nan<{vt}>({e}, {self.val(a[2], dt)})"
            return e
        y = self.val(a[1], dt)
        if op in ("add", "sub", "mul"):
            sym = {"add": "+", "sub": "-", "mul": "*"}[op]
            return (f"static_cast<{vt}>(static_cast<uint64_t>({x}) {sym} "
                    f"static_cast<uint64_t>({y}))")
        if op == "maximum":
            return f"ltt::max_nan<{vt}>({x}, {y})"
        if op == "minimum":
            return f"ltt::min_nan<{vt}>({x}, {y})"
        raise NotImplementedError(f"for_each body: {op} on {dt}")

    def body(self, outputs: Sequence[Tuple[int, torch.dtype]]) -> List[str]:
        """Statements computing every node that the outputs need, then each
        output cast to its dtype into o<k>."""
        need = set()
        stack = [i for i, _ in outputs]
        while stack:
            i = stack.pop()
            if i in need:
                continue
            need.add(i)
            stack.extend(x for x in self.nodes[i].args if isinstance(x, int)
                         and self.nodes[i].op != "input")
        lines = []
        for i, n in enumerate(self.nodes):
            if i in need and n.op != "input":
                lines.append(f"const {_vtype(n.dtype)} v{i} = {self.expr(n)};")
        for k, (i, dt) in enumerate(outputs):
            lines.append(f"o{k} = {_conv(f'v{i}', self.nodes[i].dtype, dt)};")
        return lines


def _load_expr(storage_expr: str, dt) -> str:
    if dt in (torch.bfloat16, torch.float16):
        return f"ltt::to_f32({storage_expr})"
    if dt == torch.bool:
        return f"({storage_expr} != 0)"
    return storage_expr


def _store_expr(value: str, dt) -> str:
    if dt in (torch.bfloat16, torch.float16):
        return f"ltt::from_f32<{_CTYPES[dt][0]}>({value})"
    if dt == torch.bool:
        return f"static_cast<uint8_t>({value})"
    return value


def acc_ctype(dt) -> str:
    """The accumulator's C type for a reduction in dtype ``dt``: f32 for
    floats, int32 for integers up to 32 bits, int64."""
    if dt in FLOATS:
        return "float"
    if dt == torch.int64:
        return "int64_t"
    if dt == torch.bool:
        raise NotImplementedError("reductions over bool values are outside the vocabulary")
    return "int32_t"


def vec_width(dtypes) -> int:
    """Elements per thread step of the templates (kVec): 16 bytes over the
    smallest element size, so every operand moves in whole 16-byte words."""
    return 16 // min(torch.empty((), dtype=d).element_size() for d in dtypes)


def _header(kind: str) -> List[str]:
    return [f"// {kind} body generated by laser_tpu_torch/ops/codegen.py from a traced",
            "// torch callable; the template is csrc/foreach.cuh.",
            '#include "foreach.cuh"', "", "namespace {", "", "struct Body {"]


def _elem(em: _Emitter, in_dtypes, out_vtypes, outputs, name: str = "elem") -> List[str]:
    params = ", ".join([f"const {_vtype(d)} v{i}" for i, d in enumerate(in_dtypes)] +
                       [f"{vt}& o{k}" for k, vt in enumerate(out_vtypes)])
    return ([f"  __device__ __forceinline__ static void {name}({params}) {{"] +
            [f"    {s}" for s in em.body(outputs)] + ["  }"])


def _loads(in_dtypes, vec: bool, strided: bool = False) -> Tuple[List[str], List[str]]:
    """(statements, argument expressions) loading every operand: at element
    ``i``, or with ``strided`` at its own element offset ``off[k]``."""
    at = [f"off[{i}]" if strided else "i" for i in range(len(in_dtypes))]
    if vec:
        lines = [f"    ltt::Vec<{_CTYPES[d][0]}, V> x{i}; x{i}.load(a.in[{i}], {at[i]});"
                 for i, d in enumerate(in_dtypes)]
        return lines, [_load_expr(f"x{i}[k]", d) for i, d in enumerate(in_dtypes)]
    return [], [_load_expr(f"static_cast<const {_CTYPES[d][0]}*>(a.in[{i}])[{at[i]}]", d)
                for i, d in enumerate(in_dtypes)]


def emit_for_each(traced: Traced, out_dtypes: Sequence[torch.dtype],
                  strided: bool = False) -> str:
    """The source of a for_each / for_each_multi body: output k is traced
    output k cast to ``out_dtypes[k]``. ``strided``: the body of the strided
    template, whose operand k is read at its own element offset ``off[k]``
    (the outputs are dense, written at ``i``)."""
    ins = traced.in_dtypes
    for d in out_dtypes:
        _check_dtype(d, "an output")
    em = _Emitter(traced)
    outs = list(zip(traced.outputs, out_dtypes))
    V = vec_width(list(ins) + list(out_dtypes))
    L = _header("strided for_each" if strided else "for_each")
    L += [f"  static constexpr int kIn = {len(ins)}, kOut = {len(outs)}, kVec = {V};"]
    L += _elem(em, ins, [_vtype(d) for d in out_dtypes], outs)
    decl = [f"      {_vtype(d)} o{k};" for k, d in enumerate(out_dtypes)]
    call_o = [f"o{k}" for k in range(len(outs))]
    sfx, off = ("_at", ", const int64_t (&off)[kIn]") if strided else ("", "")
    lv, av = _loads(ins, True, strided)
    L += ["  template <int V>",
          f"  __device__ __forceinline__ static void apply_vec{sfx}(const ltt::PtrArgs& a{off}, "
          "int64_t i) {"]
    L += lv
    L += [f"    ltt::Vec<{_CTYPES[d][0]}, V> y{k};" for k, d in enumerate(out_dtypes)]
    L += ["#pragma unroll", "    for (int k = 0; k < V; ++k) {"] + decl
    L += [f"      elem({', '.join(av + call_o)});"]
    L += [f"      y{k}[k] = {_store_expr(f'o{k}', d)};" for k, d in enumerate(out_dtypes)]
    L += ["    }"] + [f"    y{k}.store(a.out[{k}], i);" for k in range(len(outs))] + ["  }"]
    _, a1 = _loads(ins, False, strided)
    L += [f"  __device__ __forceinline__ static void apply1{sfx}(const ltt::PtrArgs& a{off}, "
          "int64_t i) {"]
    L += [f"    {_vtype(d)} o{k};" for k, d in enumerate(out_dtypes)]
    L += [f"    elem({', '.join(a1 + call_o)});"]
    L += [f"    static_cast<{_CTYPES[d][0]}*>(a.out[{k}])[i] = {_store_expr(f'o{k}', d)};"
          for k, d in enumerate(out_dtypes)]
    L += ["  }"]
    if strided:
        L += _tiled(ins, out_dtypes)
    entry = "LTT_FOR_EACH_STRIDED_ENTRY" if strided else "LTT_FOR_EACH_ENTRY"
    L += ["};", "", "}  // namespace", "", f"{entry}(Body)", ""]
    return "\n".join(L)


def _tiled(ins, out_dtypes) -> List[str]:
    """The strided template's tiled route: each operand's element size,
    the registers of one item (V elements of every operand; V = 1 one
    element), a load of them at the operands' offsets and the body over
    them with the store of the dense output at ``i``. The kernel loads
    several items before it runs the body on any."""
    sizes = ", ".join(str(torch.empty((), dtype=d).element_size()) for d in ins)
    L = [f"  static constexpr int kSize[kIn] = {{{sizes}}};",
         "  template <int V> struct Regs {"]
    L += [f"    ltt::Lane<{_CTYPES[d][0]}, V> x{i};" for i, d in enumerate(ins)]
    L += ["  };", "  template <int V, typename I>",
          "  __device__ __forceinline__ static void load(Regs<V>& r, const ltt::PtrArgs& a, "
          "const I (&off)[kIn]) {"]
    L += [f"    r.x{i}.load(a.in[{i}], off[{i}]);" for i in range(len(ins))]
    L += ["  }", "  template <int V, typename I>",
          "  __device__ __forceinline__ static void store(Regs<V>& r, const ltt::PtrArgs& a, "
          "I i) {"]
    L += [f"    ltt::Lane<{_CTYPES[d][0]}, V> y{k};" for k, d in enumerate(out_dtypes)]
    L += ["#pragma unroll", "    for (int k = 0; k < V; ++k) {"]
    L += [f"      {_vtype(d)} o{k};" for k, d in enumerate(out_dtypes)]
    args = [_load_expr(f"r.x{i}[k]", d) for i, d in enumerate(ins)]
    L += [f"      elem({', '.join(args + [f'o{k}' for k in range(len(out_dtypes))])});"]
    L += [f"      y{k}[k] = {_store_expr(f'o{k}', d)};" for k, d in enumerate(out_dtypes)]
    L += ["    }"] + [f"    y{k}.store(a.out[{k}], i);" for k in range(len(out_dtypes))]
    return L + ["  }"]


REDUCE_OPS = {"sum": 0, "min": 1, "max": 2}


def emit_reduce(traced: Traced, kind: str, op: str, value_dtype, identity,
                out_dtype) -> str:
    """The source of a row_reduce (``kind`` "row_reduce") or map_reduce
    ("map_reduce") body: the traced output cast to ``value_dtype`` (the
    mapped dtype, or acc_dtype), folded with ``op`` in its accumulator type
    from ``identity``; the result is rounded to ``value_dtype`` and stored
    as ``out_dtype`` (row_reduce's output, map_reduce's accumulator)."""
    ins = traced.in_dtypes
    _check_dtype(value_dtype, "the mapped value")
    _check_dtype(out_dtype, "the result")
    acc = acc_ctype(value_dtype)
    em = _Emitter(traced)
    V = vec_width(ins)
    L = _header(kind)
    L += [f"  static constexpr int kIn = {len(ins)}, kOut = 0, kVec = {V};",
          f"  static constexpr int kOp = {REDUCE_OPS[op]};",
          f"  using acc_t = {acc};",
          "  __device__ __forceinline__ static acc_t identity() { return "
          f"{_acc_lit(identity, value_dtype, acc)}; }}"]
    L += _elem(em, ins, [_vtype(value_dtype)], [(traced.outputs[0], value_dtype)])
    lv, av = _loads(ins, True)
    L += ["  template <int V>",
          "  __device__ __forceinline__ static void map_vec(const ltt::PtrArgs& a, int64_t i,",
          "                                                acc_t (&m)[V]) {"]
    L += lv
    L += ["#pragma unroll", "    for (int k = 0; k < V; ++k) {",
          f"      {_vtype(value_dtype)} o0;", f"      elem({', '.join(av + ['o0'])});",
          "      m[k] = static_cast<acc_t>(o0);", "    }", "  }"]
    _, a1 = _loads(ins, False)
    L += ["  __device__ __forceinline__ static acc_t map1(const ltt::PtrArgs& a, int64_t i) {",
          f"    {_vtype(value_dtype)} o0;", f"    elem({', '.join(a1 + ['o0'])});",
          "    return static_cast<acc_t>(o0);", "  }"]
    # the accumulator rounded (or wrapped) to the value dtype, then cast to
    # the stored one
    v = _round("v", value_dtype) if value_dtype in FLOATS else \
        f"static_cast<{_vtype(value_dtype)}>(v)"
    stored = _store_expr(_conv(f"({v})", value_dtype, out_dtype), out_dtype)
    name = "store_out" if kind == "row_reduce" else "store_acc"
    L += [f"  __device__ __forceinline__ static void {name}(void* p, int64_t i, acc_t v) {{",
          f"    static_cast<{_CTYPES[out_dtype][0]}*>(p)[i] = {stored};", "  }"]
    entry = "LTT_ROW_REDUCE_ENTRY" if kind == "row_reduce" else "LTT_MAP_REDUCE_ENTRY"
    L += ["};", "", "}  // namespace", "", f"{entry}(Body)", ""]
    return "\n".join(L)


def _acc_lit(identity, dt, acc) -> str:
    if acc == "float":
        return _lit(identity, torch.float32)
    info = torch.iinfo(dt)
    if isinstance(identity, float) and math.isinf(identity):
        v = info.max if identity > 0 else info.min
    else:
        v = int(max(min(int(identity), info.max), info.min))
    return f"static_cast<{acc}>({v}LL)"


# ---------------------------------------------------------------------------
# map_reduce_staged: the block body and the combine
# ---------------------------------------------------------------------------

_RED_OP = {"rsum": "ltt::kSum", "rmean": "ltt::kSum", "rmax": "ltt::kMax", "rmin": "ltt::kMin"}


def _red_acc(n: Node) -> torch.dtype:
    """The dtype a reduction folds in: f32 for floats, int64 for integer
    sums, int32 or int64 for integer and bool min/max."""
    if n.compute in FLOATS:
        return torch.float32
    if n.op in ("rsum", "rmean") or n.compute == torch.int64:
        return torch.int64
    return torch.int32


def _red_identity(n: Node, acc) -> str:
    if n.op in ("rsum", "rmean"):
        return "0.f" if acc == torch.float32 else "int64_t{0}"
    big = n.op == "rmin"
    if acc == torch.float32:
        return "INFINITY" if big else "(-INFINITY)"
    bits = 64 if acc == torch.int64 else 32
    return f"INT{bits}_MAX" if big else f"INT{bits}_MIN"


def _levels(nodes: Sequence[Node]) -> List[int]:
    """How many reductions lie on each node's longest path: a reduction of
    level s runs in sweep s, after every scalar of a lower level."""
    level = []
    for n in nodes:
        args = [a for a in n.args if isinstance(a, int)] if n.op != "input" else []
        level.append(max((level[a] for a in args), default=0) + (n.op in REDUCTIONS))
    return level


def _reach(nodes, roots, through) -> set:
    """Nodes reachable from ``roots`` over argument edges, entering only
    nodes for which ``through(i)`` holds (the roots always)."""
    seen, stack = set(), list(roots)
    while stack:
        i = stack.pop()
        if i in seen:
            continue
        seen.add(i)
        if nodes[i].op != "input":
            stack.extend(a for a in nodes[i].args if isinstance(a, int) and through(a))
    return seen


def emit_staged(block: Traced, combine: Traced, leaf_dtypes: Sequence[torch.dtype],
                finish: Optional[Traced] = None) -> str:
    """The source of a map_reduce_staged body for the staged template of
    csrc/foreach.cuh: ``block`` turns one block of kStagedGrain elements
    (held in registers, kStagedPer per thread) into the accumulator's
    leaves, one sweep over the registers per reduction level; ``combine``
    merges two accumulators; ``finish`` (None: the identity) turns the
    final accumulator into the stored results."""
    nodes = block.graph.nodes
    ins = block.in_dtypes
    level = _levels(nodes)
    need = _reach(nodes, block.outputs, lambda a: True)
    em = _Emitter(block)
    out_dtypes = leaf_dtypes if finish is None else finish.out_dtypes
    L = _header("map_reduce_staged")
    L += [f"  static constexpr int kIn = {len(ins)}, kLeaves = {len(leaf_dtypes)}, "
          f"kOut = {len(out_dtypes)};",
          "  struct Acc {"] + \
         [f"    {_vtype(d)} l{j};" for j, d in enumerate(leaf_dtypes)] + ["  };"]
    # the block: loads into registers, then the sweeps; it returns the leaves
    # as the partials hold them (rounded to each leaf's storage type)
    L += ["  __device__ __forceinline__ static Acc block(const ltt::StagedArgs& a, int64_t n,",
          "                                            int64_t tile, unsigned char* red) {",
          "    const int64_t base = tile * ltt::kStagedGrain;"]
    L += [f"    {_vtype(d)} x{k}[ltt::kStagedPer];" for k, d in enumerate(ins)]
    L += ["#pragma unroll", "    for (int e = 0; e < ltt::kStagedPer; ++e) {",
          "      const int64_t p = base + static_cast<int64_t>(e) * ltt::kStagedThreads + "
          "threadIdx.x;"]
    L += [f"      x{k}[e] = p < n ? "
          f"{_load_expr(f'static_cast<const {_CTYPES[d][0]}*>(a.in[{k}])[p]', d)} : "
          f"{_lit(0, d)};" for k, d in enumerate(ins)]
    L += ["    }"]

    def scalars(s):
        out = []
        for i, nd in enumerate(nodes):
            if i not in need or not nd.scalar or level[i] != s or nd.op in REDUCTIONS:
                continue
            if nd.op == "offset":
                out.append(f"    const int64_t v{i} = base;")
            elif nd.op == "width":
                out.append(f"    const int64_t v{i} = ltt::kStagedGrain;")
            else:
                out.append(f"    const {_vtype(nd.dtype)} v{i} = {em.expr(nd)};")
        return out

    L += scalars(0)
    for s in range(1, max((level[i] for i in need), default=0) + 1):
        reds = [i for i in sorted(need) if nodes[i].op in REDUCTIONS and level[i] == s]
        elems = _reach(nodes, [nodes[r].args[0] for r in reds], lambda a: not nodes[a].scalar)
        elems = {i for i in elems if not nodes[i].scalar}
        L += [f"    // sweep {s}: {', '.join(f'{nodes[r].op} v{r}' for r in reds)}"]
        L += [f"    {_vtype(_red_acc(nodes[r]))} r{r} = {_red_identity(nodes[r], _red_acc(nodes[r]))};"
              for r in reds]
        L += ["#pragma unroll", "    for (int e = 0; e < ltt::kStagedPer; ++e) {",
              "      const int64_t p = base + static_cast<int64_t>(e) * ltt::kStagedThreads + "
              "threadIdx.x;"]
        for i in sorted(elems):
            nd = nodes[i]
            if nd.op == "input":
                rhs = f"x{nd.args[0]}[e]"
            elif nd.op == "valid":
                rhs = "p < n"
            elif nd.op == "flat_index":
                rhs = "p"
            else:
                rhs = em.expr(nd)
            L += [f"      const {_vtype(nd.dtype)} v{i} = {rhs};"]
        for r in reds:
            acc, src = _red_acc(nodes[r]), nodes[r].args[0]
            L += [f"      r{r} = ltt::rcombine<{_RED_OP[nodes[r].op]}>(r{r}, "
                  f"{_conv(f'v{src}', nodes[src].dtype, acc)});"]
        L += ["    }"]
        for r in reds:
            nd, acc = nodes[r], _red_acc(nodes[r])
            v = (f"ltt::block_allreduce<{_RED_OP[nd.op]}>(r{r}, "
                 f"{_red_identity(nd, acc)}, reinterpret_cast<{_vtype(acc)}*>(red))")
            if nd.op == "rmean":
                v = f"__fdiv_rn({v}, static_cast<float>(ltt::kStagedGrain))"
            L += [f"    const {_vtype(nd.dtype)} v{r} = {_conv(v, acc, nd.dtype)};"]
        L += scalars(s)
    L += ["    Acc r;"]
    L += [f"    r.l{j} = {_load_expr(_store_expr(_conv(f'v{i}', nodes[i].dtype, d), d), d)};"
          for j, (i, d) in enumerate(zip(block.outputs, leaf_dtypes))]
    L += ["    return r;", "  }"]
    # the partials and the result, and the combine
    L += ["  __device__ __forceinline__ static void store_partial(const ltt::StagedArgs& a, "
          "int64_t i, const Acc& r) {"]
    L += [f"    static_cast<{_CTYPES[d][0]}*>(a.part[{j}])[i] = {_store_expr(f'r.l{j}', d)};"
          for j, d in enumerate(leaf_dtypes)] + ["  }"]
    L += ["  __device__ __forceinline__ static void load_partial(const ltt::StagedArgs& a, "
          "int64_t i, Acc& r) {"]
    L += [f"    r.l{j} = {_load_expr(f'static_cast<const {_CTYPES[d][0]}*>(a.part[{j}])[i]', d)};"
          for j, d in enumerate(leaf_dtypes)] + ["  }"]
    L += ["  __device__ __forceinline__ static void store_result(const ltt::StagedArgs& a, "
          "const Acc& r) {"]
    if finish is None:
        L += [f"    *static_cast<{_CTYPES[d][0]}*>(a.out[{j}]) = {_store_expr(f'r.l{j}', d)};"
              for j, d in enumerate(leaf_dtypes)]
    else:
        L += [f"    {_vtype(d)} o{j};" for j, d in enumerate(out_dtypes)]
        args = [f"r.l{j}" for j in range(len(leaf_dtypes))] + \
               [f"o{j}" for j in range(len(out_dtypes))]
        L += [f"    finish({', '.join(args)});"]
        L += [f"    *static_cast<{_CTYPES[d][0]}*>(a.out[{j}]) = {_store_expr(f'o{j}', d)};"
              for j, d in enumerate(out_dtypes)]
    L += ["  }"]
    cem = _Emitter(combine)
    L += _elem(cem, combine.in_dtypes, [_vtype(d) for d in leaf_dtypes],
               list(zip(combine.outputs, leaf_dtypes)))
    args = [f"x.l{j}" for j in range(len(leaf_dtypes))] + \
           [f"y.l{j}" for j in range(len(leaf_dtypes))] + \
           [f"r.l{j}" for j in range(len(leaf_dtypes))]
    L += ["  __device__ __forceinline__ static void combine(const Acc& x, const Acc& y, Acc& r) {",
          f"    elem({', '.join(args)});", "  }"]
    if finish is not None:
        L += _elem(_Emitter(finish), finish.in_dtypes, [_vtype(d) for d in out_dtypes],
                   list(zip(finish.outputs, out_dtypes)), name="finish")
    L += ["};", "", "}  // namespace", "", "LTT_STAGED_ENTRY(Body)", ""]
    return "\n".join(L)
