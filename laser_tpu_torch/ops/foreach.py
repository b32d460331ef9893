"""Fused elementwise and map-reduce over a traced body (port of
laser_tpu/ops/foreach.py: ``for_each``, ``for_each_multi``, ``row_reduce``,
``map_reduce``, ``for_each_staged``).

A body is a torch callable over same-shaped blocks, as laser_tpu's is a jnp
callable: ``for_each(lambda x, y, z: x + y - torch.sin(z), a, b, c)``.
Every wrapper first translates the body (``ops/codegen.py``), on every
device, so a body outside the vocabulary raises ``NotImplementedError`` on
the CPU as it would on the card. Then:

- a CPU tensor runs the plain version (``*_reference``): the body evaluated
  eagerly in torch, then a torch reduction;
- a CUDA tensor runs the hand-written template of ``csrc/foreach.cuh``
  filled with the emitted body, built by nvcc at its first use
  (``registry.load_generated``). There is no fallback.

The kernels, with the TPU kernels they replace:

- ``for_each`` (laser_tpu/ops/foreach.py:109) and ``for_each_multi``
  (:172): one grid-stride pass of N operands into K outputs;
- ``row_reduce`` (:219): one block per row, a row of any length;
- ``map_reduce`` (:277, both sites): two launches, per-block partials in a
  fixed order then one block over them, so the result is the same bits run
  after run; with a ``combine_fn`` outside {sum, min, max} (laser_tpu's
  per-block-partials site, :379) the first launch alone, and
  ``combine_fn`` applies to the partials in torch, as laser_tpu applies it
  outside its kernel;
- ``map_reduce_staged`` (:442): one launch; each block of STAGED_GRAIN
  elements held in registers runs the body's block vocabulary (one sweep
  per reduction level) into an accumulator pytree of scalars, each thread
  block merges a fixed chain of blocks' accumulators with the traced
  ``combine`` as it goes, and the one that finishes last merges the chains
  (``route="classic"``: the same order in two launches).

``for_each`` over a TensorView or a non-contiguous tensor runs
``ops/strided.py``'s strided template (laser_tpu/ops/strided.py:222); the
other wrappers materialise such operands first, as laser_tpu does.

What laser_tpu does for the TPU alone, and the port does not:
- ``_native_2d``, ``_flat_width`` and ``_prepare_flat``'s relayout into
  (rows, 128 or 4096) blocks padded with ``pad_value`` or ``identity``
  (foreach.py:36-98). The port walks the flat elements in place, so
  ``pad_value`` is accepted and unused.
- ``row_reduce``'s ``return None`` past a VMEM budget (:240): a block
  streams a row of any length.

``map_reduce`` maps only real elements. laser_tpu maps its padding too, so
where ``map_fn(identity)`` is not the identity its result is off by
n_pad * map_fn(identity) (ROADMAP queue 3, settled in the port's test
``test_map_reduce_padding_vs_laser_tpu``).

Accumulators: a reduction folds floats in f32 (a bf16 or f16 accumulator
dtype is rounded to once, where it is stored; laser_tpu rounds each pairwise
add to it) and integers in int32 or int64, wrapping as torch does. min and
max keep NaN. ``identity`` is the value of an empty reduction and the start
of each thread's fold, so it must be neutral for ``reduce_fn`` (laser_tpu
pads with it on the same assumption).

Not ported, raising ``NotImplementedError``: ``reduce_fn`` outside
{``torch.sum``, ``torch.amin``/``torch.min``, ``torch.amax``/``torch.max``}.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, List, Optional, Sequence

import torch
import torch.utils._pytree as pytree

from .. import registry
from . import codegen, strided

SOURCE = "laser_tpu_torch/csrc/foreach.cuh"
FOR_EACH = registry.kernel("for_each", SOURCE, "laser_tpu/ops/foreach.py:109 for_each")
FOR_EACH_MULTI = registry.kernel("for_each_multi", SOURCE,
                                 "laser_tpu/ops/foreach.py:172 for_each_multi")
ROW_REDUCE = registry.kernel("row_reduce", SOURCE, "laser_tpu/ops/foreach.py:219 row_reduce")
MAP_REDUCE = registry.kernel("map_reduce", SOURCE, "laser_tpu/ops/foreach.py:277 map_reduce")
MAP_REDUCE_STAGED = registry.kernel("map_reduce_staged", SOURCE,
                                    "laser_tpu/ops/foreach.py:442 map_reduce_staged")
MAP_REDUCE_STAGED_ONE = registry.kernel("map_reduce_staged_one", SOURCE,
                                        "laser_tpu/ops/foreach.py:442 map_reduce_staged")

# csrc/foreach.cuh kMaxReduceBlocks and kReduceGrain: the first launch's
# block plan, which the per-block partials of a custom combine_fn follow
REDUCE_MAX_BLOCKS = 4096
REDUCE_GRAIN = 65536
# csrc/foreach.cuh kStagedGrain: the elements of one map_reduce_staged block
# (256 threads holding 16 each in registers)
STAGED_GRAIN = 4096
# the one-launch route's workspace: a 16-byte counter slot (kStagedAccOffset),
# then the fold's accumulators, at most 1024 of 16 leaves of 8 bytes
STAGED_WORK_BYTES = 16 + 1024 * 8 * 16
_REDUCE_FNS = {torch.sum: "sum", torch.amin: "min", torch.min: "min",
               torch.amax: "max", torch.max: "max"}


def reduce_op(fn: Callable) -> str:
    """"sum", "min" or "max" for a reduce_fn of the vocabulary; raises
    otherwise (on every device)."""
    op = _REDUCE_FNS.get(fn)
    if op is None:
        raise NotImplementedError(
            f"reduce_fn {getattr(fn, '__name__', fn)!r} is outside the reduction vocabulary "
            "(torch.sum, torch.amin / torch.min, torch.amax / torch.max)")
    return op


def result_type(dtypes: Sequence[torch.dtype]) -> torch.dtype:
    """The promoted dtype of the operands (laser_tpu: jnp.result_type)."""
    return functools.reduce(torch.promote_types, dtypes)


def _operands(operands, what: str) -> List[torch.Tensor]:
    """The operands as contiguous tensors of one shape on one device: a
    TensorView or a non-contiguous tensor is materialised first, as
    laser_tpu's ``_prepare_flat`` does (foreach.py:70-98)."""
    if not operands:
        raise ValueError(f"{what} needs at least one operand")
    ops = strided.materialized(operands)
    for o in ops:
        if not isinstance(o, torch.Tensor):
            raise TypeError(f"{what}: operands are torch tensors or TensorViews, got "
                            f"{type(o).__name__}")
        if o.shape != ops[0].shape:
            raise ValueError(f"operand shape mismatch: {tuple(o.shape)} vs "
                             f"{tuple(ops[0].shape)}")
        if o.device != ops[0].device:
            raise ValueError(f"{what}: operands on {o.device} and {ops[0].device}")
    return ops


# ---------------------------------------------------------------------------
# Plans: the traced body, its source, and the dtypes around it
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Plan:
    source: str
    out_dtypes: tuple
    value_dtype: Optional[torch.dtype] = None


# The body is traced on every call, so a constant it reads from a closure or
# a global is the value of this call on every device (the CPU route runs it
# eagerly). The emitted plan is memoised on the trace itself (its ops,
# dtypes and constants; a vector-math tier is a node of it), not on the
# body object, and the library on its source text (registry.load_generated).

def _plan_for_each(fn, ops, out_dtypes, multi) -> _Plan:
    traced = codegen.trace(fn, tuple(o.dtype for o in ops), multi=multi)
    return _plan_for_each_cached(traced, None if out_dtypes is None else tuple(out_dtypes),
                                 multi)


@functools.lru_cache(maxsize=512)
def _plan_for_each_cached(traced, out_dtypes, multi) -> _Plan:
    in_dtypes = traced.in_dtypes
    if out_dtypes is None:
        out_dtypes = traced.out_dtypes if multi else (result_type(in_dtypes),)
    if len(out_dtypes) != len(traced.outputs):
        raise ValueError(f"{len(out_dtypes)} out_dtypes for {len(traced.outputs)} outputs")
    return _Plan(codegen.emit_for_each(traced, out_dtypes), out_dtypes)


def _plan_reduce(kind, map_fn, ops, reduce_fn, identity, value_dtype, out_dtype) -> _Plan:
    op = reduce_op(reduce_fn)
    traced = codegen.trace(map_fn, tuple(o.dtype for o in ops))
    return _plan_reduce_cached(kind, traced, op, identity, value_dtype, out_dtype)


@functools.lru_cache(maxsize=512)
def _plan_reduce_cached(kind, traced, op, identity, value_dtype, out_dtype) -> _Plan:
    value_dtype = value_dtype or traced.out_dtypes[0]
    codegen.acc_ctype(value_dtype)  # raises for bool values
    return _Plan(codegen.emit_reduce(traced, kind, op, value_dtype, identity, out_dtype),
                 (out_dtype,), value_dtype)


def for_each_source(fn, *operands, out_dtype=None) -> str:
    """The generated source ``for_each`` builds for these operands."""
    ops = _operands(operands, "for_each")
    return _plan_for_each(fn, ops, None if out_dtype is None else (out_dtype,), False).source


def for_each_multi_source(fn, *operands, out_dtypes=None) -> str:
    ops = _operands(operands, "for_each_multi")
    return _plan_for_each(fn, ops, out_dtypes, True).source


def row_reduce_source(map_fn, *operands, reduce_fn=torch.sum, identity=0.0,
                      out_dtype=None) -> str:
    ops = _operands(operands, "row_reduce")
    out_dt = out_dtype or result_type([o.dtype for o in ops])
    return _plan_reduce("row_reduce", map_fn, ops, reduce_fn, identity, None, out_dt).source


def map_reduce_source(map_fn, *operands, reduce_fn=torch.sum, identity=0.0,
                      acc_dtype=None) -> str:
    ops = _operands(operands, "map_reduce")
    acc = acc_dtype or result_type([o.dtype for o in ops])
    return _plan_reduce("map_reduce", map_fn, ops, reduce_fn, identity, acc, acc).source


# ---------------------------------------------------------------------------
# Launches
# ---------------------------------------------------------------------------

def _ptrs(ts) -> ctypes.Array:
    return (ctypes.c_void_p * max(len(ts), 1))(*[t.data_ptr() for t in ts])


def _launch_for_each(plan: _Plan, ops, outs, record) -> None:
    n = ops[0].numel()
    if n == 0:
        return
    lib = registry.load_generated(plan.source)
    status = lib.ltt_gen_for_each(_ptrs(ops), _ptrs(outs), n, registry.stream_handle(ops[0]))
    registry.check_launch(status, record.name)
    record.launches += 1


def _acc_scratch_dtype(dt) -> torch.dtype:
    """The dtype csrc/foreach.cuh accumulates ``dt`` in (its acc_t)."""
    return {"float": torch.float32, "int32_t": torch.int32,
            "int64_t": torch.int64}[codegen.acc_ctype(dt)]


def reduce_plan(n: int, vec: int):
    """(blocks, chunk) of map_reduce's first launch: csrc/foreach.cuh
    reduce_plan, one block per REDUCE_GRAIN elements up to
    REDUCE_MAX_BLOCKS, each chunk whole vectors of ``vec`` elements."""
    g = max(1, min(-(-n // REDUCE_GRAIN), REDUCE_MAX_BLOCKS))
    chunk = -(-(-(-n // g)) // vec) * vec
    return -(-n // chunk), chunk


# ---------------------------------------------------------------------------
# for_each / for_each_multi
# ---------------------------------------------------------------------------

def for_each_reference(fn: Callable, *operands, out_dtype=None, donate: bool = False):
    """The body evaluated eagerly in torch, cast to ``out_dtype`` (default:
    the operands' promoted dtype); ``donate`` writes it into operand 0."""
    FOR_EACH.plain_calls += 1
    ops = list(operands)
    out_dtype = out_dtype or result_type([o.dtype for o in ops])
    y = fn(*ops).to(out_dtype)
    if donate and ops[0].dtype == out_dtype:
        return ops[0].copy_(y)
    return y


def for_each(fn: Callable, *operands, out_dtype=None, pad_value=0,
             donate: bool = False) -> torch.Tensor:
    """``fn`` applied elementwise over N same-shaped contiguous operands in
    one kernel, cast to ``out_dtype`` (default: the operands' promoted
    dtype, as jnp.result_type). ``donate=True`` writes the result into
    operand 0's storage when the dtypes match and returns it (laser_tpu
    aliases operand 0 as the output); operand 0 holds the result afterwards.
    ``pad_value`` is laser_tpu's padding value; nothing is padded here.

    An operand that is a TensorView or a non-contiguous tensor sends the
    call to ``ops.strided.strided_for_each`` (one pass of the strided
    kernel, no materialisation; laser_tpu: foreach.py:132-140), unless
    every view is a contiguous window. The result is then a new dense
    tensor whatever ``donate`` says, as in laser_tpu."""
    del pad_value
    if strided.is_strided(operands):
        return strided.strided_for_each(fn, operands, out_dtype)
    ops = _operands(operands, "for_each")
    plan = _plan_for_each(fn, ops, None if out_dtype is None else (out_dtype,), False)
    out_dtype = plan.out_dtypes[0]
    if not registry.on_cuda(ops[0]):
        return for_each_reference(fn, *ops, out_dtype=out_dtype, donate=donate)
    in_place = donate and ops[0].dtype == out_dtype
    out = ops[0] if in_place else torch.empty_like(ops[0], dtype=out_dtype)
    _launch_for_each(plan, ops, [out], FOR_EACH)
    return out


def for_each_multi_reference(fn: Callable, *operands, out_dtypes=None):
    FOR_EACH_MULTI.plain_calls += 1
    vals = fn(*operands)
    out_dtypes = out_dtypes or [v.dtype for v in vals]
    return tuple(v.to(dt) for v, dt in zip(vals, out_dtypes, strict=True))


def for_each_multi(fn: Callable, *operands, out_dtypes=None, pad_value=0):
    """Like ``for_each`` but ``fn`` returns a tuple: one kernel writes every
    output in one pass over the operands. ``out_dtypes`` defaults to the
    body's own output dtypes."""
    del pad_value
    ops = _operands(operands, "for_each_multi")
    plan = _plan_for_each(fn, ops, out_dtypes, True)
    if not registry.on_cuda(ops[0]):
        return for_each_multi_reference(fn, *ops, out_dtypes=plan.out_dtypes)
    outs = [torch.empty_like(ops[0], dtype=dt) for dt in plan.out_dtypes]
    _launch_for_each(plan, ops, outs, FOR_EACH_MULTI)
    return tuple(outs)


# ---------------------------------------------------------------------------
# row_reduce
# ---------------------------------------------------------------------------

def _reduce_plain(v: torch.Tensor, op: str, dim=None) -> torch.Tensor:
    """reduce ``v`` over ``dim`` (all when None) as the templates do: floats
    summed in f32 and rounded to v's dtype once, integers in int32/int64."""
    kw = {} if dim is None else {"dim": dim}
    if op == "sum":
        acc = _acc_scratch_dtype(v.dtype)
        return v.to(acc).sum(dtype=acc, **kw).to(v.dtype)
    return v.amin(**kw) if op == "min" else v.amax(**kw)


def row_reduce_reference(map_fn: Callable, *operands, reduce_fn=torch.sum, identity=0.0,
                         out_dtype=None) -> torch.Tensor:
    """reduce(map_fn(*ops), axis=-1) in plain torch."""
    ROW_REDUCE.plain_calls += 1
    ops = list(operands)
    out_dt = out_dtype or result_type([o.dtype for o in ops])
    v = map_fn(*ops)
    if v.shape[-1] == 0:
        return torch.full(v.shape[:-1], identity, dtype=v.dtype, device=v.device).to(out_dt)
    return _reduce_plain(v, reduce_op(reduce_fn), -1).to(out_dt)


def row_reduce(map_fn: Callable, *operands, reduce_fn: Callable = torch.sum, identity=0.0,
               out_dtype=None) -> torch.Tensor:
    """reduce(map_fn(*ops), axis=-1) for 2-D same-shaped operands in one
    kernel; the result has the operands' promoted dtype unless
    ``out_dtype`` says otherwise. Rows of any length (laser_tpu returns None
    when a row overflows VMEM)."""
    ops = _operands(operands, "row_reduce")
    if ops[0].ndim != 2:
        raise ValueError("row_reduce expects 2-D operands")
    rows, cols = ops[0].shape
    out_dt = out_dtype or result_type([o.dtype for o in ops])
    plan = _plan_reduce("row_reduce", map_fn, ops, reduce_fn, identity, None, out_dt)
    if not registry.on_cuda(ops[0]):
        return row_reduce_reference(map_fn, *ops, reduce_fn=reduce_fn, identity=identity,
                                    out_dtype=out_dt)
    if cols == 0:
        return torch.full((rows,), identity, dtype=plan.value_dtype,
                          device=ops[0].device).to(out_dt)
    out = torch.empty((rows,), dtype=out_dt, device=ops[0].device)
    if rows == 0:
        return out
    lib = registry.load_generated(plan.source)
    status = lib.ltt_gen_row_reduce(_ptrs(ops), out.data_ptr(), rows, cols,
                                    registry.stream_handle(ops[0]))
    registry.check_launch(status, ROW_REDUCE.name)
    ROW_REDUCE.launches += 1
    return out


# ---------------------------------------------------------------------------
# map_reduce
# ---------------------------------------------------------------------------

def _combine(reduce_fn, combine_fn):
    """(combine op or None for a custom combine_fn) of map_reduce."""
    if combine_fn is None:
        return reduce_op(reduce_fn)
    return _REDUCE_FNS.get(combine_fn)


def map_reduce_reference(map_fn: Callable, *operands, reduce_fn=torch.sum, combine_fn=None,
                         identity=0.0, out_dtype=None, acc_dtype=None) -> torch.Tensor:
    """The plain version: map, cast to ``acc_dtype``, reduce; where the
    combine differs from the reduce (a custom ``combine_fn``, or another op
    of the vocabulary), each first-stage block's elements are reduced
    alone, as the kernel's blocks are, and combined across blocks."""
    MAP_REDUCE.plain_calls += 1
    ops = list(operands)
    op = reduce_op(reduce_fn)
    acc = acc_dtype or result_type([o.dtype for o in ops])
    out_dtype = out_dtype or acc
    m = map_fn(*ops).to(acc).reshape(-1)
    n = m.numel()
    if n == 0:
        return torch.tensor(identity, dtype=acc, device=m.device).to(out_dtype)
    cop = _combine(reduce_fn, combine_fn)
    if cop == op:
        return _reduce_plain(m, op).to(out_dtype)
    blocks, chunk = reduce_plan(n, codegen.vec_width([o.dtype for o in ops]))
    pad = torch.full((blocks * chunk - n,), identity, dtype=acc, device=m.device)
    partials = _reduce_plain(torch.cat([m, pad]).reshape(blocks, chunk), op, 1)
    if cop is None:
        return combine_fn(partials).to(out_dtype)
    return _reduce_plain(partials, cop).to(out_dtype)


def map_reduce(map_fn: Callable, *operands, reduce_fn: Callable = torch.sum,
               combine_fn: Optional[Callable] = None, identity=0.0, out_dtype=None,
               acc_dtype=None) -> torch.Tensor:
    """Fused map and deterministic reduction of any shape to a 0-d tensor.

    ``acc_dtype`` (default: the operands' promoted dtype) is the dtype the
    mapped values are cast to and the partials are kept in; ``out_dtype``
    defaults to it. ``combine_fn`` (default ``reduce_fn``) merges the
    per-block partials: in the second launch when it is one of the
    vocabulary's reductions, else in torch on the partials (one per
    first-stage block, in block order)."""
    ops = _operands(operands, "map_reduce")
    acc = acc_dtype or result_type([o.dtype for o in ops])
    out_dtype = out_dtype or acc
    plan = _plan_reduce("map_reduce", map_fn, ops, reduce_fn, identity, acc, acc)
    cop = _combine(reduce_fn, combine_fn)
    if not registry.on_cuda(ops[0]):
        return map_reduce_reference(map_fn, *ops, reduce_fn=reduce_fn, combine_fn=combine_fn,
                                    identity=identity, out_dtype=out_dtype, acc_dtype=acc)
    dev = ops[0].device
    n = ops[0].numel()
    if n == 0:
        return torch.tensor(identity, dtype=acc, device=dev).to(out_dtype)
    lib = registry.load_generated(plan.source)
    stream = registry.stream_handle(ops[0])
    if cop is None:
        blocks, _ = reduce_plan(n, codegen.vec_width([o.dtype for o in ops]))
        partials = torch.empty((blocks,), dtype=acc, device=dev)
        status = lib.ltt_gen_map_reduce(_ptrs(ops), partials.data_ptr(), None, n, 0, stream)
        registry.check_launch(status, MAP_REDUCE.name)
        MAP_REDUCE.launches += 1
        return combine_fn(partials).to(out_dtype)
    scratch = torch.empty((REDUCE_MAX_BLOCKS,), dtype=_acc_scratch_dtype(acc), device=dev)
    result = torch.empty((), dtype=acc, device=dev)
    status = lib.ltt_gen_map_reduce(_ptrs(ops), scratch.data_ptr(), result.data_ptr(), n,
                                    codegen.REDUCE_OPS[cop], stream)
    registry.check_launch(status, MAP_REDUCE.name)
    MAP_REDUCE.launches += 1
    return result if out_dtype == acc else result.to(out_dtype)


def for_each_staged(*operands, before_loop=None, in_loop: Callable,
                    after_loop: Callable = torch.sum, identity=0.0, **kw):
    """Name parity with laser_tpu (foreach.py:406): ``map_reduce`` in the
    stage vocabulary; ``before_loop`` is the identity's job."""
    del before_loop
    return map_reduce(in_loop, *operands, reduce_fn=after_loop, identity=identity, **kw)


# ---------------------------------------------------------------------------
# map_reduce_staged: accumulator pytrees of scalar leaves
# ---------------------------------------------------------------------------

class StageCtx:
    """What ``block_fn`` sees of its block (laser_tpu's StageCtx,
    foreach.py:424): ``valid`` is True for the block's real elements (a
    bool per element; past the operands' end the loaded value is 0),
    ``offset`` the flat index of the block's first element, ``width`` the
    block's element count (STAGED_GRAIN), and ``flat_indices(shape)`` each
    element's global flat index (int64; laser_tpu's is int32). The port's
    block is 1-D, so ``shape`` is the block's own (``b.shape``)."""

    def __init__(self, valid, offset, width, ids):
        self.valid = valid
        self.offset = offset
        self.width = width
        self._ids = ids

    def flat_indices(self, shape):
        if tuple(shape) != (STAGED_GRAIN,):
            raise ValueError(f"flat_indices of a block of shape ({STAGED_GRAIN},), "
                             f"got {tuple(shape)}")
        return self._ids


@dataclasses.dataclass
class _StagedPlan:
    source: str
    leaf_dtypes: tuple  # the accumulator's leaves
    out_dtypes: tuple   # the results' leaves (the finish's outputs; else the leaves)
    lib: Optional[ctypes.CDLL] = None  # the built library, kept from its first launch


@functools.lru_cache(maxsize=256)
def _plan_staged_cached(block: codegen.Traced, comb: codegen.Traced,
                        fin: Optional[codegen.Traced]) -> _StagedPlan:
    leaves = block.out_dtypes
    return _StagedPlan(codegen.emit_staged(block, comb, leaves, fin), leaves,
                       leaves if fin is None else fin.out_dtypes)


def _plan_staged(block_fn, dtypes, combine, finish=None):
    """(plan, the results' pytree spec): the block body, the combine and
    the finish traced on every call, the emitted source memoised on the
    traces."""
    block, spec = codegen.trace_staged(block_fn, dtypes, (STAGED_GRAIN,), StageCtx)
    comb = codegen.trace_combine(combine, spec, block.out_dtypes)
    if finish is None:
        return _plan_staged_cached(block, comb, None), spec
    fin, out_spec = codegen.trace_finish(finish, spec, block.out_dtypes)
    return _plan_staged_cached(block, comb, fin), out_spec


# the plans of bodies that read nothing that changes between calls (the
# library's own: mean_var's, argmax's), memoised on the functions
_plan_staged_constant = functools.lru_cache(maxsize=64)(_plan_staged)


def map_reduce_staged_source(block_fn, *operands, combine, finish=None) -> str:
    """The generated source ``map_reduce_staged`` builds for these operands."""
    ops = _operands(operands, "map_reduce_staged")
    return _plan_staged(block_fn, tuple(o.dtype for o in ops), combine, finish)[0].source


def staged_blocks(n: int) -> int:
    """The number of blocks (of STAGED_GRAIN elements) over n elements."""
    return -(-n // STAGED_GRAIN)


def map_reduce_staged_reference(block_fn: Callable, *operands, combine: Callable,
                                finish: Optional[Callable] = None):
    """The plain version: the operands cut into the kernel's blocks of
    STAGED_GRAIN elements (the last padded with 0, ``valid`` false there),
    ``block_fn`` on each block (``torch.func.vmap`` over the blocks, each a
    real (STAGED_GRAIN,) tensor to the body), then laser_tpu's pairwise
    halving tree of ``combine`` over the blocks' accumulators, each leaf
    kept in its block dtype, then ``finish`` on the result."""
    MAP_REDUCE_STAGED.plain_calls += 1
    flat = [o.reshape(-1) for o in operands]
    n = flat[0].numel()
    nb = staged_blocks(n)
    dev = flat[0].device
    blocks = [torch.cat([f, f.new_zeros(nb * STAGED_GRAIN - n)]).reshape(nb, STAGED_GRAIN)
              for f in flat]
    ids = torch.arange(nb * STAGED_GRAIN, device=dev).reshape(nb, STAGED_GRAIN)
    spec = []

    def one(valid, ids_b, offset, *bs):
        leaves, sp = pytree.tree_flatten(block_fn(StageCtx(valid, offset, STAGED_GRAIN, ids_b),
                                                  *bs))
        for leaf in leaves:
            if leaf.dim() != 0:
                raise ValueError("map_reduce_staged accumulator leaves must be scalars, got "
                                 f"shape {tuple(leaf.shape)}")
        spec[:] = [sp]
        return tuple(leaves)

    leaves = torch.func.vmap(one)(ids < n, ids, ids[:, 0], *blocks)
    dtypes = [leaf.dtype for leaf in leaves]
    accs = pytree.tree_unflatten(list(leaves), spec[0])
    m = nb
    while m > 1:
        h = m // 2
        lo = pytree.tree_map(lambda a: a[:h], accs)
        hi = pytree.tree_map(lambda a: a[h:2 * h], accs)
        merged = pytree.tree_leaves(combine(lo, hi))
        if m % 2:
            tail = pytree.tree_leaves(accs)
            merged = [torch.cat([x.to(dt), t[2 * h:]]) for x, t, dt in zip(merged, tail, dtypes)]
        accs = pytree.tree_unflatten([x.to(dt) for x, dt in zip(merged, dtypes)], spec[0])
        m = h + m % 2
    acc = pytree.tree_map(lambda a: a[0], accs)
    return acc if finish is None else finish(acc)


# map_reduce_staged's routes: None, the one-launch kernel (the two-launch
# template under CUDA graph capture), and "classic", the two-launch template
STAGED_ROUTES = (None, "classic")


def map_reduce_staged(block_fn: Callable, *operands, combine: Callable,
                      finish: Optional[Callable] = None, route: Optional[str] = None):
    """Fused block fold and deterministic combine over an accumulator
    pytree of scalar leaves (laser_tpu/ops/foreach.py:442).

    ``block_fn(ctx, *blocks)`` returns one block's accumulator: a pytree of
    block scalars made with the block vocabulary (ops/codegen.py: the
    elementwise ops, whole-block torch.sum / amax / max / amin / min / mean,
    ``ctx``); ``combine(a, b)`` merges two accumulators with the elementwise
    ops; ``finish(acc)`` (an extension of the port; None: the accumulator
    itself) maps the final accumulator to the result with the elementwise
    ops, inside the kernel's last store. Operands of any shape are
    flattened (a view is materialised first); the result has the
    accumulator's (or the finish's) structure, each leaf a 0-d tensor of
    its dtype. On a CUDA tensor it runs the staged template of
    csrc/foreach.cuh: by default one launch (``map_reduce_staged_one``:
    each thread block folds one chain of blocks as it goes, the last to
    finish runs the tree), with ``route="classic"``, and under CUDA graph
    capture (where host work costs nothing and the two kernels take less
    device time), two (``map_reduce_staged``: stage 1, then one block over
    the partials); both fold in one fixed order, so they give the same
    bits, run after run, with no atomics on the values. On a CPU tensor
    ``map_reduce_staged_reference``, whatever the route. Leaves that are not
    scalars raise ValueError, ops outside the vocabulary
    NotImplementedError, an unknown route ValueError, on every device."""
    return _staged(block_fn, operands, combine, finish, route, _plan_staged)


def map_reduce_staged_constant(block_fn: Callable, *operands, combine: Callable,
                               finish: Optional[Callable] = None,
                               route: Optional[str] = None):
    """``map_reduce_staged`` for a body, a combine and a finish that read no
    value that changes from call to call (no mutable closure cell or
    global), as the library's own mean_var / argmax / argmin: their plan is
    memoised on the functions and the dtypes, so a call skips the trace
    (0.2-0.6 ms of host work for those bodies). Any other body goes through
    ``map_reduce_staged``, which traces it on every call."""
    return _staged(block_fn, operands, combine, finish, route, _plan_staged_constant)


def _staged(block_fn, operands, combine, finish, route, planner):
    if route not in STAGED_ROUTES:
        raise ValueError(f"unknown route {route!r}; have {[r for r in STAGED_ROUTES if r]}")
    ops = _operands(operands, "map_reduce_staged")
    x = ops[0]
    n = x.numel()
    if n == 0:
        raise ValueError("map_reduce_staged of empty operands")
    plan, spec = planner(block_fn, tuple(o.dtype for o in ops), combine, finish)
    if not registry.on_cuda(x):
        return map_reduce_staged_reference(block_fn, *ops, combine=combine, finish=finish)
    dev = x.device
    outs = [torch.empty((), dtype=dt, device=dev) for dt in plan.out_dtypes]
    if plan.lib is None:
        plan.lib = registry.load_generated(plan.source)
    stream = registry.stream_handle(x)
    # the stream's workspace; None under graph capture, which takes the two launches
    work = None if route == "classic" else registry.stream_workspace(x, STAGED_WORK_BYTES)
    if work is None:
        parts = [torch.empty((staged_blocks(n),), dtype=dt, device=dev)
                 for dt in plan.leaf_dtypes]
        status = plan.lib.ltt_gen_map_reduce_staged(_ptrs(ops), _ptrs(parts), _ptrs(outs), n,
                                                    stream)
        registry.check_launch(status, MAP_REDUCE_STAGED.name)
        MAP_REDUCE_STAGED.launches += 1
    else:
        status = plan.lib.ltt_gen_map_reduce_staged_one(_ptrs(ops), _ptrs(outs), work.data_ptr(),
                                                        n, stream)
        registry.check_launch(status, MAP_REDUCE_STAGED_ONE.name)
        MAP_REDUCE_STAGED_ONE.launches += 1
    return pytree.tree_unflatten(outs, spec)
