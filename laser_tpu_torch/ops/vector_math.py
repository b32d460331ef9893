"""Row softmax (port of laser_tpu/ops/vector_math.py: ``softmax`` and
``_softmax_online``).

``softmax(x, axis=-1)`` is max-reduce, exp, sum-reduce and scale in one
kernel, over CUDA kernels in csrc/softmax.cu, the arithmetic in fp32 and
one cast to x's dtype:

- two row kernels replace laser_tpu/ops/vector_math.py:276 softmax, each
  with its own launch counter: ``softmax_vec`` (route "vec", every row the
  row route takes) holds the row in registers, read and written in 16-byte
  vectors, a warp a row up to 1024 columns and a block a row past that, a
  ragged width or an unaligned view by elements in the same launch;
  ``softmax`` (route "classic", asked for) gives each row one block that
  holds the row in shared memory. ``route=`` asks for one;
- two online kernels (``softmax_online``, which takes any width) replace
  laser_tpu/ops/vector_math.py:200 _softmax_online, each with its own
  launch counter. laser_tpu carries (m, l) in scratch from one grid step
  to the next; Hopper blocks carry nothing. ``softmax_online_cluster``
  (the default) splits each row over the blocks of a thread-block cluster
  (up to 16 blocks of 512 threads, 32 values a thread in registers:
  ``SOFTMAX_CLUSTER_MAX_COLS`` = 262144 columns): each block holds its
  slice on chip after one read, each thread its values' max m and e =
  exp(x - m), the blocks exchange their (max, sum) pairs through
  distributed shared memory after one barrier, and each thread writes
  e exp(m - M) / L (x - m and x - M round apart: within 3e-6 relative of
  exp(x - M) / L on randn * 4 rows in f32): one read and one write. ``softmax_online`` (route "classic", and rows
  wider than a cluster holds) gives each row one block that loops over it
  twice, a running (m, l) in the first sweep, exp(x - m) / l written in
  the second.

Routing is the port's own rule, by shape: a row of more than
``SOFTMAX_ROW_MAX_COLS`` (16384) columns, whose fp32 copy would take more
than 64 KB of a block's shared memory, goes online. laser_tpu routes by a
VMEM budget instead (vector_math.py:301: 8 rows of padded columns at 32
bytes each over 0.7 of the chip's VMEM), which sends rows past ~350k columns
online on a v5e and past ~46k on its CPU stand-in; the two packages compute
the same function either way.

A (rows, cols) contiguous CUDA tensor over the last axis (C1's and the
MLP's head, a vocabulary's rows) takes a short host path, the row and the
online kernels alike: ``registry.on_cuda``'s device check, the library's
entry point taken once and kept (``registry.entry``), no reshape or copy,
the output allocated and the kernel launched.

A row of nothing but -inf comes out as laser_tpu's kernels give it: NaN from
the row kernels (0 / 0) and 0 from the online kernel, which takes an empty
sum as 1 (ROADMAP queue 3).

``donate=True``: laser_tpu aliases its output onto the donated input
(``input_output_aliases``), a TPU bandwidth trick. The port writes the
result into x's own storage and returns a view of it when the rows are x's
memory as it lies (x contiguous, ``axis`` the last); x must not be used
afterwards. Otherwise ``donate`` changes nothing.

Plain versions, in fp32: ``softmax_reference`` (the row kernels' function,
counted under ``softmax``) and ``softmax_online_reference`` (the online
kernel's). On CPU tensors each wrapper runs its plain version.

``exp``, ``log``, ``tanh`` and ``sigmoid`` (laser_tpu/ops/vector_math.py:172-
197) run through ``ops.foreach.for_each``, whose body is one vector-math
core, in two tiers (``algorithm``, default ``config.vector_math_algorithm``):

- "accurate": laser_tpu's polynomial cores (``_exp_expr``, ``_log_expr``,
  ``_tanh_expr``, ``_sigmoid_expr``). In a traced body each is one node that
  the kernel computes with csrc/vector_math.cuh; evaluated eagerly (the
  plain version) it is the same polynomial written in torch (``_exp_poly``
  and friends), not ``torch.exp``, and the two agree bit for bit in f32.
  Within 1e-6 of float64 (tests/test_torch_vector_math.py).
- "fast": CUDA's own functions in the kernel (__expf, __logf, tanhf and
  1 / (1 + __expf(-x)); errors in csrc/vector_math.cuh); the plain
  version is torch.exp / log / tanh / sigmoid.

Each takes float tensors and returns the input's dtype; ``donate=True``
writes the result into x (see ``for_each``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import registry
from ..config import get_config
from . import codegen

SOFTMAX = registry.kernel("softmax", "laser_tpu_torch/csrc/softmax.cu",
                          "laser_tpu/ops/vector_math.py:276 softmax")
SOFTMAX_VEC = registry.kernel("softmax_vec", "laser_tpu_torch/csrc/softmax.cu",
                              "laser_tpu/ops/vector_math.py:276 softmax")
SOFTMAX_ONLINE = registry.kernel("softmax_online", "laser_tpu_torch/csrc/softmax.cu",
                                 "laser_tpu/ops/vector_math.py:200 _softmax_online")
SOFTMAX_ONLINE_CLUSTER = registry.kernel("softmax_online_cluster",
                                         "laser_tpu_torch/csrc/softmax.cu",
                                         "laser_tpu/ops/vector_math.py:200 _softmax_online")
# the row kernels' route codes, shared with csrc/softmax.cu (enum Route)
ROUTES = {None: 0, "classic": 1, "vec": 2}
# the online kernels' (enum OnlineRoute): None the cluster kernel where a
# row fits a cluster, else the classic one; the launcher reports the kernel
ONLINE_ROUTES = {None: 0, "classic": 1}
ONLINE_KERNELS = {1: SOFTMAX_ONLINE, 2: SOFTMAX_ONLINE_CLUSTER}
# widest row the cluster kernel holds on chip: 16 blocks of 512 threads, 32
# values a thread in registers (csrc/softmax.cu kClusterMaxBlocks,
# kClusterThreads, kClusterValues); wider rows take the classic online kernel
SOFTMAX_CLUSTER_MAX_COLS = 16 * 512 * 32

# widest row the row kernels take (the classic one holds it in shared
# memory as fp32: 64 KB)
SOFTMAX_ROW_MAX_COLS = 16384

# most rows one launch takes: the launchers take the count as a C int
SOFTMAX_MAX_ROWS = 2**31 - 1


def _exp_shifted(xf: torch.Tensor):
    """exp(x - m) per row, m the row max taken as 0 where it is not finite
    (vector_math.py:321), and exactly 0 at -inf entries."""
    m = xf.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.where(xf == -torch.inf, torch.zeros_like(xf), torch.exp(xf - m))


def softmax_reference(x: torch.Tensor) -> torch.Tensor:
    """The row kernel's function over the last axis in plain PyTorch, fp32:
    e / sum(e), NaN for an all -inf row (vector_math.py:319-327)."""
    SOFTMAX.plain_calls += 1
    e = _exp_shifted(x.float())
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def softmax_online_reference(x: torch.Tensor) -> torch.Tensor:
    """The online kernel's function over the last axis in plain PyTorch,
    fp32: an empty sum is taken as 1, so an all -inf row gives 0
    (vector_math.py:252-253)."""
    SOFTMAX_ONLINE.plain_calls += 1
    e = _exp_shifted(x.float())
    s = e.sum(dim=-1, keepdim=True)
    return (e / torch.where(s > 0, s, torch.ones_like(s))).to(x.dtype)


def _rows_cuda(x2: torch.Tensor, out: Optional[torch.Tensor],
               route: Optional[str]) -> torch.Tensor:
    """The row kernels on (rows, cols) contiguous CUDA rows, into ``out``
    (which may be x2; None: a new tensor)."""
    code, rc = registry.DTYPE_CODES.get(x2.dtype), ROUTES.get(route)
    if code is None:
        raise TypeError(f"softmax kernel: unsupported dtype {x2.dtype}")
    if rc is None:
        registry.route_code(ROUTES, route)  # raises, naming the routes
    rows, cols = x2.shape
    if cols > SOFTMAX_ROW_MAX_COLS:
        raise ValueError(f"softmax row kernel: {cols} columns > {SOFTMAX_ROW_MAX_COLS}")
    if rows > SOFTMAX_MAX_ROWS:
        raise ValueError(f"softmax kernel: {rows} rows > {SOFTMAX_MAX_ROWS}")
    if out is None:
        out = torch.empty_like(x2)
    if rows == 0 or cols == 0:
        return out
    status = registry.entry("ltt_softmax_rows")(x2.data_ptr(), out.data_ptr(), rows, cols, code,
                                                rc, registry.stream_handle(x2))
    registry.check_launch(status, "softmax")
    (SOFTMAX if route == "classic" else SOFTMAX_VEC).launches += 1
    return out


def _online_cuda(x2: torch.Tensor, out: torch.Tensor, route: Optional[str]) -> torch.Tensor:
    """The online kernels on (rows, cols) contiguous CUDA rows, into
    ``out`` (which may be x2): the cluster kernel (route None) or the
    classic one ("classic")."""
    code = registry.DTYPE_CODES.get(x2.dtype)
    if code is None:
        raise TypeError(f"softmax kernel: unsupported dtype {x2.dtype}")
    rows, cols = x2.shape
    if rows > SOFTMAX_MAX_ROWS:
        raise ValueError(f"softmax kernel: {rows} rows > {SOFTMAX_MAX_ROWS}")
    if rows == 0 or cols == 0:
        return out
    taken = ctypes.c_int(0)
    status = registry.entry("ltt_softmax_online")(
        x2.data_ptr(), out.data_ptr(), rows, cols, code, ONLINE_ROUTES[route],
        ctypes.byref(taken), registry.stream_handle(x2))
    registry.check_launch(status, "softmax_online")
    ONLINE_KERNELS[taken.value].launches += 1
    return out


def _run(x2: torch.Tensor, out: Optional[torch.Tensor], online: bool, plain: bool,
         route: Optional[str] = None):
    """One route on (rows, cols) contiguous rows, into ``out`` when given;
    ``route`` is the row kernels' name (online: "classic" the classic
    online kernel, else the cluster kernel)."""
    if plain or not registry.on_cuda(x2):
        y = (softmax_online_reference if online else softmax_reference)(x2)
        return y if out is None else out.copy_(y)
    if online:
        return _online_cuda(x2, torch.empty_like(x2) if out is None else out,
                            "classic" if route == "classic" else None)
    return _rows_cuda(x2, out, route)


def softmax(x: torch.Tensor, *, axis: int = -1, donate: bool = False,
            plain: bool = False, route: Optional[str] = None) -> torch.Tensor:
    """Row softmax over ``axis``: the row kernels for rows of at most
    ``SOFTMAX_ROW_MAX_COLS`` columns, the online kernels for wider ones.
    ``plain=True`` takes the same route through the plain versions.
    ``route`` (a CUDA tensor's): None or "vec" the vec kernel, and past
    ``SOFTMAX_ROW_MAX_COLS`` columns the cluster kernel; "classic" the
    classic row kernel, and past it the classic online kernel."""
    if (x.is_cuda and not plain and x.dim() == 2 and (axis == -1 or axis == 1)
            and x.is_contiguous() and registry.on_cuda(x)):
        if x.shape[1] <= SOFTMAX_ROW_MAX_COLS:
            return _rows_cuda(x, x if donate else None, route)
        if route in ROUTES:
            return _online_cuda(x, x if donate else torch.empty_like(x),
                                "classic" if route == "classic" else None)
    if route not in ROUTES:
        registry.route_code(ROUTES, route)  # raises, naming the routes
    last = axis in (-1, x.ndim - 1)
    xm = x if last else x.movedim(axis, -1)
    shape = xm.shape
    cols = shape[-1] if xm.ndim else 1
    x2 = xm.reshape(-1, cols)
    in_place = donate and last and x.is_contiguous()
    if not in_place:
        x2 = x2.contiguous()
    y = _run(x2, x2 if in_place else None, cols > SOFTMAX_ROW_MAX_COLS, plain, route)
    y = y.reshape(shape)
    return y if last else y.movedim(-1, axis)


def softmax_online(x: torch.Tensor, *, plain: bool = False,
                   route: Optional[str] = None) -> torch.Tensor:
    """The online function over the last axis at any width (laser_tpu's
    ``_softmax_online``, which ``softmax`` reaches only for wide rows).
    ``route`` (a CUDA tensor's): None the cluster kernel, or the classic
    online kernel past ``SOFTMAX_CLUSTER_MAX_COLS`` columns; "classic" the
    classic online kernel."""
    if route not in ONLINE_ROUTES:
        registry.route_code(ONLINE_ROUTES, route)  # raises, naming the routes
    if x.is_cuda and not plain and x.dim() == 2 and x.is_contiguous() and registry.on_cuda(x):
        return _online_cuda(x, torch.empty_like(x), route)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1] if x.ndim else 1).contiguous()
    return _run(x2, None, True, plain, route).reshape(shape)


# ---------------------------------------------------------------------------
# exp / log / tanh / sigmoid
# ---------------------------------------------------------------------------

# laser_tpu/ops/vector_math.py:40-54, 92-98: clamp, Cody-Waite split of ln 2,
# the degree-5 exp polynomial and musl's logf coefficients, as f32 values
EXP_MAX, EXP_MIN = 88.0, -88.0
_F = lambda v: float(np.float32(v))  # noqa: E731
_LOG2E = _F(1.4426950408889634)
_LN2_HI, _LN2_LO = _F(0.693359375), _F(-2.12194440e-4)
_EXP_P = tuple(_F(v) for v in (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                               4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1))
_LG1, _LG2, _LG3, _LG4 = (_F(v) for v in (0.66666662693, 0.40000972152, 0.28498786688,
                                          0.24279078841))


def _exp_poly(x: torch.Tensor) -> torch.Tensor:
    """laser_tpu's _exp_expr in torch: f32 throughout, one cast at the end."""
    orig = x.dtype
    xc = torch.clamp(x.float(), EXP_MIN, EXP_MAX)  # keeps NaN
    n = torch.round(xc * _LOG2E)
    r = xc - n * _LN2_HI
    r = r - n * _LN2_LO
    p = _EXP_P[0] * r + _EXP_P[1]
    for c in _EXP_P[2:]:
        p = p * r + c
    p = p * (r * r) + r + 1.0
    ni = torch.where(torch.isnan(n), torch.zeros_like(n), n).to(torch.int32)
    s = ((ni + 127).clamp_min(0) << 23).view(torch.float32)
    return (p * s).to(orig)


def _log_poly(x: torch.Tensor) -> torch.Tensor:
    """laser_tpu's _log_expr in torch: bitfield reduction, musl's core."""
    xf = x.float()
    shifted = xf.view(torch.int32) + (0x3F800000 - 0x3F3504F3)
    k = ((shifted >> 23) - 127).float()
    m = ((shifted & 0x007FFFFF) + 0x3F3504F3).view(torch.float32)
    f = m - 1.0
    s = f / (2.0 + f)
    z = s * s
    w = z * z
    t1 = w * (_LG2 + w * _LG4)
    t2 = z * (_LG1 + w * _LG3)
    r = t2 + t1
    hfsq = 0.5 * f * f
    res = k * _LN2_HI + (s * (hfsq + r) + k * _LN2_LO + f - hfsq)
    res = torch.where(xf == 0, -torch.inf, res)
    res = torch.where(xf < 0, torch.nan, res)
    res = torch.where(torch.isinf(xf) & (xf > 0), torch.inf, res)
    res = torch.where(torch.isnan(xf), torch.nan, res)
    return res.to(x.dtype)


def _tanh_poly(x: torch.Tensor) -> torch.Tensor:
    """laser_tpu's _tanh_expr: in x's dtype, through the exp core."""
    e = _exp_poly(torch.clamp_max(2.0 * x.abs(), 40.0))
    t = 1.0 - 2.0 / (e + 1.0)
    return (torch.sign(x) * t).to(x.dtype)


def _sigmoid_poly(x: torch.Tensor) -> torch.Tensor:
    """laser_tpu's _sigmoid_expr: in x's dtype, through the exp core."""
    e = _exp_poly(-x.abs())
    pos = 1.0 / (1.0 + e)
    return torch.where(x >= 0, pos, 1.0 - pos).to(x.dtype)


def _core(name: str, eager):
    """A body op: one node of a traced body (csrc/vector_math.cuh
    ``ltt::vm::<name>``), ``eager`` on a tensor."""
    def f(x):
        if codegen.is_traced(x):
            return codegen.special(name, x)
        if x.dtype not in codegen.FLOATS:
            raise TypeError(f"{name}: takes a float tensor, got {x.dtype}")
        return eager(x)
    f.__name__ = name
    return codegen.body_op(f)


exp_acc = _core("exp_acc", _exp_poly)
log_acc = _core("log_acc", _log_poly)
tanh_acc = _core("tanh_acc", _tanh_poly)
sigmoid_acc = _core("sigmoid_acc", _sigmoid_poly)
exp_fast = _core("exp_fast", torch.exp)
log_fast = _core("log_fast", torch.log)
tanh_fast = _core("tanh_fast", torch.tanh)
sigmoid_fast = _core("sigmoid_fast", torch.sigmoid)

CORES = {
    "exp": {"accurate": exp_acc, "fast": exp_fast},
    "log": {"accurate": log_acc, "fast": log_fast},
    "tanh": {"accurate": tanh_acc, "fast": tanh_fast},
    "sigmoid": {"accurate": sigmoid_acc, "fast": sigmoid_fast},
}


def pick(name: str, algorithm: Optional[str] = None):
    """The body of ``name`` in tier ``algorithm`` (default: the config's)."""
    algo = algorithm or get_config().vector_math_algorithm
    try:
        return CORES[name][algo]
    except KeyError:
        raise ValueError(f"{name}: unknown algorithm {algo!r} "
                         "(want 'accurate' or 'fast')") from None


def _elementwise(name: str, x: torch.Tensor, algorithm, donate) -> torch.Tensor:
    from .foreach import for_each

    return for_each(pick(name, algorithm), x, donate=donate)


def exp(x: torch.Tensor, *, algorithm: Optional[str] = None,
        donate: bool = False) -> torch.Tensor:
    """Elementwise exp through ``for_each`` (laser_tpu/ops/vector_math.py:172).
    ``donate=True`` writes the result into x; the same for log, tanh and
    sigmoid."""
    return _elementwise("exp", x, algorithm, donate)


def log(x: torch.Tensor, *, algorithm: Optional[str] = None,
        donate: bool = False) -> torch.Tensor:
    return _elementwise("log", x, algorithm, donate)


def tanh(x: torch.Tensor, *, algorithm: Optional[str] = None,
         donate: bool = False) -> torch.Tensor:
    return _elementwise("tanh", x, algorithm, donate)


def sigmoid(x: torch.Tensor, *, algorithm: Optional[str] = None,
            donate: bool = False) -> torch.Tensor:
    return _elementwise("sigmoid", x, algorithm, donate)
