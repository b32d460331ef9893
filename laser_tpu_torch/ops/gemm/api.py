"""Public GEMM API (port of laser_tpu/ops/gemm/api.py: ``gemm``,
``gemm_strided``, the dtype dispatch ``_dispatch`` / ``_acc_dtype``).

The dtype table is laser_tpu's (api.py:35-60, after gemm.nim:228-247):

- f32, bf16, f16 and int8 go to the GEMM kernel (csrc/gemm.cu). A fused
  float case (bias, epilogue or C) runs the kernel; a plain float product
  goes to ``torch.matmul``, as laser_tpu hands it to XLA. int8 always runs
  the kernel (int32 accumulator, wrapping), as laser_tpu's ``backend=None``
  sends int8 to Pallas.
- int32 and uint32 go to ``int32_kernel.gemm_int32`` (exact mod 2^32),
  int64 and uint64 to ``int64_kernel.gemm_int64`` (mod 2^64), f64 to
  ``f64_kernel.gemm_f64`` (int8 digit slices), all over csrc/limb_gemm.cu.
- Anything else raises ``NotImplementedError``, as there.

The accumulator defaults to int32 for int8, the input type for other
integers and f64, f32 otherwise; the output to the input type for floats
and the accumulator for integers. Where laser_tpu hands an integer case to
XLA (a bias, an epilogue, or an ``acc_dtype`` / ``out_dtype`` other than
the input's), the port has no XLA and torch no integer product on the card:
it computes the product with its own kernel after the cast that gives the
same exact result (to the accumulator's integer width, so an int64
accumulator takes the int64 route; an integer product bound for a float
accumulator is the exact int64 one, then cast), then applies alpha, beta * C,
bias and the epilogue in torch in the accumulator type, as laser_tpu's
``_gemm_xla``. Float inputs accumulate in f32 only.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...config import pin_fp32_matmul
from ...tensor import TensorView
from .f64_kernel import gemm_f64
from .int32_kernel import gemm_int32
from .int64_kernel import gemm_int64, int64_scalar
from .kernel import (_ACT, INT8_OUT_DTYPES, _epilogue_code, gemm_fused, gemm_plain,
                     int32_scalar)

_MXU_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int8)
_SIGNED = {torch.uint32: torch.int32, torch.uint64: torch.int64}


def is_integer(dt: torch.dtype) -> bool:
    return not dt.is_floating_point and not dt.is_complex and dt != torch.bool


def _dispatch(in_dtype: torch.dtype) -> str:
    if in_dtype in _MXU_DTYPES:
        return "mxu"
    if in_dtype in (torch.int32, torch.uint32):
        return "int32"
    if in_dtype in (torch.int64, torch.uint64):
        return "int64"
    if in_dtype == torch.float64:
        return "f64"
    raise NotImplementedError(f"gemm: unsupported dtype {in_dtype}")


def _acc_dtype(in_dtype: torch.dtype) -> torch.dtype:
    if in_dtype in (torch.int8, torch.uint8):
        return torch.int32
    if is_integer(in_dtype) or in_dtype == torch.float64:
        return in_dtype
    return torch.float32


def _shape(a, b, transpose_a, transpose_b):
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"gemm expects 2-D operands, got {tuple(a.shape)} x {tuple(b.shape)}")
    ka = a.shape[0] if transpose_a else a.shape[1]
    kb = b.shape[1] if transpose_b else b.shape[0]
    if ka != kb:
        raise ValueError(f"gemm shape mismatch: {tuple(a.shape)} x {tuple(b.shape)} "
                         f"(transpose_a={transpose_a}, transpose_b={transpose_b})")
    M = a.shape[1] if transpose_a else a.shape[0]
    N = b.shape[0] if transpose_b else b.shape[1]
    return M, N, ka


def _int_product(a, b, acc: torch.dtype) -> torch.Tensor:
    """a @ b of integer (M, K) x (K, N) operands in ``acc``: mod 2^32 for a
    32-bit accumulator, mod 2^64 for a 64-bit one, the exact int64 product
    cast for a float one."""
    width = _SIGNED.get(acc, acc)
    if width == torch.int32:
        r = gemm_int32(a.to(torch.int32), b.to(torch.int32))
    else:
        r = gemm_int64(a.to(torch.int64), b.to(torch.int64))
    return r.view(acc) if acc in _SIGNED else r.to(acc)


def _scalar(v, dt: torch.dtype):
    """A scalar in ``dt`` as ``jnp.asarray(v, dt)``: an integer type
    truncates and wraps it."""
    if is_integer(dt):
        return (int64_scalar if dt.itemsize == 8 else int32_scalar)(v)
    return float(v)


def _tail(r, alpha, beta, c, bias, epilogue, acc, out):
    """laser_tpu's ``_gemm_xla`` after its product ``r`` (in ``acc``):
    alpha, beta * C, bias and the epilogue in the accumulator type (an
    unsigned one in its signed twin, the same bits), one cast."""
    act = _ACT[_epilogue_code(epilogue)]
    work = _SIGNED.get(acc, acc)
    r = r.view(work) if acc in _SIGNED else r
    r = r * _scalar(alpha, work)
    if c is not None:
        cw = c.to(acc)
        r = r + _scalar(beta, work) * (cw.view(work) if acc in _SIGNED else cw)
    if bias is not None:
        bw = bias.to(acc).reshape(1, -1)
        r = r + (bw.view(work) if acc in _SIGNED else bw)
    r = act(r)
    if acc in _SIGNED and r.dtype == work:
        r = r.view(acc)
    return r.to(out)


def gemm(a: torch.Tensor, b: torch.Tensor, *, alpha=1.0, beta=0.0,
         c: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
         epilogue: Optional[str] = None, out_dtype=None, acc_dtype=None,
         transpose_a: bool = False, transpose_b: bool = False) -> torch.Tensor:
    """out = epilogue(alpha * (op(a) @ op(b)) + beta * c + bias).

    a: (M, K), or (K, M) with ``transpose_a``; b: (K, N), or (N, K) with
    ``transpose_b``; c: (M, N); bias: (N,)."""
    M, N, K = _shape(a, b, transpose_a, transpose_b)
    in_dtype = torch.result_type(a, b)
    path = _dispatch(in_dtype)
    acc = acc_dtype or _acc_dtype(in_dtype)
    out = out_dtype or (acc if is_integer(in_dtype) else in_dtype)
    if c is not None and tuple(c.shape) != (M, N):
        raise ValueError(f"c shape {tuple(c.shape)} != {(M, N)}")
    a, b = a.to(in_dtype), b.to(in_dtype)
    at = a.t() if transpose_a else a
    bt = b.t() if transpose_b else b
    if M == 0 or N == 0 or K == 0:
        r = torch.zeros((M, N), dtype=acc, device=a.device)
        return _tail(r, alpha, beta, c, bias, epilogue, acc, out)

    if path in ("int32", "int64"):
        native = (bias is None and epilogue in (None, "none") and out == in_dtype
                  and acc == in_dtype and (c is None or c.dtype == in_dtype))
        if native:
            fn = gemm_int32 if path == "int32" else gemm_int64
            return fn(at, bt, alpha=alpha, beta=beta, c=c)
        return _tail(_int_product(at, bt, acc), alpha, beta, c, bias, epilogue, acc, out)

    if path == "f64":
        r = gemm_f64(at, bt, alpha=alpha, beta=beta, c=c, bias=bias, epilogue=epilogue)
        return r if out == torch.float64 else r.to(out)

    if in_dtype == torch.int8:
        if acc != torch.int32:
            return _tail(_int_product(at, bt, acc), alpha, beta, c, bias, epilogue, acc, out)
        # the kernel writes int32 or a float type; another is one cast after
        kernel_out = out if out in INT8_OUT_DTYPES else torch.int32
        r = gemm_fused(a.contiguous(), b.contiguous(), alpha=alpha, beta=beta, c=c,
                       bias=bias, epilogue=epilogue, out_dtype=kernel_out,
                       transpose_a=transpose_a, transpose_b=transpose_b)
        return r if kernel_out == out else r.to(out)

    if acc != torch.float32:
        raise NotImplementedError(f"gemm: {in_dtype} inputs accumulate in float32, not {acc}")
    if epilogue is not None or bias is not None or c is not None:
        return gemm_fused(a.contiguous(), b.contiguous(), alpha=alpha,
                          beta=beta, c=c, bias=bias, epilogue=epilogue,
                          out_dtype=out, transpose_a=transpose_a,
                          transpose_b=transpose_b)
    if in_dtype == torch.float32:
        pin_fp32_matmul()
    r = torch.matmul(at, bt)
    if alpha != 1.0:
        r = r * alpha
    return r.to(out)


def gemm_reference(a, b, **kwargs) -> torch.Tensor:
    """``gemm`` of f32, bf16, f16 or int8 operands through the fused
    kernel's plain version, on any device."""
    _shape(a, b, kwargs.get("transpose_a", False), kwargs.get("transpose_b", False))
    dt = torch.result_type(a, b)
    if dt not in _MXU_DTYPES:
        raise NotImplementedError(f"gemm_reference: {dt} is not a kernel dtype")
    return gemm_plain(a.to(dt), b.to(dt), **kwargs)


def gemm_strided(M: int, N: int, K: int, alpha, A, rsA: int, csA: int,
                 B, rsB: int, csB: int, beta, C, rsC: int, csC: int,
                 **kwargs) -> torch.Tensor:
    """Signature-parity port of ``gemm_strided`` (gemm.nim:184-193).

    A, B and C are flat buffers (torch tensors, or anything
    ``torch.as_tensor`` takes); rs*/cs* are row and column strides in
    elements. Returns the new C as an (M, N) tensor (functional semantics:
    the caller rebinds C). With beta == 0, C is never read."""
    a, ta = _as_operand(torch.as_tensor(A), M, K, rsA, csA)
    b, tb = _as_operand(torch.as_tensor(B), K, N, rsB, csB)
    kwargs.setdefault("transpose_a", ta)
    kwargs.setdefault("transpose_b", tb)
    c = None
    if not (isinstance(beta, (int, float)) and beta == 0):
        if C is None:
            raise ValueError("gemm_strided: beta != 0 requires a C buffer to read")
        c = TensorView.matrix(torch.as_tensor(C), M, N, rsC, csC).materialize()
    return gemm(a, b, alpha=alpha, beta=beta, c=c, **kwargs)


def _as_operand(buf, rows, cols, rs, cs):
    """A flat buffer as a (rows, cols) operand: zero-copy when row-major or
    column-major (the latter handed to the kernel as an in-place transposed
    contraction); any other layout materialises (the packing analog)."""
    v = TensorView.matrix(buf, rows, cols, rs, cs)
    flat = v.buffer
    if v.offset == 0 and rows * cols == flat.numel():
        if rs == cols and cs == 1:
            return flat.reshape(rows, cols), False
        if rs == 1 and cs == rows:
            return flat.reshape(cols, rows), True
    return v.materialize(), False
